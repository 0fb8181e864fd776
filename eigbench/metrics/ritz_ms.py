"""ritz_ms: the mean over the measured window's solves of the program's
spans ``timings["jacobi_s"] + timings["project_s"]`` (the Ritz stage:
``core/eigensolver.py`` ``ritz_decompose`` and ``ritz_extract``), in ms."""


def read(ctx):
    ts = [t["jacobi_s"] + t["project_s"] for t in ctx["window"]["timings"]
          if "jacobi_s" in t and "project_s" in t]
    return 1e3 * sum(ts) / len(ts) if ts else None
