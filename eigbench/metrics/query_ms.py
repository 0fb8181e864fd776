"""query_ms: the query layer's self time, the mean over the measured
window's solves of the program's spans ``timings["query_s"]`` less
``lanczos_s``, ``jacobi_s`` and ``project_s`` (``api/session.py``
``eigsh_many`` around ``core/eigensolver.py`` ``solve_fixed``: the
queries' checks, the ``v0`` digest, the plan's lookup and the result), in
ms.  A card's reading only: on the CPU the ``v0`` reaches the host with no
copy, so the layer does other work there.  None on the CPU and where the
program has no ``query_s``."""

KEYS = ("query_s", "lanczos_s", "jacobi_s", "project_s")


def read(ctx):
    if ctx["device"]["platform"] != "gpu":
        return None
    ts = [t["query_s"] - t["lanczos_s"] - t["jacobi_s"] - t["project_s"]
          for t in ctx["window"]["timings"] if all(k in t for k in KEYS)]
    return 1e3 * sum(ts) / len(ts) if ts else None
