"""lanczos_ms: the mean over the measured window's solves of the
program's own span ``timings["lanczos_s"]`` (``core/eigensolver.py``
``solve_fixed``: the Lanczos sweep, ended by a device sync), in ms."""


def read(ctx):
    ts = [t["lanczos_s"] for t in ctx["window"]["timings"] if "lanczos_s" in t]
    return 1e3 * sum(ts) / len(ts) if ts else None
