"""solve_ms: the measured window's length over the solves completed in
it, in milliseconds (host clock; the window stops only while a sampled
solve's eigenpairs are copied out for the comparison)."""

from eigbench.reference.stats import per_item_ms


def read(ctx):
    w = ctx["window"]
    return per_item_ms(w["window_s"], w["completed"])
