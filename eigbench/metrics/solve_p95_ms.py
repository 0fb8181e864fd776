"""solve_p95_ms: the 95th percentile of every completed solve's latency in
the window, from the call until its eigenvalues are on the host."""

from eigbench.reference.stats import percentile


def read(ctx):
    lat = ctx["window"]["latencies"]
    return percentile(lat, 95) * 1e3 if lat else None
