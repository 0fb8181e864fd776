"""The readers of the program's query-path span and copy counter,
``query_ms`` and ``host_copy_mb``, on hand-made run contexts."""

import pytest

from eigbench import cells
from eigbench.tests.tiny import REPO

SOLVE = {"query_s": 0.400, "lanczos_s": 0.030, "jacobi_s": 0.008, "project_s": 0.002,
         "host_copy_bytes": 128_019_304.0 + 848.0}
OTHER = {"query_s": 0.300, "lanczos_s": 0.020, "jacobi_s": 0.009, "project_s": 0.001,
         "host_copy_bytes": 64.0 * 2**20}


def _ctx(timings, platform="gpu"):
    return {"device": {"platform": platform}, "window": {"timings": timings}}


def _read(name, ctx):
    return cells.metric_reader(REPO, name).read(ctx)


def test_query_ms_is_the_mean_self_time_of_the_query():
    assert _read("query_ms", _ctx([SOLVE])) == pytest.approx(360.0)
    assert _read("query_ms", _ctx([SOLVE, OTHER])) == pytest.approx((360.0 + 270.0) / 2)


def test_host_copy_mb_is_the_mean_count_in_mib():
    assert _read("host_copy_mb", _ctx([SOLVE])) == pytest.approx(122.0895, abs=1e-4)
    assert _read("host_copy_mb", _ctx([SOLVE, OTHER])) == pytest.approx(
        (SOLVE["host_copy_bytes"] / 2**20 + 64.0) / 2)


@pytest.mark.parametrize("name", ["query_ms", "host_copy_mb"])
def test_no_reading_on_the_cpu_or_without_the_keys(name):
    assert _read(name, _ctx([SOLVE], platform="cpu")) is None
    assert _read(name, _ctx([])) is None
    # A program without the spans, as before they existed: only the sweep's.
    older = {k: SOLVE[k] for k in ("lanczos_s", "jacobi_s", "project_s")}
    assert _read(name, _ctx([older, dict(older, total_s=0.04)])) is None
