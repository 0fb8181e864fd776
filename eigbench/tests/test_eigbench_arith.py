"""The benchmark's arithmetic on hand-made samples: rate, p95,
the roofline's bytes, and the trace's busy union and idle gaps."""

import pytest
import torch

from eigbench import tracing
from eigbench.reference import roofline, stats


def test_percentile_is_linear_between_ranks():
    xs = list(range(1, 101))  # 1..100
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([4.0, 1.0, 3.0, 2.0], 50) == 2.5
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_over_the_window():
    assert stats.per_item_ms(51.0, 136) == pytest.approx(375.0)
    with pytest.raises(ValueError):
        stats.per_item_ms(1.0, 0)


def test_spmv_bytes_follow_the_csr_not_the_layout():
    # 10 rows, 25 nonzeros: f32 values + int32 columns, x f32 in, y f64 out
    assert roofline.spmv_bytes(10, 25, "float32", "float32", "float64") == 25 * 8 + 40 + 80
    assert roofline.spmv_bytes(10, 25, "float64", "float64", "float64") == 25 * 12 + 80 + 80
    t = roofline.least_seconds(3.35e12, "NVIDIA H100 80GB HBM3")
    assert t == pytest.approx(1.0)
    assert roofline.least_seconds(1.0, "some other card") is None


def _trace(device, host, spans=(), window=100.0):
    dev = sorted(device, key=lambda r: r[1])
    return tracing.Trace(window, tracing.busy_us(dev), dev, sorted(host, key=lambda r: r[1]),
                         sorted(spans, key=lambda r: r[1]))


def test_busy_is_the_union_of_device_intervals():
    t = _trace([("k1", 0.0, 10.0), ("k2", 5.0, 15.0), ("copy", 20.0, 30.0)], [])
    assert t.busy_us == 25.0
    assert t.device_us(("k",)) == 20.0
    ops = tracing.device_ops(t)
    assert ops[0] == ["k1", 10.0 / 1e6] or ops[0] == ["k2", 10.0 / 1e6]


def test_idle_gaps_are_named_by_the_host():
    dev = [("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 60.0, 70.0), ("k", 75.0, 80.0)]
    host = [("aten::copy_", 12.0, 18.0), ("aten::mv", 71.0, 72.0)]
    spans = [("eigbench.solve", 0.0, 72.0)]
    gaps = dict(tracing.idle_gaps(_trace(dev, host, spans)))
    assert gaps["host: aten::copy_"] == pytest.approx(10.0 / 1e6)
    assert gaps["host: eigbench.solve (no torch op)"] == pytest.approx(30.0 / 1e6)
    assert gaps["host: no profiled host event"] == pytest.approx(5.0 / 1e6)


def test_trace_read_drops_annotations_on_the_device_timeline():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("eigbench.solve"):
            torch.ones(64).sum()
    t = tracing.read(prof, 1.0)
    assert [name for name, _, _ in t.spans] == ["eigbench.solve"]
    assert t.device == [] and t.busy_us == 0.0
    assert any(name == "aten::sum" for name, _, _ in t.host)
