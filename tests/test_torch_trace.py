"""The spans and the counter of a solve (``repro_torch.core.trace``).

On the CPU: under ``torch.profiler`` an ``EigenSession.eigsh`` with a
``v0`` records its seven spans, nested as ``core/trace.py`` lists them,
and no digest of the ``v0``; the benchmark's idle-gap naming
(``eigbench.tracing.idle_gaps``) names a gap by the innermost span that
covers it; without a profiler no range is opened; the profiler changes no
bit of the answer; the result's ``timings`` carry every key, and
``v0_digest_s`` only where a digest was taken.  The ``gpu`` case checks
that a card ``v0`` is neither copied to the host nor hashed, also where
two byte-equal ones are grouped.  The file imports neither ``jax`` nor the
reference package, so on the card's machine it runs from the repository
root as

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_trace.py
"""

import numpy as np
import pytest
import torch

import repro_torch
from eigbench import tracing
from repro_torch.core import trace
from repro_torch.sparse import generate

N = 4096
QUERY = "repro_torch.query"
CHILDREN = ("repro_torch.query.normalize", "repro_torch.query.plan", "repro_torch.sweep.lanczos",
            "repro_torch.ritz.jacobi", "repro_torch.ritz.project", "repro_torch.query.finish")
DIGEST = "repro_torch.query.v0_digest"
SPANS = (QUERY,) + CHILDREN
COUNTERS = ("host_copy_bytes", "start_compares", "v0_digests")
NEW_KEYS = ("query_s", "normalize_s", "plan_s", "finish_s") + COUNTERS
OLD_KEYS = ("lanczos_s", "jacobi_s", "project_s", "total_s", "solve_s", "prepare_s")


@pytest.fixture(scope="module")
def session():
    a = generate("road", N, 2.1, seed=3, values="normalized")
    return repro_torch.prepare(a, device="cpu")


@pytest.fixture(scope="module")
def v0():
    return torch.randn(N, generator=torch.Generator().manual_seed(11), dtype=torch.float64)


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _ranges(prof) -> dict:
    """{span name: [(start, end), ...]} of the user annotations."""
    got = {}
    for e in prof.events():
        if e.is_user_annotation:
            got.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return got


def _solve(session, v0):
    return session.eigsh(8, num_iters=8, reorth="half", v0=v0)


def test_a_solve_records_its_spans_nested(session, v0):
    _, prof = _profiled(lambda: _solve(session, v0))
    got = _ranges(prof)
    assert set(got) == set(SPANS) and all(len(r) == 1 for r in got.values())
    assert DIGEST not in got
    (q0, q1), = got[QUERY]
    prev = q0
    for name in CHILDREN:  # inside the query, one after another
        (s, e), = got[name]
        assert prev <= s <= e <= q1, name
        prev = e


def test_idle_gaps_name_the_innermost_span(session, v0):
    """A synthetic idle gap of the card at a point of a solve is named by
    the innermost span there, also with the benchmark's own span around
    the call (eight spans: its look-back of eight still reaches the query)."""

    def call():
        with torch.profiler.record_function("eigbench.solve"):
            return _solve(session, v0)

    _, prof = _profiled(call)
    got = {name: r[0] for name, r in _ranges(prof).items()}
    trc = tracing.read(prof, 1.0)
    assert [name for name, _, _ in trc.spans][:2] == ["eigbench.solve", QUERY]
    (_, p1), (f0, f1) = got["repro_torch.ritz.project"], got["repro_torch.query.finish"]
    assert p1 < f0
    points = {"repro_torch.query.normalize": sum(got["repro_torch.query.normalize"]) / 2,
              "repro_torch.query.plan": sum(got["repro_torch.query.plan"]) / 2,
              "repro_torch.query.finish": (f0 + f1) / 2,
              QUERY: (p1 + f0) / 2}
    for name, t in points.items():
        eps = 1e-3
        gap = tracing.Trace(1.0, 0.0, [("k", t - 2 * eps, t - eps), ("k", t + eps, t + 2 * eps)],
                            [], trc.spans)
        ((label, seconds),) = tracing.idle_gaps(gap)
        assert label == f"host: {name} (no torch op)"
        assert seconds == pytest.approx(2 * eps / 1e6)


def test_no_profiler_opens_no_range(session, v0, monkeypatch):
    entered = []
    enter = torch.autograd._record_function_with_args_enter
    rf_enter = torch.profiler.record_function.__enter__

    def counting_enter(name, *args):
        entered.append(name)
        return enter(name, *args)

    def counting_rf_enter(self):
        entered.append(self.name)
        return rf_enter(self)

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", counting_enter)
    monkeypatch.setattr(torch.profiler.record_function, "__enter__", counting_rf_enter)
    _solve(session, v0)
    assert entered == []
    _profiled(lambda: _solve(session, v0))  # the patch sees the ranges a profiler opens
    assert sorted(entered) == sorted(SPANS)


def test_the_profiler_changes_no_bit(session, v0):
    off = _solve(session, v0)
    on, _ = _profiled(lambda: _solve(session, v0))
    assert torch.equal(off.eigenvalues, on.eigenvalues)
    assert torch.equal(off.eigenvectors, on.eigenvectors)
    assert torch.equal(off.tridiag.alpha, on.tridiag.alpha)
    assert torch.equal(off.tridiag.beta, on.tridiag.beta)


def test_timings_carry_every_span(session, v0, tmp_path):
    t = _solve(session, v0).timings
    assert set(NEW_KEYS + OLD_KEYS) <= set(t)
    assert all(isinstance(t[k], float) and t[k] >= 0 for k in NEW_KEYS + OLD_KEYS)
    parts = ("normalize_s", "plan_s", "lanczos_s", "jacobi_s", "project_s", "finish_s")
    assert t["query_s"] >= sum(t[k] for k in parts)
    assert all(t[k] == 0.0 for k in COUNTERS)  # a host tensor is not copied; a lone v0 not read
    assert "v0_digest_s" not in t
    bare = session.eigsh(8, num_iters=8).timings
    assert "v0_digest_s" not in bare
    assert set(NEW_KEYS) <= set(bare)
    # A checkpointed sweep's token takes the digest: one, inside the call.
    a = generate("road", N, 2.1, seed=3, values="normalized")
    ckpt = repro_torch.prepare(a, device="cpu", checkpoint_dir=str(tmp_path))
    t = ckpt.eigsh(4, tol=1e-6, subspace=12, max_restarts=2, v0=v0).timings
    assert t["v0_digests"] == 1.0 and t["start_compares"] == 0.0
    assert 0 < t["v0_digest_s"] <= t["query_s"] - t["normalize_s"]


def test_a_group_shares_the_call(session, v0):
    """Two queries on one start vector: one sweep, one call; each result
    has the call's numbers and its own normalize and finish."""
    from repro_torch.api import EigQuery

    a, b = session.eigsh_many([EigQuery(k=4, num_iters=8, v0=v0),
                               EigQuery(k=8, num_iters=8, v0=v0)])
    assert a.timings["query_s"] == b.timings["query_s"]
    assert a.timings["lanczos_s"] == b.timings["lanczos_s"]
    assert a.timings["plan_s"] == b.timings["plan_s"]
    assert a.timings["query_s"] >= a.timings["lanczos_s"] + a.timings["finish_s"] \
        + b.timings["finish_s"] + a.timings["normalize_s"] + b.timings["normalize_s"]


def test_span_count_and_records():
    outer, inner, into = {}, {}, {"x_s": 1.0}
    trace.count("n", 5)  # no record open: nothing to add to
    with trace.counting(outer):
        trace.count("n", 2)
        with trace.counting(inner), trace.span(None, into, "x_s"):
            trace.count("n", 3)
            trace.to_host(torch.ones(4))  # a host tensor: no copy counted
    trace.count("n", 7)
    assert outer == {"n": 5.0} and inner == {"n": 3.0}
    assert into["x_s"] > 1.0
    with pytest.raises(ValueError), trace.span(None, into, "y_s"):
        raise ValueError("the span still ends")
    assert into["y_s"] >= 0.0


@pytest.mark.gpu
def test_card_counts_the_v0_copy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    from repro_torch.api import EigQuery

    a = generate("road", 1 << 16, 2.1, seed=3, values="normalized")
    s = repro_torch.prepare(a, device="cuda", policy="FDF")
    n = a.shape[0]
    v = torch.randn(n, dtype=torch.float64, device="cuda")
    s.eigsh(8, num_iters=8, v0=v)
    t = s.eigsh(8, num_iters=8, v0=v).timings
    # The Ritz stage's and the probe's few hundred bytes; the v0 stays put.
    assert t["host_copy_bytes"] < 4096
    assert t["v0_digests"] == 0.0 and t["start_compares"] == 0.0 and "v0_digest_s" not in t
    assert np.isfinite(t["finish_s"])
    # Two distinct, byte-equal card vectors and a host copy of the same
    # bytes: two comparisons (the host one on the card), one sweep (as the
    # reference groups them), still nothing of the v0 copied to the host.
    sweeps = s.stats["sweeps"]
    got = s.eigsh_many([EigQuery(k=8, num_iters=8, v0=v), EigQuery(k=4, num_iters=8, v0=v.clone()),
                        EigQuery(k=2, num_iters=8, v0=v.cpu().numpy())])
    assert s.stats["sweeps"] == sweeps + 1
    assert [r.timings["amortized_over"] for r in got] == [3.0, 3.0, 3.0]
    t = got[0].timings
    assert t["start_compares"] == 2.0 and t["v0_digests"] == 0.0
    assert t["host_copy_bytes"] < 4096
    # One element's bytes apart (-0.0 against 0.0): two starts, two sweeps.
    w, z = v.clone(), v.clone()
    w[3], z[3] = 0.0, -0.0
    sweeps = s.stats["sweeps"]
    s.eigsh_many([EigQuery(k=8, num_iters=8, v0=w), EigQuery(k=8, num_iters=8, v0=z)])
    assert s.stats["sweeps"] == sweeps + 2
