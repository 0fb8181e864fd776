"""The serving layer of the port (``repro_torch.serving``) against the
reference's (``repro.serving``): scheduler coalescing, SLOs, faults, the
warm-session store and its warm restarts.

Each scenario runs on both packages with the same seeded matrix and, where
results are compared, the same explicit NumPy start vector; the typed
outcomes (error class names, stats counters) must agree.  Eigenvalues of
the port are held to the reference's at rel 1e-9 of |lambda|max under FDF
and 1e-5 under FFF, and to the port's own batched API bit for bit.  The
port runs on the CPU here (``device="cpu"``: the kernels' plain versions).
"""

import shutil
import threading
import time
import types

import numpy as np
import pytest
import torch

import repro
import repro.serving as jserving
from repro.api import SolverConfig as JaxConfig
from repro.kernels import engine as jeng
from repro.sparse import generate as jax_generate
from repro.sparse.formats import conversion_count as jax_conversions
from repro.testing import faults as jfaults
import repro_torch
import repro_torch.serving as serving
from repro_torch.api import EigenSession, SolverConfig, prepare
from repro_torch.kernels import engine as eng
from repro_torch.sparse import CSR, DiskCSR, open_diskcsr, save_diskcsr
from repro_torch.sparse.formats import conversion_count
from repro_torch.testing import faults

ITERS = 20
EIG_TOL = {"FDF": 1e-9, "FFF": 1e-5}
SK = dict(k=4, num_iters=16)


def _port_csr(c) -> CSR:
    return CSR(indptr=np.asarray(c.indptr), indices=np.asarray(c.indices),
               data=np.asarray(c.data), shape=c.shape)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("REPRO_SPMV_TUNE", "0")
    monkeypatch.delenv("REPRO_ITER_UPDATE", raising=False)
    repro_torch.session_cache_clear()
    repro.api.session_cache_clear()
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()
    repro_torch.session_cache_clear()
    repro.api.session_cache_clear()


@pytest.fixture(scope="module")
def jcsr():
    return jax_generate("web", 384, 6.0, seed=3, values="normalized")


def _pkg(name, jcsr, policy="FDF"):
    """One package's serving surface, config and matrix."""
    if name == "repro":
        return types.SimpleNamespace(
            name=name, sv=jserving, csr=jcsr, prepare=repro.api.prepare,
            Session=repro.api.EigenSession, conversions=jax_conversions,
            probes=jeng.tuner_probe_count, faults=jfaults,
            cfg=JaxConfig(reorth="full", backend="single", policy=policy),
            kw={}, np=lambda t: np.asarray(t, dtype=np.float64))
    return types.SimpleNamespace(
        name=name, sv=serving, csr=_port_csr(jcsr), prepare=repro_torch.prepare,
        Session=EigenSession, conversions=conversion_count, probes=eng.tuner_probe_count,
        faults=faults, cfg=SolverConfig(reorth="full", backend="single", policy=policy,
                                        device="cpu"),
        kw={"device": "cpu"}, np=lambda t: t.double().numpy())


PKGS = ("repro", "repro_torch")


def _mk(P, *, start=True, store=None, **knobs):
    knobs.setdefault("admission_window_s", 0.02)
    sched = P.sv.EigenScheduler(P.sv.SchedulerConfig(**knobs), store=store, start=start)
    return sched, sched.add_matrix(P.csr, name="m", config=P.cfg)


def _close_eigs(got, want, policy):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=EIG_TOL[policy] * np.abs(want).max())


def _run_both(jcsr, scenario, **kw):
    """Run ``scenario(P)`` for each package and return the two outcomes."""
    return {name: scenario(_pkg(name, jcsr, **kw)) for name in PKGS}


# ---------------------------------------------------------------- coalescing


@pytest.mark.parametrize("policy", ["FDF", "FFF"])
def test_coalesced_results_match_reference(jcsr, policy):
    """Three queries with one group key ride ONE sweep in both packages; the
    port's answers equal its batched API's bits and its lone solves, and the
    reference scheduler's and ``eigsh_many``'s within the policy's bound."""
    v = np.random.default_rng(0).standard_normal(jcsr.n)
    queries = [{"k": k, "num_iters": ITERS, "reorth": "full", "v0": v} for k in (2, 3, 4)]

    def scenario(P):
        sched, key = _mk(P, start=False)
        try:
            handles = [sched.submit(key, q) for q in queries]
            sched.start()
            got = [h.result(timeout=120.0) for h in handles]
        finally:
            sched.close()
        st = sched.stats()
        batched = P.prepare(P.csr, reorth="full", backend="single", policy=policy,
                            **P.kw).eigsh_many(queries)
        return got, batched, (st.groups, st.grouped_queries, st.coalesce_rate,
                              st.batch_occupancy)

    out = _run_both(jcsr, scenario, policy=policy)
    (got, batched, st), (jgot, jbatched, jst) = out["repro_torch"], out["repro"]
    assert st == jst == (1, 3, 1.0, 3.0)
    assert all(r.timings.get("amortized_over") == 3 for r in got)
    ref_sess = prepare(_port_csr(jcsr), reorth="full", backend="single", policy=policy,
                       device="cpu")
    for q, r, b, jr, jb in zip(queries, got, batched, jgot, jbatched):
        assert r.k == b.k == jr.k == q["k"]
        assert torch.equal(r.eigenvalues, b.eigenvalues)
        solo = ref_sess.eigsh(**q)
        np.testing.assert_allclose(r.eigenvalues.double().numpy(),
                                   solo.eigenvalues.double().numpy(), rtol=1e-10)
        _close_eigs(r.eigenvalues.double().numpy(), jr.eigenvalues, policy)
        _close_eigs(r.eigenvalues.double().numpy(), jb.eigenvalues, policy)


def test_incompatible_queries_are_not_coalesced(jcsr):
    def scenario(P):
        sched, key = _mk(P, start=False)
        try:
            h1 = sched.submit(key, k=2, num_iters=ITERS, reorth="full")
            h2 = sched.submit(key, k=2, num_iters=ITERS, reorth="half")
            sched.start()
            ks = (h1.result(timeout=120.0).k, h2.result(timeout=120.0).k)
        finally:
            sched.close()
        return ks, sched.stats().groups, sched.stats().coalesce_rate

    out = _run_both(jcsr, scenario)
    assert out["repro_torch"] == out["repro"] == ((2, 2), 2, 0.0)


def test_group_key_predicate_matches_reference(jcsr):
    """The port's keys split queries into the reference's classes."""
    queries = [{"k": 2, "num_iters": ITERS, "reorth": "full"},
               {"k": 6, "num_iters": 40, "reorth": "full"},
               {"k": 2, "num_iters": ITERS, "reorth": "half"},
               {"k": 2, "num_iters": ITERS, "reorth": "full", "policy": "FFF"}]

    def scenario(P):
        sess = P.Session(P.csr, P.cfg)
        keys = [sess.group_key(q) for q in queries]
        classes = sorted(sorted(i for i, k in enumerate(keys) if k == key) for key in set(keys))
        auto = sess.group_key({"k": 2, "num_iters": ITERS, "policy": "auto"})
        with pytest.raises(ValueError):
            sess.group_key({"k": 0, "num_iters": ITERS})
        return classes, auto

    out = _run_both(jcsr, scenario)
    assert out["repro_torch"] == out["repro"] == ([[0, 1], [2], [3]], None)


def test_queue_and_e2e_timing_split(jcsr):
    P = _pkg("repro_torch", jcsr)
    sched, key = _mk(P)
    try:
        res = sched.submit(key, k=2, num_iters=ITERS, reorth="full").result(timeout=120.0)
    finally:
        sched.close()
    t = res.timings
    assert t["queue_s"] >= 0.0
    assert t["e2e_s"] == pytest.approx(t["queue_s"] + t["total_s"], abs=1e-12)
    assert res.queue_s == t["queue_s"]


# ----------------------------------------------------------------- SLO plane


def _deadline(P):
    sched, key = _mk(P, start=False)
    try:
        h = sched.submit(key, k=2, num_iters=ITERS, deadline_s=0.02)
        time.sleep(0.1)  # the deadline lapses while the dispatcher is off
        sched.start()
        err = type(h.exception(timeout=30.0)).__name__
    finally:
        sched.close()
    return err, sched.stats().rejected_deadline, sched.stats().completed


def _backpressure(P):
    sched, key = _mk(P, start=False, max_queue=4)
    try:
        for _ in range(4):
            sched.submit(key, k=2, num_iters=ITERS)
        with pytest.raises(P.sv.QueueFullError):
            sched.submit(key, k=2, num_iters=ITERS)
        return sched.stats().rejected_full, sched.stats().queue_depth
    finally:
        sched.close()


def _cancel(P):
    sched, key = _mk(P, start=False)
    try:
        h = sched.submit(key, k=2, num_iters=ITERS)
        first, again = h.cancel(), h.cancel()
        sched.start()
        err = type(h.exception(timeout=30.0)).__name__
    finally:
        sched.close()
    return first, again, h.cancelled(), err, sched.stats().cancelled


def _invalid(P):
    sched, key = _mk(P, start=False)
    try:
        with pytest.raises(ValueError):
            sched.submit(key, k=0, num_iters=ITERS)
        with pytest.raises(P.sv.UnknownMatrixError):
            sched.submit("nope", k=2, num_iters=ITERS)
        return sched.stats().queue_depth
    finally:
        sched.close()


def _close_fails_leftovers(P):
    sched, key = _mk(P, start=False)
    h = sched.submit(key, k=2, num_iters=ITERS)
    sched.close()
    return type(h.exception(timeout=5.0)).__name__


def _lru(P):
    road = jax_generate("road", 256, 3.0, seed=5, values="normalized")
    road = road if P.name == "repro" else _port_csr(road)
    sched = P.sv.EigenScheduler(P.sv.SchedulerConfig(max_sessions=1), start=False)
    try:
        k1 = sched.add_matrix(P.csr, name="a", config=P.cfg)
        k2 = sched.add_matrix(road, name="b", config=P.cfg)
        sched.session(k2)
        with pytest.raises(P.sv.UnknownMatrixError):
            sched.session(k1)
        return sched.stats().sessions
    finally:
        sched.close()


@pytest.mark.parametrize("scenario, want", [
    (_deadline, ("DeadlineExceededError", 1, 0)),
    (_backpressure, (1, 4)),
    (_cancel, (True, True, True, "QueryCancelledError", 1)),
    (_invalid, 0),
    (_close_fails_leftovers, "ServingError"),
    (_lru, 1),
], ids=["deadline", "backpressure", "cancel", "invalid_query", "close_fails_leftovers",
        "lru_eviction"])
def test_slo_plane_matches_reference(jcsr, scenario, want):
    """Deadlines, backpressure, cancellation, synchronous validation, close
    and the LRU session pool: the same typed outcome and counters."""
    out = _run_both(jcsr, scenario)
    assert out["repro_torch"] == out["repro"] == want


# ------------------------------------------------------------- concurrency


def test_concurrent_submitters_all_served_correctly(jcsr):
    v = np.random.default_rng(1).standard_normal(jcsr.n)
    jref = repro.api.prepare(jcsr, reorth="full", backend="single")
    expect = {k: np.asarray(jref.eigsh(k=k, num_iters=ITERS, reorth="full", v0=v).eigenvalues)
              for k in (2, 3, 4)}
    P = _pkg("repro_torch", jcsr)
    results, errors = {}, []
    sched, key = _mk(P, admission_window_s=0.05, max_group=16)
    try:
        def client(tid):
            try:
                hs = [(k, sched.submit(key, k=k, num_iters=ITERS, reorth="full", v0=v))
                      for k in (2, 3, 4)]
                results[tid] = [(k, h.result(timeout=120.0)) for k, h in hs]
            except Exception as exc:  # surfaced below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sched.close()
    assert not errors and len(results) == 4
    for per_thread in results.values():
        for k, r in per_thread:
            assert r.k == k
            _close_eigs(r.eigenvalues.double().numpy(), expect[k], "FDF")
    stats = sched.stats()
    assert stats.completed == 12
    assert stats.groups < 12 and stats.batch_occupancy > 1.0


# ------------------------------------------------------------------ faults


def _retry_recovers(P):
    cfg = P.sv.SchedulerConfig(max_retries=1, retry_backoff_s=0.01, watchdog_interval_s=0.1)
    with P.sv.EigenScheduler(cfg) as s:
        key = s.add_matrix(P.csr, config=P.cfg)
        with P.faults.inject("spmv_nan@iter=3"):
            res = s.submit(key, **SK).result(timeout=120.0)
        st = s.stats()
    return res.k, st.retries, st.failed


def _retry_exhausts(P):
    cfg = P.sv.SchedulerConfig(max_retries=1, retry_backoff_s=0.01, watchdog_interval_s=0.1)
    with P.sv.EigenScheduler(cfg) as s:
        key = s.add_matrix(P.csr, config=P.cfg)
        with P.faults.inject("spmv_nan@iter=3,count=99"):
            exc = s.submit(key, **SK).exception(timeout=120.0)
        with pytest.raises(ValueError):
            s.submit(key, k=4, num_iters=2)  # a caller bug: rejected, never retried
        st = s.stats()
    return type(exc).__name__, exc.kind, st.retries, st.failed


def _breaker(P):
    cfg = P.sv.SchedulerConfig(breaker_threshold=2, breaker_cooldown_s=0.3,
                               watchdog_interval_s=0.1)
    with P.sv.EigenScheduler(cfg) as s:
        key = s.add_matrix(P.csr, config=P.cfg)
        with P.faults.inject("spmv_nan@iter=3,count=99"):
            for _ in range(2):
                assert s.submit(key, **SK).exception(timeout=120.0) is not None
        deadline = time.monotonic() + 5.0
        while s.breaker_state(key) != "open" and time.monotonic() < deadline:
            time.sleep(0.01)
        opened = s.breaker_state(key)
        with pytest.raises(P.sv.SessionUnhealthyError):
            s.submit(key, **SK)
        time.sleep(0.35)  # cooldown: the next submit is the half-open probe
        k = s.submit(key, **SK).result(timeout=120.0).k
        st = s.stats()
        closed = s.breaker_state(key)
    return opened, k, closed, st.breaker_trips, st.rejected_breaker


def _watchdog(P):
    s = P.sv.EigenScheduler(P.sv.SchedulerConfig(watchdog_interval_s=0.05))
    try:
        key = s.add_matrix(P.csr, config=P.cfg)
        with P.faults.inject("scheduler_crash"):
            t0 = time.monotonic()
            exc = s.submit(key, **SK).exception(timeout=30.0)
            bounded = time.monotonic() - t0 < 10.0
        with pytest.raises(P.sv.SchedulerCrashedError):
            s.submit(key, **SK)
        trips = s.stats().watchdog_trips
        s.start()  # an explicit restart recovers the scheduler
        k = s.submit(key, **SK).result(timeout=120.0).k
    finally:
        s.close()
    return type(exc).__name__, bounded, trips, k


def _loop_guard(P):
    s = P.sv.EigenScheduler(P.sv.SchedulerConfig(watchdog_interval_s=0.1))
    try:
        key = s.add_matrix(P.csr, config=P.cfg)
        orig, calls = s._dispatch, {"n": 0}

        def boom(group):
            if calls["n"] == 0:
                calls["n"] += 1
                raise RuntimeError("synthetic dispatch bug")
            return orig(group)

        s._dispatch = boom
        exc = s.submit(key, **SK).exception(timeout=30.0)
        alive = s._thread.is_alive()
        k = s.submit(key, **SK).result(timeout=120.0).k
        return (type(exc).__name__, "internal dispatch failure" in str(exc), alive, k,
                s.stats().dispatch_errors)
    finally:
        s.close()


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("scenario, want", [
    (_retry_recovers, (4, 1, 0)),
    (_retry_exhausts, ("NumericalBreakdown", "nonfinite", 1, 1)),
    (_breaker, ("open", 4, "closed", 1, 1)),
    (_watchdog, ("SchedulerCrashedError", True, 1, 4)),
    (_loop_guard, ("ServingError", True, True, 4, 1)),
], ids=["retry_recovers", "retry_exhausts", "breaker", "watchdog", "loop_guard"])
def test_scheduler_faults_match_reference(jcsr, scenario, want):
    """Retries, the circuit breaker, the watchdog (the dispatch loop calls
    ``testing.faults.check_scheduler``) and the loop guard, under each
    package's own fault registry."""
    out = _run_both(jcsr, scenario)
    assert out["repro_torch"] == out["repro"] == want


# ------------------------------------------------------------ warm restarts


def test_warm_restart_zero_conversions_and_probes(jcsr, tmp_path, monkeypatch):
    """A closed scheduler persists its sessions; a second one on the same
    store warms them with zero conversions and zero tuner probes (tuning
    on, so the cold build did probe) and answers with the same bits, in
    both packages; the port's answer is the reference's within FDF's bound."""
    monkeypatch.setenv("REPRO_SPMV_TUNE", "1")
    monkeypatch.setenv("REPRO_SPMV_TUNE_BUDGET", "2")
    v = np.random.default_rng(2).standard_normal(jcsr.n)
    q = dict(k=3, num_iters=ITERS, v0=v)

    def scenario(P):
        monkeypatch.setenv("REPRO_SPMV_TUNE_CACHE", str(tmp_path / f"{P.name}.json"))
        store = P.sv.SessionStore(str(tmp_path / P.name))
        probes0 = P.probes()
        with P.sv.EigenScheduler(P.sv.SchedulerConfig(), store=store) as s1:
            key = s1.add_matrix(P.csr, config=P.cfg)
            before = s1.submit(key, **q).result(timeout=120.0)
            cold = s1.stats().cold_builds
        assert P.probes() > probes0 and store.entries()
        conv0, probes0 = P.conversions(), P.probes()
        with P.sv.EigenScheduler(P.sv.SchedulerConfig(), store=store) as s2:
            key2 = s2.add_matrix(P.csr, config=P.cfg)
            warm = (s2.stats().warm_starts, s2.stats().cold_builds)
            res = s2.submit(key2, **q).result(timeout=120.0)
        counts = (P.conversions() - conv0, P.probes() - probes0,
                  res.partition["spmv"]["conversions"], res.partition["spmv"]["tuner_probes"])
        same = np.array_equal(P.np(res.eigenvalues), P.np(before.eigenvalues))
        return cold, warm, counts, res.session_reuse, same, res.eigenvalues

    out = _run_both(jcsr, scenario)
    port, ref = out["repro_torch"], out["repro"]
    assert port[:5] == ref[:5] == (1, (1, 0), (0, 0, 0, 0), True, True)
    _close_eigs(port[5].double().numpy(), ref[5], "FDF")


def test_layout_config_change_misses_the_store(jcsr, tmp_path):
    def scenario(P):
        store = P.sv.SessionStore(str(tmp_path / P.name))
        with P.sv.EigenScheduler(P.sv.SchedulerConfig(), store=store) as s1:
            s1.add_matrix(P.csr, config=P.cfg)
        other = type(P.cfg)(reorth="full", backend="auto", **P.kw)
        with P.sv.EigenScheduler(P.sv.SchedulerConfig(), store=store) as s2:
            s2.add_matrix(P.csr, config=other)
            return s2.stats().warm_starts, s2.stats().cold_builds

    out = _run_both(jcsr, scenario)
    assert out["repro_torch"] == out["repro"] == (0, 1)


@pytest.mark.parametrize("field, value", [
    ("repro_version", "0.0.1"),
    ("package", "repro"),
    ("layout_fingerprint", "0" * 24),
])
def test_stale_persisted_state_rejected_then_cold_rebuild(jcsr, field, value):
    """A stale or foreign header is refused with a warning and the session
    cold-builds; the untampered state imports with zero conversions and
    gives the cold build's bits."""
    P = _pkg("repro_torch", jcsr)
    s1 = EigenSession(P.csr, P.cfg).warmup()
    state = s1.export_state()
    assert state["plans"] and state["package"] == "repro_torch"
    s2 = EigenSession(P.csr, P.cfg)
    with pytest.warns(UserWarning, match="stale persisted session rejected"):
        assert s2.import_plans(dict(state, **{field: value})) == 0
    conv0 = conversion_count()
    r = s2.eigsh(k=2, num_iters=ITERS, reorth="full")
    assert conversion_count() - conv0 > 0
    s3 = EigenSession(P.csr, P.cfg)
    assert s3.import_plans(state) >= 1
    conv0 = conversion_count()
    r3 = s3.eigsh(k=2, num_iters=ITERS, reorth="full")
    assert conversion_count() - conv0 == 0
    assert torch.equal(r3.eigenvalues, r.eigenvalues)


@pytest.mark.parametrize("writer", PKGS)
def test_each_package_refuses_the_others_store_entry(jcsr, tmp_path, writer):
    """An entry one package wrote, placed where the other's store looks,
    is refused with a warning (the version and package differ: the layouts
    do too, ELL slots padded to 8 against 128 lanes), and the reader
    cold-builds."""
    reader = "repro" if writer == "repro_torch" else "repro_torch"
    W, R = _pkg(writer, jcsr), _pkg(reader, jcsr)
    ws = W.Session(W.csr, W.cfg).warmup()
    wstore, rstore = W.sv.SessionStore(str(tmp_path / "w")), R.sv.SessionStore(str(tmp_path / "r"))
    src = wstore.save(ws)
    rs = R.Session(R.csr, R.cfg)
    shutil.copytree(src, rstore.path_for(rs))
    with pytest.warns(UserWarning, match="stale persisted session rejected"):
        assert rstore.load_into(rs) == 0
    conv0 = R.conversions()
    assert rs.eigsh(k=2, num_iters=ITERS, reorth="full").k == 2
    assert R.conversions() - conv0 > 0


def test_store_persists_header_only_pointer(jcsr, tmp_path):
    """A chunked session over a diskcsr directory persists a pointer, not
    the payload; its sampled fingerprint is the reference's, and a revive
    refuses changed bytes and a missing directory
    (``tests/test_oocore.py``'s counterparts)."""
    from repro.sparse.diskcsr import diskcsr_fingerprint as jax_diskcsr_fingerprint

    web = _port_csr(jcsr)
    path = save_diskcsr(str(tmp_path / "m"), web)
    disk = open_diskcsr(path)
    session = prepare(disk, backend="chunked", format="ell", chunk_nnz=2048, num_iters=ITERS,
                      device="cpu")
    store = serving.SessionStore(str(tmp_path / "store"))
    entry = store.save(session)
    assert entry is not None and store.entries()
    assert (entry / "plans.npz").stat().st_size < disk.nbytes_on_disk() // 4
    state = store.load_state(session)
    ref = state["matrix_ref"]
    assert ref["kind"] == "diskcsr" and ref["path"] == disk.path
    assert ref["fingerprint"] == jax_diskcsr_fingerprint(path)
    revived = serving.SessionStore.revive_matrix(state)
    assert isinstance(revived, DiskCSR) and revived.n == web.n
    moved = dict(state, matrix_ref=dict(ref, path=str(tmp_path / "gone")))
    with pytest.warns(UserWarning, match="no longer"):
        assert serving.SessionStore.revive_matrix(moved) is None
    data = tmp_path / "m" / "data.npy"
    raw = bytearray(data.read_bytes())
    raw[-1] ^= 0xFF
    data.write_bytes(bytes(raw))
    with pytest.warns(UserWarning, match="fingerprint mismatch"):
        assert serving.SessionStore.revive_matrix(state) is None


def test_serving_surface_matches_reference():
    """The port exports the reference's serving names; the legacy LM engine
    comes through the reference's ``DeprecationWarning`` shim."""
    assert set(serving.__all__) == set(jserving.__all__)
    from repro_torch.serving import engine as serving_engine
    from repro_torch.serving import lm

    for mod in (serving, serving_engine):
        for name in ("Engine", "ServeConfig"):
            with pytest.warns(DeprecationWarning, match="serving.lm"):
                assert getattr(mod, name) is getattr(lm, name)
    assert serving.default_store_root().endswith("serving_store")
