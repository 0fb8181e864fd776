"""Solve robustness: the fault registry, typed breakdowns, ``recovery="auto"``
and checkpoint resume, through ``repro_torch`` and, where the two can meet,
``repro`` on the same inputs (each package arms its own registry).

Tolerances:
- a breakdown's ``kind`` and ``iteration`` and a trail's ``action`` /
  ``from`` / ``to`` are equal between the packages;
- eigenvalues after a recovery are within rel 1e-5 of |lambda|max of the
  reference's where both start from the same vector (an explicit ``v0``, or
  the restarted engine's NumPy draw from the seed); the reseeded fixed path
  draws its new start from ``jax.random`` in the reference, so only its
  trail is compared;
- a resumed solve has the same bits as an uninterrupted one of the same
  package, and is within rel 1e-5 of the reference's uninterrupted solve.
"""

import json

import numpy as np
import pytest
import torch

import repro
from repro.api import session_cache_clear as jax_cache_clear
from repro.core.lanczos import NumericalBreakdown as JaxBreakdown
from repro.serving.store import SolveCheckpoint as JaxCheckpoint
from repro.sparse import generate as jax_generate
from repro.testing import faults as jfaults
import repro_torch
from repro_torch.api import EigenResult, NumericalBreakdown
from repro_torch.core.lanczos import lanczos_tridiag
from repro_torch.core.operators import ChunkedOperator
from repro_torch.core.precision import FDF
from repro_torch.kernels.engine import make_engine
from repro_torch.serving import SolveCheckpoint, default_checkpoint_root
from repro_torch.sparse import CSR
from repro_torch.testing import faults

K = 4
ITERS = 20
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_slate():
    faults.reset()
    jfaults.reset()
    repro_torch.session_cache_clear()
    jax_cache_clear()
    yield
    faults.reset()
    jfaults.reset()
    repro_torch.session_cache_clear()
    jax_cache_clear()


def _port_csr(c) -> CSR:
    return CSR(indptr=np.asarray(c.indptr), indices=np.asarray(c.indices),
               data=np.asarray(c.data), shape=c.shape)


@pytest.fixture(scope="module")
def web_ref():
    return jax_generate("web", 384, 6.0, seed=7, values="normalized")


@pytest.fixture(scope="module")
def web(web_ref):
    return _port_csr(web_ref)


@pytest.fixture(scope="module")
def v0(web_ref):
    return np.random.default_rng(5).standard_normal(web_ref.n)


def _kw(backend, **kw):
    kw.setdefault("policy", "FFF")
    kw.setdefault("num_iters", ITERS)
    if backend == "restarted":
        kw.setdefault("subspace", 12)
        kw.setdefault("tol", 1e-10)
        kw.pop("num_iters")
    if backend == "chunked":
        kw.setdefault("chunk_nnz", 1024)
    return dict(backend=backend, **kw)


def _port(a, backend, **kw):
    return repro_torch.eigsh(a, K, device="cpu", **_kw(backend, **kw))


def _ref(a, backend, **kw):
    kw = _kw(backend, **kw)
    if kw.get("v0") is not None:
        kw["v0"] = np.asarray(kw["v0"])
    return repro.eigsh(a, K, **kw)


def _trail(res):
    return [(t["action"], t.get("from"), t.get("to")) for t in (res.recovery_trail or [])]


def _close(port_res, ref_res, rtol=RTOL):
    got = np.sort(port_res.eigenvalues.double().numpy())
    want = np.sort(np.asarray(ref_res.eigenvalues, dtype=np.float64))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


# ---------------------------------------------------------------------------
# grammar + registry mechanics (the reference's tests, on the port)


def test_parse_fault_grammar():
    fs = faults.parse_fault("spmv_nan@iter=3,count=2")
    assert (fs.kind, fs.iteration, fs.count) == ("spmv_nan", 3, 2)
    assert faults.parse_fault("chunk_io_error@chunk=1").iteration == 1
    assert faults.parse_fault("solve_crash@cycle=4").iteration == 4
    assert faults.parse_fault("kernel_error").iteration is None
    assert faults.FAULT_KINDS == jfaults.FAULT_KINDS


@pytest.mark.parametrize(
    "bad", ["frobnicate", "spmv_nan@iter", "spmv_nan@iter=x", "spmv_nan@depth=3"]
)
def test_parse_fault_rejects(bad):
    with pytest.raises(ValueError):
        faults.parse_fault(bad)


def test_inject_arms_and_disarms():
    assert faults.fault_spec("spmv_nan") is None
    with faults.inject("spmv_nan@iter=1") as fs:
        assert faults.fault_spec("spmv_nan") is fs
        assert jfaults.fault_spec("spmv_nan") is None  # each package its own registry
    assert faults.fault_spec("spmv_nan") is None


def test_fault_count_exhaustion():
    u = torch.ones(4)
    with faults.inject("spmv_nan@iter=1,count=2") as fs:
        for _ in range(3):
            faults.tap_spmv(u, 1)
        assert fs.fired == 2  # the third application was inert
        assert faults.fault_spec("spmv_nan") is None


def test_tap_spmv_poisons_a_copy():
    u = torch.arange(4, dtype=torch.float32)
    with faults.inject("spmv_nan@iter=2"):
        assert faults.tap_spmv(u, 1) is u  # another step: untouched
        p = faults.tap_spmv(u, 2)
    assert torch.isnan(p[0]) and torch.equal(p[1:], u[1:])
    assert torch.equal(u, torch.arange(4, dtype=torch.float32))  # the input kept


def test_tap_beta_zeroes_tensor_and_float():
    beta = torch.tensor(0.75, dtype=torch.float64)
    with faults.inject("beta_collapse@iter=0,count=2"):
        out = faults.tap_beta(beta, 0)
        assert isinstance(out, torch.Tensor) and out.shape == () and float(out) == 0.0
        assert faults.tap_beta(0.75, 0) == 0.0
    assert float(beta) == 0.75


def test_consume_lanczos_counts_per_launch():
    with faults.inject("spmv_nan@iter=1") as fs:
        key = faults.trace_key()
        assert key and key[0][0] == "spmv_nan"
        faults.consume_lanczos(key)
        assert fs.fired == 1
        assert faults.trace_key() is None  # exhausted -> clean key
    faults.consume_lanczos(None)  # no-op


def test_env_var_injection(monkeypatch, web, web_ref):
    monkeypatch.setenv("REPRO_FAULT", "spmv_nan@iter=2")
    with pytest.raises(NumericalBreakdown) as port:
        _port(web, "single", recovery="raise")
    with pytest.raises(JaxBreakdown) as ref:
        _ref(web_ref, "single", recovery="raise")
    assert (port.value.kind, port.value.iteration) == (ref.value.kind, ref.value.iteration)
    assert port.value.kind == "nonfinite"


def test_sweep_entry_faults_raise_typed():
    with faults.inject("kernel_error"):
        with pytest.raises(faults.InjectedKernelError):
            faults.check_sweep_entry()
    with faults.inject("oom"):
        with pytest.raises(faults.InjectedOOMError, match="out of memory"):
            faults.check_sweep_entry()
    with faults.inject("solve_crash@cycle=3"):
        faults.check_solve_crash(2)  # another cycle: nothing
        with pytest.raises(faults.InjectedCrash):
            faults.check_solve_crash(3)
    with faults.inject("scheduler_crash"):
        with pytest.raises(faults.SchedulerThreadDeath):
            faults.check_scheduler()
    assert issubclass(faults.InjectedChunkIOError, OSError)
    assert not issubclass(faults.SchedulerThreadDeath, Exception)


# ---------------------------------------------------------------------------
# typed breakdowns, per engine (recovery="raise"), both packages

ENGINES = ["single", "restarted", "chunked"]


@pytest.mark.parametrize("backend", ENGINES)
@pytest.mark.parametrize("fault,kind,iteration", [
    ("spmv_nan@iter=3", "nonfinite", 3),
    ("beta_collapse@iter=2", "beta_underflow", 2),
])
def test_breakdown_raises_typed_like_reference(web, web_ref, backend, fault, kind, iteration):
    with faults.inject(fault):
        with pytest.raises(NumericalBreakdown) as port:
            _port(web, backend, recovery="raise")
    with jfaults.inject(fault):
        with pytest.raises(JaxBreakdown) as ref:
            _ref(web_ref, backend, recovery="raise")
    assert (port.value.kind, port.value.iteration) == (kind, iteration)
    assert (ref.value.kind, ref.value.iteration) == (kind, iteration)
    assert port.value.policy == "FFF"


def test_recovery_none_disables_probe(web):
    with faults.inject("spmv_nan@iter=3"):
        res = _port(web, "single", recovery="none")
    assert not torch.isfinite(res.eigenvalues).all()


# ---------------------------------------------------------------------------
# recovery="auto": the documented escalation per failure class, both packages


@pytest.mark.parametrize("backend", ENGINES)
def test_auto_escalates_policy_on_nan(web, web_ref, v0, backend):
    start = None if backend == "restarted" else v0
    with faults.inject("spmv_nan@iter=3"):
        port = _port(web, backend, recovery="auto", v0=start)
    with jfaults.inject("spmv_nan@iter=3"):
        ref = _ref(web_ref, backend, recovery="auto", v0=start)
    assert _trail(port) == _trail(ref) == [("escalate_policy", "FFF", "FCF")]
    step = port.recovery_trail[0]
    assert (step["kind"], step["iteration"]) == ("nonfinite", 3)
    assert port.policy == "FCF"
    _close(port, ref)


@pytest.mark.parametrize("backend", ["single", "restarted"])
def test_auto_reseeds_on_beta_collapse(web, web_ref, backend):
    with faults.inject("beta_collapse@iter=2"):
        port = _port(web, backend, recovery="auto")
    with jfaults.inject("beta_collapse@iter=2"):
        ref = _ref(web_ref, backend, recovery="auto")
    assert _trail(port) == _trail(ref) == [("reseed", "seed:0", "seed:1000")]
    assert port.recovery_trail[0]["kind"] == "beta_underflow"
    assert torch.isfinite(port.eigenvalues).all()
    if backend == "restarted":  # both draw the new start from NumPy
        _close(port, ref)


def test_kernel_error_raise_mode_propagates(web):
    with faults.inject("kernel_error"):
        with pytest.raises(faults.InjectedKernelError):
            _port(web, "single", recovery="raise")


def test_auto_unfuses_on_kernel_error(web, web_ref, v0):
    with faults.inject("kernel_error"):
        port = _port(web, "single", recovery="auto", v0=v0)
    with jfaults.inject("kernel_error"):
        ref = _ref(web_ref, "single", recovery="auto", v0=v0)
    assert _trail(port) == _trail(ref) == [("unfuse", "fused", "unfused")]
    _close(port, ref)


def test_oom_raise_mode_propagates(web):
    with faults.inject("oom"):
        with pytest.raises(faults.InjectedOOMError):
            _port(web, "single", recovery="raise")


def test_auto_falls_back_to_chunked_on_oom(web, web_ref, v0):
    with faults.inject("oom"):
        port = _port(web, "single", recovery="auto", v0=v0)
    with jfaults.inject("oom"):
        ref = _ref(web_ref, "single", recovery="auto", v0=v0)
    assert _trail(port) == _trail(ref) == [("fallback_chunked", "single", "chunked")]
    assert port.backend == ref.backend == "chunked"
    _close(port, ref)


def test_oom_on_chunked_has_no_fallback(web):
    # Already at the bottom of the memory ladder: the typed error surfaces.
    with faults.inject("oom@iter=0,count=99"):
        with pytest.raises(faults.InjectedOOMError):
            _port(web, "chunked", recovery="auto")


def test_chunk_io_error_is_typed_oserror(web):
    with faults.inject("chunk_io_error@chunk=0"):
        with pytest.raises(OSError) as ei:
            _port(web, "chunked", recovery="raise")
    assert isinstance(ei.value, faults.InjectedChunkIOError)


def test_unrecoverable_breakdown_carries_its_trail(web):
    # NaN on every sweep: FFF -> FCF -> FDF -> DDD, then the ladder's top.
    with faults.inject("spmv_nan@iter=3,count=99"):
        with pytest.raises(NumericalBreakdown) as ei:
            _port(web, "single", recovery="auto")
    assert [t[2] for t in _trail(ei.value)] == ["FCF", "FDF", "DDD"]


def test_auto_policy_with_auto_recovery(web, web_ref):
    with faults.inject("spmv_nan@iter=3"):
        port = repro_torch.eigsh(web, K, policy="auto", tol=1e-4, recovery="auto", device="cpu")
    with jfaults.inject("spmv_nan@iter=3"):
        ref = repro.eigsh(web_ref, K, policy="auto", tol=1e-4, recovery="auto")
    assert [a["policy"] for a in port.policy_escalations] == [
        a["policy"] for a in ref.policy_escalations]
    assert torch.isfinite(port.eigenvalues).all()


def test_recovery_trail_roundtrips_through_dict(web, v0):
    with faults.inject("spmv_nan@iter=3"):
        res = _port(web, "single", recovery="auto", v0=v0)
    assert res.recovery_trail
    back = EigenResult.from_dict(json.loads(json.dumps(res.to_dict())))
    assert back.recovery_trail == res.recovery_trail


def test_recovery_auto_groups_apart_from_raise(web, v0):
    sess = repro_torch.prepare(web, device="cpu", policy="FFF", num_iters=ITERS)
    a = sess.group_key({"k": K, "recovery": "auto"})
    b = sess.group_key({"k": K})
    assert a != b


# ---------------------------------------------------------------------------
# checkpoint / resume round trips


def test_restarted_checkpoint_resume_bit_identical(web, web_ref, tmp_path):
    kw = dict(policy="FDF", backend="restarted", tol=1e-10, subspace=16, seed=3)
    want = repro_torch.eigsh(web, K, device="cpu", **kw)
    repro_torch.session_cache_clear()
    with faults.inject("solve_crash@cycle=2"):
        with pytest.raises(faults.InjectedCrash):
            repro_torch.eigsh(web, K, device="cpu", checkpoint_dir=str(tmp_path), **kw)
    store = SolveCheckpoint(str(tmp_path))
    assert store.entries(), "the crash must leave a resumable snapshot"
    repro_torch.session_cache_clear()
    got = repro_torch.eigsh(web, K, device="cpu", checkpoint_dir=str(tmp_path), **kw)
    assert torch.equal(got.eigenvalues, want.eigenvalues)
    assert torch.equal(got.eigenvectors, want.eigenvectors)
    assert (got.iterations, got.restarts) == (want.iterations, want.restarts)
    assert not store.entries(), "a completed solve clears its checkpoint"
    _close(got, repro.eigsh(web_ref, K, **kw), rtol=1e-12)


@pytest.mark.parametrize("policy", ["FDF", "FFF"])
def test_restarted_resume_rebuilds_the_reorth_mirror(web, tmp_path, policy):
    """FDF keeps an f64 mirror of the f32 rows (FFF none): a resume from any
    cycle gives the bits of the uninterrupted run."""
    kw = dict(policy=policy, backend="restarted", tol=1e-12, subspace=10, max_restarts=6, seed=1)
    want = repro_torch.eigsh(web, K, device="cpu", **kw)
    for cycle in (1, 4):
        repro_torch.session_cache_clear()
        with faults.inject(f"solve_crash@cycle={cycle}"):
            with pytest.raises(faults.InjectedCrash):
                repro_torch.eigsh(web, K, device="cpu", checkpoint_dir=str(tmp_path), **kw)
        repro_torch.session_cache_clear()
        got = repro_torch.eigsh(web, K, device="cpu", checkpoint_dir=str(tmp_path), **kw)
        assert torch.equal(got.eigenvalues, want.eigenvalues), cycle
        assert torch.equal(got.eigenvectors, want.eigenvectors), cycle


def test_host_loop_checkpoint_resume_bit_identical(tmp_path):
    """The Lanczos loop interrupted mid-sweep: the resume from the last
    snapshot replays to the same tridiagonalization."""
    from repro.core.lanczos import lanczos_tridiag as jax_lanczos
    from repro.core.precision import FDF as JFDF
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.standard_normal((48, 48))
    a = (a + a.T) / 2
    at = torch.as_tensor(a)
    v1 = rng.standard_normal(48)
    pol = FDF.effective()
    m, every = 16, 4

    def mv(v):
        return at @ v.to(torch.float64)

    calls = {"n": 0}

    def mv_crash(v):
        calls["n"] += 1
        if calls["n"] == 11:  # after the i=7 snapshot, before the i=11 one
            raise RuntimeError("injected mid-sweep crash")
        return mv(v)

    want = lanczos_tridiag(mv, torch.as_tensor(v1), m, pol, reorth="full")
    store = SolveCheckpoint(str(tmp_path))
    token = SolveCheckpoint.token("unit-fp", engine="lanczos", m=m)
    with pytest.raises(RuntimeError):
        lanczos_tridiag(mv_crash, torch.as_tensor(v1), m, pol, reorth="full",
                        checkpoint=(store, token, every))
    assert store.entries()
    got = lanczos_tridiag(mv, torch.as_tensor(v1), m, pol, reorth="full",
                          checkpoint=(store, token, every))
    assert not store.entries()
    for f in ("alpha", "beta", "basis"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    aj = jnp.asarray(a)
    ref = jax_lanczos(lambda v: aj @ v.astype(jnp.float64), jnp.asarray(v1), m, JFDF.effective(),
                      reorth="full", jit=False)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(ref.alpha), rtol=0,
                               atol=RTOL * np.abs(np.asarray(ref.alpha)).max())


def _chunked_kw(v0):
    return dict(policy="FFF", num_iters=ITERS, backend="chunked", format="ell",
                chunk_nnz=1024, v0=v0)


@pytest.mark.parametrize("every", [1, 2, 0])
def test_chunk_io_fault_resume_bit_identical(web, web_ref, v0, tmp_path, monkeypatch, every):
    """A chunk I/O fault mid-step leaves a chunk-cursor snapshot every
    ``REPRO_CHUNK_CKPT_EVERY`` chunks (0: none inside a step, so none here)
    whose resume replays to the same bits."""
    monkeypatch.setenv("REPRO_CHUNK_CKPT_EVERY", str(every))
    kw = _chunked_kw(v0)
    want = repro_torch.eigsh(web, K, device="cpu", **kw)
    repro_torch.session_cache_clear()
    with faults.inject("chunk_io_error@chunk=2"):
        with pytest.raises(OSError):
            repro_torch.eigsh(web, K, device="cpu", checkpoint_dir=str(tmp_path), **kw)
    state = SolveCheckpoint(str(tmp_path))
    if every:
        (token,) = state.entries()
        snap = state.load(token)
        # stage_depth 1: chunk 2 is staged after chunk 1 is summed.
        assert snap["i"] == 0 and snap["chunk"] == 1
        assert snap["partial"].dtype == torch.float32
    else:
        assert not state.entries()
    repro_torch.session_cache_clear()
    got = repro_torch.eigsh(web, K, device="cpu", checkpoint_dir=str(tmp_path), **kw)
    assert torch.equal(got.eigenvalues, want.eigenvalues)
    assert torch.equal(got.eigenvectors, want.eigenvectors)
    assert not state.entries()
    _close(got, repro.eigsh(web_ref, K, **kw))


def test_chunked_resume_at_a_step_boundary(web, v0, tmp_path, monkeypatch):
    """Every ``checkpoint_every`` steps the loop saves its carry: a fault in
    step 5 resumes from the end of step 3 (chunk cursors off)."""
    monkeypatch.setenv("REPRO_CHUNK_CKPT_EVERY", "0")
    kw = _chunked_kw(v0)
    want = repro_torch.eigsh(web, K, device="cpu", **kw)
    n_chunks = want.partition["num_chunks"]
    repro_torch.session_cache_clear()
    calls = {"n": 0}

    def fail_in_step_5(j):
        calls["n"] += 1  # one call per chunk staged, n_chunks per step
        if calls["n"] == 5 * n_chunks + 1:
            raise faults.InjectedChunkIOError(f"injected I/O error staging chunk {j}")

    monkeypatch.setattr(faults, "check_chunk_io", fail_in_step_5)
    with pytest.raises(OSError):
        repro_torch.eigsh(web, K, device="cpu", checkpoint_dir=str(tmp_path),
                          checkpoint_every=4, **kw)
    monkeypatch.undo()
    store = SolveCheckpoint(str(tmp_path))
    (token,) = store.entries()
    snap = store.load(token)
    assert snap["i"] == 3 and "chunk" not in snap
    repro_torch.session_cache_clear()
    got = repro_torch.eigsh(web, K, device="cpu", checkpoint_dir=str(tmp_path),
                            checkpoint_every=4, **kw)
    assert torch.equal(got.eigenvalues, want.eigenvalues)
    assert torch.equal(got.eigenvectors, want.eigenvectors)


def test_failed_stream_frees_its_windows(web):
    eng = make_engine(web, "ell", accum_dtype=torch.float32, device="cpu")
    op = ChunkedOperator(web, chunk_nnz=512, engine=eng, device="cpu", stage_depth=2)
    assert op.num_chunks > 3
    x = torch.ones(web.n)
    want = op.matvec(x)
    with faults.inject("chunk_io_error@chunk=3"):
        with pytest.raises(OSError):
            op.matvec(x)
    assert all(w.chunk is None and not w.pending for w in op._windows)
    assert torch.equal(op.matvec(x), want)


def test_checkpoint_token_excludes_budget_knobs():
    t1 = SolveCheckpoint.token("fp", backend="restarted", policy="FDF", k=4, m=16)
    t2 = SolveCheckpoint.token("fp", backend="restarted", policy="FDF", k=4, m=16)
    t3 = SolveCheckpoint.token("fp", backend="restarted", policy="FDF", k=4, m=32)
    assert t1 == t2 != t3
    # The same function as the reference's.
    assert t1 == JaxCheckpoint.token("fp", backend="restarted", policy="FDF", k=4, m=16)


def test_session_tokens_name_the_package(web, tmp_path):
    """The port's tokens carry ``package="repro_torch"``: neither package
    resumes the other's snapshot under a shared root."""
    kw = dict(policy="FDF", backend="restarted", tol=1e-10, subspace=16, seed=3)
    with faults.inject("solve_crash@cycle=1"):
        with pytest.raises(faults.InjectedCrash):
            repro_torch.eigsh(web, K, device="cpu", checkpoint_dir=str(tmp_path), **kw)
    sess = repro_torch.prepare(web, device="cpu", checkpoint_dir=str(tmp_path), **kw)
    q = sess._normalize(repro_torch.api.EigQuery(k=K), 0, sess.cfg)
    _, token = sess._solve_checkpoint(q, q.pol, "restarted", K, 16)
    assert SolveCheckpoint(str(tmp_path)).entries() == [token]
    reference_token = SolveCheckpoint.token(
        sess.ensure_fingerprint(), backend="restarted", policy="FDF", k=K, m=16, start=q.start_key,
        tol=q.tol_eff, reorth=q.reorth)
    assert reference_token != token


def test_bf16_snapshot_round_trip(tmp_path):
    store = SolveCheckpoint(str(tmp_path))
    g = torch.Generator().manual_seed(0)
    basis = torch.randn(3, 17, generator=g).to(torch.bfloat16)
    t_hat = np.arange(9.0).reshape(3, 3)
    store.save("tok", {"engine": "restarted", "cycle": 2, "basis": basis, "t_hat": t_hat,
                       "beta": torch.tensor(0.5, dtype=torch.float64)})
    state = store.load("tok")
    assert state["engine"] == "restarted" and state["cycle"] == 2
    assert state["basis"].dtype == torch.bfloat16 and torch.equal(state["basis"], basis)
    assert np.array_equal(np.asarray(state["t_hat"]), t_hat)
    assert state["beta"].dtype == torch.float64 and float(state["beta"]) == 0.5
    header = json.loads((tmp_path / "tok" / "header.json").read_text())
    assert header["array_dtypes"]["basis"] == "bfloat16" and header["schema"] == 1
    assert store.clear("tok") and not store.clear("tok") and store.load("tok") is None


def test_corrupt_snapshot_reads_as_absent(tmp_path):
    store = SolveCheckpoint(str(tmp_path))
    store.save("tok", {"engine": "lanczos", "w": torch.zeros(3)})
    (tmp_path / "tok" / "state.npz").write_bytes(b"not an npz")
    with pytest.warns(UserWarning, match="corrupt solve checkpoint"):
        assert store.load("tok") is None


def test_reference_reads_the_ports_snapshot_layout(tmp_path):
    """Same layout and schema: the reference's store loads what the port's
    wrote (bf16 narrowed back by each package)."""
    basis = torch.randn(2, 5).to(torch.bfloat16)
    SolveCheckpoint(str(tmp_path)).save("tok", {"engine": "restarted", "basis": basis})
    state = JaxCheckpoint(str(tmp_path)).load("tok")
    assert state["engine"] == "restarted"
    np.testing.assert_array_equal(np.asarray(state["basis"], np.float32), basis.float().numpy())


def test_default_checkpoint_root(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_SOLVE_CHECKPOINTS", str(tmp_path / "snaps"))
    assert default_checkpoint_root() == str(tmp_path / "snaps")
    monkeypatch.delenv("REPRO_SOLVE_CHECKPOINTS")
    root = default_checkpoint_root()
    assert root.endswith("solve_checkpoints") and ".cache/repro" not in root



@pytest.mark.parametrize("exc,action", [
    (NumericalBreakdown("beta_underflow", 2), "reseed"),
    (NumericalBreakdown("nonfinite", 3), "escalate_policy"),
    (MemoryError(), "fallback_chunked"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     "fallback_chunked"),
    (faults.InjectedOOMError("CUDA out of memory (fault harness)"), "fallback_chunked"),
    (faults.InjectedKernelError("injected"), "unfuse"),
    # A real CUDA error may have poisoned the context: no action, by design.
    (RuntimeError("spmv_ell: CUDA launch failed (700): an illegal memory access"), None),
    (ValueError("bad k"), None),
])
def test_classify_failure(exc, action):
    from repro_torch.api.session import _classify_failure

    assert _classify_failure(exc) == action
