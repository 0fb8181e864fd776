"""Solve robustness on the card: the fault taps, ``recovery="auto"``,
checkpoint resume, the device Jacobi and the legacy entry points.

Every test here needs a CUDA card and skips without one.  The file imports
neither ``jax`` nor the reference package, so it runs on a machine that has
only PyTorch: from the repository root,

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_faults_gpu.py

Resumes are held to the same bits as an uninterrupted run on the card;
the device Jacobi to rel 1e-12 of the host Jacobi (f64).
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import make_operator, topk_eigs
from repro_torch.core.lanczos import lanczos_tridiag, ops_for_operator
from repro_torch.core.precision import POLICIES
from repro_torch.kernels import engine as keng
from repro_torch.kernels import lanczos_update, ops, spmv_bsr, spmv_ell, spmv_ell_packed
from repro_torch.serving import SolveCheckpoint
from repro_torch.sparse import generate
from repro_torch.testing import faults

K = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    faults.reset()
    repro_torch.session_cache_clear()
    yield torch.device("cuda")
    faults.reset()
    repro_torch.session_cache_clear()


@pytest.fixture
def road():
    return generate("road", 1 << 14, 2.1, seed=1, values="normalized")


def _reset():
    for fn in (spmv_ell.spmv_ell_kernel_call, lanczos_update.lanczos_update_kernel_call,
               spmv_bsr.spmv_bsr_kernel_call, spmv_ell_packed.spmv_ell_packed_kernel_call):
        fn.launches = 0


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["spmv_nan@iter=3", "beta_collapse@iter=2"])
def test_armed_taps_never_sync(cuda, road, fault):
    """An armed tap poisons the step on the card: the loop still reads
    nothing back, and the probe after it names the step."""
    pol = POLICIES["FDF"]
    eng = keng.make_engine(road, accum_dtype=pol.phase_dtype("spmv"), device="cuda")
    op = make_operator(road, "coo", pol.storage, eng)
    v1 = torch.randn(road.n, dtype=pol.compute, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(0))
    ops_ = ops_for_operator(op, pol, device="cuda")
    torch.cuda.synchronize()
    with faults.inject(fault) as fs:
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = lanczos_tridiag(op.bound_matvec(pol), v1, K, pol, ops=ops_)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert fs.fired == 1
    alpha, beta = res.alpha.cpu(), res.beta.cpu()
    if fault.startswith("spmv_nan"):
        assert not torch.isfinite(alpha[3])
    else:
        assert beta[2] == 0


@pytest.mark.gpu
def test_unfuse_runs_the_plain_update(cuda, road):
    v0 = np.random.default_rng(0).standard_normal(road.n)
    fused = repro_torch.eigsh(road, K, v0=v0, policy="FFF", device="cuda")
    _reset()
    with faults.inject("kernel_error"):
        res = repro_torch.eigsh(road, K, v0=v0, policy="FFF", recovery="auto", device="cuda")
    assert [t["action"] for t in res.recovery_trail] == ["unfuse"]
    assert spmv_ell.spmv_ell_kernel_call.launches == K
    assert lanczos_update.lanczos_update_kernel_call.launches == 0
    lam = fused.eigenvalues.double().abs().max()
    assert float((res.eigenvalues.double() - fused.eigenvalues.double()).abs().max()) <= 1e-5 * lam


@pytest.mark.gpu
def test_oom_falls_back_to_chunked(cuda, road):
    with faults.inject("oom"):
        res = repro_torch.eigsh(road, K, policy="FFF", recovery="auto", chunk_nnz=1 << 12,
                                device="cuda")
    assert [t["action"] for t in res.recovery_trail] == ["fallback_chunked"]
    assert res.backend == "chunked" and torch.isfinite(res.eigenvalues).all()


@pytest.mark.gpu
def test_restarted_resume_bit_identical(cuda, road, tmp_path):
    kw = dict(k=K, tol=1e-10, max_restarts=6, device="cuda")
    want = repro_torch.eigsh(road, **kw)
    repro_torch.session_cache_clear()
    with faults.inject("solve_crash@cycle=3"):
        with pytest.raises(faults.InjectedCrash):
            repro_torch.eigsh(road, checkpoint_dir=str(tmp_path), **kw)
    assert SolveCheckpoint(str(tmp_path)).entries()
    repro_torch.session_cache_clear()
    _reset()
    got = repro_torch.eigsh(road, checkpoint_dir=str(tmp_path), **kw)
    assert torch.equal(got.eigenvalues, want.eigenvalues)
    assert torch.equal(got.eigenvectors, want.eigenvectors)
    assert (got.iterations, got.restarts) == (want.iterations, want.restarts)
    m = 2 * K
    assert spmv_ell.spmv_ell_kernel_call.launches == got.iterations - m - 2 * (m - K)
    assert not SolveCheckpoint(str(tmp_path)).entries()


@pytest.mark.gpu
@pytest.mark.parametrize("every", ["1", "3"])
def test_chunked_resume_bit_identical(cuda, road, tmp_path, monkeypatch, every):
    monkeypatch.setenv("REPRO_CHUNK_CKPT_EVERY", every)
    v0 = np.random.default_rng(1).standard_normal(road.n)
    kw = dict(k=K, v0=v0, backend="chunked", chunk_nnz=1 << 12, device="cuda")
    want = repro_torch.eigsh(road, **kw)
    assert want.partition["num_chunks"] > 8
    repro_torch.session_cache_clear()
    with faults.inject("chunk_io_error@chunk=7"):
        with pytest.raises(faults.InjectedChunkIOError):
            repro_torch.eigsh(road, checkpoint_dir=str(tmp_path), **kw)
    repro_torch.session_cache_clear()
    got = repro_torch.eigsh(road, checkpoint_dir=str(tmp_path), **kw)
    assert torch.equal(got.eigenvalues, want.eigenvalues)
    assert torch.equal(got.eigenvectors, want.eigenvectors)


@pytest.mark.gpu
def test_device_jacobi_matches_host(cuda, road):
    v0 = np.random.default_rng(2).standard_normal(road.n)
    host = repro_torch.eigsh(road, K, v0=v0, device="cuda")
    dev = repro_torch.eigsh(road, K, v0=v0, jacobi="jax", device="cuda")
    lam = host.eigenvalues.double().abs().max()
    assert float((dev.eigenvalues.double() - host.eigenvalues.double()).abs().max()) <= 1e-12 * lam


@pytest.mark.gpu
def test_legacy_impls_launch_their_kernels(cuda, road):
    v1 = np.random.default_rng(3).standard_normal(road.n)
    _reset()
    with pytest.warns(DeprecationWarning):
        a = topk_eigs(make_operator(road, "ell"), K, v1=v1)
    assert spmv_ell.spmv_ell_kernel_call.launches == K
    _reset()
    with pytest.warns(DeprecationWarning):
        b = topk_eigs(make_operator(road, "bsr_kernel"), K, v1=v1)
    assert spmv_bsr.spmv_bsr_kernel_call.launches == K
    lam = a.eigenvalues.double().abs().max()
    assert float((a.eigenvalues.double() - b.eigenvalues.double()).abs().max()) <= 1e-9 * lam


@pytest.mark.gpu
def test_ops_spmv_ell_packed_f64_runs_the_kernel(cuda):
    from repro_torch.kernels import ref
    from repro_torch.kernels.spmv_ell_packed import pack_ell_chunk

    rng = np.random.default_rng(4)
    col = np.sort(rng.integers(0, 4000, size=(64, 8)), axis=1).astype(np.int32)
    val = rng.standard_normal((64, 8)).astype(np.float32)
    packed = [t.to("cuda") for t in pack_ell_chunk(val, col, "bf16")]
    x = torch.randn(4000, dtype=torch.float32, device="cuda")
    _reset()
    got = ops.spmv_ell_packed(*packed, x, 60, accum_dtype=torch.float64)
    assert spmv_ell_packed.spmv_ell_packed_kernel_call.launches == 1
    want = ref.spmv_ell_packed_ref(*packed, x, torch.float64)[:60]
    assert got.shape == (60,)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
