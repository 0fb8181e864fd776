"""The device Jacobi and the legacy entry points: ``jacobi_eigh``,
``ritz_decompose(jacobi="jax")``, ``topk_eigs`` / ``topk_eigs_restarted``,
``make_operator``'s ``impl`` paths, ``blocked_ell_from_csr``,
``precision.dot`` / ``norm2`` and ``ops.spmv_ell_packed``, against the
reference on the same inputs (CPU).

Tolerances: the Jacobi eigenvalues within rel 1e-12 of |lambda|max in f64
and 1e-5 in f32, the eigenvectors equal up to sign within the same; solves
with a shared start vector, FDF 1e-12 and FFF 1e-5 of |lambda|max (the same
arithmetic in another sum order); SpMV products 1e-6 (f32 accumulation) and
1e-12 (f64) of max |y|.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import eigensolver as jax_eigensolver
from repro.core import precision as jax_precision
from repro.core.jacobi import jacobi_eigh as jax_jacobi_eigh
from repro.core.jacobi import tridiag_to_dense as jax_tridiag_to_dense
from repro.core.lanczos import LanczosResult as JaxLanczosResult
from repro.core.operators import make_operator as jax_make_operator
from repro.core.restarted import topk_eigs_restarted as jax_topk_eigs_restarted
from repro.kernels import ops as jax_ops
from repro.kernels.spmv_bsr import blocked_ell_from_csr as jax_blocked_ell_from_csr
from repro.kernels.spmv_ell_packed import pack_ell_chunk as jax_pack_ell_chunk
from repro.sparse import generate as jax_generate
import repro_torch
import repro_torch.core as tcore
from repro_torch.core import precision
from repro_torch.core.eigensolver import ritz_decompose
from repro_torch.core.jacobi import jacobi_eigh, jacobi_eigh_host, tridiag_to_dense
from repro_torch.core.lanczos import LanczosResult
from repro_torch.core.operators import ChunkedOperator, DenseOperator, SparseOperator
from repro_torch.kernels import ops
from repro_torch.kernels.engine import make_engine
from repro_torch.kernels.spmv_bsr import blocked_ell_from_csr
from repro_torch.kernels.spmv_ell_packed import pack_ell_chunk
from repro_torch.sparse import CSR

JAC_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture(autouse=True)
def _fresh_cache():
    repro_torch.session_cache_clear()
    yield
    repro_torch.session_cache_clear()


def _port_csr(c) -> CSR:
    return CSR(indptr=np.asarray(c.indptr), indices=np.asarray(c.indices),
               data=np.asarray(c.data), shape=c.shape)


@pytest.fixture(scope="module")
def small_ref():
    return jax_generate("web", 384, 6.0, seed=7, values="normalized")


@pytest.fixture(scope="module")
def small(small_ref):
    return _port_csr(small_ref)


def _sym(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / 2


def _tridiag(n, seed):
    rng = np.random.default_rng(seed)
    return np.array(jax_tridiag_to_dense(jnp.asarray(rng.standard_normal(n)),
                                         jnp.asarray(rng.standard_normal(n - 1))))


def _evals_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _vecs_close_up_to_sign(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    signs = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got * signs, want, rtol=0, atol=tol)


# ------------------------------------------------------------- jacobi_eigh


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["dense12", "dense8", "tridiag16"])
def test_jacobi_eigh_matches_reference(dtype, case):
    a = {"dense12": lambda: _sym(12, 0), "dense8": lambda: _sym(8, 1),
         "tridiag16": lambda: _tridiag(16, 2)}[case]()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ev_j, w_j = jax_jacobi_eigh(jnp.asarray(a, jdt))
    ev_t, w_t = jacobi_eigh(torch.as_tensor(a).to(dtype))
    assert ev_t.dtype == dtype and w_t.shape == a.shape
    tol = JAC_TOL[dtype]
    _evals_close(ev_t.numpy(), ev_j, tol)
    _vecs_close_up_to_sign(w_t.numpy(), w_j, tol)
    assert np.all(np.diff(np.abs(ev_t.double().numpy())) <= 0)  # |lambda| descending


def test_jacobi_eigh_matches_host():
    a = _sym(16, 1)
    ev_h, _ = jacobi_eigh_host(a)
    ev_t, w_t = jacobi_eigh(torch.as_tensor(a))
    np.testing.assert_allclose(ev_t.numpy(), ev_h, atol=1e-10)
    w = w_t.numpy()
    assert np.linalg.norm(a @ w - w @ np.diag(ev_t.numpy())) < 1e-8


@pytest.mark.parametrize("max_sweeps,tol", [(0, 0.0), (1, 0.0), (2, 0.0), (30, 1e-2)])
def test_jacobi_eigh_stopping_rule_matches_reference(max_sweeps, tol):
    """Sweep while sweeps < max_sweeps and the off-diagonal norm exceeds
    max(tol, eps): a cut-off run stops at the reference's matrix."""
    a = _sym(10, 4)
    ev_j, w_j = jax_jacobi_eigh(jnp.asarray(a), max_sweeps=max_sweeps, tol=tol)
    ev_t, w_t = jacobi_eigh(torch.as_tensor(a), max_sweeps=max_sweeps, tol=tol)
    _evals_close(ev_t.numpy(), ev_j, 1e-12)
    _vecs_close_up_to_sign(w_t.numpy(), w_j, 1e-12)


def test_jacobi_eigh_skips_zero_rotations():
    # Already diagonal (and 1 x 1): every |a_pq| < eps, the eigenvectors
    # stay the identity up to the |lambda| order.
    a = torch.diag(torch.tensor([1.0, -3.0, 2.0], dtype=torch.float64))
    ev, w = jacobi_eigh(a)
    assert ev.tolist() == [-3.0, 2.0, 1.0]
    assert torch.equal(w.abs(), torch.eye(3, dtype=torch.float64)[:, [1, 2, 0]])
    ev1, w1 = jacobi_eigh(torch.tensor([[5.0]], dtype=torch.float64))
    assert ev1.tolist() == [5.0] and w1.tolist() == [[1.0]]


def test_tridiag_to_dense_tensor_and_array():
    alpha, beta = np.array([1.0, 2.0, 3.0]), np.array([0.5, -0.25])
    want = np.asarray(jax_tridiag_to_dense(jnp.asarray(alpha), jnp.asarray(beta)))
    assert np.array_equal(tridiag_to_dense(alpha, beta), want)
    got = tridiag_to_dense(torch.as_tensor(alpha), torch.as_tensor(beta))
    assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), want)


# --------------------------------------------------------- ritz_decompose


def _lanczos_pair(m=10, seed=3):
    rng = np.random.default_rng(seed)
    alpha, beta = rng.standard_normal(m), np.abs(rng.standard_normal(m - 1)) + 0.1
    basis = rng.standard_normal((m, 32))
    port = LanczosResult(alpha=torch.as_tensor(alpha), beta=torch.as_tensor(beta),
                         basis=torch.as_tensor(basis).float(),
                         beta_last=torch.tensor(0.3, dtype=torch.float64))
    ref = JaxLanczosResult(alpha=jnp.asarray(alpha), beta=jnp.asarray(beta),
                           basis=jnp.asarray(basis, jnp.float32), beta_last=jnp.asarray(0.3))
    return port, ref


@pytest.mark.parametrize("policy", ["FDF", "FFF"])
def test_ritz_decompose_device_jacobi_matches_reference(policy):
    port, ref = _lanczos_pair()
    pol = precision.POLICIES[policy]
    evals, w, evals_f64, w_f64, beta_m = ritz_decompose(port, pol, jacobi="jax")
    j_evals, j_w, j_ef64, j_wf64, j_bm = jax_eigensolver.ritz_decompose(
        ref, jax_precision.POLICIES[policy], jacobi="jax")
    assert evals.dtype == pol.phase_dtype("ritz") and w.dtype == pol.phase_dtype("ritz")
    tol = JAC_TOL[pol.phase_dtype("ritz")]
    _evals_close(evals_f64, j_ef64, tol)
    _vecs_close_up_to_sign(w_f64, j_wf64, tol)
    assert beta_m == j_bm == 0.3
    # Device and host placements agree too.
    h_evals, _, h_ef64, h_wf64, _ = ritz_decompose(port, pol, jacobi="host")
    _evals_close(evals_f64, h_ef64, tol)
    _vecs_close_up_to_sign(w_f64, h_wf64, tol)


def test_ritz_decompose_rejects_unknown_placement():
    port, _ = _lanczos_pair()
    with pytest.raises(ValueError, match="jacobi"):
        ritz_decompose(port, precision.FDF, jacobi="gpu")


@pytest.mark.parametrize("policy", ["FDF", "FFF"])
def test_eigsh_device_jacobi_matches_reference(small, small_ref, policy):
    v0 = np.random.default_rng(1).standard_normal(small.n)
    port = repro_torch.eigsh(small, 6, v0=v0, num_iters=16, policy=policy, jacobi="jax",
                             device="cpu")
    ref = repro.eigsh(small_ref, 6, v0=v0, num_iters=16, policy=policy, jacobi="jax")
    host = repro_torch.eigsh(small, 6, v0=v0, num_iters=16, policy=policy, device="cpu")
    tol = 1e-12 if policy == "FDF" else 1e-5
    _evals_close(port.eigenvalues.numpy(), np.asarray(ref.eigenvalues), tol)
    _evals_close(port.eigenvalues.numpy(), host.eigenvalues.numpy(), tol)
    np.testing.assert_allclose(port.residuals, host.residuals, rtol=0,
                               atol=tol * np.abs(host.eigenvalues.numpy()).max())
    assert port.timings["jacobi_s"] > 0


def test_restarted_keeps_the_host_jacobi(small):
    a = repro_torch.eigsh(small, 4, tol=1e-8, jacobi="jax", device="cpu")
    b = repro_torch.eigsh(small, 4, tol=1e-8, device="cpu")
    assert a.backend == "restarted" and torch.equal(a.eigenvalues, b.eigenvalues)


def test_unknown_jacobi_rejected(small):
    with pytest.raises(ValueError, match="jacobi"):
        repro_torch.eigsh(small, 4, jacobi="gpu", device="cpu")


# ------------------------------------------------------------ make_operator

IMPLS = ["coo", "ell", "ell_kernel", "bsr_kernel", "chunked"]


@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
@pytest.mark.parametrize("impl", IMPLS)
def test_make_operator_impl_matches_reference(small, small_ref, impl, acc):
    op = tcore.make_operator(small, impl, torch.float32, device="cpu")
    jop = jax_make_operator(small_ref, impl, jnp.float32)
    assert op.n == jop.n == small.n
    if impl != "chunked":
        assert op.spmv_format == jop.spmv_format
    x = np.random.default_rng(0).standard_normal(small.n).astype(np.float32)
    jacc = jnp.float32 if acc == torch.float32 else jnp.float64
    got = op.matvec(torch.as_tensor(x), accum_dtype=acc)
    want = np.asarray(jop.matvec(jnp.asarray(x), accum_dtype=jacc), np.float64)
    assert got.dtype == acc and got.shape == (small.n,)
    tol = 1e-6 if acc == torch.float32 else 1e-12
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0, atol=tol * np.abs(want).max())


def test_make_operator_types_and_errors(small):
    assert isinstance(tcore.make_operator(small, "chunked", device="cpu"), ChunkedOperator)
    op = tcore.make_operator(small, "bsr_kernel", device="cpu")
    assert isinstance(op, SparseOperator) and isinstance(op.mat, tuple)
    assert op.spmv_format == "bsr" and op.device == torch.device("cpu")
    with pytest.raises(ValueError, match="impl"):
        tcore.make_operator(small, "csr5", device="cpu")
    # With an engine, impl is ignored (the reference's rule).
    eng = make_engine(small, "ell", accum_dtype=torch.float64, device="cpu")
    op = tcore.make_operator(small, "bsr_kernel", torch.float32, eng)
    assert op.engine is eng and op.spmv_format == "ell"


@pytest.mark.parametrize("block_size", [4, 8])
def test_blocked_ell_from_csr_matches_reference(small, small_ref, block_size):
    val, bcol, n_rows = blocked_ell_from_csr(small, block_size=block_size, device="cpu")
    jval, jbcol, jn = jax_blocked_ell_from_csr(small_ref, block_size=block_size)
    assert n_rows == jn == small.n
    assert np.array_equal(val.numpy(), np.asarray(jval))
    assert np.array_equal(bcol.numpy(), np.asarray(jbcol))
    assert val.dtype == torch.float32 and bcol.dtype == torch.int32


# ------------------------------------------------------------- topk shims


@pytest.mark.parametrize("impl", ["coo", "ell", "bsr_kernel", "chunked"])
def test_topk_eigs_matches_reference(small, small_ref, impl):
    v1 = np.random.default_rng(2).standard_normal(small.n)
    with pytest.warns(DeprecationWarning, match="topk_eigs"):
        got = tcore.topk_eigs(tcore.make_operator(small, impl, device="cpu"), 4, policy=tcore.FDF,
                              reorth="full", num_iters=16, v1=v1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jax_eigensolver.topk_eigs(jax_make_operator(small_ref, impl), 4,
                                         policy=jax_precision.FDF, reorth="full", num_iters=16,
                                         v1=jnp.asarray(v1))
    assert isinstance(got, tcore.EigResult) and got.wall_time_s > 0
    assert got.tridiag.basis.shape == (16, small.n)
    _evals_close(got.eigenvalues.numpy(), np.asarray(want.eigenvalues), 1e-12)


def test_topk_eigs_device_jacobi(small):
    v1 = np.random.default_rng(2).standard_normal(small.n)
    op = tcore.make_operator(small, "ell", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        a = tcore.topk_eigs(op, 4, num_iters=12, v1=v1, jacobi="jax")
        b = tcore.topk_eigs(op, 4, num_iters=12, v1=v1)
    _evals_close(a.eigenvalues.numpy(), b.eigenvalues.numpy(), 1e-12)


def test_topk_eigs_restarted_matches_reference(small, small_ref):
    with pytest.warns(DeprecationWarning, match="topk_eigs_restarted"):
        got = tcore.topk_eigs_restarted(tcore.make_operator(small, "coo", device="cpu"), 4,
                                        policy=tcore.FDF, m=12, tol=1e-8, max_restarts=20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jax_topk_eigs_restarted(jax_make_operator(small_ref, "coo"), 4,
                                       policy=jax_precision.FDF, m=12, tol=1e-8, max_restarts=20)
    assert got.tridiag.basis.shape[0] == 12
    _evals_close(got.eigenvalues.numpy(), np.asarray(want.eigenvalues), 1e-12)


# ------------------------------------ the reference's eigensolver tests, ported


def test_dense_operator_topk_exact():
    """On a small dense symmetric matrix with m = n, Lanczos + Jacobi is exact."""
    a = _sym(64, 2)
    op = DenseOperator(torch.as_tensor(a, dtype=torch.float64))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res = tcore.topk_eigs(op, 5, policy=tcore.DDD, reorth="full2", num_iters=64)
    ref = np.linalg.eigvalsh(a)
    ref = ref[np.argsort(-np.abs(ref))][:5]
    np.testing.assert_allclose(res.eigenvalues.numpy(), ref, rtol=1e-8)


def test_topk_matches_arpack(web_csr):
    import scipy.sparse.linalg as spla

    ref = spla.eigsh(web_csr.to_scipy(), k=4, which="LM")[0]
    ref = ref[np.argsort(-np.abs(ref))]
    op = tcore.make_operator(_port_csr(web_csr), "coo", torch.float32, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res = tcore.topk_eigs(op, 4, policy=tcore.FDF, reorth="full", num_iters=24)
    np.testing.assert_allclose(res.eigenvalues.double().numpy(), ref, rtol=1e-4)


def test_chunked_out_of_core_matches_incore(web_csr):
    csr = _port_csr(web_csr)
    op_ic = tcore.make_operator(csr, "coo", torch.float32, device="cpu")
    op_oc = ChunkedOperator(csr, chunk_nnz=4096, dtype=torch.float32, device="cpu")
    assert op_oc.num_chunks > 1
    v1 = np.ones(csr.n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        r_ic = tcore.topk_eigs(op_ic, 3, policy=tcore.FDF, reorth="full", num_iters=12, v1=v1)
        r_oc = tcore.topk_eigs(op_oc, 3, policy=tcore.FDF, reorth="full", num_iters=12, v1=v1)
    np.testing.assert_allclose(r_ic.eigenvalues.numpy(), r_oc.eigenvalues.numpy(), rtol=1e-6)


def test_ell_impl_matches_coo(web_csr):
    csr = _port_csr(web_csr)
    v1 = np.ones(csr.n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        r_coo = tcore.topk_eigs(tcore.make_operator(csr, "coo", device="cpu"), 3,
                                policy=tcore.FFF, reorth="full", num_iters=9, v1=v1)
        r_ell = tcore.topk_eigs(tcore.make_operator(csr, "ell", device="cpu"), 3,
                                policy=tcore.FFF, reorth="full", num_iters=9, v1=v1)
    np.testing.assert_allclose(r_coo.eigenvalues.numpy(), r_ell.eigenvalues.numpy(), rtol=1e-5)


def test_thick_restart_matches_arpack_tightly(norm_csr):
    import scipy.sparse.linalg as spla

    ref = spla.eigsh(norm_csr.to_scipy(), k=6, which="LM")[0]
    ref = ref[np.argsort(-np.abs(ref))]
    op = tcore.make_operator(_port_csr(norm_csr), "coo", torch.float32, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        r = tcore.topk_eigs_restarted(op, 6, policy=tcore.FDF, m=20, tol=1e-7, max_restarts=40)
    np.testing.assert_allclose(r.eigenvalues.double().numpy(), ref, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------- precision, ops


@pytest.mark.parametrize("policy", ["FFF", "FDF", "FCF", "DDD", "BFF"])
def test_precision_dot_norm2_match_reference(policy):
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal(1000), rng.standard_normal(1000)
    pol, jpol = precision.POLICIES[policy], jax_precision.POLICIES[policy].effective()
    sdt = pol.storage
    jsdt = {torch.float32: jnp.float32, torch.float64: jnp.float64,
            torch.bfloat16: jnp.bfloat16}[sdt]
    ta, tb = torch.as_tensor(a).to(sdt), torch.as_tensor(b).to(sdt)
    ja, jb = jnp.asarray(a, jsdt), jnp.asarray(b, jsdt)
    got = precision.dot(ta, tb, pol)
    want = float(jax_precision.dot(ja, jb, jpol))
    assert got.dtype == pol.compute and got.shape == ()
    tol = 1e-12 if pol.compute == torch.float64 else 1e-5
    terms = float(np.sum(np.abs(a * b)))
    assert abs(float(got) - want) <= tol * terms
    n_got, n_want = float(precision.norm2(ta, pol)), float(jax_precision.norm2(ja, jpol))
    assert abs(n_got - n_want) <= tol * n_want


@pytest.mark.parametrize("mode", ["bf16", "fp8"])
@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
def test_ops_spmv_ell_packed_matches_reference(mode, acc):
    rng = np.random.default_rng(9)
    rows, width, n_cols = 24, 8, 500
    col = np.zeros((rows, width), np.int32)
    val = np.zeros((rows, width), np.float32)
    for r in range(rows):
        k = int(rng.integers(1, width + 1))
        col[r, :k] = np.sort(rng.choice(n_cols, size=k, replace=False))
        val[r, :k] = rng.standard_normal(k)
    packed = pack_ell_chunk(val, col, mode)
    jpacked = jax_pack_ell_chunk(val, col, mode)
    x = rng.standard_normal(n_cols).astype(np.float32)
    got = ops.spmv_ell_packed(*packed, torch.as_tensor(x), 20, accum_dtype=acc)
    jacc = jnp.float32 if acc == torch.float32 else jnp.float64
    want = np.asarray(jax_ops.spmv_ell_packed(*jpacked, jnp.asarray(x), 20, accum_dtype=jacc),
                      np.float64)
    assert got.shape == (20,) and got.dtype == acc
    tol = 1e-6 if acc == torch.float32 else 1e-12
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0, atol=tol * np.abs(want).max())


def test_core_exports_the_reference_names():
    import repro.core as jcore

    ported = {"EigResult", "FixedSolveOutput", "solve_fixed", "topk_eigs", "jacobi_eigh",
              "jacobi_eigh_host", "tridiag_to_dense", "LanczosResult", "lanczos_tridiag",
              "CallableOperator", "ChunkedOperator", "DenseOperator", "LinearOperator",
              "SparseOperator", "make_operator", "RestartedSolveOutput", "solve_restarted",
              "topk_eigs_restarted", "PrecisionPolicy", "POLICIES", "PHASES", "auto_ladder",
              "phase_op_counts", "FDF", "FFF", "DDD", "BFF", "HFF", "FCF", "BCF"}
    for name in ported:
        assert hasattr(jcore, name) and hasattr(tcore, name), name
    import repro_torch.kernels as tk

    for name in ("engine", "ops", "ref", "SpmvEngine", "choose_format", "make_engine"):
        assert hasattr(tk, name), name
