"""The restarted backend: ``repro_torch.eigsh(A, k, tol=...)`` against
``repro.eigsh(A, k, tol=...)`` on the CPU, both through ``backend="auto"``
(any ``tol`` selects the thick-restart engine).  No shared start vector is
needed: both engines draw it from ``np.random.default_rng(seed)``.

Tolerances, relative to |lambda|max:
- eigenvalues: ``test_torch_eigsh.py``'s, FDF 1e-12, FFF 1e-6, BFF 1e-3;
- Ritz residual bounds: FDF 1e-7, FFF 1e-6, BFF 1e-3.  The bound of a
  pair that has not converged moves with the rounding of the stored basis,
  which the engine writes and compresses every cycle: on the road network,
  whose top eight eigenvalues lie within 1e-2 of each other and exhaust the
  30 restarts, the reference's own bounds move by 3.6e-8 when one entry of
  its start vector changes by 1e-7.  The two packages differ by at most
  4.1e-9 under FDF (road) and 1.3e-13 elsewhere; FDF's 1e-7 sits above
  that, and below ``TOL`` so that it does not pass any two converged bounds.
Eigenvalues (with their bounds and flags) are compared sorted by value: a
+-lambda pair of nearly equal magnitude may come out in either order.
``iterations`` and ``restarts`` are equal under FDF and FFF; under BFF a
bf16 rounding may move the stopping cycle.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import repro
from repro.core import operators as jax_operators
from repro.core.lanczos import NumericalBreakdown as JaxBreakdown
from repro.core.precision import POLICIES as JAX_POLICIES
from repro.core.restarted import solve_restarted as jax_solve_restarted
from repro.sparse import generate as jax_generate
from repro.sparse.formats import CSR as JaxCSR
import repro_torch
from repro_torch.api import NumericalBreakdown
from repro_torch.core.operators import DenseOperator
from repro_torch.core.precision import POLICIES
from repro_torch.core.restarted import solve_restarted
from repro_torch.sparse import CSR

K = 8
TOL = 1e-6
EIG_TOL = {"FDF": 1e-12, "FFF": 1e-6, "BFF": 1e-3}
RES_TOL = {"FDF": 1e-7, "FFF": 1e-6, "BFF": 1e-3}


@pytest.fixture(autouse=True)
def _fresh_cache():
    repro_torch.session_cache_clear()
    yield
    repro_torch.session_cache_clear()


def _port_csr(c) -> CSR:
    return CSR(indptr=np.asarray(c.indptr), indices=np.asarray(c.indices),
               data=np.asarray(c.data), shape=c.shape)


def _block_csr() -> JaxCSR:
    """kron(small road network, dense symmetric 8 x 8): full 8 x 8 blocks."""
    road = jax_generate("road", 64, 2.1, seed=0, values="normalized")
    b = np.random.default_rng(0).random((8, 8))
    m = sp.kron(road.to_scipy(), sp.csr_matrix((b + b.T) / 2)).tocsr()
    m.sort_indices()
    return JaxCSR(indptr=m.indptr.astype(np.int64), indices=m.indices.astype(np.int32),
                  data=m.data.astype(np.float64), shape=m.shape)


MATRICES = {
    "web_csr": ("fixture", "hybrid"),
    "norm_csr": ("fixture", "hybrid"),
    "road": (lambda: jax_generate("road", 1024, 2.1, seed=3, values="normalized"), "ell"),
    "kron": (lambda: jax_generate("kron", 1024, 8.0, seed=2, values="normalized"), "coo"),
    "block": (_block_csr, "bsr"),
}


def _sorted(res):
    lam = np.asarray(res.eigenvalues.double() if isinstance(res.eigenvalues, torch.Tensor)
                     else res.eigenvalues, np.float64)
    order = np.argsort(lam)
    return lam[order], np.asarray(res.residuals)[order], np.asarray(res.converged)[order]


def _assert_matches(got, want, policy):
    lam_g, res_g, conv_g = _sorted(got)
    lam_w, res_w, conv_w = _sorted(want)
    scale = np.abs(lam_w).max()
    np.testing.assert_allclose(lam_g, lam_w, rtol=0, atol=EIG_TOL[policy] * scale)
    np.testing.assert_allclose(res_g, res_w, rtol=0, atol=RES_TOL[policy] * scale)
    np.testing.assert_array_equal(conv_g, conv_w)
    assert got.tol == want.tol
    if policy != "BFF":
        assert (got.iterations, got.restarts) == (want.iterations, want.restarts)
        assert got.partition["spmv"]["precision"] == want.partition["spmv"]["precision"]


@pytest.mark.parametrize("policy", list(EIG_TOL))
@pytest.mark.parametrize("name", list(MATRICES))
def test_restarted_matches_reference(name, policy, request):
    make, fmt = MATRICES[name]
    ref = request.getfixturevalue(name) if make == "fixture" else make()
    want = repro.eigsh(ref, k=K, tol=TOL, policy=policy)
    got = repro_torch.eigsh(_port_csr(ref), k=K, tol=TOL, policy=policy, device="cpu")
    assert got.backend == want.backend == "restarted"
    assert got.spmv_format == want.spmv_format == fmt
    assert got.policy == want.policy == policy
    assert got.eigenvalues.shape == (K,) and got.eigenvectors.shape == (ref.n, K)
    _assert_matches(got, want, policy)


def _dense(n=96, seed=4):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + a.T) / np.sqrt(n)


def test_engine_exhausts_max_restarts_without_compressing():
    """The last cycle stops before compressing, so the eigenvectors are
    Ritz vectors of the basis the bounds were computed in: each true
    residual equals its bound."""
    a = _dense()
    kw = dict(m=10, max_restarts=3, tol=1e-14, seed=5)
    want = jax_solve_restarted(jax_operators.DenseOperator(jnp.asarray(a, jnp.float32)), 4,
                               JAX_POLICIES["FDF"], **kw)
    got = solve_restarted(DenseOperator(torch.tensor(a, dtype=torch.float32)), 4, POLICIES["FDF"],
                          **kw)
    assert (got.iterations, got.restarts) == (want.iterations, want.restarts) == (10 + 2 * 6, 2)
    np.testing.assert_allclose(got.eigenvalues_f64, want.eigenvalues_f64, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.residuals, want.residuals, rtol=0, atol=1e-6)
    assert not np.all(got.residuals <= 1e-14 * np.abs(got.eigenvalues_f64))
    np.testing.assert_allclose(got.tridiag.alpha.numpy(), np.asarray(want.tridiag.alpha),
                               atol=1e-12)
    x = got.eigenvectors.double().numpy()
    true = np.linalg.norm(a @ x - x * got.eigenvalues_f64, axis=0)
    np.testing.assert_allclose(true, got.residuals, rtol=1e-3, atol=1e-6)


def test_num_iters_is_a_total_step_budget(norm_csr):
    """num_iters=30, subspace=12, k=4: the first cycle takes 12 steps, each
    restart refills 8 rows, so two restarts fit (28 steps) and a third
    would overshoot."""
    kw = dict(tol=1e-14, num_iters=30, subspace=12)
    want = repro.eigsh(norm_csr, 4, **kw)
    got = repro_torch.eigsh(_port_csr(norm_csr), 4, device="cpu", **kw)
    assert (got.iterations, got.restarts) == (want.iterations, want.restarts) == (28, 2)
    _assert_matches(got, want, "FDF")
    for pkg, a in ((repro, norm_csr), (repro_torch, _port_csr(norm_csr))):
        extra = {} if pkg is repro else {"device": "cpu"}
        with pytest.raises(ValueError, match="cannot fund a restarted solve"):
            pkg.eigsh(a, 4, tol=1e-6, num_iters=5, **extra)
        with pytest.raises(ValueError, match="max_restarts must be >= 1"):
            pkg.eigsh(a, 4, tol=1e-6, max_restarts=0, **extra)


def test_reorth_other_than_full_is_ignored_with_a_warning(norm_csr):
    port = _port_csr(norm_csr)
    with pytest.warns(UserWarning, match="ignored by the restarted backend"):
        got = repro_torch.eigsh(port, 4, tol=1e-6, reorth="half", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        full = repro_torch.eigsh(port, 4, tol=1e-6, reorth="full", device="cpu")
    assert torch.equal(got.eigenvalues, full.eigenvalues)
    assert got.partition["spmv"]["precision"]["ops_by_dtype"] == (
        full.partition["spmv"]["precision"]["ops_by_dtype"])


@pytest.mark.parametrize("policy", ["FDF", "BFF"])
def test_breakdown_matches_reference(policy):
    """A rank-2 dense matrix (a swap of coordinates 0 and 1) from e_0: the
    Krylov space closes at step 1 with beta exactly 0, in every dtype."""
    n = 32
    a = np.zeros((n, n))
    a[0, 1] = a[1, 0] = 1.0
    v0 = np.zeros(n)
    v0[0] = 1.0
    with pytest.raises(JaxBreakdown) as want:
        repro.eigsh(a, 1, tol=1e-8, v0=v0, policy=policy)
    with pytest.raises(NumericalBreakdown) as got:
        repro_torch.eigsh(a, 1, tol=1e-8, v0=v0, policy=policy, device="cpu")
    assert (got.value.kind, got.value.iteration) == (want.value.kind, want.value.iteration)
    assert (got.value.kind, got.value.iteration, got.value.policy) == ("beta_underflow", 1, policy)


def test_matrix_free_inputs_match_reference():
    """A NumPy matvec callable (with ``n=``) and a scipy LinearOperator:
    restarted under ``tol=``, the fixed subspace otherwise, both matching
    the reference; ``policy="auto"`` judges them on the Ritz bounds.  The
    matrix has four separated eigenvalues (10, 9, 8, 7) over a bulk in
    [-1, 1]."""
    n = 128
    rng = np.random.default_rng(6)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([[10.0, 9.0, 8.0, 7.0], rng.uniform(-1.0, 1.0, n - 4)])
    a = (q * lam) @ q.T

    def matvec(x):  # the port hands over a tensor, the reference an array
        if isinstance(x, torch.Tensor):
            x = x.double().numpy()
        return a @ np.asarray(x, dtype=np.float64)

    want = repro.eigsh(matvec, 4, n=n, tol=1e-8)
    got = repro_torch.eigsh(matvec, 4, n=n, tol=1e-8, device="cpu")
    assert got.backend == want.backend == "restarted"
    assert got.spmv_format == want.spmv_format == "matfree"
    _assert_matches(got, want, "FDF")
    lin = spla.LinearOperator((n, n), matvec=matvec, dtype=np.float64)
    via_scipy = repro_torch.eigsh(lin, 4, tol=1e-8, device="cpu")
    assert torch.equal(via_scipy.eigenvalues, got.eigenvalues)
    v0 = np.random.default_rng(7).standard_normal(n)
    fixed_w = repro.eigsh(matvec, 4, n=n, num_iters=24, v0=v0)
    fixed_g = repro_torch.eigsh(matvec, 4, n=n, num_iters=24, v0=v0, device="cpu")
    assert fixed_g.backend == fixed_w.backend == "single"
    _assert_matches(fixed_g, fixed_w, "FDF")
    auto = repro_torch.eigsh(matvec, 4, n=n, policy="auto", tol=1e-5, device="cpu")
    trail = auto.policy_escalations
    assert {t["residual_kind"] for t in trail} == {"ritz_bound"} and trail[-1]["converged"]
    with pytest.raises(ValueError, match="pass n="):
        repro_torch.eigsh(matvec, 4, tol=1e-8, device="cpu")
