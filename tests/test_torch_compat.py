"""Keyword arguments and constants of the reference that the port's
signatures lacked: ``eigsh(impl=)``, ``HvpOperator(ggn=)``,
``lanczos_tridiag(jit=)`` and ``analysis.kernel_check.KERNELS``, each in
both packages on the same input (CPU).

Eigenvalues of the two packages within 1e-12 of max |lambda| under FDF
(f64 arithmetic, another summation order), as in ``test_torch_session``.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.analysis import kernel_check as jax_kernel_check
from repro.core import lanczos as jax_lanczos
from repro.core import precision as jax_precision
from repro.core.operators import HvpOperator as JaxHvpOperator
from repro.core.operators import make_operator as jax_make_operator
from repro.sparse import generate as jax_generate
import repro_torch
from repro_torch.analysis import kernel_check
from repro_torch.core import lanczos, precision
from repro_torch.core.operators import HvpOperator, make_operator
from repro_torch.sparse import CSR

K, ITERS = 4, 16


@pytest.fixture(autouse=True)
def _fresh_cache():
    repro_torch.session_cache_clear()
    repro.api.session_cache_clear()
    yield
    repro_torch.session_cache_clear()
    repro.api.session_cache_clear()


@pytest.fixture(scope="module")
def small():
    c = jax_generate("web", 512, 6.0, seed=3, values="normalized")
    port = CSR(indptr=np.asarray(c.indptr), indices=np.asarray(c.indices),
               data=np.asarray(c.data), shape=c.shape)
    return c, port


def _both(small, **kw):
    """The same call on both packages (one NumPy start vector); the warnings
    each raised."""
    c, port = small
    v0 = np.random.default_rng(0).standard_normal(c.shape[0])
    out = []
    for call, a in ((repro.eigsh, c), (repro_torch.eigsh, port)):
        extra = {"device": "cpu"} if call is repro_torch.eigsh else {}
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            r = call(a, K, v0=v0, num_iters=ITERS, **kw, **extra)
        out.append((r, [w.category for w in seen]))
    return out


@pytest.mark.parametrize("impl,fmt,want", [
    ("ell", "auto", "ell"), ("ell_kernel", "auto", "ell"), ("bsr_kernel", "auto", "bsr"),
    ("coo", "auto", "coo"), ("ell", "coo", "coo"),
], ids=["ell", "ell_kernel", "bsr_kernel", "coo", "format-wins"])
def test_eigsh_impl_maps_onto_format_in_both_packages(small, impl, fmt, want):
    (jr, jw), (tr, tw) = _both(small, impl=impl, format=fmt)
    assert DeprecationWarning in jw and DeprecationWarning in tw
    assert tr.spmv_format == jr.spmv_format == want
    lam_w = np.sort(np.asarray(jr.eigenvalues, np.float64))
    lam_g = np.sort(tr.eigenvalues.double().numpy())
    np.testing.assert_allclose(lam_g, lam_w, rtol=0, atol=1e-12 * np.abs(lam_w).max())


def test_eigsh_unknown_impl_raises_in_both_packages(small):
    c, port = small
    for call, a, extra in ((repro.eigsh, c, {}), (repro_torch.eigsh, port, {"device": "cpu"})):
        with pytest.warns(DeprecationWarning, match="impl= is deprecated"):
            with pytest.raises(ValueError, match="unknown legacy impl"):
                call(a, K, impl="bogus", **extra)


def test_hvp_operator_accepts_ggn():
    """``ggn`` is accepted and ignored in both packages: the full Hessian's
    product either way (a quadratic with a known Hessian)."""
    rng = np.random.default_rng(1)
    m = rng.standard_normal((6, 6))
    h = m @ m.T
    x0 = rng.standard_normal(6)
    v = rng.standard_normal(6)

    def tloss(p):
        y = torch.sin(p["w"]) + p["w"]
        return 0.5 * y @ torch.from_numpy(h) @ y

    def jloss(p):
        y = jnp.sin(p["w"]) + p["w"]
        return 0.5 * y @ jnp.asarray(h) @ y

    tp = {"w": torch.from_numpy(x0)}
    for ggn in (False, True):
        got = HvpOperator(tloss, tp, ggn=ggn).matvec(torch.from_numpy(v)).numpy()
        want = np.asarray(JaxHvpOperator(jloss, {"w": jnp.asarray(x0)}, ggn=ggn).matvec(
            jnp.asarray(v)))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("jit", [True, False])
def test_lanczos_tridiag_accepts_jit(small, jit):
    """``jit`` (the reference's compiled-or-eager switch; the port's loop is
    always eager) is accepted, positionally too, and changes nothing: the
    alphas and betas of the reference's loop under the same ``jit``."""
    c, port = small
    v1 = np.random.default_rng(11).standard_normal(c.shape[0])
    jp, tp = jax_precision.POLICIES["FDF"], precision.POLICIES["FDF"]
    jop = jax_make_operator(c, impl="coo", dtype=jp.storage)
    jres = jax_lanczos.lanczos_tridiag(jop.bound_matvec(jp), jnp.asarray(v1), 12, jp, "half",
                                       None, jit)
    op = make_operator(port, "coo", dtype=tp.storage, device="cpu")
    tres = lanczos.lanczos_tridiag(op.bound_matvec(tp), torch.from_numpy(v1), 12, tp, "half",
                                   None, jit)
    a_j, a_t = np.asarray(jres.alpha, np.float64), tres.alpha.double().numpy()
    scale = np.abs(a_j).max()
    np.testing.assert_allclose(a_t, a_j, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(tres.beta.double().numpy(), np.asarray(jres.beta, np.float64),
                               rtol=0, atol=1e-12 * scale)


def test_kernels_tuple_matches_reference():
    """The six kernels by the reference's module names, in its order."""
    assert kernel_check.KERNELS == jax_kernel_check.KERNELS
    assert "KERNELS" in kernel_check.__all__
