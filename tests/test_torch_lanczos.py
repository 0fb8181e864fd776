"""The port's Lanczos phase against the reference, and the same-package
bit-identity of its update modes (the port of ``tests/test_iteration_tuner.py``'s
parity check), on the CPU plain versions.

Tolerances on alpha / beta, relative to max |alpha|: FDF 1e-12 (f64
arithmetic, only the order of the sums differs); FFF / FCF 1e-5 (f32
arithmetic: order differences of a few ulps, grown over the steps); BFF
1e-3 (an ulp-level difference of the f32 vector can flip its rounding to
bf16 storage, whose eps is 7.8e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.lanczos as jlan
import repro.core.precision as jprec
import repro.kernels.engine as jeng
from repro.core.jacobi import jacobi_eigh_host as jax_jacobi
from repro.core.operators import make_operator as jax_make_operator
from repro.sparse import generate as jax_generate
import repro_torch
from repro_torch.core import lanczos as tlan
from repro_torch.core import precision as tprec
from repro_torch.core.jacobi import jacobi_eigh_host, tridiag_to_dense
from repro_torch.core.operators import make_operator
from repro_torch.kernels import engine as teng
from repro_torch.sparse import CSR, generate

TOL = {"FDF": 1e-12, "FFF": 1e-5, "FCF": 1e-5, "BFF": 1e-3}


def _port_csr(c) -> CSR:
    return CSR(indptr=np.asarray(c.indptr), indices=np.asarray(c.indices),
               data=np.asarray(c.data), shape=c.shape)


@pytest.mark.parametrize("policy", list(TOL))
@pytest.mark.parametrize("kind", ["road", "web"])
def test_lanczos_tridiag_matches_reference(policy, kind):
    ref = (jax_generate("road", 1024, 2.1, seed=4) if kind == "road"
           else jax_generate("web", 1024, 8.0, seed=7))
    m = 12
    v1 = np.random.default_rng(11).standard_normal(ref.n)
    jp, tp = jprec.POLICIES[policy], tprec.POLICIES[policy]

    jeng_ = jeng.make_engine(ref, accum_dtype=jp.phase_dtype("spmv"), storage_dtype=jp.storage)
    jop = jax_make_operator(ref, dtype=jp.storage, engine=jeng_)
    jres = jlan.lanczos_tridiag(jop.bound_matvec(jp), jnp.asarray(v1), m, jp,
                                ops=jlan.ops_for_operator(jop, jp))

    eng = teng.make_engine(_port_csr(ref), accum_dtype=tp.phase_dtype("spmv"), device="cpu")
    assert eng.format == jeng_.format
    op = make_operator(_port_csr(ref), dtype=tp.storage, engine=eng)
    tres = tlan.lanczos_tridiag(op.bound_matvec(tp), torch.from_numpy(v1), m, tp,
                                ops=tlan.ops_for_operator(op, tp, device="cpu"))

    a_j, b_j = np.asarray(jres.alpha, np.float64), np.asarray(jres.beta, np.float64)
    a_t, b_t = tres.alpha.double().numpy(), tres.beta.double().numpy()
    scale = np.abs(a_j).max()
    assert tres.alpha.dtype == tp.compute and tres.basis.dtype == tp.storage
    np.testing.assert_allclose(a_t, a_j, rtol=0, atol=TOL[policy] * scale)
    np.testing.assert_allclose(b_t, b_j, rtol=0, atol=TOL[policy] * scale)
    assert abs(float(tres.beta_last) - float(jres.beta_last)) <= TOL[policy] * scale


@pytest.mark.parametrize("reorth", ["full", "none"])
@pytest.mark.parametrize("kind", ["web", "road"])
@pytest.mark.parametrize("mode", ["fused", "fused_spmv"])
def test_update_modes_bit_identical(mode, kind, reorth, monkeypatch):
    """Routing is a pure performance decision: every plan rung returns the
    same bits (the web graph runs hybrid, where fused_spmv falls back to
    fused; the road network runs ELL, where it is the real two-pass step)."""
    csr = generate(kind, 512, 6.0 if kind == "web" else 2.1, seed=5, values="normalized")
    monkeypatch.delenv("REPRO_FUSED_LANCZOS", raising=False)
    out = {}
    for m in ("unfused", mode):
        monkeypatch.setenv("REPRO_ITER_UPDATE", m)
        r = repro_torch.eigsh(csr, 4, num_iters=16, policy="FFF", reorth=reorth, seed=7,
                              device="cpu")
        assert r.partition["spmv"]["iteration_plan"]["effective"] == m
        out[m] = r
    assert out[mode].spmv_format == ("hybrid" if kind == "web" else "ell")
    for f in ("alpha", "beta", "beta_last"):
        assert torch.equal(getattr(out["unfused"].tridiag, f), getattr(out[mode].tridiag, f)), f
    assert torch.equal(out["unfused"].eigenvalues, out[mode].eigenvalues)


def test_update_mode_resolution(monkeypatch):
    monkeypatch.delenv("REPRO_ITER_UPDATE", raising=False)
    monkeypatch.delenv("REPRO_FUSED_LANCZOS", raising=False)
    assert tlan.resolve_update_mode(tprec.FDF, device="cpu") == "unfused"
    assert tlan.resolve_update_mode(tprec.FDF, device="cuda") == "fused"
    assert tlan.resolve_update_mode(tprec.FCF, device="cuda") == "unfused"  # compensated
    assert tlan.resolve_update_mode(tprec.FDF.with_phases(alpha_beta="f32"),
                                    device="cuda") == "unfused"
    monkeypatch.setenv("REPRO_FUSED_LANCZOS", "0")
    assert tlan.resolve_update_mode(tprec.FFF, device="cuda") == "unfused"
    monkeypatch.setenv("REPRO_FUSED_LANCZOS", "1")
    assert tlan.resolve_update_mode(tprec.FFF, device="cpu") == "fused"
    monkeypatch.delenv("REPRO_FUSED_LANCZOS")
    monkeypatch.setenv("REPRO_ITER_UPDATE", "sideways")
    with pytest.raises(ValueError, match="REPRO_ITER_UPDATE"):
        tlan.resolve_update_mode(tprec.FFF, device="cpu")


def test_compensated_sum_matches_reference():
    n = 1 << 16
    rng = np.random.default_rng(9)
    big = rng.standard_normal(n // 2) * 1e4
    x = np.stack([big, -big], axis=1).reshape(-1) + rng.standard_normal(n) * 1e-3
    want = float(np.sum(x))
    got_t = float(tprec.compensated_sum(torch.from_numpy(x), torch.float32))
    got_j = float(jprec.compensated_sum(jnp.asarray(x), jnp.float32))
    # Same chunking and Neumaier order; the native f32 sums inside each
    # 256-chunk run in another order, so agreement is to f32 eps of sum |x|.
    scale = float(np.abs(x).sum())
    assert abs(got_t - want) <= 1e-6 * scale
    assert abs(got_t - got_j) <= 1e-6 * scale


def test_policies_mirror_reference():
    assert list(tprec.POLICIES) == list(jprec.POLICIES)
    for name, p in tprec.POLICIES.items():
        q = jprec.POLICIES[name]
        assert p.compensated == q.compensated
        for a, b in ((p.storage, q.storage), (p.compute, q.compute), (p.output, q.output)):
            assert tprec.dtype_name(a) == jnp.dtype(b).name
    split = tprec.FDF.with_phases(reorth="f32")
    assert split.name == jprec.FDF.with_phases(reorth="f32").name
    assert split.phase_map() == jprec.FDF.with_phases(reorth="f32").phase_map()
    with pytest.raises(ValueError, match="unknown precision phase"):
        tprec.FDF.with_phases(bogus="f32")


def test_jacobi_host_is_the_reference():
    rng = np.random.default_rng(3)
    alpha, beta = rng.standard_normal(12), rng.standard_normal(11)
    t = tridiag_to_dense(alpha, beta)
    ev_t, w_t = jacobi_eigh_host(t)
    ev_j, w_j = jax_jacobi(t)
    np.testing.assert_array_equal(ev_t, ev_j)
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_allclose(np.sort(ev_t), np.linalg.eigvalsh(t), atol=1e-12)


def test_health_probe_raises_typed_breakdowns():
    basis = torch.zeros(4, 8)
    nan = tlan.LanczosResult(torch.tensor([1.0, float("nan"), 1.0, 1.0]), torch.ones(3), basis,
                             torch.tensor(1.0))
    with pytest.raises(tlan.NumericalBreakdown) as e:
        tlan.check_tridiag_health(nan, tprec.FFF)
    assert e.value.kind == "nonfinite" and e.value.iteration == 1
    under = tlan.LanczosResult(torch.ones(4), torch.tensor([1.0, 0.0, 1.0]), basis,
                               torch.tensor(1.0))
    with pytest.raises(tlan.NumericalBreakdown) as e:
        tlan.check_tridiag_health(under, tprec.FFF)
    assert e.value.kind == "beta_underflow" and e.value.iteration == 1
    tlan.check_tridiag_health(tlan.LanczosResult(torch.ones(4), torch.ones(3), basis,
                                                 torch.tensor(0.0)), tprec.FFF)
