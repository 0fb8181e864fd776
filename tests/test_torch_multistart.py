"""The port's multi-start sweep (``core.lanczos.lanczos_tridiag_multi`` and
the batched ``eigsh_many`` on dense and COO operators) against the
reference's vmapped sweep, and its pieces against their lone counterparts
(CPU, the plain versions).

Tolerances, relative to max |alpha| or max |lambda|: FDF and DDD 1e-12
(f64 arithmetic: the block matvec and the row-wise dots sum in another
order than a lone sweep, and than the reference); FCF 1e-5 (f32 arithmetic
with compensated sums).  The block matvecs and the batched plain update's
norms against their lone calls within 1e-15 in f64 and 1e-6 in f32 (the
same products, summed in another order at most); its ``u`` bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro
import repro.core.lanczos as jlan
import repro.core.precision as jprec
from repro.core.operators import DenseOperator as JaxDenseOperator
from repro.core.operators import make_operator as jax_make_operator
from repro.sparse import generate as jax_generate
import repro_torch
from repro_torch.api import EigQuery
from repro_torch.core import lanczos as tlan
from repro_torch.core import precision as tprec
from repro_torch.core.operators import DenseOperator, make_operator
from repro_torch.kernels import ops, ref
from repro_torch.kernels.lanczos_update import lanczos_update_contract, lanczos_update_multi_contract
from repro_torch.analysis import op_count
from repro_torch.sparse import CSR

TOL = {"FDF": 1e-12, "DDD": 1e-12, "FCF": 1e-5}
M = 12


def _port_csr(c) -> CSR:
    return CSR(indptr=np.asarray(c.indptr), indices=np.asarray(c.indices),
               data=np.asarray(c.data), shape=c.shape)


@pytest.fixture(scope="module")
def road():
    return jax_generate("road", 1024, 2.1, seed=4, values="normalized")


def _dense(c) -> np.ndarray:
    return sp.csr_matrix((np.asarray(c.data), np.asarray(c.indices), np.asarray(c.indptr)),
                         shape=c.shape).toarray()


def _starts(n, b=3):
    return np.stack([np.random.default_rng(s).standard_normal(n) for s in range(b)])


def _operators(road, layout, policy):
    """(reference operator, port operator) on the same matrix."""
    jp, tp = jprec.POLICIES[policy], tprec.POLICIES[policy]
    if layout == "dense":
        a = _dense(road)
        return (JaxDenseOperator(jnp.asarray(a, dtype=jp.storage)),
                DenseOperator(torch.from_numpy(a).to(tp.storage)))
    return (jax_make_operator(road, impl="coo", dtype=jp.storage),
            make_operator(_port_csr(road), impl="coo", dtype=tp.storage, device="cpu"))


@pytest.mark.parametrize("reorth", ["half", "full", "none"])
@pytest.mark.parametrize("policy", list(TOL))
@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_lanczos_tridiag_multi_matches_reference(road, layout, policy, reorth):
    """Every start's alpha, beta, beta_last and basis against the
    reference's vmapped sweep from the same start."""
    jp, tp = jprec.POLICIES[policy], tprec.POLICIES[policy]
    jop, top = _operators(road, layout, policy)
    v1s = _starts(road.n)
    jres = jlan.lanczos_tridiag_multi(jop.bound_matvec(jp), jnp.asarray(v1s), M, jp,
                                      reorth=reorth)
    tres = tlan.lanczos_tridiag_multi(top.bound_matvec(tp), torch.from_numpy(v1s), M, tp,
                                      reorth=reorth)
    assert tres.alpha.shape == (3, M) and tres.beta.shape == (3, M - 1)
    assert tres.basis.shape == (3, M, road.n) and tres.beta_last.shape == (3,)
    assert tres.alpha.dtype == tp.compute and tres.basis.dtype == tp.storage
    for s in range(3):
        a_j = np.asarray(jres.alpha[s], np.float64)
        scale = np.abs(a_j).max()
        tol = TOL[policy] * scale
        np.testing.assert_allclose(tres.alpha[s].double().numpy(), a_j, rtol=0, atol=tol)
        np.testing.assert_allclose(tres.beta[s].double().numpy(),
                                   np.asarray(jres.beta[s], np.float64), rtol=0, atol=tol)
        assert abs(float(tres.beta_last[s]) - float(jres.beta_last[s])) <= tol
        if policy != "FCF":
            np.testing.assert_allclose(tres.basis[s].double().numpy(),
                                       np.asarray(jres.basis[s], np.float64), rtol=0, atol=1e-9)


@pytest.mark.parametrize("policy", ["FDF", "FCF"])
@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_each_start_matches_a_lone_sweep(road, layout, policy):
    """Start s of the multi-start sweep against ``lanczos_tridiag`` from
    start s alone, with the lone sweep's own ops handed over (their update
    mode carries to the batched ops)."""
    tp = tprec.POLICIES[policy]
    _, top = _operators(road, layout, policy)
    v1s = _starts(road.n)
    lone_ops = tlan.ops_for_operator(top, tp, device="cpu")
    multi = tlan.lanczos_tridiag_multi(top.bound_matvec(tp), torch.from_numpy(v1s), M, tp,
                                       ops=lone_ops)
    for s in range(3):
        one = tlan.lanczos_tridiag(top.bound_matvec(tp), torch.from_numpy(v1s[s]), M, tp,
                                   ops=lone_ops)
        scale = float(one.alpha.abs().max())
        for got, want in ((multi.alpha[s], one.alpha), (multi.beta[s], one.beta)):
            assert float((got - want).abs().max()) <= TOL[policy] * scale


@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_eigsh_many_is_one_sweep_in_both_packages(road, layout):
    """Three start vectors, the first asked twice (k 3 and k 2): one sweep
    of three starts in both packages; every result counts the whole group
    of four queries in ``amortized_over`` and matches the reference's
    within 1e-12."""
    starts = _starts(road.n)
    queries = [{"k": 3, "num_iters": M, "v0": v} for v in starts] + \
              [{"k": 2, "num_iters": M, "v0": starts[0]}]
    if layout == "dense":
        a_w = a_g = _dense(road)
        kw = {}
    else:
        a_w, a_g, kw = road, _port_csr(road), {"format": "coo"}
    want_sess = repro.prepare(a_w, **kw)
    got_sess = repro_torch.prepare(a_g, device="cpu", **kw)
    want = want_sess.eigsh_many(queries)
    got = got_sess.eigsh_many([EigQuery(**q) for q in queries])
    assert want_sess.stats["sweeps"] == got_sess.stats["sweeps"] == 1
    for g, w in zip(got, want):
        assert g.timings["amortized_over"] == w.timings["amortized_over"] == 4.0
        assert g.partition.get("spmv", {}).get("format", layout) == layout
        lw = np.sort(np.asarray(w.eigenvalues, np.float64))
        lg = np.sort(g.eigenvalues.double().numpy())
        assert np.abs(lg - lw).max() <= 1e-12 * np.abs(lw).max()
        assert g.timings["lanczos_s"] == got[0].timings["lanczos_s"]  # shared by the batch
    assert torch.equal(got[3].eigenvalues, got[0].eigenvalues[:2])


def test_seeded_starts_draw_as_a_lone_call(road):
    """Queries without ``v0`` draw their start from their ``seed`` as the
    lone sweep does, so each matches ``eigsh(seed=...)``."""
    sess = repro_torch.prepare(_port_csr(road), device="cpu", format="coo")
    got = sess.eigsh_many([EigQuery(k=3, num_iters=M, seed=s) for s in (0, 5)])
    assert sess.stats["sweeps"] == 1
    for g, s in zip(got, (0, 5)):
        alone = sess.eigsh(3, num_iters=M, seed=s)
        lw, lg = alone.eigenvalues.double().numpy(), g.eigenvalues.double().numpy()
        assert np.abs(lg - lw).max() <= 1e-12 * np.abs(lw).max()
    assert not torch.equal(got[0].eigenvalues, got[1].eigenvalues)


@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_group_past_the_batch_cap_runs_in_batches(road, layout, monkeypatch):
    """A group of five starts where one sweep takes two: three sweeps of
    2, 2 and 1 starts, every result still amortized over the whole group
    and within 1e-12 of its start's lone call."""
    from repro_torch.api import session as tsession

    monkeypatch.setattr(tsession, "_multistart_batch", lambda op, pol, m, dev: 2)
    starts = _starts(road.n, 5)
    a = torch.from_numpy(_dense(road)) if layout == "dense" else _port_csr(road)
    kw = {} if layout == "dense" else {"format": "coo"}
    sess = repro_torch.prepare(a, device="cpu", **kw)
    got = sess.eigsh_many([EigQuery(k=3, num_iters=M, v0=v) for v in starts])
    assert sess.stats["sweeps"] == 3
    assert all(g.timings["amortized_over"] == 5.0 for g in got)
    assert got[0].timings["lanczos_s"] == got[1].timings["lanczos_s"]  # shared by a batch
    assert got[2].timings["lanczos_s"] == got[3].timings["lanczos_s"]
    for g, v in zip(got, starts):
        alone = sess.eigsh(3, num_iters=M, v0=v)
        lw, lg = alone.eigenvalues.double().numpy(), g.eigenvalues.double().numpy()
        assert np.abs(lg - lw).max() <= 1e-12 * np.abs(lw).max()


def test_batch_cap_is_the_row_limit_on_the_host(road):
    """Off the card the batch is bounded by the batched launch's row limit
    only."""
    from repro_torch.api.session import _multistart_batch
    from repro_torch.kernels.lanczos_update import MAX_ROWS

    _, top = _operators(road, "coo", "FDF")
    assert _multistart_batch(top, tprec.POLICIES["FDF"], M, torch.device("cpu")) == MAX_ROWS


def test_kernel_layouts_keep_one_sweep_a_start(road):
    """The ELL layout's matvec is a kernel that takes one vector: its
    starts run one sweep each, as in the reference."""
    sess = repro_torch.prepare(_port_csr(road), device="cpu", format="ell")
    got = sess.eigsh_many([EigQuery(k=3, num_iters=M, v0=v) for v in _starts(road.n, 2)])
    assert sess.stats["sweeps"] == 2 and all("amortized_over" not in g.timings for g in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_matvecs_match_single_matvecs(road, dtype):
    """``DeviceCOO.matvec`` and ``DenseOperator.matvec`` on an (n, B)
    block, column by column against B single matvecs."""
    _, dense = _operators(road, "dense", "DDD")
    _, coo = _operators(road, "coo", "DDD")
    x = torch.from_numpy(_starts(road.n, 4).T.copy()).to(dtype)
    for op in (dense, coo):
        y = op.matvec(x, accum_dtype=torch.float64)
        assert y.shape == (road.n, 4)
        for j in range(4):
            one = op.matvec(x[:, j].contiguous(), accum_dtype=torch.float64)
            assert float((y[:, j] - one).abs().max()) <= 1e-15 * float(one.abs().max())
    # a transposed view (the sweep's rows) is a valid block too
    rows = x.T.contiguous()
    assert torch.equal(coo.matvec(rows.T, accum_dtype=torch.float64),
                       coo.matvec(x, accum_dtype=torch.float64))


@pytest.mark.parametrize("sdt,acc", [(torch.float32, torch.float32),
                                     (torch.float32, torch.float64),
                                     (torch.float64, torch.float64),
                                     (torch.bfloat16, torch.float32)])
def test_batched_plain_update_matches_solo_calls(sdt, acc):
    rng = np.random.default_rng(3)
    b, n = 4, 999
    w, v, vp = (torch.from_numpy(rng.standard_normal((b, n))).to(sdt) for _ in range(3))
    alpha, beta = (torch.from_numpy(rng.standard_normal(b)).to(acc) for _ in range(2))
    u, nrm = ref.lanczos_update_multi_ref(w, v, vp, alpha, beta, acc)
    rtol = 1e-15 if acc == torch.float64 else 1e-6  # the same products, another sum order
    assert u.dtype == sdt and nrm.dtype == acc and nrm.shape == (b,)
    for s in range(b):
        us, ns = ref.lanczos_update_ref(w[s], v[s], vp[s], alpha[s], beta[s], acc)
        assert torch.equal(u[s], us)
        assert abs(float(nrm[s]) - float(ns)) <= rtol * float(ns)
    got = ops.lanczos_update_multi(w, v, vp, alpha, beta, accum_dtype=acc)
    assert torch.equal(got[0], u) and torch.equal(got[1], nrm)


def test_batched_update_contract_is_b_solo_contracts():
    """The batched launch declares B times the solo launch's element ops,
    with its conversions, and the op counter records it under its own
    name."""
    rng = np.random.default_rng(4)
    w, v = (torch.from_numpy(rng.standard_normal((3, 64))).float() for _ in range(2))
    a, b = torch.ones(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)
    ops_, convs = lanczos_update_multi_contract(w, torch.float64)
    solo_ops, solo_convs = lanczos_update_contract(w[0], torch.float64)
    assert ops_ == {k: 3 * n for k, n in solo_ops.items()} and convs == solo_convs
    plain = op_count.count_ops_by_dtype(
        lambda: ref.lanczos_update_multi_ref(w, v, v, a, b, torch.float64))
    assert 0.5 <= ops_["float64"] / plain["float64"] <= 2.0
    with op_count.OpCounter() as c:
        ops.lanczos_update_multi(w, v, v, a, b, accum_dtype=torch.float64)
    assert c.kernels["lanczos_update_multi"]["ops"] == ops_ and "lanczos_update" not in c.kernels


def test_multi_rejects_a_single_vector(road):
    _, top = _operators(road, "coo", "FDF")
    with pytest.raises(ValueError, match=r"\(s, n\)"):
        tlan.lanczos_tridiag_multi(top.bound_matvec(tprec.FDF),
                                   torch.zeros(road.n, dtype=torch.float64), M, tprec.FDF)
