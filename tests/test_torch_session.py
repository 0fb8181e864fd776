"""The session's query layer: ``eigsh_many``, ``group_key``, the session
cache, the fingerprints, ``policy="auto"`` and the precision audit, against
the reference where it has the same function.

Tolerances relative to |lambda|max, as in ``test_torch_eigsh.py`` and
``test_torch_restarted.py``: eigenvalues FDF 1e-12 and FFF 1e-6, Ritz
residual bounds 1e-12 on the fixed subspace (FDF) and 1e-6 (f32 storage)
on the restarted one.  The fixed-subspace queries pass the same start
vector to both packages; restarted ones draw it from the same NumPy seed.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro
from repro.api import session as jax_session
from repro.api.coerce import matrix_fingerprint as jax_fingerprint
from repro.core import precision as jax_precision
from repro.sparse import generate as jax_generate
from repro.sparse import save_diskcsr as jax_save_diskcsr
from repro.sparse.diskcsr import diskcsr_fingerprint as jax_diskcsr_fingerprint
import repro_torch
from repro_torch.api import EigenResult, EigQuery, SolverConfig, get_session, matrix_fingerprint
from repro_torch.api.session import policy_key
from repro_torch.core import precision
from repro_torch.sparse import CSR, diskcsr_fingerprint, save_diskcsr

ITERS = 24
EIG_TOL = {"FDF": 1e-12, "FFF": 1e-6}


@pytest.fixture(autouse=True)
def _fresh_cache():
    repro_torch.session_cache_clear()
    repro.api.session_cache_clear()
    yield
    repro_torch.session_cache_clear()
    repro.api.session_cache_clear()


@pytest.fixture(scope="module")
def small():
    return jax_generate("web", 512, 6.0, seed=3, values="normalized")


def _port_csr(c) -> CSR:
    return CSR(indptr=np.asarray(c.indptr), indices=np.asarray(c.indices),
               data=np.asarray(c.data), shape=c.shape)


def _assert_close(got, want, eig_tol, res_tol):
    lam_w = np.asarray(want.eigenvalues, np.float64)
    lam_g = got.eigenvalues.double().numpy()
    order_w, order_g = np.argsort(lam_w), np.argsort(lam_g)
    scale = np.abs(lam_w).max()
    np.testing.assert_allclose(lam_g[order_g], lam_w[order_w], rtol=0, atol=eig_tol * scale)
    np.testing.assert_allclose(got.residuals[order_g], want.residuals[order_w], rtol=0,
                               atol=res_tol * scale)
    np.testing.assert_array_equal(got.converged[order_g], want.converged[order_w])
    assert (got.k, got.backend, got.policy, got.tol, got.iterations, got.restarts) == (
        want.k, want.backend, want.policy, want.tol, want.iterations, want.restarts)


def _classes(keys):
    """Equality classes of a list of keys, as lists of indices."""
    seen = {}
    for i, key in enumerate(keys):
        seen.setdefault(key, []).append(i)
    return sorted(seen.values())


def test_eigsh_many_groups_and_answers_like_the_reference(small):
    v = np.random.default_rng(0).standard_normal(small.n)
    queries = [
        {"k": 2, "num_iters": ITERS, "v0": v},
        {"k": 4, "num_iters": ITERS, "v0": v},
        {"k": 3, "num_iters": ITERS, "v0": v, "policy": "FFF"},
        {"k": 2, "tol": 1e-7, "subspace": 16},
        {"k": 4, "tol": 1e-6, "subspace": 16},
        {"k": 4, "num_iters": ITERS, "v0": v, "reorth": "full"},
        {"k": 3, "tol": 1e-4, "policy": "auto"},
    ]
    want_sess = repro.prepare(small)
    got_sess = repro_torch.prepare(_port_csr(small), device="cpu")
    want = want_sess.eigsh_many(queries)
    got = got_sess.eigsh_many(queries)
    # One sweep for each of the four groups, and one for each rung of the auto query.
    rungs = len(got[-1].policy_escalations)
    assert got_sess.stats["sweeps"] == want_sess.stats["sweeps"] == 4 + rungs
    assert got_sess.stats["queries"] == want_sess.stats["queries"] == len(queries)
    for q, g, w in zip(queries, got, want):
        if q.get("policy") == "auto":
            assert [a["policy"] for a in g.policy_escalations] == [
                a["policy"] for a in w.policy_escalations]
            continue
        restarted = "tol" in q
        pol = q.get("policy", "FDF")
        _assert_close(g, w, EIG_TOL[pol], 1e-6 if restarted else EIG_TOL[pol])
        assert g.timings.get("amortized_over") == w.timings.get("amortized_over")
    assert got[0].timings["amortized_over"] == 2.0  # k=2 and k=4 share one sweep
    np.testing.assert_array_equal(got[0].eigenvalues.numpy(), got[1].eigenvalues[:2].numpy())

    keys_w = [want_sess.group_key(q) for q in queries]
    keys_g = [got_sess.group_key(q) for q in queries]
    assert keys_g[-1] is None and keys_w[-1] is None  # auto never groups
    assert _classes(keys_g) == _classes(keys_w) == [[0, 1], [2], [3, 4], [5], [6]]
    with pytest.raises(ValueError, match="exceeds the operator dimension"):
        got_sess.group_key(small.n + 1)
    with pytest.raises(TypeError, match="EigQuery"):
        got_sess.eigsh_many(["nope"])


@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_multistart_sweep_matches_reference(small, layout):
    """Queries that differ only in their start vector, on dense and COO
    operators: each start gives what the reference's multi-start sweep
    gives it, and what a lone solve from it gives (within rel 1e-12: the
    block matvec and the row-wise dots sum in another order than the lone
    sweep's).  Both packages run the starts as one sweep
    (``stats["sweeps"]`` 1, ``amortized_over`` 3)."""
    starts = [np.random.default_rng(s).standard_normal(small.n) for s in range(3)]
    queries = [{"k": 3, "num_iters": ITERS, "v0": v} for v in starts]
    if layout == "dense":
        a_w, a_g, kw = small.toarray(), small.toarray(), {}
    else:
        a_w, a_g, kw = small, _port_csr(small), {"format": "coo"}
    want_sess = repro.prepare(a_w, **kw)
    got_sess = repro_torch.prepare(a_g, device="cpu", **kw)
    want = want_sess.eigsh_many(queries)
    got = got_sess.eigsh_many([EigQuery(**q) for q in queries])
    assert want_sess.stats["sweeps"] == 1 and got_sess.stats["sweeps"] == 1
    for g, w, v in zip(got, want, starts):
        assert g.spmv_format == w.spmv_format == layout
        _assert_close(g, w, 1e-12, 1e-12)
        assert w.timings["amortized_over"] == g.timings["amortized_over"] == 3.0
        alone = got_sess.eigsh(3, num_iters=ITERS, v0=v)
        _assert_close(g, alone, 1e-12, 1e-12)


def test_cache_hits_misses_and_rejects_mutation(small):
    a = CSR(indptr=small.indptr.copy(), indices=small.indices.copy(), data=small.data.copy(),
            shape=small.shape)
    r1 = repro_torch.eigsh(a, 4, num_iters=ITERS, device="cpu")
    r2 = repro_torch.eigsh(a, 4, num_iters=ITERS, device="cpu")
    assert not r1.session_reuse and r1.partition["spmv"]["conversions"] == 1
    assert r2.session_reuse and r2.partition["spmv"]["conversions"] == 0
    assert r2.timings["prepare_s"] == 0.0 and torch.equal(r1.eigenvalues, r2.eigenvalues)
    # A tol= query runs on the in-core layout of the fixed ones.
    r3 = repro_torch.eigsh(a, 4, tol=1e-6, device="cpu")
    assert r3.backend == "restarted" and r3.session_reuse
    assert repro_torch.session_cache_info()["size"] == 1
    # Another layout setting is another session.
    r4 = repro_torch.eigsh(a, 4, num_iters=ITERS, format="coo", device="cpu")
    assert not r4.session_reuse and repro_torch.session_cache_info()["size"] == 2
    # A byte-identical copy hits; an in-place mutation misses, and the
    # cached session kept its own copy of the data.
    copy = CSR(indptr=a.indptr.copy(), indices=a.indices.copy(), data=a.data.copy(), shape=a.shape)
    assert repro_torch.eigsh(copy, 4, num_iters=ITERS, device="cpu").session_reuse
    sess, hit = get_session(a, SolverConfig(device="cpu"))
    assert hit
    a.data[0] *= 2.0
    r5 = repro_torch.eigsh(a, 4, num_iters=ITERS, device="cpu")
    assert not r5.session_reuse
    assert sess.csr.data[0] == small.data[0]


def test_cache_limit_evicts_least_recent_and_releases_plans(small, monkeypatch):
    monkeypatch.setenv("REPRO_EIGSH_SESSION_CACHE", "2")
    mats = [_port_csr(jax_generate("web", 256, 6.0, seed=s, values="normalized"))
            for s in range(3)]
    cfg = SolverConfig(device="cpu", num_iters=ITERS)
    first, _ = get_session(mats[0], cfg)
    first.eigsh(4)
    assert first._prepared
    repro_torch.eigsh(mats[1], 4, config=cfg)
    assert repro_torch.eigsh(mats[0], 4, config=cfg).session_reuse  # mats[0] now most recent
    repro_torch.eigsh(mats[2], 4, config=cfg)  # evicts mats[1]
    assert repro_torch.session_cache_info()["size"] == 2
    assert repro_torch.eigsh(mats[0], 4, config=cfg).session_reuse
    assert not repro_torch.eigsh(mats[1], 4, config=cfg).session_reuse  # evicts mats[2]
    repro_torch.eigsh(mats[2], 4, config=cfg)  # evicts mats[0]
    assert not first._prepared  # the evicted session dropped its plans
    monkeypatch.setenv("REPRO_EIGSH_SESSION_CACHE", "0")
    repro_torch.session_cache_clear()
    repro_torch.eigsh(mats[0], 4, config=cfg)
    assert repro_torch.session_cache_info()["size"] == 0
    assert not repro_torch.eigsh(mats[0], 4, config=cfg).session_reuse


def test_cache_byte_budget(small, monkeypatch):
    """The budget counts the host data and the plans' tensors: a matrix
    larger than the whole budget is served, never cached; one whose plan
    pushes it over is evicted after the build."""
    a = _port_csr(small)
    host = a.indptr.nbytes + a.indices.nbytes + a.data.nbytes
    sess = repro_torch.prepare(a, device="cpu")
    assert sess.approx_bytes() > host  # the built plan's tensors count
    monkeypatch.setenv("REPRO_EIGSH_SESSION_CACHE_MB", str(host / 2 / 1e6))
    repro_torch.eigsh(a, 4, num_iters=ITERS, device="cpu")
    assert repro_torch.session_cache_info()["size"] == 0
    monkeypatch.setenv("REPRO_EIGSH_SESSION_CACHE_MB", str((host + 1) / 1e6))
    repro_torch.eigsh(a, 4, num_iters=ITERS, device="cpu")
    assert repro_torch.session_cache_info()["size"] == 0  # admitted, then evicted
    monkeypatch.setenv("REPRO_EIGSH_SESSION_CACHE_MB", str((sess.approx_bytes() + 10) / 1e6))
    repro_torch.eigsh(a, 4, num_iters=ITERS, device="cpu")
    info = repro_torch.session_cache_info()
    assert info["size"] == 1 and info["bytes"] == sess.approx_bytes() <= info["budget_bytes"]


def test_fingerprints_equal_the_reference(small, tmp_path, monkeypatch):
    assert matrix_fingerprint(_port_csr(small)) == jax_fingerprint(small)
    for dense in (small.toarray(), small.toarray().astype(np.float32)):
        assert matrix_fingerprint(dense) == jax_fingerprint(dense)
        assert matrix_fingerprint(torch.from_numpy(dense)) == jax_fingerprint(dense)
    assert matrix_fingerprint(lambda x: x) is None
    big = jax_generate("road", 1 << 14, 2.1, seed=1)  # indices span more than 2 blocks
    jax_save_diskcsr(str(tmp_path / "ref"), big)
    save_diskcsr(str(tmp_path / "port"), _port_csr(big))
    for blocks in ("2", "16"):
        monkeypatch.setenv("REPRO_DISKCSR_FP_BLOCKS", blocks)
        for d in ("ref", "port"):
            path = str(tmp_path / d)
            assert diskcsr_fingerprint(path) == jax_diskcsr_fingerprint(path)
            assert matrix_fingerprint(path) == jax_fingerprint(path)
    assert diskcsr_fingerprint(str(tmp_path / "ref"), blocks=2) != diskcsr_fingerprint(
        str(tmp_path / "ref"), blocks=16)


@pytest.fixture(scope="module")
def mat():
    """``tests/test_precision_phases.py``'s harness matrix."""
    return jax_generate("web", 512, 6.0, seed=11, values="normalized")


@pytest.mark.parametrize("tol", [1e-4, 5e-2, 1e-9])
def test_auto_policy_tries_and_accepts_the_reference_rungs(mat, tol):
    kw = dict(policy="auto", tol=tol, subspace=12, max_restarts=30)
    want = repro.eigsh(mat, 3, **kw)
    got = repro_torch.eigsh(_port_csr(mat), 3, device="cpu", **kw)
    trail_w, trail_g = want.policy_escalations, got.policy_escalations
    assert [a["policy"] for a in trail_g] == [a["policy"] for a in trail_w]
    assert [a["converged"] for a in trail_g] == [a["converged"] for a in trail_w]
    assert [a["residual_kind"] for a in trail_g] == ["verified"] * len(trail_w)
    assert got.policy == want.policy and trail_g[-1]["converged"]
    assert trail_g[-1]["max_residual"] <= tol
    assert got.partition["spmv"]["precision"]["policy"] == got.policy
    again = repro_torch.eigsh(_port_csr(mat), 3, device="cpu", **kw)
    assert again.session_reuse and again.partition["spmv"]["conversions"] == 0


def test_auto_result_round_trips_through_json(mat):
    res = repro_torch.eigsh(_port_csr(mat), 2, policy="auto", tol=5e-2, subspace=12,
                            device="cpu")
    back = EigenResult.from_dict(json.loads(json.dumps(res.to_dict())))
    assert back.policy_escalations == res.policy_escalations
    assert torch.equal(back.eigenvalues, res.eigenvalues)
    assert repro_torch.eigsh(_port_csr(mat), 2, policy="FFF", num_iters=8,
                             device="cpu").policy_escalations is None
    for resolve in (repro_torch.api.resolve_policy, repro.api.resolve_policy):
        with pytest.raises(ValueError, match="selection mode"):
            resolve("auto")
    assert precision.auto_ladder() == jax_precision.auto_ladder()


@pytest.mark.parametrize("reorth", ["none", "half", "half_alt", "full", "full2"])
def test_phase_op_counts_equal_the_reference(reorth):
    split = {"base": "FDF", "reorth": "f32", "ritz": "bf16"}
    pols = [*precision.POLICIES, split]
    for name in pols:
        p_g = repro_torch.api.resolve_policy(name)
        p_w = repro.api.resolve_policy(name)
        kw = dict(n=2048, nnz=16_000, m=24, k=8, reorth=reorth)
        assert precision.phase_op_counts(p_g, **kw) == jax_precision.phase_op_counts(p_w, **kw)
        assert policy_key(p_g) == jax_session.policy_key(p_w)


def test_module_level_eigsh_many_hits_the_cache(small):
    a = _port_csr(small)
    rs = repro_torch.eigsh_many(a, [2, 4], num_iters=ITERS, device="cpu")
    assert [r.k for r in rs] == [2, 4]
    again = repro_torch.eigsh_many(a, [2, 4], num_iters=ITERS, device="cpu")
    assert all(r.session_reuse for r in again)
    scipy_in = repro_torch.eigsh_many(sp.csr_matrix(small.to_scipy()), [2], num_iters=ITERS,
                                      device="cpu")
    assert scipy_in[0].session_reuse  # the digest is of the converted CSR


def test_metrics_equal_the_reference(small):
    import jax.numpy as jnp

    from repro.core import metrics as jax_metrics
    from repro.core.operators import DenseOperator as JaxDense
    from repro_torch.core import metrics
    from repro_torch.core.operators import DenseOperator

    vals_w, vecs_w = jax_metrics.eigsh_reference(small, 4)
    vals_g, vecs_g = metrics.eigsh_reference(_port_csr(small), 4)
    np.testing.assert_allclose(vals_g, vals_w, rtol=1e-10)
    a = small.toarray()
    err_w = jax_metrics.reconstruction_error(JaxDense(jnp.asarray(a)), vals_w, jnp.asarray(vecs_w),
                                             accum_dtype=jnp.float64)
    err_g = metrics.reconstruction_error(DenseOperator(torch.from_numpy(a)), vals_w,
                                         torch.from_numpy(vecs_w), accum_dtype=torch.float64)
    assert err_g == pytest.approx(err_w, abs=1e-14) and err_g < 1e-10
    assert metrics.pairwise_orthogonality_deg(torch.from_numpy(vecs_g)) == pytest.approx(
        jax_metrics.pairwise_orthogonality_deg(vecs_g), abs=1e-9)
