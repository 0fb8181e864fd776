"""The measured autotuner and the serving scheduler on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither ``jax`` nor the reference package, so it runs on a machine that has
only PyTorch: from the repository root,

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_serving_gpu.py

A tuned solve must launch what its plan says and equal the untuned (table)
solve at rel 1e-9 of |lambda|max under FDF; a scheduler sweep launches its
SpMV kernel once a step; a warm restart on the card converts and probes
nothing and gives the same bits.
"""

import threading

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.api import SolverConfig
from repro_torch.kernels import engine as keng
from repro_torch.kernels import lanczos_fused, lanczos_update, spmv_bsr, spmv_ell
from repro_torch.serving import EigenScheduler, SchedulerConfig, SessionStore
from repro_torch.sparse import generate
from repro_torch.sparse.formats import conversion_count

K = 8
KERNELS = {
    "spmv_ell": spmv_ell.spmv_ell_kernel_call,
    "spmv_ell_alpha": lanczos_fused.spmv_ell_alpha_kernel_call,
    "lanczos_update": lanczos_update.lanczos_update_kernel_call,
    "spmv_bsr": spmv_bsr.spmv_bsr_kernel_call,
}
# Launches of one K-step sweep under each update mode of an ELL plan.
PER_PLAN = {
    "fused_spmv": {"spmv_ell": 0, "spmv_ell_alpha": K, "lanczos_update": K},
    "fused": {"spmv_ell": K, "spmv_ell_alpha": 0, "lanczos_update": K},
    "unfused": {"spmv_ell": K, "spmv_ell_alpha": 0, "lanczos_update": 0},
}


@pytest.fixture
def cuda(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    monkeypatch.setenv("REPRO_SPMV_TUNE", "1")
    monkeypatch.setenv("REPRO_SPMV_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.delenv("REPRO_ITER_UPDATE", raising=False)
    monkeypatch.setattr(keng, "_TUNER", None)
    repro_torch.session_cache_clear()
    yield torch.device("cuda")
    repro_torch.session_cache_clear()


@pytest.fixture
def road():
    return generate("road", 1 << 16, 2.1, seed=1, values="normalized")


def _reset():
    for fn in KERNELS.values():
        fn.launches = 0


def _launches():
    return {name: fn.launches for name, fn in KERNELS.items()}


@pytest.mark.gpu
def test_tuned_plan_on_the_card(cuda, road, monkeypatch):
    """The card's probes measure every ELL mode, the tuned solve launches
    what the plan says, and a second prepare probes nothing."""
    v0 = np.random.default_rng(0).standard_normal(road.n)
    p0 = keng.tuner_probe_count()
    sess = repro_torch.prepare(road, device="cuda")
    assert keng.tuner_probe_count() - p0 == sess.prepare_tuner_probes == 2
    assert repro_torch.prepare(road, device="cuda").prepare_tuner_probes == 0
    _reset()
    res = sess.eigsh(K, v0=v0)
    plan = res.partition["spmv"]["iteration_plan"]
    assert plan["source"] == "tuned" and res.partition["spmv"]["tiles_from"] == "tuned"
    got = _launches()
    assert {n: got[n] for n in PER_PLAN[plan["effective"]]} == PER_PLAN[plan["effective"]]
    monkeypatch.setenv("REPRO_SPMV_TUNE", "0")
    table = repro_torch.prepare(road, device="cuda").eigsh(K, v0=v0)
    lam, want = res.eigenvalues.double().cpu(), table.eigenvalues.double().cpu()
    assert float((lam - want).abs().max() / want.abs().max()) <= 1e-9


@pytest.mark.gpu
def test_tuned_bsr_block_edge_on_the_card(cuda):
    """The BSR probe picks one of the kernel's block edges; the tuned solve
    runs ``spmv_bsr`` once a step."""
    import scipy.sparse as sp

    from repro_torch.sparse import CSR

    small = generate("road", 1 << 12, 2.1, seed=0)
    b = np.random.default_rng(1).random((8, 8))
    m = sp.kron(small.to_scipy(), sp.csr_matrix((b + b.T) / 2)).tocsr()
    m.sort_indices()
    block = CSR(indptr=m.indptr.astype(np.int64), indices=m.indices.astype(np.int32),
                data=m.data, shape=m.shape)
    sess = repro_torch.prepare(block, device="cuda")
    assert sess.prepare_tuner_probes == 1  # the iteration probe (block edges)
    _reset()
    res = sess.eigsh(K, v0=np.random.default_rng(0).standard_normal(block.n))
    spmv = res.partition["spmv"]
    assert res.spmv_format == "bsr" and spmv["block_size"] in (4, 8, 16)
    assert _launches()["spmv_bsr"] == K


@pytest.mark.gpu
def test_scheduler_launches_per_sweep_and_warm_restart(cuda, road, tmp_path):
    """Coalesced queries from three threads: each sweep launches the plan's
    kernels once a step, results equal ``eigsh_many``'s bits, and a warm
    restart on the card converts and probes nothing and gives the same
    bits."""
    v0 = np.random.default_rng(0).standard_normal(road.n)
    store = SessionStore(str(tmp_path / "store"))
    cfg = SchedulerConfig(admission_window_s=0.05, watchdog_interval_s=0.1)
    sched = EigenScheduler(cfg, store=store)
    key = sched.add_matrix(road, name="road", config=SolverConfig(device="cuda"))
    sess = sched.session(key)
    sweeps0 = sess.stats["sweeps"]
    results, errors = [], []

    def client(tid):
        try:
            hs = [sched.submit(key, k=k, num_iters=K, v0=v0) for k in (2, 4, 8)]
            results.extend((h.query.k, h.result(timeout=300.0)) for h in hs)
        except Exception as exc:  # surfaced below
            errors.append(exc)

    _reset()
    threads = [threading.Thread(target=client, args=(t,)) for t in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600.0)
    got = _launches()
    assert not errors and len(results) == 9
    sweeps = sess.stats["sweeps"] - sweeps0
    assert sweeps < 9  # something coalesced
    plan = results[0][1].partition["spmv"]["iteration_plan"]["effective"]
    assert {n: got[n] for n in PER_PLAN[plan]} == {n: sweeps * c for n, c in PER_PLAN[plan].items()}
    for k, r in results:
        (alone,) = sess.eigsh_many([{"k": k, "num_iters": K, "v0": v0}])
        assert torch.equal(r.eigenvalues, alone.eigenvalues)
    before = next(r for k, r in results if k == K)
    sched.close(persist=True)
    conv0, probes0 = conversion_count(), keng.tuner_probe_count()
    with EigenScheduler(cfg, store=store) as sched2:
        sched2.add_matrix(road, name="road", config=SolverConfig(device="cuda"))
        res = sched2.submit("road", k=K, num_iters=K, v0=v0).result(timeout=300.0)
        assert sched2.stats().warm_starts == 1
    assert conversion_count() == conv0 and keng.tuner_probe_count() == probes0
    assert res.session_reuse and torch.equal(res.eigenvalues, before.eigenvalues)
