"""The sharded trainer on the card: ranks sharing one card over gloo, their
DTensor collectives staged through the host (``distributed/host_staged.py``).

Every test here needs a CUDA card and skips without one.  The file imports
neither ``jax`` nor the reference package, so it runs on a machine that has
only PyTorch: from the repository root,

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_sharded_train_gpu.py

The smoke qwen3 (f32) on (data=1, model=2) and (2, 2): 3 AdamW steps with
rank-identical losses within rel 1e-5 of the same steps unsharded on the
card, params within rel 1e-4 of max |param| (the card's f32 products of
other shapes sum in other orders; through AdamW's normalized step an
element whose gradient is near zero moves by a larger share of lr: the
first card run measured 1.0-1.4e-5); the sharded Hessian probe's
eigenvalues rank-identical and within rel 1e-4 of the unsharded probe's
from the same start vector, with ``lanczos_update`` launched once a step on
every rank.
"""

import numpy as np
import pytest
import torch

import torch_sharded_ranks as sr
from repro_torch.core import tree
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.common import split_tree
from repro_torch.models.model import init_model, params_to_numpy
from repro_torch.training import DataConfig, Trainer, data_stream, synthetic_batch
from repro_torch.training.spectral import hessian_spectrum

pytestmark = pytest.mark.gpu

STEPS, BATCH, SEQ, K, ITERS = 3, 8, 32, 2, 6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: ranks share cuda:0 over host-staged gloo collectives")
    from repro_torch.configs import get_config

    cfg = get_config(sr.ARCH, smoke=True)
    params_np = params_to_numpy(split_tree(init_model(torch.Generator().manual_seed(0), cfg))[0])
    _, params, _ = sr.smoke_setup(params_np)
    params = tree.tree_map(lambda t: t.cuda(), params)
    tmp = tmp_path_factory.mktemp("sharded_gpu")
    dc = DataConfig(batch=BATCH, seq_len=SEQ, seed=0)
    tr = Trainer(cfg, sr.train_config(str(tmp / "unsharded"), STEPS), params)
    losses = tr.run(data_stream(cfg, dc, device="cuda"), num_steps=STEPS, log_every=10**9)
    want = [t.cpu().numpy() for t in tree.leaves(tr.params)]
    n = sum(t.numel() for t in tree.leaves(params))
    v0 = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    probe = hessian_spectrum(params, cfg, synthetic_batch(cfg, dc, 0, device="cuda"), k=K,
                             num_iters=ITERS, v0=torch.from_numpy(v0).cuda())
    out = {}
    for shape in ((1, 2), (2, 2)):
        job = {"params": params_np, "shape": shape, "steps": STEPS, "batch": BATCH, "seq": SEQ,
               "ckpt_sharded": str(tmp / f"s{shape}"), "ckpt_unsharded": str(tmp / "unsharded"),
               "v0": v0, "k": K, "iters": ITERS, "seq_mesh": None, "device": "cuda"}
        out[shape] = run_ranks(sr.train_rank, shape[0] * shape[1], args=(job,), backend="gloo",
                               device="cuda", timeout=300)
    return {"losses": losses, "params": want, "evals": probe.eigenvalues.cpu().numpy(),
            "runs": out}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sharded_steps_on_the_card(runs, shape):
    ranks = runs["runs"][shape]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
    err = np.abs(np.asarray(ranks[0]["losses"]) - runs["losses"]).max() / max(runs["losses"])
    assert err <= 1e-5, err
    for a, b in zip(ranks[0]["params"], runs["params"]):
        e = float(np.abs(a - b).max() / np.abs(b).max())
        assert e <= 1e-4, e


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sharded_probe_on_the_card(runs, shape):
    ranks = runs["runs"][shape]
    for r in ranks:
        assert r["evals"] == ranks[0]["evals"]
        assert r["probe_launches"]["lanczos_update"] == ITERS
        assert sum(v for k, v in r["probe_launches"].items() if k != "lanczos_update") == 0
    want = runs["evals"]
    err = float(np.abs(np.asarray(ranks[0]["evals"]) - want).max() / np.abs(want).max())
    assert err <= 1e-4, err
