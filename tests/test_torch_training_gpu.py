"""The LM training path and its Hessian monitor on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither ``jax`` nor the reference package, so it runs on a machine that has
only PyTorch: from the repository root,

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_training_gpu.py

At the qwen3 smoke config (f32): the card's HVP within rel 1e-5 of max |Hv|
of the host's; a probe launches ``lanczos_update`` once a Lanczos step and
no SpMV kernel; the card's training losses within rel 1e-4 of the host's
over three steps (AdamW divides by sqrt(v), which magnifies sum-order
differences in near-zero gradients); checkpoints round-trip on the card.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.core.operators import HvpOperator
from repro_torch.kernels import lanczos_update, mixed_dot, spmv_bsr, spmv_ell
from repro_torch.kernels import lanczos_fused, spmv_ell_packed
from repro_torch.models.common import split_tree
from repro_torch.models.model import init_model, loss_fn
from repro_torch.training import (
    CheckpointManager,
    DataConfig,
    OptConfig,
    TrainConfig,
    Trainer,
    data_stream,
    synthetic_batch,
)
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.spectral import hessian_spectrum

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-0.6b"
KERNELS = (spmv_ell.spmv_ell_kernel_call, lanczos_update.lanczos_update_kernel_call,
           lanczos_fused.spmv_ell_alpha_kernel_call, spmv_bsr.spmv_bsr_kernel_call,
           spmv_ell_packed.spmv_ell_packed_kernel_call, mixed_dot.mixed_dot_kernel_call)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def smoke():
    cfg = get_config(ARCH, smoke=True)
    params = split_tree(init_model(torch.Generator().manual_seed(1), cfg))[0]
    batch = synthetic_batch(cfg, DataConfig(batch=2, seq_len=16, seed=5), 0)
    return cfg, params, batch


def _on(tree_or_batch, dev):
    if isinstance(tree_or_batch, dict) and "tokens" in tree_or_batch:
        return {k: v.to(dev) for k, v in tree_or_batch.items()}
    return tree.tree_map(lambda t: t.to(dev), tree_or_batch)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hvp_card_matches_host(cuda, smoke, seed):
    cfg, params, batch = smoke
    host = HvpOperator(lambda p: loss_fn(p, cfg, batch)[0], params)
    b = _on(batch, cuda)
    card = HvpOperator(lambda p: loss_fn(p, cfg, b)[0], _on(params, cuda))
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(host.n).astype(np.float32))
    want = host.matvec(x)
    got = card.matvec(x.to(cuda)).cpu()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-5, f"HVP card vs host: rel err {err:.3e}"


@pytest.mark.gpu
def test_probe_runs_the_update_kernel(cuda, smoke):
    cfg, params, batch = smoke
    for fn in KERNELS:
        fn.launches = 0
    res = hessian_spectrum(_on(params, cuda), cfg, _on(batch, cuda), k=4)
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    assert launches.pop("lanczos_update_kernel_call") == 8
    assert all(v == 0 for v in launches.values()), launches
    ev = res.eigenvalues.cpu().numpy()
    assert np.isfinite(ev).all() and np.all(np.diff(np.abs(ev)) <= 0)
    host = hessian_spectrum(params, cfg, batch, k=4, v0=_start(res))
    err = float(np.abs(host.eigenvalues.numpy() - ev).max() / np.abs(ev).max())
    assert err <= 1e-4, f"probe card vs host, same start vector: rel err {err:.3e}"


def _start(res) -> np.ndarray:
    """The card probe's start vector: the seeded draw on the card."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    return torch.randn((res.n,), generator=gen, device="cuda").cpu().numpy()


@pytest.mark.gpu
def test_training_card_matches_host(cuda, smoke, tmp_path):
    cfg, params, _ = smoke
    dc = DataConfig(batch=4, seq_len=32, seed=2)
    hist = {}
    for dev in ("cpu", cuda):
        tc = TrainConfig(opt=OptConfig(warmup_steps=1, decay_steps=3),
                         ckpt_dir=str(tmp_path / str(dev)), async_ckpt=False)
        tr = Trainer(cfg, tc, _on(params, dev))
        hist[str(dev)] = tr.run(data_stream(cfg, dc, device=dev), num_steps=3,
                                log_fn=lambda *_: None)
    a, b = np.array(hist["cpu"]), np.array(hist["cuda"])
    err = float(np.abs(a - b).max() / np.abs(a).max())
    assert err <= 1e-4, f"losses {b} vs {a}: rel err {err:.3e}"


@pytest.mark.gpu
def test_checkpoint_round_trip_on_the_card(cuda, smoke, tmp_path):
    _, params, _ = smoke
    p = _on(params, cuda)
    tmpl = {"params": p, "opt": init_opt_state(p)}
    mgr = CheckpointManager(str(tmp_path), keep_n=1, async_write=True)
    mgr.save(5, tmpl)
    step, got, _ = mgr.restore_latest(tmpl)
    assert step == 5
    for a, b in zip(tree.leaves(got), tree.leaves(tmpl)):
        assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.gpu
def test_launch_train_runs_on_the_card_by_default(cuda, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--smoke",
         "--steps", "4", "--spectral-every", "2", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "on cuda" in out.stdout and out.stdout.count("Hessian top-|λ|") == 2, out.stdout
