"""End-to-end LM training driver example on the PyTorch port, the
counterpart of ``examples/train_lm.py``.

Trains a width-reduced mamba2-family model (~15M params; pass --full for the
real mamba2-130m config) for a few hundred steps on the deterministic
synthetic stream, with checkpointing, NaN rollback, and the paper-integrated
spectral monitor (top-K Hessian eigenvalues via mixed-precision Lanczos)
enabled.  Runs on the card unless ``--device cpu``:

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 [--device cpu]
"""

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.tree import tree_map
from repro_torch.models.common import param_count, split_tree
from repro_torch.models.model import init_model
from repro_torch.training import DataConfig, OptConfig, TrainConfig, Trainer, data_stream
from repro_torch.training.data import synthetic_batch


def model_config(arch: str, full: bool):
    """The arch's full config, or its smoke config scaled up to ~15M params."""
    cfg = get_config(arch, smoke=not full)
    if not full:  # scale the smoke config up to ~15M params
        cfg = dataclasses.replace(cfg, d_model=256, n_layers=6, vocab=8192,
                                  ssm_state=64 if cfg.family == "ssm" else cfg.ssm_state)
    return cfg


def main(argv=None):
    """Runs the example; returns the :class:`Trainer` (its ``spectra`` hold
    the monitor's probes)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--full", action="store_true", help="use the full config (slow on CPU)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = model_config(args.arch, args.full)
    # weights from a seeded host generator: the same on either device
    params, _ = split_tree(init_model(torch.Generator().manual_seed(0), cfg))
    params = tree_map(lambda t: t.to(args.device), params)
    n_params = param_count(params)
    print(f"{cfg.name} (reduced={not args.full}): {n_params/1e6:.1f}M params")

    dc = DataConfig(batch=args.batch, seq_len=args.seq, seed=0)
    tc = TrainConfig(
        opt=OptConfig(peak_lr=3e-3, warmup_steps=20, decay_steps=args.steps),
        ckpt_every=100, ckpt_dir=args.ckpt_dir,
        spectral_every=max(50, args.steps // 3), spectral_k=3,
    )
    trainer = Trainer(cfg, tc, params,
                      probe_batch_fn=lambda: synthetic_batch(cfg, dc, 10**6, device=args.device))
    hist = trainer.run(data_stream(cfg, dc, device=args.device), num_steps=args.steps,
                       log_every=25)
    print(f"loss: {hist[0]:.3f} -> {np.mean(hist[-10:]):.3f} over {len(hist)} steps")
    for step, ev in trainer.spectra.items():
        print(f"Hessian top-3 |λ| @ step {step}: {np.round(ev, 4)}")
    return trainer


if __name__ == "__main__":
    main()
