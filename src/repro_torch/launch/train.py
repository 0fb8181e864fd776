"""Training entry point of the port: the reference's flags, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 6 --spectral-every 3                 # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \
        --steps 20 --device cpu                      # reduced config, on the host

``--arch`` is any arch of ``repro_torch.configs.ARCHS``: the dense, MoE,
RG-LRU hybrid and SSD families.  It initializes the model from a seeded
``torch.Generator`` on ``--device`` (``cuda`` unless asked), trains with
the port's ``Trainer`` on synthetic data and, every ``--spectral-every``
steps, probes the top-K Hessian eigenvalues, listed at the end
(``training/spectral.py``: ``eigsh`` on the matrix-free HVP operator, its
Lanczos update in the ``lanczos_update`` kernel on the card).  The full
config computes in bf16, as the reference's launcher does.  A mesh
(``--mesh-model`` above 1) waits for the sharding slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--spectral-every", type=int, default=0,
                    help="every N steps, top-K Hessian eigenvalues via the paper's Lanczos")
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build(args):
    """(cfg, TrainConfig, DataConfig, params) of a command line."""
    from ..configs import get_config
    from ..models.common import split_tree
    from ..models.model import init_model
    from ..training import DataConfig, OptConfig, TrainConfig

    if args.mesh_model > 1:
        raise SystemExit("--mesh-model > 1: the sharded trainer is not ported yet (ROADMAP "
                         "queue A, item 'configs/shapes.py, distributed/sharding.py, "
                         "launch/mesh.py and launch/dryrun.py')")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is visible (pass --device cpu)")
    cfg = get_config(args.arch, smoke=args.smoke)
    if not args.smoke:
        cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    tc = TrainConfig(
        opt=OptConfig(peak_lr=args.lr, warmup_steps=max(5, args.steps // 20),
                      decay_steps=args.steps),
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        spectral_every=args.spectral_every, optimizer=args.optimizer,
    )
    dc = DataConfig(batch=args.batch, seq_len=args.seq, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    params, _ = split_tree(init_model(gen, cfg))
    return cfg, tc, dc, params


def main(argv=None):
    args = parse_args(argv)
    from ..models.common import param_count
    from ..training import Trainer, data_stream
    from ..training.data import synthetic_batch

    cfg, tc, dc, params = build(args)
    print(f"{cfg.name}: {param_count(params) / 1e6:.1f}M params ({param_count(params):,}) "
          f"on {args.device}")
    trainer = Trainer(cfg, tc, params,
                      probe_batch_fn=lambda: synthetic_batch(cfg, dc, 10**6, device=args.device))
    del params
    if args.resume and trainer.try_resume():
        print(f"resumed from step {trainer.step}")
    hist = trainer.run(data_stream(cfg, dc, start_step=trainer.step, device=args.device),
                       num_steps=args.steps)
    print(f"final loss: {np.mean(hist[-5:]):.4f} (start {hist[0]:.4f})")
    if trainer.straggler_events:
        print(f"straggler events: {len(trainer.straggler_events)}")
    if trainer.spectra:
        for step, ev in trainer.spectra.items():
            print(f"  Hessian top-|λ| @ step {step}: {ev}")
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
