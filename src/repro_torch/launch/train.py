"""Training entry point of the port: the reference's flags and mesh rule.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 6 --spectral-every 3                 # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \
        --steps 20 --device cpu                      # reduced config, on the host
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --arch qwen3-0.6b --mesh-model 2 --steps 2

``--arch`` is any arch of ``repro_torch.configs.ARCHS``: the dense, MoE,
RG-LRU hybrid, SSD, encoder-decoder and VLM families (the last two train
on synthetic batches with frames: ``--arch seamless-m4t-medium``).  It
initializes the model from a seeded ``torch.Generator`` on ``--device``
(``cuda`` unless asked), trains with the port's ``Trainer`` on synthetic
data and, every ``--spectral-every`` steps, probes the top-K Hessian
eigenvalues, listed at the end (``training/spectral.py``: Lanczos on the
matrix-free HVP operator, its update in the ``lanczos_update`` kernel on
the card).  The full config computes in bf16, as the reference's launcher
does.

The mesh rule is the reference's.  With more than one rank (``torchrun``'s
``WORLD_SIZE``/``RANK``/``LOCAL_RANK``), the ranks form a ``(data = world
// --mesh-model, model = --mesh-model)`` mesh (an error when
``--mesh-model`` does not divide the world), the params and every batch
are DTensors laid out by the logical rule engine, and training runs under
``sharding_ctx(mesh)``; the Hessian probe partitions its vector over the
ranks.  With one rank the model trains without a mesh, whatever
``--mesh-model`` says.  Ranks with a card each join over NCCL; ranks that
share a card (more ranks on a host than cards) join over gloo, their
DTensor collectives staged through the host (``distributed/host_staged.py``);
host ranks (``--device cpu``) join over gloo.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
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


def join_world(device: str):
    """Join ``torchrun``'s process group when it launched more than one
    rank; returns the world size (1: no group)."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return dist.get_world_size() if dist.is_initialized() else 1
    rank = int(os.environ["RANK"])
    backend = "gloo"
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count()
        torch.cuda.set_device(local % cards)
        if local_world <= cards:
            backend = "nccl"
        else:
            from ..distributed.host_staged import register

            register()
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    return world


def make_train_mesh(world: int, mesh_model: int, device: str):
    """The reference's rule: ``(data, model)`` over more than one rank,
    else None."""
    if world <= 1:
        return None
    if world % mesh_model:
        raise ValueError(f"--mesh-model {mesh_model} does not divide the world of {world} ranks")
    from .mesh import make_mesh

    return make_mesh((world // mesh_model, mesh_model), ("data", "model"),
                     torch.device(device).type)


def build(args):
    """(cfg, TrainConfig, DataConfig, params, axes) of a command line."""
    from ..configs import get_config
    from ..models.common import split_tree
    from ..models.model import init_model
    from ..training import DataConfig, OptConfig, TrainConfig

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
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    params, axes = split_tree(init_model(gen, cfg))
    return cfg, tc, dc, params, axes


def main(argv=None):
    import torch.distributed as dist

    args = parse_args(argv)
    from ..distributed.sharding import distribute_tree, sharding_ctx
    from ..models.common import param_count
    from ..training import Trainer, data_stream
    from ..training.data import BATCH_AXES, synthetic_batch

    world = join_world(args.device)
    rank = dist.get_rank() if world > 1 else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        mesh = make_train_mesh(world, args.mesh_model, args.device)
        if mesh is not None:
            say(f"mesh: data={world // args.mesh_model} model={args.mesh_model}")
        with sharding_ctx(mesh):
            cfg, tc, dc, params, axes = build(args)
            dev = str(torch.device("cuda", torch.cuda.current_device())
                      if torch.device(args.device).type == "cuda" else args.device)
            say(f"{cfg.name}: {param_count(params) / 1e6:.1f}M params ({param_count(params):,}) "
                f"on {args.device}")
            params = distribute_tree(params, axes)

            def place(batch):
                return {k: distribute_tree(v, BATCH_AXES[k]) for k, v in batch.items()}

            trainer = Trainer(cfg, tc, params,
                              probe_batch_fn=lambda: place(synthetic_batch(cfg, dc, 10**6,
                                                                           device=dev)))
            del params
            if args.resume and trainer.try_resume():
                say(f"resumed from step {trainer.step}")
            stream = (place(b) for b in data_stream(cfg, dc, start_step=trainer.step, device=dev))
            hist = trainer.run(stream, num_steps=args.steps, log_fn=say)
            say(f"final loss: {np.mean(hist[-5:]):.4f} (start {hist[0]:.4f})")
            if trainer.straggler_events:
                say(f"straggler events: {len(trainer.straggler_events)}")
            if trainer.spectra:
                for step, ev in trainer.spectra.items():
                    say(f"  Hessian top-|λ| @ step {step}: {ev}")
        return trainer
    finally:
        if world > 1 and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
