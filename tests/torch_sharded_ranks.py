"""Rank functions of the sharded-trainer tests (``launch.ranks.run_ranks``
imports this module in each spawned rank, so it imports no ``jax``).

``train_rank`` takes the reference's smoke qwen3 weights as NumPy, lays
them out over a ``(data, model)`` mesh of the gloo ranks and runs, in
order: ``steps`` AdamW steps of the port's ``Trainer`` (checkpointing the
last one, whole, from rank 0), a resume of the unsharded run's checkpoint
into DTensors, the sharded Hessian probe from an explicit start vector, and
optionally the loss and gradients on a second mesh whose model axis does
not divide the KV heads (the attention core's sequence split).
"""

from __future__ import annotations

import numpy as np
import torch

ARCH = "qwen3-0.6b"


def smoke_setup(params_np):
    """(cfg, port params, axes) of the smoke qwen3 from NumPy weights."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import MetaGenerator, split_tree
    from repro_torch.models.model import init_model, params_from_numpy

    cfg = get_config(ARCH, smoke=True)
    _, axes = split_tree(init_model(MetaGenerator(), cfg))
    return cfg, params_from_numpy(params_np, device="cpu"), axes


def train_config(ckpt_dir: str, steps: int):
    from repro_torch.training import OptConfig, TrainConfig

    return TrainConfig(opt=OptConfig(warmup_steps=2, decay_steps=10), ckpt_every=steps,
                       ckpt_dir=ckpt_dir, async_ckpt=False)


def _whole_np(tree_):
    from torch.distributed.tensor import DTensor

    from repro_torch.core import tree

    return [(t.full_tensor() if isinstance(t, DTensor) else t).detach().cpu().numpy()
            for t in tree.leaves(tree_)]


def _launches() -> dict:
    """Each kernel wrapper's launch count (they count only on the card)."""
    from repro_torch.kernels import (
        lanczos_fused,
        lanczos_update,
        mixed_dot,
        spmv_bsr,
        spmv_ell,
        spmv_ell_packed,
    )

    fns = {"spmv_ell": spmv_ell.spmv_ell_kernel_call,
           "lanczos_update": lanczos_update.lanczos_update_kernel_call,
           "lanczos_update_multi": lanczos_update.lanczos_update_multi_kernel_call,
           "spmv_ell_alpha": lanczos_fused.spmv_ell_alpha_kernel_call,
           "spmv_bsr": spmv_bsr.spmv_bsr_kernel_call,
           "spmv_ell_packed": spmv_ell_packed.spmv_ell_packed_kernel_call,
           "mixed_dot": mixed_dot.mixed_dot_kernel_call}
    return {k: int(getattr(f, "launches", 0)) for k, f in fns.items()}


def _loss_and_grads(params, cfg, batch):
    from repro_torch.core import tree
    from repro_torch.distributed.sharding import settle
    from repro_torch.models.model import loss_fn

    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss, _ = loss_fn(tree.unflatten(params, leaves), cfg, batch)
    loss = settle(loss)
    grads = torch.autograd.grad(loss, leaves)
    return loss, grads


def train_rank(rank: int, world: int, job: dict) -> dict:
    import torch.distributed as dist

    from repro_torch.core import tree
    from repro_torch.distributed.sharding import distribute_tree, sharding_ctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import DataConfig, Trainer, data_stream, synthetic_batch
    from repro_torch.training.data import BATCH_AXES
    from repro_torch.training.spectral import hessian_spectrum

    dev = job.get("device", "cpu")
    cfg, params, axes = smoke_setup(job["params"])
    params = tree.tree_map(lambda t: t.to(dev), params)
    dc = DataConfig(batch=job["batch"], seq_len=job["seq"], seed=0)
    out = {}
    mesh = make_mesh(job["shape"], ("data", "model"), torch.device(dev).type)
    with sharding_ctx(mesh):
        dp = distribute_tree(params, axes)

        def place(b):
            return {k: distribute_tree(v, BATCH_AXES[k]) for k, v in b.items()}

        tr = Trainer(cfg, train_config(job["ckpt_sharded"], job["steps"]), dp)
        out["losses"] = tr.run((place(b) for b in data_stream(cfg, dc, device=dev)),
                               num_steps=job["steps"], log_every=10**9)
        out["placements"] = [str(t.placements) for t in tree.leaves(tr.params)]
        out["opt_placements"] = [str(t.placements) for t in tree.leaves(tr.opt_state.m)]
        out["local_bytes"] = sum(t.to_local().numel() * t.to_local().element_size()
                                 for t in tree.leaves((tr.params, tr.opt_state.m, tr.opt_state.v)))
        whole = _whole_np(tr.params)  # every rank gathers
        if rank == 0:
            out["params"] = whole
        # the unsharded run's checkpoint, resumed into this layout
        back = Trainer(cfg, train_config(job["ckpt_unsharded"], job["steps"]), dp)
        out["resumed"] = back.try_resume()
        out["resumed_step"] = back.step
        out["resume_err"] = max(float(np.abs(a - b).max())
                                for a, b in zip(_whole_np(back.params), whole))
        out["resumed_layout"] = [str(t.placements) for t in tree.leaves(back.params)] == \
            out["placements"]
        if job.get("force_patch"):
            # the differentiable DTensor backwards the card's PyTorch needs,
            # forced here: one sharded HVP against the unsharded one
            from repro_torch.core.operators import HvpOperator
            from repro_torch.distributed.sharding import differentiable_backwards
            from repro_torch.models.model import loss_fn

            differentiable_backwards(force=True)
            batch = place(synthetic_batch(cfg, dc, 0, device=dev))
            op = HvpOperator(lambda p: loss_fn(p, cfg, batch)[0], dp)
            got = op.matvec(op.local_slices(torch.from_numpy(job["hvp_x"]).to(dev)))
            want = op.local_slices(torch.from_numpy(job["hvp_want"]).to(dev))
            out["patched_hvp_err"] = float((got - want).abs().max() / want.abs().max())
        if not job.get("probe", True):
            dist.barrier()
            return out
        # the sharded probe from the parent's start vector
        batch = place(synthetic_batch(cfg, dc, 0, device=dev))
        before = _launches()
        res = hessian_spectrum(dp, cfg, batch, k=job["k"], num_iters=job["iters"],
                               v0=torch.from_numpy(job["v0"]).to(dev))
        out["probe_launches"] = {k: v - before[k] for k, v in _launches().items()}
        out["evals"] = res.eigenvalues.detach().cpu().numpy().tolist()
        out["n_local"] = int(res.partition["n_local"])
    if job.get("seq_mesh"):
        mesh2 = make_mesh(job["seq_mesh"], ("data", "model"), "cpu")
        with sharding_ctx(mesh2):
            batch = {k: distribute_tree(v, BATCH_AXES[k])
                     for k, v in synthetic_batch(cfg, dc, 0, device="cpu").items()}
            loss, grads = _loss_and_grads(distribute_tree(params, axes), cfg, batch)
            out["seq_loss"] = float(loss.to_local())
            grads = [g.full_tensor().numpy() for g in grads]
            if rank == 0:
                out["seq_grads"] = grads
    dist.barrier()
    return out


def staged_rank(rank: int, world: int) -> dict:
    """The host-staged collectives against gloo's own on host tensors."""
    import torch.distributed as dist

    from repro_torch.distributed import host_staged as hs

    name = dist.group.WORLD.group_name
    x = torch.arange(8, dtype=torch.float32) + 10 * rank
    ag_ref = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(ag_ref, x)
    ar_ref = x.clone()
    dist.all_reduce(ar_ref)
    a2a_ref = torch.empty_like(x)
    dist.all_to_all_single(a2a_ref, x)
    bc_ref = x.clone()
    dist.broadcast(bc_ref, 1)
    return {"ag": hs.all_gather_into_tensor(x, world, name).tolist(),
            "ag_ref": torch.cat(ag_ref).tolist(),
            "ar": hs.all_reduce(x, "sum", name).tolist(), "ar_ref": ar_ref.tolist(),
            "rs": hs.reduce_scatter_tensor(x, "sum", world, name).tolist(),
            "rs_ref": ar_ref.chunk(world)[rank].tolist(),
            "a2a": hs.all_to_all_single(x, None, None, name).tolist(),
            "a2a_ref": a2a_ref.tolist(),
            "bc": hs.broadcast(x, 1, name).tolist(), "bc_ref": bc_ref.tolist()}
