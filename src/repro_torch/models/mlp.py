"""MLP blocks: SwiGLU and token-choice top-K MoE (``repro/models/mlp.py``).

The MoE is GShard/Switch-style capacity-based dispatch written as einsums
over (groups, group, experts, capacity) one-hots: tokens are grouped along
the batch*seq dim, top-k experts are taken by k argmaxes (the first maximum
on ties, as ``jnp.argmax``), each token's place in its expert's queue is a
cumsum, and tokens over capacity fall through on the residual path.  An
auxiliary load-balancing loss (Switch §2.2) goes back to the trainer.
Routing (argmax, one-hots, the capacity mask) is piecewise constant, so
the Hessian-vector product differentiates through the gates and the
expert MLPs only.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import as_dtensor, current_ctx, from_local, hint, logical_spec, to_local
from .common import ModelConfig, dense_init

__all__ = ["init_mlp", "mlp", "init_moe", "moe"]


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff=None, d_in=None,
             lead: Tuple[int, ...] = ()):
    d, f = d_in or cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.param_dtype
    return {
        "wi": dense_init(gen, (d, f), ("embed", "mlp"), dt, lead=lead),
        "wg": dense_init(gen, (d, f), ("embed", "mlp"), dt, lead=lead),
        "wo": dense_init(gen, (f, d), ("mlp", "embed"), dt, lead=lead),
    }


def mlp(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.compute_dtype
    x = hint(x.to(dt), "batch", "seq", "act_embed")  # the sequence whole for the projections
    h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
    h = hint(h, "batch", "seq", "act_mlp")
    return hint(h @ p["wo"].to(dt), "batch", "seq", "act_embed")


def init_moe(gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = ()):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    p = {
        "router": dense_init(gen, (d, e), ("embed", None), torch.float32, lead=lead),
        "wi": dense_init(gen, (e, d, f), ("expert", "embed", "moe_mlp"), dt, lead=lead),
        "wg": dense_init(gen, (e, d, f), ("expert", "embed", "moe_mlp"), dt, lead=lead),
        "wo": dense_init(gen, (e, f, d), ("expert", "moe_mlp", "embed"), dt, lead=lead),
    }
    if cfg.dense_residual:  # arctic: dense MLP in parallel with the MoE
        p["dense"] = init_mlp(gen, cfg, lead=lead)
    return p


def _expert_ffn(xe, wg, wi, wo):
    hg = F.silu(torch.einsum("gecd,edf->gecf", xe, wg))
    hi = torch.einsum("gecd,edf->gecf", xe, wi)
    return torch.einsum("gecf,efd->gecd", hg * hi, wo)


def _experts(p, xe, dt):
    """The experts' SwiGLU on the dispatched tokens (ng, e, cap, d).

    Under a mesh it runs on each rank's shards: the groups split as the
    batch, the experts' FSDP (``embed``) dimension gathered, and the
    ``model`` axis on the experts (expert parallel: each rank its experts'
    tokens) or on their hidden dimension (``moe_mlp``, tensor parallel:
    each rank a partial sum of every expert's output).  The weights'
    gradients are partial sums over the batch axes, the tokens' over a
    tensor-parallel axis."""
    wg, wi, wo = p["wg"].to(dt), p["wi"].to(dt), p["wo"].to(dt)
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None:
        return _expert_ffn(xe, wg, wi, wo)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = ctx.mesh
    batch = logical_spec(tuple(xe.shape), ("batch", None, None, None), ctx)[0]
    batch = set((batch,) if isinstance(batch, str) else (batch or ()))
    xe_pl, w_pl, wo_pl, out_pl, xe_grad, w_grad, wo_grad = ([] for _ in range(7))
    for name, pw in zip(mesh.mesh_dim_names, as_dtensor(p["wi"], mesh).placements):
        ep = pw.is_shard() and pw.dim == 0  # experts split over this axis
        tp = pw.is_shard() and pw.dim == 2  # every expert's hidden dim split
        if name in batch:
            xe_pl.append(Shard(0)), out_pl.append(Shard(0)), xe_grad.append(Shard(0))
        elif ep:
            xe_pl.append(Shard(1)), out_pl.append(Shard(1)), xe_grad.append(Shard(1))
        else:
            xe_pl.append(Replicate()), out_pl.append(Partial() if tp else Replicate())
            xe_grad.append(Partial() if tp else Replicate())
        w_pl.append(Shard(0) if ep else Shard(2) if tp else Replicate())
        wo_pl.append(Shard(0) if ep else Shard(1) if tp else Replicate())
        w_grad.append(Partial() if name in batch else w_pl[-1])
        wo_grad.append(Partial() if name in batch else wo_pl[-1])
    y = _expert_ffn(to_local(xe, mesh, xe_pl, xe_grad), to_local(wg, mesh, w_pl, w_grad),
                    to_local(wi, mesh, w_pl, w_grad), to_local(wo, mesh, wo_pl, wo_grad))
    return from_local(y, mesh, out_pl, tuple(xe.shape))


def moe(p, cfg: ModelConfig, x: torch.Tensor, dropless: bool = False):
    """Returns (output (B,S,d), aux load-balance loss, an f32 scalar).

    ``dropless=True`` (serving): capacity is 4x the fair share instead of
    the training ``capacity_factor``, and a group of at most 2x the experts
    (single-token decode) gets the whole group as capacity, as in the
    reference.
    """
    dt = cfg.compute_dtype
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    gs = min(cfg.moe_group_size, b * s)
    ng = (b * s) // gs
    if ng * gs != b * s:
        raise ValueError(f"tokens {b * s} are not a multiple of the MoE group {gs}")
    if dropless:
        cap = gs if gs <= 2 * e else min(gs, int(gs * k / e * 4.0) + 1)
    else:
        cap = min(gs, int(gs * k / e * cfg.capacity_factor) + 1)

    x = hint(x, "batch", "seq", "act_embed")  # the sequence whole: groups cut (B * S)
    xt = hint(x.reshape(ng, gs, d), "batch", None, "act_embed")
    logits = xt.float() @ p["router"].float()  # (ng, gs, e)
    probs = torch.softmax(logits, dim=-1)

    # top-k routing with capacity: take the argmax k times
    gates = torch.zeros_like(probs)
    rem = probs
    for _ in range(k):
        oh = F.one_hot(rem.argmax(dim=-1), e).to(probs.dtype)
        gates = gates + rem * oh
        rem = rem * (1.0 - oh)
    mask = gates > 0.0

    # capacity: each token's place in its expert's queue
    pos_in_e = torch.cumsum(mask.to(torch.int32), dim=1) - 1  # (ng, gs, e)
    keep = mask & (pos_in_e < cap)
    gates = torch.where(keep, gates, torch.zeros((), dtype=gates.dtype, device=gates.device))
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # dispatch/combine one-hots (GShard): (ng, gs, e, cap).  A dropped
    # token's row is zero (``jax.nn.one_hot(-1)``; ``F.one_hot`` takes no -1)
    cap_oh = F.one_hot(pos_in_e.clamp(0, cap - 1).long(), cap).to(dt) * keep[..., None].to(dt)
    combine = gates[..., None].to(dt) * cap_oh

    xe = torch.einsum("gsec,gsd->gecd", cap_oh, xt.to(dt))  # (ng, e, cap, d)
    xe = hint(xe, "batch", "act_expert", None, None)
    ye = _experts(p, xe, dt)
    ye = hint(ye, "batch", "act_expert", None, None)
    y = torch.einsum("gsec,gecd->gsd", combine, ye).reshape(b, s, d)

    # Switch aux loss: e * sum_e (fraction routed to e) * (mean router prob e)
    frac = mask.float().mean(dim=(0, 1)) / k
    imp = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac * imp)

    if cfg.dense_residual:
        y = y + mlp(p["dense"], cfg, x)
    return hint(y, "batch", "seq", "act_embed"), aux
