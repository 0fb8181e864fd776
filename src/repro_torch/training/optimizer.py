"""AdamW + warmup-cosine schedule + global-norm clipping, and the factored
Adafactor variant (``repro/training/optimizer.py``).

Functional, as the reference: an update returns new params and a new state
(trees shaped like the params, f32 moments), so the trainer's rollback and
checkpoint keep the old ones intact.  The step, the learning rate and the
norms stay 0-d tensors on the params' device: no read-back per step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from ..core import tree as _tree

__all__ = ["OptConfig", "OptState", "init_opt_state", "adamw_update", "lr_at", "global_norm",
           "FactoredState", "init_factored_state", "adafactor_update"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any  # first moment (params-shaped, f32)
    v: Any  # second moment


def _device(params):
    ls = _tree.leaves(params)
    return ls[0].device if ls else torch.device("cpu")


def init_opt_state(params) -> OptState:
    def zeros():
        return _tree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)

    return OptState(step=torch.zeros((), dtype=torch.int32, device=_device(params)),
                    m=zeros(), v=zeros())


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in _tree.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


class FactoredState(NamedTuple):
    """Adafactor-style second-moment factorization (Shazeer & Stern 2018):
    for an N-D parameter (..., n, m) the second moment is stored as row and
    column running means (..., n) and (..., m)."""

    step: torch.Tensor
    vr: Any  # row second moments (or full v for vectors/scalars)
    vc: Any  # col second moments (0-d zeros for vectors)


def init_factored_state(params) -> FactoredState:
    def rows(p):
        shape = p.shape[:-1] if p.ndim >= 2 else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def cols(p):
        shape = p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else ()
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return FactoredState(step=torch.zeros((), dtype=torch.int32, device=_device(params)),
                         vr=_tree.tree_map(rows, params), vc=_tree.tree_map(cols, params))


def adafactor_update(grads, state: FactoredState, params,
                     cfg: OptConfig) -> Tuple[Any, FactoredState, dict]:
    """Adafactor (no momentum, fixed beta2) with update clipping."""
    step = state.step + 1
    gnorm = global_norm(grads)
    b2 = cfg.b2
    lr = lr_at(cfg, step)

    def upd_slice(p, g, vr, vc):
        g = g.float()
        g2 = g * g + 1e-30
        if p.ndim >= 2:
            vr2 = b2 * vr + (1 - b2) * g2.mean(dim=-1)
            vc2 = b2 * vc + (1 - b2) * g2.mean(dim=-2)
            denom = vr2.mean(dim=-1, keepdim=True)
            vhat = (vr2 / torch.clamp_min(denom, 1e-30))[..., None] * vc2[..., None, :]
            u = g / (torch.sqrt(vhat) + cfg.eps)
        else:
            vr2 = b2 * vr + (1 - b2) * g2
            vc2 = vc
            u = g / (torch.sqrt(vr2) + cfg.eps)
        # update clipping by RMS (Adafactor's d=1.0 rule)
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp_min(rms_u, 1.0)
        new_p = p.float() - lr * (u + cfg.weight_decay * p.float())
        return new_p.to(p.dtype), vr2, vc2

    def upd(p, g, vr, vc):
        # Stacked-layer leaves: one slice at a time, as the reference scans
        # (the clipping RMS is per slice, and the f32 temporaries stay small).
        if p.ndim >= 3 and p.shape[0] > 1:
            outs = [upd_slice(*sl) for sl in zip(p.unbind(0), g.unbind(0), vr.unbind(0),
                                                  vc.unbind(0))]
            return tuple(torch.stack([o[j] for o in outs]) for j in range(3))
        return upd_slice(p, g, vr, vc)

    outs = [upd(*xs) for xs in zip(_tree.leaves(params), _tree.leaves(grads),
                                   _tree.leaves(state.vr), _tree.leaves(state.vc))]
    new_params = _tree.unflatten(params, [o[0] for o in outs])
    vr = _tree.unflatten(params, [o[1] for o in outs])
    vc = _tree.unflatten(params, [o[2] for o in outs])
    return new_params, FactoredState(step=step, vr=vr, vc=vc), {"grad_norm": gnorm, "lr": lr}


def adamw_update(grads, state: OptState, params, cfg: OptConfig) -> Tuple[Any, OptState, dict]:
    """Returns (new_params, new_state, metrics)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    lr = lr_at(cfg, step)

    new_p, new_m, new_v = [], [], []
    for p, g, mm, vv in zip(_tree.leaves(params), _tree.leaves(grads), _tree.leaves(state.m),
                            _tree.leaves(state.v)):
        g = g.float() * scale
        m = b1 * mm + (1 - b1) * g
        v = b2 * vv + (1 - b2) * g * g
        del g
        pf = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * pf
        new_p.append((pf - lr * delta).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return (_tree.unflatten(params, new_p),
            OptState(step=step, m=_tree.unflatten(params, new_m), v=_tree.unflatten(params, new_v)),
            {"grad_norm": gnorm, "lr": lr})
