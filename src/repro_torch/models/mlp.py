"""MLP blocks: SwiGLU (``repro/models/mlp.py``'s dense half).

``init_moe`` and ``moe`` wait for the MoE family.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, dense_init

__all__ = ["init_mlp", "mlp"]


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
    x = x.to(dt)
    h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
    return h @ p["wo"].to(dt)
