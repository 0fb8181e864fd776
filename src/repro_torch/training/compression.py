"""Gradient compression for the data-parallel reduction
(``repro/training/compression.py``).

Per-tensor symmetric int8 quantization.  ``compress_tree`` is the stateless
form (quantize -> dequantize before the reduction); ``EFState`` carries the
error-feedback residual across steps (Seide et al.).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..core import tree as _tree

__all__ = ["quantize_int8", "dequantize_int8", "compress_tree", "EFState", "init_ef_state",
           "ef_compress_tree"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = x.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: Any) -> Any:
    """Quantize-dequantize every leaf (simulates int8 on the wire)."""

    def qdq(g):
        q, s = quantize_int8(g.float())
        return dequantize_int8(q, s).to(g.dtype)

    return _tree.tree_map(qdq, grads)


class EFState(NamedTuple):
    residual: Any  # params-shaped error-feedback buffers (f32)


def init_ef_state(params) -> EFState:
    return EFState(residual=_tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def ef_compress_tree(grads: Any, ef: EFState) -> Tuple[Any, EFState]:
    """Classic error feedback: compress (g + residual), carry the error."""

    def step(g, r):
        x = g.float() + r
        q, s = quantize_int8(x)
        dq = dequantize_int8(q, s)
        return dq.to(g.dtype), x - dq

    outs = [step(g, r) for g, r in zip(_tree.leaves(grads), _tree.leaves(ef.residual))]
    return (_tree.unflatten(grads, [o[0] for o in outs]),
            EFState(residual=_tree.unflatten(grads, [o[1] for o in outs])))
