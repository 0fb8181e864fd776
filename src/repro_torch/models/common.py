"""Shared model substrate: config, param machinery, norms, RoPE / M-RoPE.

The reference's design (``repro/models/common.py``): parameters are built as
trees of ``Leaf(value, axes)``, where ``axes`` are the logical sharding axes;
``split_tree`` separates them into a plain value tree (what the apply
functions take) and an axes tree (layout metadata).  Values are tensors on
the device of the ``torch.Generator`` that draws them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..core import tree as _tree

__all__ = [
    "ModelConfig",
    "Leaf",
    "split_tree",
    "dense_init",
    "rms_norm",
    "apply_rope",
    "make_positions",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's config, field for field; dtypes are torch dtypes."""

    name: str
    family: str  # dense | moe | hybrid_rglru | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    window: Optional[int] = None  # sliding-window (mixtral SWA / rg local attn)
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    # MoE
    n_experts: int = 0
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    moe_group_size: int = 512
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    # hybrid (recurrentgemma)
    block_pattern: Tuple[str, ...] = ()
    lru_width: Optional[int] = None
    conv_width: int = 4
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 64
    # encoder-decoder
    n_enc_layers: int = 0
    frontend: Optional[str] = None  # 'audio' | 'vision' (stub: embeddings given)
    # numerics / execution
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    remat: str = "full"  # 'none' | 'full' | 'dots' (the port recomputes whole layers for both)
    scan_layers: bool = True
    vocab_round: int = 128
    # attention micro-tiling (online-softmax KV chunk)
    attn_chunk: int = 1024
    kv_cache_dtype: str = "bf16"  # 'bf16' | 'int8' (quantized serving cache)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // self.vocab_round) * self.vocab_round

    @property
    def d_inner(self) -> int:  # mamba2
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def params_count_note(self) -> str:
        return f"{self.name}: {self.n_layers}L d={self.d_model}"


@dataclasses.dataclass
class Leaf:
    """Parameter leaf with logical sharding axes metadata."""

    value: torch.Tensor
    axes: Tuple[Optional[str], ...]


def _map_leaves(fn, tree):
    if isinstance(tree, Leaf):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return tree


def split_tree(tree):
    """Tree of Leaf -> (values tree, axes tree)."""
    return _map_leaves(lambda l: l.value, tree), _map_leaves(lambda l: l.axes, tree)


def dense_init(gen: torch.Generator, shape, axes, dtype, scale: Optional[float] = None,
               lead: Tuple[int, ...] = ()) -> Leaf:
    """Truncated-normal fan-in init with logical axes: N(0, 1) cut at +-2,
    times ``1 / sqrt(shape[0])`` unless ``scale`` is given.  ``lead`` stacks
    independent draws on leading axes (the layer stack); the fan-in is the
    per-layer one."""
    fan_in = shape[0]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    v = torch.empty(tuple(lead) + tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return Leaf((v * s).to(dtype), tuple(axes))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with an f32 statistic; ``x`` keeps its dtype (the reference's
    contract: bf16 x bf16 products are exact in f32, so the mean square is
    the upcast one up to summation order), scaled by ``1 + scale``."""
    xf = x.float()
    var = (xf * xf).sum(-1, keepdim=True) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


def _rope_freqs(hd_half: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(hd_half, dtype=torch.float32, device=device) / hd_half))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
               sections: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Rotary embedding, half-split convention.

    x: (B, S, H, D).  pos: (B, S) int, or (3, B, S) for M-RoPE, where the
    three planes are (temporal, height, width) position ids and ``sections``
    partitions the D/2 frequency slots among them (qwen2-vl).
    """
    d = x.shape[-1]
    half = d // 2
    freqs = _rope_freqs(half, theta, x.device)
    if sections is None:
        angles = pos.float()[..., None] * freqs  # (B, S, half)
    else:
        if pos.ndim != 3:
            raise ValueError("M-RoPE needs (3, B, S) positions")
        secs, off = [], 0
        for i, w in enumerate(sections):
            secs.append(pos[i].float()[..., None] * freqs[off:off + w])
            off += w
        if off != half:
            raise ValueError(f"mrope sections {sections} must sum to {half}")
        angles = torch.cat(secs, dim=-1)
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def make_positions(batch: int, seq: int, offset=0, mrope: bool = False,
                   device="cpu") -> torch.Tensor:
    p = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    p = p.expand(batch, seq)
    if mrope:
        return p[None].expand(3, batch, seq)
    return p


def param_count(params) -> int:
    return sum(t.numel() for t in _tree.leaves(params))
