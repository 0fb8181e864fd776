"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427),
``repro/models/rglru.py``.

Block: x -> [gate branch: W_gate -> GeLU] * [rec branch: W_rec -> causal
depthwise conv1d(4) -> RG-LRU] -> W_out.

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = exp(-c * softplus(L) * r_t)       c = 8, L learnable
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The sequence form solves the linear recurrence h_t = a_t h_{t-1} + b_t
with the combine ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)`` of the
reference's ``jax.lax.associative_scan``, as a doubling (Hillis-Steele)
scan: ceil(log2 S) steps of elementwise ops on the whole (B, S, W) tensors,
each out of place, so the scan is twice differentiable (the Hessian probe
takes its double backward).  The decode form is the O(1) single-step
update carrying h.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import hint
from .common import Leaf, ModelConfig, dense_init

__all__ = ["init_rglru_block", "rglru_block", "rglru_decode_step", "RGLRUState",
           "init_rglru_state"]

_C = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor  # (B, W) recurrence state, f32
    conv: torch.Tensor  # (B, cw-1, W) conv tail, compute dtype


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = ()):
    d, w, cw = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.conv_width
    dt, dev, lead = cfg.param_dtype, gen.device, tuple(lead)
    # Lambda init so that a = exp(-c*softplus(L)) lands in [0.9, 0.999).
    u = torch.rand(lead + (w,), generator=gen, dtype=torch.float32, device=dev) * 0.099 + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / _C))  # inverse softplus
    conv_w = torch.randn(lead + (cw, w), generator=gen, dtype=torch.float32, device=dev) / cw

    def zeros(n):
        return torch.zeros(lead + (n,), dtype=torch.float32, device=dev)

    return {
        "w_gate": dense_init(gen, (d, w), ("embed", "lru"), dt, lead=lead),
        "w_rec": dense_init(gen, (d, w), ("embed", "lru"), dt, lead=lead),
        "w_out": dense_init(gen, (w, d), ("lru", "embed"), dt, lead=lead),
        "w_a": dense_init(gen, (w, w), (None, "lru"), dt, scale=0.0, lead=lead),
        "w_x": dense_init(gen, (w, w), (None, "lru"), dt, scale=0.0, lead=lead),
        "b_a": Leaf(zeros(w), (None,)),
        "b_x": Leaf(zeros(w), (None,)),
        "lam": Leaf(lam, (None,)),
        "conv_w": Leaf(conv_w, ("conv", "lru")),
        "conv_b": Leaf(zeros(w), (None,)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tail=None) -> torch.Tensor:
    """Depthwise causal conv1d; x: (B,S,W), w: (cw,W). tail: (B,cw-1,W)."""
    cw = w.shape[0]
    pad = tail if tail is not None else x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s, :] * w[0]
    for i in range(1, cw):
        y = y + xp[:, i:i + s, :] * w[i]
    return y + b


def _gates(p, xr: torch.Tensor):
    """Returns (log_a (B,S,W) f32, gated input (B,S,W) f32)."""
    xf = xr.float()
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(xf @ p["w_x"].float() + p["b_x"])
    log_a = -_C * F.softplus(p["lam"]) * r
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a2, 1e-9)) * (i * xf)
    return log_a, b


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0: after the step of
    offset d, (a_t, b_t) hold the combine of elements t-2d+1..t, so
    ceil(log2 S) steps leave h in b."""
    for j in range((a.shape[1] - 1).bit_length()):
        d = 1 << j
        b = b + a * F.pad(b[:, :-d], (0, 0, d, 0))
        a = a * F.pad(a[:, :-d], (0, 0, d, 0), value=1.0)
    return b


def rglru_block(p, cfg: ModelConfig, x: torch.Tensor):
    """Sequence form. x: (B,S,d) -> ((B,S,d), final RGLRUState)."""
    dt = cfg.compute_dtype
    x = x.to(dt)
    gate = F.gelu(x @ p["w_gate"].to(dt), approximate="tanh")  # jax.nn.gelu's default
    xr = x @ p["w_rec"].to(dt)
    xr = hint(xr, "batch", "act_seq", None)
    conv_tail = xr[:, -(cfg.conv_width - 1):, :]  # raw inputs: the decode conv state
    xr = _causal_conv(xr, p["conv_w"].to(dt), p["conv_b"].to(dt))
    log_a, b = _gates(p, xr)
    log_a = hint(log_a, "batch", "act_seq", None)
    b = hint(b, "batch", "act_seq", None)
    h = _linear_scan(torch.exp(log_a), b)
    h = hint(h, "batch", "act_seq", None)
    y = (h.to(dt) * gate) @ p["w_out"].to(dt)
    state = RGLRUState(h=h[:, -1], conv=conv_tail)
    return hint(y, "batch", "seq", "act_embed"), state


def init_rglru_state(cfg: ModelConfig, batch: int, device="cpu",
                     lead: Tuple[int, ...] = ()) -> RGLRUState:
    w, lead = cfg.lru_width or cfg.d_model, tuple(lead)
    return RGLRUState(
        h=torch.zeros(lead + (batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros(lead + (batch, cfg.conv_width - 1, w), dtype=cfg.compute_dtype,
                         device=device),
    )


def rglru_decode_step(p, cfg: ModelConfig, x: torch.Tensor, state: RGLRUState):
    """Single-token form. x: (B,1,d) -> ((B,1,d), new state); O(1) in the
    sequence length."""
    dt = cfg.compute_dtype
    x = x.to(dt)
    gate = F.gelu(x @ p["w_gate"].to(dt), approximate="tanh")
    xr = x @ p["w_rec"].to(dt)  # (B,1,W)
    conv_in = torch.cat([state.conv, xr], dim=1)  # (B,cw,W)
    w = p["conv_w"].to(dt)
    xr_c = conv_in[:, 0:1, :] * w[0]
    for i in range(1, w.shape[0]):
        xr_c = xr_c + conv_in[:, i:i + 1, :] * w[i]
    xr_c = xr_c + p["conv_b"].to(dt)
    log_a, b = _gates(p, xr_c)
    h = torch.exp(log_a[:, 0]) * state.h + b[:, 0]
    y = (h[:, None, :].to(dt) * gate) @ p["w_out"].to(dt)
    return y, RGLRUState(h=h, conv=conv_in[:, 1:, :])
