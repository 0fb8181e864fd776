"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060),
``repro/models/ssd.py``.

The SSD form computes the selective-SSM recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;   y_t = C_t . h_t + D x_t

in *chunks*: within a chunk the input-output map is an attention-like
lower-triangular matmul; across chunks a Python loop (the reference's
``lax.scan``) carries the (H, P, N) state, so only one chunk's (L x L)
decay matrix is live.  Decode is the O(1) recurrence update.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..distributed.sharding import hint, keep_layout, split_last
from .common import Leaf, ModelConfig, dense_init, rms_norm
from .rglru import _causal_conv  # the same depthwise causal conv

__all__ = ["init_ssd_block", "ssd_block", "ssd_decode_step", "SSDState", "init_ssd_state"]


class SSDState(NamedTuple):
    h: torch.Tensor  # (B, H, P, N) SSM state, f32
    conv: torch.Tensor  # (B, cw-1, conv_dim) conv tail, compute dtype


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    h = cfg.n_ssm_heads
    p = cfg.ssm_headdim
    n = cfg.ssm_state
    conv_dim = di + 2 * n  # conv over (x, B, C)
    return di, h, p, n, conv_dim


def init_ssd_block(gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = ()):
    d = cfg.d_model
    di, h, p, n, conv_dim = _dims(cfg)
    dev, lead = gen.device, tuple(lead)
    in_dim = 2 * di + 2 * n + h  # z, x, B, C, dt
    lo, hi = torch.log(torch.tensor(1e-3)), torch.log(torch.tensor(1e-1))
    u = torch.rand(lead + (h,), generator=gen, dtype=torch.float32, device=dev) * (hi - lo) + lo
    dt_bias = torch.log(torch.expm1(torch.exp(u)))  # inverse softplus of dt in [1e-3, 1e-1)
    conv_w = torch.randn(lead + (cfg.conv_width, conv_dim), generator=gen, dtype=torch.float32,
                         device=dev) / cfg.conv_width
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=dev)).expand(lead + (h,))
    return {
        "w_in": dense_init(gen, (d, in_dim), ("embed", "ssm_inner"), cfg.param_dtype, lead=lead),
        "w_out": dense_init(gen, (di, d), ("ssm_inner", "embed"), cfg.param_dtype, lead=lead),
        "conv_w": Leaf(conv_w, ("conv", "ssm_inner")),
        "conv_b": Leaf(torch.zeros(lead + (conv_dim,), dtype=torch.float32, device=dev), (None,)),
        "a_log": Leaf(a_log.clone(), ("ssm_heads",)),
        "dt_bias": Leaf(dt_bias, ("ssm_heads",)),
        "d_skip": Leaf(torch.ones(lead + (h,), dtype=torch.float32, device=dev), ("ssm_heads",)),
        "out_norm": Leaf(torch.zeros(lead + (di,), dtype=torch.float32, device=dev), (None,)),
    }


def _split_proj(p, cfg: ModelConfig, u: torch.Tensor):
    """u: (B,S,d) -> z (B,S,di), xbc (B,S,conv_dim), dt (B,S,H) pre-softplus."""
    di, _, _, _, conv_dim = _dims(cfg)
    dt_ = cfg.compute_dtype
    u = hint(u.to(dt_), "batch", "seq", "act_embed")  # the sequence whole for the projection
    zxbcdt = u @ p["w_in"].to(dt_)
    return zxbcdt[..., :di], zxbcdt[..., di:di + conv_dim], zxbcdt[..., di + conv_dim:]


def _ssd_chunked(x, dt, a, b, c, chunk: int, h0=None):
    """Chunked SSD scan.

    x: (B,S,H,P); dt: (B,S,H) (post-softplus); a: (H,) negative;
    b, c: (B,S,N) (single group, broadcast over heads).
    Returns (y (B,S,H,P), h_final (B,H,P,N)).

    The intra-chunk decay exp(dac_i - dac_j) is masked *before* the ``exp``
    (-inf above the diagonal, so the exponential is 0 there): the reference
    masks after it, which gives the same values, but an ``exp`` that
    overflows above the diagonal (long chunks, large |A|) would put
    0 * inf = NaN into the backward pass.
    """
    bsz, s, nh, p = x.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the SSD chunk {chunk}")
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    h = h0 if h0 is not None else x.new_zeros((bsz, nh, p, n), dtype=torch.float32)
    ys = []
    for j in range(s // chunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        xj, dtj, bj, cj = x[:, sl], dt[:, sl], b[:, sl], c[:, sl]  # (B,L,H,P) (B,L,H) (B,L,N) x2
        dac = torch.cumsum(dtj * a, dim=1)  # (B,L,H), inclusive
        # intra-chunk: y_i += sum_{j<=i} (C_i.B_j) exp(dac_i - dac_j) dt_j x_j
        scores = torch.einsum("bin,bjn->bij", cj, bj)
        diff = dac[:, :, None, :] - dac[:, None, :, :]  # (B,L,L,H)
        decay = torch.exp(diff.masked_fill(~tri[None, :, :, None], float("-inf")))
        m = scores[..., None] * decay * dtj[:, None, :, :]  # (B,L,L,H)
        y = torch.einsum("bijh,bjhp->bihp", m, xj)
        # + contribution of the incoming state
        y = y + torch.einsum("bin,bhpn->bihp", cj, h) * torch.exp(dac)[..., None]
        # state update to the end of the chunk
        dec_end = torch.exp(dac[:, -1:, :] - dac)  # (B,L,H)
        h = h * torch.exp(dac[:, -1])[:, :, None, None] + torch.einsum(
            "bjn,bjh,bjhp->bhpn", bj, dtj * dec_end, xj)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def ssd_block(p, cfg: ModelConfig, u: torch.Tensor):
    """Sequence form. u: (B,S,d) -> ((B,S,d), final SSDState)."""
    di, nh, hp, n, _ = _dims(cfg)
    dt_ = cfg.compute_dtype
    z, xbc, dtp = _split_proj(p, cfg, u)
    conv_tail = xbc[:, -(cfg.conv_width - 1):, :]  # the decode conv state
    xbc = F.silu(_causal_conv(xbc, p["conv_w"].to(dt_), p["conv_b"].to(dt_)))
    x, b, c = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    bsz, s = x.shape[:2]
    xh = hint(split_last(x, (bsz, s, nh, hp), ("batch", "seq", "act_heads", None)).float(),
              "batch", "seq", "act_heads", None)
    dt = F.softplus(dtp.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    b, c = b.float(), c.float()
    # ragged sequences: pad to a chunk multiple with dt = 0 steps (identity
    # recurrence: no decay, no input), so the final state is untouched
    s_pad = (-s) % cfg.ssm_chunk
    if s_pad:
        xh, dt, b, c = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, s_pad)) for t in (xh, dt, b, c))
    y, hf = _ssd_chunked(xh, dt, a, b, c, cfg.ssm_chunk)
    y = y + xh * p["d_skip"][None, None, :, None]
    y = keep_layout(y[:, :s].reshape(bsz, s, di)).to(dt_)  # its gradient merges back
    y = rms_norm(y * F.silu(z), p["out_norm"], cfg.rms_eps)
    out = hint(y @ p["w_out"].to(dt_), "batch", "seq", "act_embed")
    return out, SSDState(h=hf, conv=conv_tail)


def init_ssd_state(cfg: ModelConfig, batch: int, device="cuda",
                   lead: Tuple[int, ...] = ()) -> SSDState:
    device = resolve_device(device)
    _, nh, hp, n, conv_dim = _dims(cfg)
    lead = tuple(lead)
    return SSDState(
        h=torch.zeros(lead + (batch, nh, hp, n), dtype=torch.float32, device=device),
        conv=torch.zeros(lead + (batch, cfg.conv_width - 1, conv_dim), dtype=cfg.compute_dtype,
                         device=device),
    )


def ssd_decode_step(p, cfg: ModelConfig, u: torch.Tensor, state: SSDState):
    """Single-token form: O(1) state update. u: (B,1,d) -> ((B,1,d), new state)."""
    di, nh, hp, n, _ = _dims(cfg)
    dt_ = cfg.compute_dtype
    z, xbc, dtp = _split_proj(p, cfg, u)
    conv_in = torch.cat([state.conv, xbc], dim=1)  # (B,cw,conv_dim)
    w = p["conv_w"].to(dt_)
    xbc_c = conv_in[:, 0:1, :] * w[0]
    for i in range(1, w.shape[0]):
        xbc_c = xbc_c + conv_in[:, i:i + 1, :] * w[i]
    xbc_c = F.silu(xbc_c + p["conv_b"].to(dt_))
    # (B,H,P); under a mesh laid out as the heads split (24 SSD heads on 16 do not)
    x = split_last(xbc_c[:, 0, :di], (xbc_c.shape[0], nh, hp), ("batch", "act_heads", None)).float()
    b = hint(xbc_c[:, 0, di:di + n].float(), "batch", None)  # (B,N)
    c = hint(xbc_c[:, 0, di + n:].float(), "batch", None)
    dt = hint(F.softplus(dtp[:, 0].float() + p["dt_bias"]), "batch", "act_heads")  # (B,H)
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt * a)  # (B,H)
    h0 = hint(state.h, "batch", "act_heads", None, None)
    h = h0 * da[..., None, None] + torch.einsum("bh,bn,bhp->bhpn", dt, b, x)
    y = torch.einsum("bn,bhpn->bhp", c, h) + x * p["d_skip"][None, :, None]
    y = keep_layout(y.reshape(-1, 1, di)).to(dt_)
    y = rms_norm(y * F.silu(z), p["out_norm"], cfg.rms_eps)
    return y @ p["w_out"].to(dt_), SSDState(h=h, conv=conv_in[:, 1:, :])
