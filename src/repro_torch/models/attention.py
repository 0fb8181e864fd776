"""Attention, sequence path: GQA/MHA with RoPE / M-RoPE, qk-norm, QKV bias,
sliding-window masks (``repro/models/attention.py``'s training and prefill
half).

Training runs *online-softmax chunked attention*: a loop over KV chunks
that keeps the live score tensor at (B, Sq, KV, G, chunk) instead of
(B, H, S, S).  GQA is computed in grouped form (no replicated K/V heads).
It is made of plain tensor ops, so it is twice differentiable, which the
Hessian-vector product of ``training/spectral.py`` needs
(``F.scaled_dot_product_attention``'s fused backends have no double
backward).

The decode half (``AttnCache``, ``init_cache``, ``decode_attention``,
``quantize_kv``) waits for the serving slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .common import Leaf, ModelConfig, apply_rope, dense_init, rms_norm

__all__ = ["init_attention", "attention", "project_kv_only"]

_NEG = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig, d_in: Optional[int] = None,
                   lead: Tuple[int, ...] = ()):
    d = d_in or cfg.d_model
    hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt, dev = cfg.param_dtype, gen.device

    def zeros(n):
        return torch.zeros(tuple(lead) + (n,), dtype=dt, device=dev)

    p = {
        "wq": dense_init(gen, (d, h * hd), ("embed", "qkv"), dt, lead=lead),
        "wk": dense_init(gen, (d, kv * hd), ("embed", "qkv"), dt, lead=lead),
        "wv": dense_init(gen, (d, kv * hd), ("embed", "qkv"), dt, lead=lead),
        "wo": dense_init(gen, (h * hd, d), ("qkv", "embed"), dt, lead=lead),
    }
    if cfg.qkv_bias:
        p["bq"] = Leaf(zeros(h * hd), ("qkv",))
        p["bk"] = Leaf(zeros(kv * hd), ("qkv",))
        p["bv"] = Leaf(zeros(kv * hd), ("qkv",))
    if cfg.qk_norm:
        p["q_norm"] = Leaf(zeros(hd), (None,))
        p["k_norm"] = Leaf(zeros(hd), (None,))
    return p


def _project_qkv(p, cfg: ModelConfig, x, pos, rope: bool = True):
    b, s, _ = x.shape
    hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.compute_dtype
    q = (x @ p["wq"].to(dt)).reshape(b, s, h, hd)
    k = (x @ p["wk"].to(dt)).reshape(b, s, kv, hd)
    v = (x @ p["wv"].to(dt)).reshape(b, s, kv, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt).reshape(h, hd)
        k = k + p["bk"].to(dt).reshape(kv, hd)
        v = v + p["bv"].to(dt).reshape(kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    if rope:
        q = apply_rope(q, pos, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, pos, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _chunked_gqa(q, k, v, q_pos, kv_pos, *, causal: bool, window: Optional[int], chunk: int):
    """Online-softmax attention over KV chunks.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D); positions: (B, Sq) / (B, Skv),
    a negative KV position marks an empty slot.  Returns (B, Sq, H, D) in
    q's dtype; scores, softmax and the accumulator run in f32.

    Every chunk is computed: the reference skips a chunk masked for every
    query (``lax.cond``), but a masked chunk changes no value here either
    (its ``exp`` terms are 0, or are wiped by the next live chunk's
    correction ``exp(-1e30 - m) = 0``), and deciding to skip would read a
    flag back to the host every chunk.
    """
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh  # GQA group size
    scale = d ** -0.5
    chunk = min(chunk, skv)
    if skv % chunk:  # pad KV to a chunk multiple; padded slots mask via pos=-1
        pad = chunk - skv % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
        skv += pad
    nc = skv // chunk

    qg = q.reshape(b, sq, kvh, g, d).float() * scale
    m = torch.full((b, sq, kvh, g), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, kvh, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kvh, g, d), dtype=torch.float32, device=q.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        kj, vj, pj = k[:, sl].float(), v[:, sl].float(), kv_pos[:, sl]
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kj)
        msk = pj[:, None, :] >= 0  # empty slots
        if causal:
            msk = msk & (pj[:, None, :] <= q_pos[:, :, None])
        if window is not None:
            msk = msk & (pj[:, None, :] > (q_pos[:, :, None] - window))
        s = s.masked_fill(~msk[:, :, None, None, :], _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        pr = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + pr.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", pr, vj)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(b, sq, h, d).to(q.dtype)


def attention(p, cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None, kv_override=None):
    """Full-sequence attention (training / prefill / encoder).

    ``kv_override`` = (k, v, kv_pos) enables cross-attention (decoder side).
    """
    dt = cfg.compute_dtype
    x = x.to(dt)
    pos2d = pos if pos.ndim == 2 else pos[0]
    q, k, v = _project_qkv(p, cfg, x, pos, rope=kv_override is None or cfg.family != "encdec")
    if kv_override is not None:
        k, v, kv_pos = kv_override
    else:
        kv_pos = pos2d
    out = _chunked_gqa(q, k, v, pos2d, kv_pos, causal=causal, window=window, chunk=cfg.attn_chunk)
    b, s = x.shape[:2]
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"].to(dt)


def project_kv_only(p, cfg: ModelConfig, x: torch.Tensor):
    """K/V projection of encoder output for cross-attention (no RoPE)."""
    b, s, _ = x.shape
    dt = cfg.compute_dtype
    kv, hd = cfg.n_kv_heads, cfg.hd
    k = (x.to(dt) @ p["wk"].to(dt)).reshape(b, s, kv, hd)
    v = (x.to(dt) @ p["wv"].to(dt)).reshape(b, s, kv, hd)
    return k, v
