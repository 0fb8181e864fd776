"""Attention: GQA/MHA with RoPE / M-RoPE, qk-norm, QKV bias, sliding-window
masks, and a KV-cached decode path (``repro/models/attention.py``).

Training and prefill run *online-softmax chunked attention*: a loop over KV
chunks that keeps the live score tensor at (B, Sq, KV, G, chunk) instead of
(B, H, S, S).  GQA is computed in grouped form (no replicated K/V heads).
It is made of plain tensor ops, so it is twice differentiable, which the
Hessian-vector product of ``training/spectral.py`` needs
(``F.scaled_dot_product_attention``'s fused backends have no double
backward).

Decode keeps an :class:`AttnCache` per layer: bf16 (the compute dtype) or
int8 with per-(batch, slot, head) f32 scales, dequantized one KV chunk at a
time inside the chunk loop, so no full-width copy of the cache is made.
Windowed archs size the cache to the window and write slot ``pos % w``: a
ring.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..distributed.sharding import (
    current_ctx,
    from_local,
    hint,
    keep_layout,
    logical_spec,
    placements_of,
    split_last,
)
from ..distributed.sharding import to_local as _to_local
from .common import Leaf, ModelConfig, apply_rope, dense_init, rms_norm

__all__ = ["init_attention", "attention", "project_kv_only", "decode_attention", "AttnCache",
           "init_cache", "quantize_kv"]

_NEG = -1e30


class AttnCache(NamedTuple):
    """KV cache, optionally int8-quantized.

    ``k``/``v`` are in the compute dtype (scales None) or int8 with
    per-(batch, slot, head) f32 scales.
    """

    k: torch.Tensor  # (B, W, KV, D) compute dtype | int8
    v: torch.Tensor  # (B, W, KV, D)
    slot_pos: torch.Tensor  # (B, W) int32 absolute position per slot, -1 = empty
    k_scale: Optional[torch.Tensor] = None  # (B, W, KV) f32 when int8
    v_scale: Optional[torch.Tensor] = None


def quantize_kv(x: torch.Tensor):
    """Per-(batch, slot, head) symmetric int8. x: (..., D) -> (int8, f32 scale).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-10)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _deq(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    if scale is None:
        return x.float()
    return x.float() * scale[..., None].float()


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
    q, k, v = x @ p["wq"].to(dt), x @ p["wk"].to(dt), x @ p["wv"].to(dt)
    if cfg.qkv_bias:  # added before the head split: the same sums, elementwise
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    # under a mesh: laid out as the hints below resolve, before the split
    q = split_last(q, (b, s, h, hd), ("batch", "act_seq", "act_heads", None))
    k = split_last(k, (b, s, kv, hd), ("batch", "act_seq", "act_kv_heads", None))
    v = split_last(v, (b, s, kv, hd), ("batch", "act_seq", "act_kv_heads", None))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    if rope:
        q = apply_rope(q, pos, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, pos, cfg.rope_theta, cfg.mrope_sections)
    q = hint(q, "batch", "act_seq", "act_heads", None)
    k = hint(k, "batch", "act_seq", "act_kv_heads", None)
    v = hint(v, "batch", "act_seq", "act_kv_heads", None)
    return q, k, v


def _chunked_gqa(q, k, v, q_pos, kv_pos, *, causal: bool, window: Optional[int], chunk: int,
                 k_scale=None, v_scale=None):
    """Online-softmax attention over KV chunks.

    q: (B, Sq, H, D); k, v: (B, Skv, KV, D) in any float dtype, or int8 with
    per-(B, Skv, KV) f32 ``k_scale`` / ``v_scale`` (dequantized a chunk at a
    time); positions: (B, Sq) / (B, Skv), a negative KV position marks an
    empty slot.  Returns (B, Sq, H, D) in q's dtype; scores, softmax and the
    accumulator run in f32.

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
        if k_scale is not None:
            k_scale = F.pad(k_scale, (0, 0, 0, pad))
            v_scale = F.pad(v_scale, (0, 0, 0, pad))
        skv += pad
    nc = skv // chunk

    qg = q.reshape(b, sq, kvh, g, d).float() * scale
    m = torch.full((b, sq, kvh, g), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, kvh, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kvh, g, d), dtype=torch.float32, device=q.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        if k_scale is not None:
            kj, vj = _deq(k[:, sl], k_scale[:, sl]), _deq(v[:, sl], v_scale[:, sl])
        else:
            kj, vj = k[:, sl].float(), v[:, sl].float()
        pj = kv_pos[:, sl]
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


def _gqa(q, k, v, q_pos, kv_pos, *, k_scale=None, v_scale=None, **kw):
    """:func:`_chunked_gqa`; under a mesh, on each rank's shard.

    Attention is independent per batch row, per KV head group and per
    query, so the core runs on local tensors (no DTensor op inside the
    chunk loop).  The grouped form reshapes the query heads into (KV heads,
    group), so the ``model`` axis may split the heads only when both the
    query and the KV heads divide it (``act_heads`` and ``act_kv_heads``
    agree); else it splits the queries (``act_seq``: the keys and values
    whole on every rank, their gradients partial sums there, as the
    reference's "attention re-gathers inside the layer"), else nothing.
    The batch is split as the ``batch`` rule puts it; the output keeps the
    queries' layout."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None:
        return _chunked_gqa(q, k, v, q_pos, kv_pos, k_scale=k_scale, v_scale=v_scale, **kw)
    from torch.distributed.tensor import Partial

    mesh = ctx.mesh
    qs, ks = tuple(q.shape), tuple(k.shape)
    q_spec = logical_spec(qs, ("batch", None, "act_heads", None), ctx)
    kv_spec = logical_spec(ks, ("batch", None, "act_kv_heads", None), ctx)
    if q_spec[2] is None or q_spec[2] != kv_spec[2]:
        q_spec = logical_spec(qs, ("batch", "act_seq", None, None), ctx)
        kv_spec = logical_spec(ks, ("batch", None, None, None), ctx)
    P = type(q_spec)
    q_pl, kv_pl = placements_of(q_spec, mesh), placements_of(kv_spec, mesh)
    # where the queries are split and the keys are not, each rank's key and
    # value gradients are partial sums
    kv_grad = tuple(Partial() if a.is_shard() and b.is_replicate() else b
                    for a, b in zip(q_pl, kv_pl))

    def loc(t, spec, grad=None):
        return None if t is None else _to_local(t, mesh, placements_of(spec, mesh), grad)

    out = _chunked_gqa(
        loc(q, q_spec), loc(k, kv_spec, kv_grad), loc(v, kv_spec, kv_grad),
        loc(q_pos, P(*q_spec[:2])), loc(kv_pos, P(*kv_spec[:2])),
        k_scale=loc(k_scale, P(*kv_spec[:3])), v_scale=loc(v_scale, P(*kv_spec[:3])), **kw)
    return from_local(out, mesh, q_pl, qs)


def attention(p, cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None, kv_override=None):
    """Full-sequence attention (training / prefill / encoder).

    ``kv_override`` = (k, v, kv_pos) enables cross-attention (decoder side).
    """
    dt = cfg.compute_dtype
    x = hint(x.to(dt), "batch", "seq", "act_embed")  # the sequence whole for the projections
    pos2d = pos if pos.ndim == 2 else pos[0]
    q, k, v = _project_qkv(p, cfg, x, pos, rope=kv_override is None or cfg.family != "encdec")
    if kv_override is not None:
        k, v, kv_pos = kv_override
    else:
        kv_pos = pos2d
    out = _gqa(q, k, v, pos2d, kv_pos, causal=causal, window=window, chunk=cfg.attn_chunk)
    out = hint(out, "batch", "seq", "act_heads", None)
    b, s = x.shape[:2]
    y = keep_layout(out.reshape(b, s, cfg.n_heads * cfg.hd)) @ p["wo"].to(dt)
    return hint(y, "batch", "seq", "act_embed")


def project_kv_only(p, cfg: ModelConfig, x: torch.Tensor):
    """K/V projection of encoder output for cross-attention (no RoPE)."""
    b, s, _ = x.shape
    dt = cfg.compute_dtype
    kv, hd = cfg.n_kv_heads, cfg.hd
    x = hint(x.to(dt), "batch", "seq", "act_embed")
    k = split_last(x @ p["wk"].to(dt), (b, s, kv, hd), ("batch", "act_seq", "act_kv_heads", None))
    v = split_last(x @ p["wv"].to(dt), (b, s, kv, hd), ("batch", "act_seq", "act_kv_heads", None))
    return k, v


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device="cuda",
               lead: Tuple[int, ...] = ()) -> AttnCache:
    """An empty cache of ``max_len`` slots (``lead`` stacks independent
    caches on leading axes: the layer stack)."""
    device = resolve_device(device)
    dtype = dtype or (torch.int8 if cfg.kv_cache_dtype == "int8" else cfg.compute_dtype)
    kv, hd = cfg.n_kv_heads, cfg.hd
    lead = tuple(lead)
    int8 = dtype == torch.int8

    def zeros(shape, dt):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    return AttnCache(
        k=zeros((batch, max_len, kv, hd), dtype),
        v=zeros((batch, max_len, kv, hd), dtype),
        slot_pos=torch.full(lead + (batch, max_len), -1, dtype=torch.int32, device=device),
        k_scale=zeros((batch, max_len, kv), torch.float32) if int8 else None,
        v_scale=zeros((batch, max_len, kv), torch.float32) if int8 else None,
    )


def decode_attention(p, cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor, cache: AttnCache, *,
                     window: Optional[int] = None, cross_kv=None, step: Optional[int] = None):
    """Single-token attention against a (ring-buffered) KV cache.

    x: (B, 1, d); pos: (B, 1) or (3, B, 1), the new token's absolute
    position.  Windowed archs keep ``max_len == window`` and overwrite slot
    ``pos % w``, which makes decode O(window), not O(seq).  Decode rows
    advance in lockstep, so the new K/V go to one slot for the whole batch:
    one indexed copy per buffer, written **in place** into ``cache`` (which
    is returned).  ``step`` is that position as a host int (``decode_step``
    passes it), so finding the slot reads nothing back from the device;
    without it, ``pos`` is read.  Returns (y (B,1,d), cache).
    """
    dt = cfg.compute_dtype
    x = x.to(dt)
    pos2d = pos if pos.ndim == 2 else pos[0]
    q, k_new, v_new = _project_qkv(p, cfg, x, pos, rope=cross_kv is None)
    k_scale = v_scale = None
    if cross_kv is not None:
        k, v, kv_pos = cross_kv
    else:
        w = cache.k.shape[1]
        slot = (int(pos2d[0, 0]) if step is None else int(step)) % w
        if cache.k_scale is not None:  # int8 cache: quantize the new K/V
            kq, ks = quantize_kv(k_new)
            vq, vs = quantize_kv(v_new)
            cache.k_scale[:, slot] = ks[:, 0]
            cache.v_scale[:, slot] = vs[:, 0]
            k_new, v_new = kq, vq
            k_scale, v_scale = cache.k_scale, cache.v_scale
        cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
        cache.slot_pos[:, slot] = pos2d[:, 0].to(torch.int32)
        k, v, kv_pos = cache.k, cache.v, cache.slot_pos
    out = _gqa(
        q, k, v, pos2d, kv_pos,
        causal=cross_kv is None,  # cross-attention sees the whole encoder
        window=window, chunk=min(cfg.attn_chunk, k.shape[1]),
        k_scale=k_scale, v_scale=v_scale,
    )
    b = x.shape[0]
    y = keep_layout(out.reshape(b, 1, cfg.n_heads * cfg.hd)) @ p["wo"].to(dt)
    return y, cache
