"""Model top level: init / forward / loss / prefill / decode for all
families (``repro/models/model.py``).

Families: ``dense``, ``moe`` and ``vlm`` (a uniform decoder stack,
attention + MLP or MoE), ``hybrid_rglru`` (RecurrentGemma's pattern: rec,
rec, local attention), ``ssm`` (a Mamba-2 SSD stack) and ``encdec`` (an
encoder stack, then a decoder with cross-attention: seamless).  The
modality frontends are stubs, as in the reference: ``batch["frames"]``
carries precomputed frame or patch embeddings, which ``encdec`` encodes and
``vlm`` prefixes to the text embeddings.

Layer parameters are stacked on a leading ``layers`` axis, one stack per
kind of the pattern (``params["blocks"]["rec_0"]``, ...), with the
remainder layers in the list ``params["rem"]``, so the tree, its flat order
and its checkpoint names are the reference's.  The forward unbinds each
stack once per call and runs the layers in a Python loop.  ``remat !=
"none"`` recomputes each layer in the backward pass, and each
cross-entropy chunk is always recomputed (the reference's policies),
through non-reentrant ``torch.utils.checkpoint``, which also supports the
double backward of the Hessian-vector product.

Decode keeps the reference's state tree (:class:`DecodeState`: per-kind
stacked layer states, the remainder's, the encoder's cross K/V), with ``step``
as host data, so the ring slot ``step % w`` needs no read from the device.
``decode_step`` updates the layer states in place (see its docstring).
Prefill and decode run without autograd: they serve.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..core import tree as _tree
from ..distributed.sharding import as_dtensor, from_local, hint, settle, to_local
from .attention import (
    AttnCache,
    _project_qkv,
    attention,
    decode_attention,
    init_attention,
    init_cache,
    project_kv_only,
    quantize_kv,
)
from .common import Leaf, ModelConfig, _map_leaves, make_positions, rms_norm
from .mlp import init_mlp, init_moe, mlp, moe
from .rglru import RGLRUState, init_rglru_block, init_rglru_state, rglru_block, rglru_decode_step
from .ssd import SSDState, init_ssd_block, init_ssd_state, ssd_block, ssd_decode_step

__all__ = ["init_model", "forward", "loss_fn", "prefill", "decode_step", "init_decode_state",
           "decode_state_axes", "DecodeState", "params_from_numpy", "params_to_numpy"]

_ATTN_KINDS = ("dense", "moe", "attn_local", "dec")  # blocks with self-attention and a KV cache


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _norm_leaf(cfg: ModelConfig, dev, lead=()):
    return Leaf(torch.zeros(tuple(lead) + (cfg.d_model,), dtype=torch.float32, device=dev), (None,))


def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, lead=()):
    dev = gen.device
    if kind in ("dense", "attn_local", "enc"):
        return {"n1": _norm_leaf(cfg, dev, lead), "attn": init_attention(gen, cfg, lead=lead),
                "n2": _norm_leaf(cfg, dev, lead), "mlp": init_mlp(gen, cfg, lead=lead)}
    if kind == "moe":
        return {"n1": _norm_leaf(cfg, dev, lead), "attn": init_attention(gen, cfg, lead=lead),
                "n2": _norm_leaf(cfg, dev, lead), "moe": init_moe(gen, cfg, lead=lead)}
    if kind == "rec":
        return {"n1": _norm_leaf(cfg, dev, lead), "rec": init_rglru_block(gen, cfg, lead=lead),
                "n2": _norm_leaf(cfg, dev, lead), "mlp": init_mlp(gen, cfg, lead=lead)}
    if kind == "ssd":
        return {"n1": _norm_leaf(cfg, dev, lead), "ssd": init_ssd_block(gen, cfg, lead=lead)}
    if kind == "dec":
        return {"n1": _norm_leaf(cfg, dev, lead), "attn": init_attention(gen, cfg, lead=lead),
                "nx": _norm_leaf(cfg, dev, lead), "xattn": init_attention(gen, cfg, lead=lead),
                "n2": _norm_leaf(cfg, dev, lead), "mlp": init_mlp(gen, cfg, lead=lead)}
    raise ValueError(kind)


def _stacked_init(gen: torch.Generator, cfg: ModelConfig, kind: str, n: int):
    blocks = _init_block(gen, cfg, kind, lead=(n,))
    return _map_leaves(lambda l: Leaf(l.value, ("layers",) + l.axes), blocks)


def _pattern(cfg: ModelConfig):
    if cfg.family == "hybrid_rglru":
        return cfg.block_pattern or ("rec", "rec", "attn_local")
    if cfg.family == "ssm":
        return ("ssd",)
    if cfg.family == "moe":
        return ("moe",)
    if cfg.family == "encdec":
        return ("dec",)
    return ("dense",)


def init_model(gen: torch.Generator, cfg: ModelConfig):
    """Tree of :class:`Leaf` on ``gen.device`` (``split_tree`` gives the
    values): embedding N(0, 0.02), truncated-normal fan-in projections,
    zero norms and biases, and the RG-LRU and SSD blocks' own inits, as the
    reference draws them (not its bits)."""
    pat = _pattern(cfg)
    dev = gen.device
    vp = cfg.vocab_padded

    def normal(shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev) * 0.02).to(
            cfg.param_dtype)

    params: Dict[str, Any] = {
        "embed": Leaf(normal((vp, cfg.d_model)), ("vocab", "embed")),
        "final_norm": _norm_leaf(cfg, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = Leaf(normal((cfg.d_model, vp)), ("embed", "vocab"))
    if cfg.family == "encdec":
        params["enc"] = _stacked_init(gen, cfg, "enc", cfg.n_enc_layers)
        params["enc_norm"] = _norm_leaf(cfg, dev)
        params["blocks"] = {"dec_0": _stacked_init(gen, cfg, "dec", cfg.n_layers)}
        params["rem"] = []
        return params
    n_full, rem = divmod(cfg.n_layers, len(pat))
    params["blocks"] = {f"{kind}_{i}": _stacked_init(gen, cfg, kind, n_full)
                        for i, kind in enumerate(pat)}
    params["rem"] = [_init_block(gen, cfg, pat[i]) for i in range(rem)]
    return params


# --------------------------------------------------------------------------
# sequence forward (training / prefill / encoder)
# --------------------------------------------------------------------------

def _block_seq(p, cfg: ModelConfig, kind: str, x, pos, enc_ctx=None, collect: bool = False):
    """One residual block, full sequence. Returns (x, aux, side).

    ``side``: with ``collect=True``, (k, v) for attention kinds and the final
    recurrent state for rec/ssd kinds; else ().  ``collect`` also marks the
    serving path, which runs the MoE dropless (see ``mlp.moe``).  An ``enc``
    block attends without a causal mask or a window; a ``dec`` block adds
    cross-attention to ``enc_ctx = (enc_out, enc_pos)``.
    """
    side: Any = ()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in _ATTN_KINDS or kind == "enc":
        window = cfg.window if kind not in ("enc", "dec") else None
        h = rms_norm(x, p["n1"], cfg.rms_eps)
        if collect:
            _, k, v = _project_qkv(p["attn"], cfg, h, pos)
            side = (k, v)
        x = x + attention(p["attn"], cfg, h, pos, causal=kind != "enc", window=window)
        if kind == "dec":
            enc_out, enc_pos = enc_ctx
            hx = rms_norm(x, p["nx"], cfg.rms_eps)
            k, v = project_kv_only(p["xattn"], cfg, enc_out)
            x = x + attention(p["xattn"], cfg, hx, pos if pos.ndim == 2 else pos[0],
                              causal=False, kv_override=(k, v, enc_pos))
        h2 = rms_norm(x, p["n2"], cfg.rms_eps)
        if kind == "moe":
            y, aux = moe(p["moe"], cfg, h2, dropless=collect)
        else:
            y = mlp(p["mlp"], cfg, h2)
        x = x + y
    elif kind == "rec":
        h = rms_norm(x, p["n1"], cfg.rms_eps)
        y, st = rglru_block(p["rec"], cfg, h)
        if collect:
            side = st
        x = x + y
        h2 = rms_norm(x, p["n2"], cfg.rms_eps)
        x = x + mlp(p["mlp"], cfg, h2)
    elif kind == "ssd":
        h = rms_norm(x, p["n1"], cfg.rms_eps)
        y, st = ssd_block(p["ssd"], cfg, h)
        if collect:
            side = st
        x = x + y
    else:
        raise ValueError(kind)
    return x, aux, side


def _unstack(stacked) -> list:
    """Per-layer trees of a stacked tree: one ``unbind`` per leaf (a ``p[i]``
    per layer would give each layer's backward a zero tensor of the whole
    stack).  Each per-layer leaf is a view of its stack."""
    cols = [t.unbind(0) for t in _tree.leaves(stacked)]
    return [_tree.unflatten(stacked, [c[i] for c in cols]) for i in range(len(cols[0]))]


def _stack(trees: list):
    """The inverse of :func:`_unstack`: leaves stacked on a new leading axis."""
    cols = zip(*(_tree.leaves(t) for t in trees))
    return _tree.unflatten(trees[0], [torch.stack(c) for c in cols])


def _run_stack(params, cfg: ModelConfig, x, pos, enc_ctx=None, collect: bool = False):
    """The block stack, then the remainder layers.  Returns (x, aux_sum,
    (side_stacks, rem_sides)): the MoE aux loss summed over the layers (0
    without MoE), and with ``collect`` each kind's sides stacked over its
    layers and the remainder's sides (see :func:`_block_seq`)."""
    pat = _pattern(cfg)
    keys = [f"{kind}_{i}" for i, kind in enumerate(pat)]
    stacks = [_unstack(params["blocks"][key]) for key in keys]
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    sides = {key: [] for key in keys}
    for layer in zip(*stacks):
        for key, kind, bp in zip(keys, pat, layer):
            fn = lambda x_, bp=bp, kind=kind: _block_seq(bp, cfg, kind, x_, pos, enc_ctx,  # noqa: E731
                                                         collect)
            x, aux, side = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
            aux_sum = aux_sum + aux
            sides[key].append(side)
        # the layer boundary: sequence-sharded under a mesh
        x = hint(x, "batch", "act_seq", "act_embed")
    side_stacks = {key: _stack(s) if collect and s else () for key, s in sides.items()}
    rem_sides = []
    for i, bp in enumerate(params.get("rem", [])):
        x, aux, side = _block_seq(bp, cfg, pat[i], x, pos, enc_ctx, collect)
        aux_sum = aux_sum + aux
        rem_sides.append(side)
    return x, aux_sum, (side_stacks, rem_sides)


def _embed(params, cfg: ModelConfig, tokens):
    """Embedding lookup: a gather of table rows, cast to the compute dtype.
    The reference contracts a one-hot with the table under a custom VJP (a
    TPU sharding device); each one-hot row sums a single term, so the values
    are the same, and the table's gradient accumulates in the table's dtype."""
    x = _lookup(params["embed"], tokens).to(cfg.compute_dtype)
    return hint(x, "batch", "seq", "act_embed")


def _lookup(table, tokens):
    """``F.embedding(tokens, table)``; under a mesh, vocab-parallel on each
    rank's shards.

    Each rank looks its tokens up in its own rows of the table (the vocab
    split as the table is, its other dimensions gathered) and zeroes the
    tokens outside them; the output is a partial sum over the vocab's mesh
    axes, each token's row coming from exactly one rank, so the sum is the
    lookup's values exactly.  The table's gradient stays on its rows (a
    partial sum over the batch axes).  A mesh axis that split both the vocab
    and the batch would split the vocab only.  DTensor's own vocab-sharded
    lookup cannot take a batch-sharded index on a 2-D mesh, and gathering
    the whole table would move its bytes at every call."""
    from torch.distributed.tensor import DTensor

    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = table.device_mesh
    tok = as_dtensor(tokens, mesh)
    vocab = [p.is_shard() and p.dim == 0 for p in table.placements]
    batch = [p.is_shard() and p.dim == 0 and not v for p, v in zip(tok.placements, vocab)]
    t_pl = [Shard(0) if v else Replicate() for v in vocab]
    k_pl = [Shard(0) if b else Replicate() for b in batch]
    t_grad = [Shard(0) if v else Partial() if b else Replicate() for v, b in zip(vocab, batch)]
    out_pl = [Partial() if v else Shard(0) if b else Replicate() for v, b in zip(vocab, batch)]
    local_shape, offset = compute_local_shape_and_global_offset(table.shape, mesh, t_pl)
    rows = to_local(table, mesh, t_pl, t_grad)
    ids = to_local(tok, mesh, k_pl)
    lo, n = int(offset[0]), int(local_shape[0])
    inside = (ids >= lo) & (ids < lo + n)
    out = F.embedding((ids - lo).clamp(0, max(n - 1, 0)), rows) * inside[..., None].to(rows.dtype)
    return from_local(out, mesh, out_pl, tuple(tokens.shape) + (table.shape[1],))


def _sharded_nll(logits, lbl):
    """``logsumexp(logits) - logits[lbl]`` per token, vocab-parallel: each
    rank works on its own (batch rows, vocab slice) of the f32 logits, and
    only per-token scalars cross ranks (the max, the sum of exponentials and
    the label's logit, each a reduction over the vocab's mesh axes), never
    the (B, C, V) logits themselves.  The same terms in the same order per
    vocab slice as one device, summed over the slices."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = logits.device_mesh
    logits = settle(logits)
    pl = tuple(Shard(2) if p.is_shard() and p.dim % 3 == 2 else Shard(0)
               if p.is_shard() and p.dim % 3 == 0 else Replicate() for p in logits.placements)
    vocab = [p.is_shard() and p.dim == 2 for p in pl]
    row = tuple(Shard(0) if p.is_shard() and p.dim == 0 else Replicate() for p in pl)
    shape = tuple(logits.shape[:2])
    lg = to_local(logits, mesh, pl)
    ids = to_local(lbl, mesh, row)
    _, off = compute_local_shape_and_global_offset(logits.shape, mesh, pl)
    lo, n = int(off[2]), lg.shape[-1]

    def reduced(t, op="sum"):
        part = tuple(Partial(op) if v else r for v, r in zip(vocab, row))
        return from_local(t, mesh, part, shape).redistribute(mesh, row)

    m = reduced(lg.detach().amax(dim=-1), "max").to_local()
    se = reduced(torch.exp(lg - m[..., None]).sum(dim=-1))
    inside = (ids >= lo) & (ids < lo + n)
    picked = lg.gather(-1, (ids - lo).clamp(0, n - 1)[..., None])[..., 0] * inside.to(lg.dtype)
    return torch.log(se) + from_local(m, mesh, row, shape) - reduced(picked)


def _logits(params, cfg: ModelConfig, x):
    dt = cfg.compute_dtype
    x = hint(rms_norm(x, params["final_norm"], cfg.rms_eps), "batch", "seq", "act_embed")
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    # under a mesh: the head's vocab split, its model dimension gathered, so
    # the product needs no collective (DTensor's own choice moves the logits)
    head = hint(head.to(dt), None, "act_vocab")
    logits = (x @ head).float()
    if cfg.vocab_padded != cfg.vocab:  # mask padded vocab slots
        mask = torch.zeros((cfg.vocab_padded,), dtype=torch.float32, device=logits.device)
        mask[cfg.vocab:] = -1e30
        logits = logits + mask
    return hint(logits, "batch", "seq", "act_vocab")


def _positions(cfg: ModelConfig, batch, b: int, s: int, device):
    pos = batch.get("positions")
    if pos is None:
        pos = make_positions(b, s, mrope=cfg.mrope_sections is not None, device=device)
    return pos


def _encode(params, cfg: ModelConfig, frames):
    """Encoder stack over stub frame embeddings. Returns (enc_out, enc_pos)."""
    b, s_src = frames.shape[:2]
    enc_pos = make_positions(b, s_src, device=frames.device)
    x = hint(frames.to(cfg.compute_dtype), "batch", "seq", "act_embed")
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for bp in _unstack(params["enc"]):
        fn = lambda x_, bp=bp: _block_seq(bp, cfg, "enc", x_, enc_pos)[0]  # noqa: E731
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    return rms_norm(x, params["enc_norm"], cfg.rms_eps), enc_pos


def _inputs(params, cfg: ModelConfig, batch):
    """(x, pos, enc_ctx): the embedded input of the block stack, its
    positions and, for ``encdec``, the encoded frames.  For ``vlm`` the
    frames are prefixed to the text embeddings (and count in the
    positions, M-RoPE ``(3, B, S)`` unless ``batch["positions"]`` is given)."""
    enc_ctx = None
    if cfg.family == "encdec":
        enc_ctx = _encode(params, cfg, batch["frames"])
    x = _embed(params, cfg, batch["tokens"])
    if cfg.family == "vlm" and batch.get("frames") is not None:
        x = torch.cat([batch["frames"].to(cfg.compute_dtype), x], dim=1)
    pos = _positions(cfg, batch, x.shape[0], x.shape[1], x.device)
    return x, pos, enc_ctx


def _backbone(params, cfg: ModelConfig, batch):
    """Everything up to (but not including) the LM head. Returns (x, aux)."""
    x, pos, enc_ctx = _inputs(params, cfg, batch)
    x, aux, _ = _run_stack(params, cfg, x, pos, enc_ctx)
    return x, aux


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """batch: tokens (B,S) [, frames, positions] -> (logits (B,S,Vp) f32,
    {"moe_aux": aux}); for ``vlm`` with frames, S counts the frames too."""
    x, aux = _backbone(params, cfg, batch)
    return _logits(params, cfg, x), {"moe_aux": aux}


def loss_fn(params, cfg: ModelConfig, batch, aux_weight: float = 0.01):
    """Next-token cross-entropy (+ MoE aux). Labels < 0 are masked.

    The sequence is cut into chunks of 512 tokens (padded with masked
    labels); each chunk's f32 logits are recomputed in the backward pass,
    so no (B, S, V) buffer is kept.  Chunks add up in order, as the
    reference's scan does.
    """
    x, aux = _backbone(params, cfg, batch)
    labels = batch["labels"]
    b, s, d = x.shape

    def ce_chunk(xc, lc):
        logits = _logits(params, cfg, xc)  # (B,C,Vp) f32
        valid = lc >= 0
        lbl = torch.clamp_min(lc, 0).long()
        if isinstance(logits, DTensor):
            return (_sharded_nll(logits, lbl) * valid).sum()
        m = logits.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
        label_logit = logits.gather(-1, lbl[..., None])[..., 0]
        nll = (lse - label_logit) * valid
        return nll.sum()

    chunk = min(512, s)
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        s += pad
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(s // chunk):
        xc, lc = x[:, c * chunk:(c + 1) * chunk], labels[:, c * chunk:(c + 1) * chunk]
        if torch.is_grad_enabled():
            nll = checkpoint(ce_chunk, xc, lc, use_reentrant=False)
        else:
            nll = ce_chunk(xc, lc)
        tot = tot + nll
    cnt = (labels >= 0).sum().to(torch.int32)
    loss = tot / torch.clamp_min(cnt, 1)
    return loss + aux_weight * aux, {"ce": loss, "moe_aux": aux}


# --------------------------------------------------------------------------
# decode (serving)
# --------------------------------------------------------------------------

class DecodeState(NamedTuple):
    step: int  # absolute position of the NEXT token: host data (an int or a CPU 0-d tensor)
    layers: Any  # dict: per-pattern-kind stacked layer states
    rem: Any  # remainder-layer states (tuple)
    cross: Any  # encdec: (k_stack (L,B,S_src,KV,D), v_stack, enc_pos (B,S_src)) or None


def _layer_state(cfg: ModelConfig, kind: str, batch: int, max_len: int, device, lead=()):
    if kind in _ATTN_KINDS:
        w = min(max_len, cfg.window) if cfg.window else max_len
        return init_cache(cfg, batch, w, device=device, lead=lead)
    if kind == "rec":
        return init_rglru_state(cfg, batch, device=device, lead=lead)
    if kind == "ssd":
        return init_ssd_state(cfg, batch, device=device, lead=lead)
    raise ValueError(kind)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, step: int = 0,
                      enc_len: int = 1, device="cuda") -> DecodeState:
    """Empty caches and zero recurrent states on ``device``, each kind's
    stacked over its layers.  For ``encdec``, zero cross K/V placeholders
    of ``enc_len`` encoder positions (``prefill`` fills them)."""
    pat = _pattern(cfg)
    n_full, rem = divmod(cfg.n_layers, len(pat))
    layers = {f"{kind}_{i}": _layer_state(cfg, kind, batch, max_len, device, lead=(n_full,))
              for i, kind in enumerate(pat)}
    rem_states = tuple(_layer_state(cfg, pat[i], batch, max_len, device) for i in range(rem))
    cross = None
    if cfg.family == "encdec":
        shape = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.hd)
        cross = (torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
                 torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
                 torch.zeros((batch, enc_len), dtype=torch.int32, device=device))
    return DecodeState(step=int(step), layers=layers, rem=rem_states, cross=cross)


def _layer_state_axes(cfg: ModelConfig, kind: str):
    """Logical sharding axes mirroring _layer_state's structure."""
    if kind in _ATTN_KINDS:
        sc = ("batch", "cache_seq", "act_kv_heads") if cfg.kv_cache_dtype == "int8" else None
        return AttnCache(k=("batch", "cache_seq", "act_kv_heads", None),
                         v=("batch", "cache_seq", "act_kv_heads", None),
                         slot_pos=("batch", "cache_seq"), k_scale=sc, v_scale=sc)
    if kind == "rec":
        return RGLRUState(h=("batch", "act_ssm_inner"), conv=("batch", None, "act_ssm_inner"))
    if kind == "ssd":
        return SSDState(h=("batch", "ssm_heads", None, None), conv=("batch", None, "act_ssm_inner"))
    raise ValueError(kind)


def decode_state_axes(cfg: ModelConfig) -> DecodeState:
    """Logical-axes tree matching :func:`init_decode_state` (plain data:
    tuples of axis names, ``("layers",)`` prepended on the stacked states)."""
    pat = _pattern(cfg)
    n_full, rem = divmod(cfg.n_layers, len(pat))

    def prepend(st):
        return type(st)(*(None if a is None else ("layers",) + a for a in st))

    layers = {f"{kind}_{i}": prepend(_layer_state_axes(cfg, kind)) for i, kind in enumerate(pat)}
    rem_axes = tuple(_layer_state_axes(cfg, pat[i]) for i in range(rem))
    cross = None
    if cfg.family == "encdec":
        cross = (("layers", "batch", None, "act_kv_heads", None),
                 ("layers", "batch", None, "act_kv_heads", None),
                 ("batch", None))
    return DecodeState(step=(), layers=layers, rem=rem_axes, cross=cross)


def _block_decode(p, cfg: ModelConfig, kind: str, x, pos, state, step: int, cross_kv=None):
    if kind in _ATTN_KINDS:
        window = cfg.window if kind != "dec" else None
        h = rms_norm(x, p["n1"], cfg.rms_eps)
        y, state = decode_attention(p["attn"], cfg, h, pos, state, window=window, step=step)
        x = x + y
        if kind == "dec":
            hx = rms_norm(x, p["nx"], cfg.rms_eps)
            yx, _ = decode_attention(p["xattn"], cfg, hx, pos, state, cross_kv=cross_kv)
            x = x + yx
        h2 = rms_norm(x, p["n2"], cfg.rms_eps)
        if kind == "moe":
            y2, _ = moe(p["moe"], cfg, h2, dropless=True)  # serving: no drops
        else:
            y2 = mlp(p["mlp"], cfg, h2)
        x = x + y2
    elif kind == "rec":
        h = rms_norm(x, p["n1"], cfg.rms_eps)
        y, state = rglru_decode_step(p["rec"], cfg, h, state)
        x = x + y
        h2 = rms_norm(x, p["n2"], cfg.rms_eps)
        x = x + mlp(p["mlp"], cfg, h2)
    elif kind == "ssd":
        h = rms_norm(x, p["n1"], cfg.rms_eps)
        y, state = ssd_decode_step(p["ssd"], cfg, h, state)
        x = x + y
    else:
        raise ValueError(kind)
    return x, state


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, state: DecodeState, tokens: torch.Tensor):
    """One serving step: tokens (B, 1) -> (logits (B, vocab_padded) f32, state').

    The state passed in is **consumed**: its cache slots and recurrent
    states are overwritten in place (one slot of each attention cache, each
    stacked recurrent state), and ``state'`` holds the same buffers with
    ``step + 1``.  Read only the state returned.
    """
    b = tokens.shape[0]
    step = int(state.step)
    pos = make_positions(b, 1, offset=step, mrope=cfg.mrope_sections is not None,
                         device=tokens.device)
    x = _embed(params, cfg, tokens)
    pat = _pattern(cfg)
    keys = [f"{kind}_{i}" for i, kind in enumerate(pat)]
    stacks = [_unstack(params["blocks"][key]) for key in keys]
    states = [_unstack(state.layers[key]) for key in keys]  # per-layer views of the stacks
    crosses = [None] * len(states[0])
    if cfg.family == "encdec":  # one pattern kind ("dec"): one cross K/V a layer
        ck, cv, cpos = state.cross
        crosses = [(k, v, cpos) for k, v in zip(ck.unbind(0), cv.unbind(0))]
    for layer, layer_states, cross_kv in zip(zip(*stacks), zip(*states), crosses):
        for kind, bp, st in zip(pat, layer, layer_states):
            x, new = _block_decode(bp, cfg, kind, x, pos, st, step, cross_kv=cross_kv)
            for dst, src in zip(_tree.leaves(st), _tree.leaves(new)):
                if dst is not src:
                    dst.copy_(src)
    new_rem = []
    for i, (bp, st) in enumerate(zip(params.get("rem", []), state.rem)):
        x, st2 = _block_decode(bp, cfg, pat[i], x, pos, st, step)
        new_rem.append(st2)
    logits = _logits(params, cfg, x)[:, 0]
    return logits, DecodeState(step=step + 1, layers=state.layers, rem=tuple(new_rem),
                               cross=state.cross)


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------

def _fill_cache(cache: AttnCache, k, v, pos2d) -> AttnCache:
    """A (ring) cache shaped like ``cache`` holding the prompt's K/V.

    Position p lives at slot p % w, so the last ``take`` positions form a
    cyclic shift: pad to w, then roll, as the reference does.
    """
    s = k.shape[1]
    w = cache.k.shape[1]
    take = min(w, s)
    shift = (s - take) % w

    def place(buf, new, fill):
        new = new[:, s - take:].to(buf.dtype)
        if take < w:
            new = F.pad(new, (0, 0) * (new.ndim - 2) + (0, w - take), value=fill)
        return torch.roll(new, shift, dims=1) if shift else new

    if cache.k_scale is not None:  # int8 cache: quantize the prompt K/V
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return AttnCache(k=place(cache.k, kq, 0), v=place(cache.v, vq, 0),
                         slot_pos=place(cache.slot_pos, pos2d, -1),
                         k_scale=place(cache.k_scale, ks, 0), v_scale=place(cache.v_scale, vs, 0))
    return AttnCache(k=place(cache.k, k, 0), v=place(cache.v, v, 0),
                     slot_pos=place(cache.slot_pos, pos2d, -1))


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch, max_len: int):
    """Run the prompt; build the decode state on the tokens' device.
    Returns (state, last-position logits (B, vocab_padded) f32).

    For ``encdec`` the frames are encoded once and each decoder layer's
    cross K/V are stacked into ``state.cross``; for ``vlm`` the frames
    prefix the prompt, so ``state.step`` counts them and decode positions
    run on past them."""
    x, pos, enc_ctx = _inputs(params, cfg, batch)
    b, s = x.shape[:2]
    cross = None
    if enc_ctx is not None:
        enc_out, enc_pos = enc_ctx
        kvs = [project_kv_only(bp["xattn"], cfg, enc_out)
               for bp in _unstack(params["blocks"]["dec_0"])]
        cross = (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]), enc_pos)
    pos2d = pos if pos.ndim == 2 else pos[0]
    x, _, (side_stacks, rem_sides) = _run_stack(params, cfg, x, pos, enc_ctx, collect=True)
    # logits of the LAST position only (a whole prompt's would be (B, S, V) f32)
    logits = _logits(params, cfg, x[:, -1:, :])[:, -1]

    pat = _pattern(cfg)
    new_layers = {}
    for i, kind in enumerate(pat):
        key = f"{kind}_{i}"
        side = side_stacks[key]  # stacked over layers
        if kind in _ATTN_KINDS:
            empty = _layer_state(cfg, kind, b, max_len, x.device)
            new_layers[key] = _stack([_fill_cache(empty, k, v, pos2d) for k, v in zip(*side)])
        else:
            new_layers[key] = side  # recurrent states, already stacked
    new_rem = []
    for i, side in enumerate(rem_sides):
        if pat[i] in _ATTN_KINDS:
            empty = _layer_state(cfg, pat[i], b, max_len, x.device)
            new_rem.append(_fill_cache(empty, side[0], side[1], pos2d))
        else:
            new_rem.append(side)
    return DecodeState(step=s, layers=new_layers, rem=tuple(new_rem), cross=cross), logits


# --------------------------------------------------------------------------
# weights carried across packages
# --------------------------------------------------------------------------

def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def params_from_numpy(tree, device="cuda"):
    """A tree of NumPy arrays (dicts and lists, as ``jax.device_get`` gives
    the reference's params) as the port's tree of tensors on ``device``,
    element for element."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return _to_tensor(tree, device)


def params_to_numpy(tree):
    """The inverse of :func:`params_from_numpy` (bf16 leaves come back as f32:
    NumPy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    t = tree.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
