"""Model top level, dense decoder family: init / forward / loss
(``repro/models/model.py``'s sequence path).

Layer parameters are stacked on a leading ``layers`` axis
(``params["blocks"]["dense_0"]``, with the remainder list ``params["rem"]``),
so the tree, its flat order and its checkpoint names are the reference's.
The forward unbinds each stack once per call and runs the layers in a
Python loop.  ``remat != "none"`` recomputes each layer in the backward
pass, and each cross-entropy chunk is always recomputed (the reference's
policies), through non-reentrant ``torch.utils.checkpoint``, which also
supports the double backward of the Hessian-vector product.

Other families (MoE, RG-LRU, SSD, encoder-decoder, VLM) and the decode path
wait for their own slices of the port.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core import tree as _tree
from .attention import attention, init_attention
from .common import Leaf, ModelConfig, _map_leaves, make_positions, rms_norm
from .mlp import init_mlp, mlp

__all__ = ["init_model", "forward", "loss_fn", "params_from_numpy", "params_to_numpy"]

# The ROADMAP queue A item that ports each family still missing.
_PENDING_FAMILY = {
    "moe": "the MoE, RG-LRU and SSD families",
    "hybrid_rglru": "the MoE, RG-LRU and SSD families",
    "ssm": "the MoE, RG-LRU and SSD families",
    "encdec": "encdec/vlm",
    "vlm": "encdec/vlm",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        item = _PENDING_FAMILY.get(cfg.family)
        where = f"ROADMAP queue A, item {item!r}" if item else "no ROADMAP item"
        raise ValueError(f"model family {cfg.family!r} ({cfg.name}) is not ported yet: {where}")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _norm_leaf(cfg: ModelConfig, dev, lead=()):
    return Leaf(torch.zeros(tuple(lead) + (cfg.d_model,), dtype=torch.float32, device=dev), (None,))


def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, lead=()):
    if kind != "dense":
        raise ValueError(kind)
    dev = gen.device
    return {"n1": _norm_leaf(cfg, dev, lead), "attn": init_attention(gen, cfg, lead=lead),
            "n2": _norm_leaf(cfg, dev, lead), "mlp": init_mlp(gen, cfg, lead=lead)}


def _stacked_init(gen: torch.Generator, cfg: ModelConfig, kind: str, n: int):
    blocks = _init_block(gen, cfg, kind, lead=(n,))
    return _map_leaves(lambda l: Leaf(l.value, ("layers",) + l.axes), blocks)


def _pattern(cfg: ModelConfig):
    _check_family(cfg)
    return ("dense",)


def init_model(gen: torch.Generator, cfg: ModelConfig):
    """Tree of :class:`Leaf` on ``gen.device`` (``split_tree`` gives the
    values): embedding N(0, 0.02), truncated-normal fan-in projections,
    zero norms and biases, as the reference draws them (not its bits)."""
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
    n_full, rem = divmod(cfg.n_layers, len(pat))
    params["blocks"] = {f"{kind}_{i}": _stacked_init(gen, cfg, kind, n_full)
                        for i, kind in enumerate(pat)}
    params["rem"] = [_init_block(gen, cfg, pat[i]) for i in range(rem)]
    return params


# --------------------------------------------------------------------------
# sequence forward
# --------------------------------------------------------------------------

def _block_seq(p, cfg: ModelConfig, kind: str, x, pos):
    """One residual block, full sequence (the dense kind has no MoE aux loss)."""
    if kind != "dense":
        raise ValueError(kind)
    h = rms_norm(x, p["n1"], cfg.rms_eps)
    x = x + attention(p["attn"], cfg, h, pos, causal=True, window=cfg.window)
    h2 = rms_norm(x, p["n2"], cfg.rms_eps)
    return x + mlp(p["mlp"], cfg, h2)


def _unstack(stacked) -> list:
    """Per-layer trees of a stacked block tree: one ``unbind`` per leaf (a
    ``p[i]`` per layer would give each layer's backward a zero tensor of
    the whole stack)."""
    cols = [t.unbind(0) for t in _tree.leaves(stacked)]
    return [_tree.unflatten(stacked, [c[i] for c in cols]) for i in range(len(cols[0]))]


def _run_stack(params, cfg: ModelConfig, x, pos):
    """The block stack, then the remainder layers. Returns (x, aux): the
    MoE aux loss, 0 for the dense family."""
    pat = _pattern(cfg)
    stacks = [_unstack(params["blocks"][f"{kind}_{i}"]) for i, kind in enumerate(pat)]
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for layer in zip(*stacks):
        for kind, bp in zip(pat, layer):
            fn = lambda x_, bp=bp, kind=kind: _block_seq(bp, cfg, kind, x_, pos)  # noqa: E731
            x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    for i, bp in enumerate(params.get("rem", [])):
        x = _block_seq(bp, cfg, pat[i], x, pos)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _embed(params, cfg: ModelConfig, tokens):
    """Embedding lookup: a gather of table rows, cast to the compute dtype.
    The reference contracts a one-hot with the table under a custom VJP (a
    TPU sharding device); each one-hot row sums a single term, so the values
    are the same, and the table's gradient accumulates in the table's dtype."""
    return F.embedding(tokens, params["embed"]).to(cfg.compute_dtype)


def _logits(params, cfg: ModelConfig, x):
    dt = cfg.compute_dtype
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(dt)).float()
    if cfg.vocab_padded != cfg.vocab:  # mask padded vocab slots
        mask = torch.zeros((cfg.vocab_padded,), dtype=torch.float32, device=logits.device)
        mask[cfg.vocab:] = -1e30
        logits = logits + mask
    return logits


def _positions(cfg: ModelConfig, batch, b: int, s: int, device):
    pos = batch.get("positions")
    if pos is None:
        pos = make_positions(b, s, mrope=cfg.mrope_sections is not None, device=device)
    return pos


def _backbone(params, cfg: ModelConfig, batch):
    """Everything up to (but not including) the LM head. Returns (x, aux)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens)
    pos = _positions(cfg, batch, tokens.shape[0], x.shape[1], x.device)
    return _run_stack(params, cfg, x, pos)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """batch: tokens (B,S) [, positions] -> (logits (B,S,Vp) f32, aux)."""
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
# weights carried across packages
# --------------------------------------------------------------------------

def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def params_from_numpy(tree, device="cpu"):
    """A tree of NumPy arrays (dicts and lists, as ``jax.device_get`` gives
    the reference's params) as the port's tree of tensors on ``device``,
    element for element."""
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
