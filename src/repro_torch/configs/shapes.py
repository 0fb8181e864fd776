"""Assigned input-shape sets and meta-tensor builders, the dry-run's inputs
(``repro/configs/shapes.py``).

Every LM arch is paired with four shapes:

  train_4k     seq=4096    global_batch=256   -> runs train_step
  prefill_32k  seq=32768   global_batch=32    -> runs prefill
  decode_32k   seq=32768   global_batch=128   -> runs decode_step (1 token,
                                                 KV cache of seq_len)
  long_500k    seq=524288  global_batch=1     -> decode_step; sub-quadratic
                                                 archs only (SSM / RG-LRU
                                                 local attn / SWA)

``input_specs`` returns tensors on the meta device (shapes and dtypes, no
storage): the port's ``ShapeDtypeStruct``.  For the [audio]/[vlm] archs the
modality frontend is a stub: the inputs carry precomputed frame/patch
embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..models.common import ModelConfig

__all__ = ["SHAPES", "ShapeSpec", "input_specs", "applicable"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Archs with O(S^2) full attention cannot run 512k-token attention at all:
# long_500k pairs only with the sub-quadratic ones.
_SUBQUADRATIC = {"mamba2-130m", "recurrentgemma-2b", "mixtral-8x7b"}


def applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in _SUBQUADRATIC
    return True


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(
    cfg: ModelConfig, shape: ShapeSpec, batch_override: Optional[int] = None
) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this (arch, shape).

    For 'train'/'prefill': a batch dict.  For 'decode': a batch dict with a
    1-token step plus the decode-state template, built by
    ``init_decode_state`` on the meta device (no allocation).
    """
    b = batch_override or shape.global_batch
    s = shape.seq_len
    emb = torch.float32  # stub frontend embeddings arrive in f32

    if shape.mode in ("train", "prefill"):
        if cfg.family == "encdec":
            src, tgt = s // 2, s // 2
            d = {"frames": _meta((b, src, cfg.d_model), emb), "tokens": _meta((b, tgt))}
            if shape.mode == "train":
                d["labels"] = _meta((b, tgt))
            return d
        if cfg.family == "vlm":
            patches = min(1024, s // 4)
            d = {
                "frames": _meta((b, patches, cfg.d_model), emb),
                "tokens": _meta((b, s - patches)),
                "positions": _meta((3, b, s)),
            }
            if shape.mode == "train":
                d["labels"] = _meta((b, s))
            return d
        d = {"tokens": _meta((b, s))}
        if shape.mode == "train":
            d["labels"] = _meta((b, s))
        if cfg.mrope_sections is not None:
            d["positions"] = _meta((3, b, s))
        return d

    # decode: one new token against a state of length seq_len
    from ..models.model import init_decode_state

    enc_len = min(4096, s // 8)  # encdec: assumed encoder context
    state = init_decode_state(cfg, b, s, step=s - 1, enc_len=enc_len, device="meta")
    return {"tokens": _meta((b, 1)), "state": state}
