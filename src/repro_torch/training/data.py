"""Deterministic synthetic LM data pipeline (``repro/training/data.py``).

Zipf-distributed token streams with a planted bigram structure, so the loss
has real signal to minimize.  Batches are derived purely from (seed, step,
host) with NumPy's generator, the reference's draws, so both packages get
byte-equal batches; a restarted job resumes the stream exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from .._device import resolve_device
from ..models.common import ModelConfig

__all__ = ["DataConfig", "synthetic_batch", "data_stream", "BATCH_AXES"]

# The inputs' logical axes (the reference dry-run's ``batch_axes``): under a
# mesh ``distributed.sharding.distribute_tree(batch, BATCH_AXES)`` splits
# each over the batch axes.
BATCH_AXES = {
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "frames": ("batch", None, None),
    "positions": (None, "batch", None),
}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.3
    num_hosts: int = 1
    host_id: int = 0


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int, a: float) -> np.ndarray:
    """Bounded zipf via inverse-CDF (np.random.zipf is unbounded)."""
    ranks = np.arange(1, min(vocab, 65536) + 1, dtype=np.float64)
    p = ranks ** (-a)
    cdf = np.cumsum(p / p.sum())
    u = rng.random(shape)
    return np.searchsorted(cdf, u).astype(np.int32) % vocab


def synthetic_batch(cfg: ModelConfig, dc: DataConfig, step: int,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """One batch of int32 ``tokens`` and ``labels`` on ``device``.  Planted
    structure: every token at odd position repeats a deterministic function
    of its predecessor (learnable bigrams).  ``encdec`` batches carry f32
    ``frames`` (B, S, d_model) for the encoder; ``vlm`` batches carry
    ``max(1, S // 8)`` patch embeddings, which prefix the text, with labels
    -1 over them."""
    device = resolve_device(device)
    rng = np.random.default_rng((dc.seed * 1_000_003 + step) * 97 + dc.host_id)
    b = dc.batch // dc.num_hosts
    s = dc.seq_len
    toks = _zipf_tokens(rng, (b, s), cfg.vocab, dc.zipf_a)
    # plant bigram signal: t[2i+1] = (t[2i] * 7 + 13) % vocab
    toks[:, 1::2] = (toks[:, 0::2] * 7 + 13) % cfg.vocab
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
    frames = None
    if cfg.family == "encdec":
        frames = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.family == "vlm":
        npatch = max(1, s // 8)
        frames = rng.standard_normal((b, npatch, cfg.d_model)).astype(np.float32) * 0.02
        labels = np.concatenate([np.full((b, npatch), -1, np.int32), labels], axis=1)
    batch = {"tokens": torch.from_numpy(toks).to(device),
             "labels": torch.from_numpy(labels).to(device)}
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames).to(device)
    return batch


def data_stream(cfg: ModelConfig, dc: DataConfig, start_step: int = 0,
                device="cuda") -> Iterator[Dict]:
    device = resolve_device(device)
    step = start_step
    while True:
        yield synthetic_batch(cfg, dc, step, device=device)
        step += 1
