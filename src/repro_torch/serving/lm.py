"""Legacy LM decode engine: prefill, then a loop of single-token decode
steps (``repro/serving/lm.py``).

It is not the eigensolver serving layer (``repro_torch.serving.scheduler``).
Importing ``Engine`` / ``ServeConfig`` from ``repro_torch.serving`` still
works with a ``DeprecationWarning``; import them from here to silence it.
Decode steps run eagerly (the reference jits them); greedy decoding takes
the argmax over the real vocabulary, and a temperature above 0 samples from
a ``torch.Generator`` seeded by ``seed`` on the logits' device, so sampled
tokens are reproducible but not the reference's ``jax.random`` draws.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Tuple

import torch

from ..models.common import ModelConfig
from ..models.model import decode_step, prefill

__all__ = ["ServeConfig", "Engine"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0  # 0 = greedy
    eos_id: int = -1  # -1 = never stop
    pad_id: int = 0


class Engine:
    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig = ServeConfig()):
        self.cfg = cfg
        self.params = params
        self.sc = sc
        self._decode = partial(decode_step, cfg=cfg)

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        logits = logits[..., : self.cfg.vocab]
        if self.sc.temperature <= 0.0:
            return logits.argmax(dim=-1).to(torch.int32)
        probs = torch.softmax(logits / self.sc.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)

    @torch.no_grad()
    def generate(self, batch: Dict, steps: int, seed: int = 0) -> Tuple[torch.Tensor, Dict]:
        """batch: prompt dict (tokens (B,S) [, frames]) on the model's device.  Returns
        (tokens (B, steps) int32, {"token_logprobs": (B, steps) f32,
        "final_state": DecodeState}); after an ``eos_id`` a row emits
        ``pad_id``."""
        state, logits = prefill(self.params, self.cfg, batch, max_len=self.sc.max_len)
        b = batch["tokens"].shape[0]
        dev = logits.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        outs, tok_ps = [], []
        for _ in range(steps):
            nxt = self._sample(logits, gen)
            logp = torch.log_softmax(logits[..., : self.cfg.vocab], dim=-1)
            tok_ps.append(logp.gather(-1, nxt[:, None].long())[:, 0])
            nxt = torch.where(done, torch.full_like(nxt, self.sc.pad_id), nxt)
            outs.append(nxt)
            if self.sc.eos_id >= 0:
                done = done | (nxt == self.sc.eos_id)
            logits, state = self._decode(params=self.params, state=state, tokens=nxt[:, None])
        tokens = torch.stack(outs, dim=1)
        return tokens, {"token_logprobs": torch.stack(tok_ps, dim=1), "final_state": state}
