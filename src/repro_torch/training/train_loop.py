"""Train-step factory and the fault-tolerant training loop
(``repro/training/train_loop.py``).

``make_train_step`` builds a (params, opt_state, batch) -> (params,
opt_state, metrics) function with optional gradient accumulation over
microbatches and optional int8 gradient compression.

``Trainer`` wraps it with the production concerns: periodic atomic
checkpoints (async), NaN/inf rollback, preemption-safe resume, straggler
detection, and the paper-integration spectral monitor (top-K Hessian
eigenvalues through the Lanczos core).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from ..core import tree as _tree
from ..models.common import ModelConfig
from ..models.model import loss_fn
from .checkpoint import CheckpointManager
from .optimizer import (
    OptConfig,
    OptState,
    adafactor_update,
    adamw_update,
    init_factored_state,
    init_opt_state,
)

__all__ = ["TrainConfig", "make_train_step", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    accum_steps: int = 1
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep_n: int = 3
    async_ckpt: bool = True
    straggler_factor: float = 3.0
    spectral_every: int = 0  # 0 = off; else compute top-K Hessian eigs
    spectral_k: int = 4
    compress_grads: bool = False  # int8 quantize-dequantize of the gradients
    optimizer: str = "adamw"  # 'adamw' | 'adafactor' (factored 2nd moment)
    accum_dtype: Any = None  # grad-accumulation dtype; None -> f32


def _grads_of(cfg: ModelConfig, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in _tree.leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(_tree.unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, _tree.unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, tc: TrainConfig) -> Callable:
    """The train step (gradient accumulation over ``tc.accum_steps``
    microbatches, each a slice of the batch axis)."""

    def train_step(params, opt_state: OptState, batch):
        if tc.accum_steps > 1:
            def split_mb(key, x):
                # batch axis: 1 for M-RoPE positions (3, B, S), else 0
                return x.chunk(tc.accum_steps, dim=1 if key == "positions" else 0)

            parts = {k: split_mb(k, v) for k, v in batch.items()}
            adt = tc.accum_dtype or torch.float32
            gsum = _tree.tree_map(lambda p: torch.zeros(p.shape, dtype=adt, device=p.device),
                                  params)
            lsum = torch.zeros((), dtype=torch.float32, device=_tree.leaves(params)[0].device)
            for i in range(tc.accum_steps):
                loss, _, grads = _grads_of(cfg, params, {k: v[i] for k, v in parts.items()})
                gsum = _tree.tree_map(lambda a, g: a + g.to(a.dtype), gsum, grads)
                lsum = lsum + loss
            grads = _tree.tree_map(lambda g: g / tc.accum_steps, gsum)
            loss = lsum / tc.accum_steps
            metrics = {}
        else:
            loss, metrics, grads = _grads_of(cfg, params, batch)

        if tc.compress_grads:
            from .compression import compress_tree

            grads = compress_tree(grads)

        if tc.optimizer == "adafactor":
            new_params, new_opt, opt_metrics = adafactor_update(grads, opt_state, params, tc.opt)
        else:
            new_params, new_opt, opt_metrics = adamw_update(grads, opt_state, params, tc.opt)
        return new_params, new_opt, {"loss": loss, **metrics, **opt_metrics}

    return train_step


class Trainer:
    """Fault-tolerant host loop around the step function."""

    def __init__(
        self,
        cfg: ModelConfig,
        tc: TrainConfig,
        params,
        step_fn: Optional[Callable] = None,
        probe_batch_fn: Optional[Callable[[], Dict]] = None,
    ):
        self.cfg = cfg
        self.tc = tc
        # own the buffers: the caller's tensors are never updated
        self.params = _tree.tree_map(lambda p: p.detach().clone(), params)
        self.opt_state = (
            init_factored_state(self.params) if tc.optimizer == "adafactor"
            else init_opt_state(self.params)
        )
        self.step_fn = step_fn or make_train_step(cfg, tc)
        self.ckpt = CheckpointManager(tc.ckpt_dir, keep_n=tc.keep_n, async_write=tc.async_ckpt)
        self.step = 0
        self.rollbacks = 0
        self.straggler_events = []
        self.spectra: Dict[int, Any] = {}
        self._probe_batch_fn = probe_batch_fn
        self._ema_dt = None

    # ---- fault tolerance ----
    def try_resume(self):
        tmpl = {"params": self.params, "opt": self.opt_state}
        step, tree, extra = self.ckpt.restore_latest(tmpl)
        if step is not None:
            self.params = tree["params"]
            self.opt_state = tree["opt"]
            self.step = step
            return True
        return False

    def _checkpoint(self):
        self.ckpt.save(self.step, {"params": self.params, "opt": self.opt_state},
                       extra={"rollbacks": self.rollbacks})

    def _rollback(self):
        """NaN/inf loss: restore last good checkpoint and skip forward."""
        tmpl = {"params": self.params, "opt": self.opt_state}
        step, tree, _ = self.ckpt.restore_latest(tmpl)
        if step is None:
            raise RuntimeError("non-finite loss before any checkpoint exists")
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step = step
        self.rollbacks += 1

    def _spectral_probe(self):
        """Paper integration: top-K eigenvalues of the loss Hessian via the
        mixed-precision Lanczos core (matrix-free HVP operator)."""
        from .spectral import hessian_topk

        batch = self._probe_batch_fn()
        evals = hessian_topk(self.params, self.cfg, batch, k=self.tc.spectral_k)
        self.spectra[self.step] = evals

    # ---- main loop ----
    def run(self, stream: Iterator[Dict], num_steps: int, log_every: int = 10,
            log_fn: Callable = print):
        if self.step == 0:
            self._checkpoint()  # step-0 anchor for rollback
        history = []
        for batch in stream:
            if self.step >= num_steps:
                break
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            # straggler detection (per-step time watchdog)
            if self._ema_dt is not None and dt > self.tc.straggler_factor * self._ema_dt:
                self.straggler_events.append((self.step, dt, self._ema_dt))
            self._ema_dt = dt if self._ema_dt is None else 0.9 * self._ema_dt + 0.1 * dt

            if not math.isfinite(loss):
                log_fn(f"step {self.step}: non-finite loss ({loss}); rolling back")
                self._rollback()
                continue
            self.step += 1
            history.append(loss)
            if self.step % self.tc.ckpt_every == 0:
                self._checkpoint()
            if self.tc.spectral_every and self.step % self.tc.spectral_every == 0 \
                    and self._probe_batch_fn is not None:
                self._spectral_probe()
            if self.step % log_every == 0:
                log_fn(
                    f"step {self.step}: loss={loss:.4f} lr={float(metrics['lr']):.2e} "
                    f"gnorm={float(metrics['grad_norm']):.2f} dt={dt*1e3:.0f}ms"
                )
        self.ckpt.wait()
        return history
