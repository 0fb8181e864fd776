"""Spectral monitoring of training: the framework integration of the paper
(``repro/training/spectral.py``).

The same Top-K solver runs *matrix-free* on the loss Hessian through
:class:`~repro_torch.core.operators.HvpOperator`: the top-K curvature
eigenvalues diagnose sharpness, learning-rate stability (lambda_max against
2/eta) and the conditioning of the loss landscape.  The mixed-precision
policy applies unchanged: the Lanczos vectors are stored in the policy's
storage dtype while alpha and beta accumulate in its compute dtype.  On the
card the three-term update of every step runs the ``lanczos_update`` kernel
(``fused`` is the card's update mode), on a params-sized vector.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..api import EigenResult, eigsh
from ..core import tree as _tree
from ..core.operators import HvpOperator
from ..core.precision import FFF, PrecisionPolicy
from ..models.common import ModelConfig
from ..models.model import loss_fn

__all__ = ["hessian_topk", "hessian_spectrum"]


def hessian_spectrum(
    params,
    cfg: ModelConfig,
    batch: Dict,
    k: int = 4,
    policy: PrecisionPolicy = FFF,
    num_iters: Optional[int] = None,
    seed: int = 0,
    tol: Optional[float] = None,
    v0=None,
) -> EigenResult:
    """Full :class:`EigenResult` for the Hessian of the batch loss at
    ``params``, solved on the params' device.  ``v0`` (length: the number
    of parameters, in the flat order of :mod:`repro_torch.core.tree`) pins
    the start vector; without it one is drawn from ``seed``."""

    def scalar_loss(p):
        return loss_fn(p, cfg, batch)[0]

    op = HvpOperator(scalar_loss, params)
    return eigsh(
        op,
        k,
        policy=policy,
        backend="single",
        reorth="full",
        num_iters=num_iters or max(2 * k, 8),
        tol=tol,
        seed=seed,
        v0=v0,
        device=str(_tree.leaves(params)[0].device),
    )


def hessian_topk(
    params,
    cfg: ModelConfig,
    batch: Dict,
    k: int = 4,
    policy: PrecisionPolicy = FFF,
    num_iters: Optional[int] = None,
    seed: int = 0,
) -> np.ndarray:
    """Top-K |eigenvalues| of the Hessian of the batch loss at ``params``."""
    res = hessian_spectrum(params, cfg, batch, k=k, policy=policy, num_iters=num_iters, seed=seed)
    return res.eigenvalues.detach().cpu().double().numpy()
