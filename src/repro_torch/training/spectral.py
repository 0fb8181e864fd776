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

With DTensor params (a sharded model, under ``sharding_ctx``) the vector is
partitioned over the ranks (``HvpOperator``'s owned blocks): each rank runs
the update on its own slice and the reductions meet in rank order, so the
eigenvalues are the same on every rank; the eigenvectors come back as each
rank's slices.
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
    if op.sharded:
        return _sharded_spectrum(op, k, policy, num_iters or max(2 * k, 8), seed, v0)
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


def _sharded_spectrum(op: HvpOperator, k: int, policy: PrecisionPolicy, m: int, seed: int,
                      v0) -> EigenResult:
    """The fixed-subspace solve of ``eigsh(op, k, reorth="full")`` with the
    vector partitioned over the default group's ranks (see
    :class:`HvpOperator`): each rank runs the loop on its owned slice, the
    three-term update in ``lanczos_update`` on the card, ``dot`` and
    ``project_out`` reduced in rank order by ``ShardComm`` (rank-identical
    alpha and beta, hence rank-identical eigenvalues).  The start vector is
    ``v0``'s slice, or, without one, the slice of the whole draw an
    unsharded call makes.  The eigenvectors are this rank's
    ``(n_local, k)`` slices."""
    import time

    import torch

    from ..core.distributed import ShardComm, sharded_reductions
    from ..core.eigensolver import ritz_decompose, ritz_extract
    from ..core.lanczos import Ops, _lanczos_loop, check_tridiag_health, resolve_update_mode

    policy = policy.effective()
    comm = ShardComm()
    t0 = time.perf_counter()
    if v0 is None:
        gen = torch.Generator(device=op.device).manual_seed(seed)
        v0 = torch.randn((op.n,), generator=gen, dtype=policy.compute, device=op.device)
    v1 = op.local_slices(v0).to(policy.compute)
    dot, project_out, fused_update = sharded_reductions(policy, comm, "full")
    if resolve_update_mode(policy, device=op.device) == "unfused":
        fused_update = None
    ops = Ops(matvec=lambda x: op.matvec(x, accum_dtype=policy.compute), dot=dot,
              project_out=project_out, fused_update=fused_update)
    lres = _lanczos_loop(v1, ops, m, policy, "full")
    check_tridiag_health(lres, policy)
    t_lanczos = time.perf_counter() - t0
    evals, w, _, w_f64, beta_m = ritz_decompose(lres, policy)
    evals_k, x, residuals = ritz_extract(lres, evals, w, w_f64, beta_m, k, policy)
    return EigenResult(
        eigenvalues=evals_k, eigenvectors=x, residuals=np.asarray(residuals, dtype=np.float64),
        converged=np.zeros(k, dtype=bool), iterations=m, restarts=0, k=k, n=op.n,
        backend="distributed", policy=policy.name, tol=0.0, num_devices=comm.size,
        partition={"layout": "owned DTensor blocks", "n_local": int(op.n_local),
                   "num_shards": int(comm.size)},
        timings={"lanczos_s": t_lanczos, "collective_s": comm.take_seconds(),
                 "total_s": time.perf_counter() - t0},
        tridiag=lres,
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
