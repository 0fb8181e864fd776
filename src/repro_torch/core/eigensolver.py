"""Fixed-subspace Top-K eigensolver engine (the paper's Fig. 1 pipeline).

``solve_fixed`` = Lanczos on the operator's device (phase 1) + Jacobi on the
host (phase 2, the paper's placement; ``jacobi="jax"`` runs it on the
device) + the back-projection ``X = V^T W`` and |lambda|-descending
selection (phase 3).  The user-facing entry point is ``repro_torch.eigsh``;
``topk_eigs`` is a deprecated shim.
"""

from __future__ import annotations

import time
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..analysis.op_count import host_scope
from .jacobi import jacobi_eigh, jacobi_eigh_host, tridiag_to_dense
from .lanczos import LanczosResult, check_tridiag_health, lanczos_tridiag, ops_for_operator
from .operators import LinearOperator
from .precision import FDF, PrecisionPolicy

__all__ = [
    "EigResult",
    "FixedSolveOutput",
    "ritz_decompose",
    "ritz_extract",
    "solve_fixed",
    "topk_eigs",
    "operator_device",
]

JACOBI_PLACEMENTS = ("host", "jax")


class EigResult(NamedTuple):
    """Legacy result type of the deprecated ``topk_eigs`` shims."""

    eigenvalues: torch.Tensor  # (k,) output dtype, |lambda| descending
    eigenvectors: torch.Tensor  # (n, k) output dtype, column-wise
    tridiag: LanczosResult  # raw Lanczos output (alpha, beta, basis)
    wall_time_s: float


class FixedSolveOutput(NamedTuple):
    """Raw engine output consumed by the ``eigsh`` frontend."""

    eigenvalues: torch.Tensor  # (k,) output dtype, |lambda| descending
    eigenvectors: torch.Tensor  # (n, k) output dtype
    residuals: np.ndarray  # (k,) float64 — Ritz residual bounds |beta_m W[m-1,i]|
    eigenvalues_f64: np.ndarray  # (k,) float64 — before the output cast
    tridiag: LanczosResult
    iterations: int
    timings: dict  # seconds: lanczos / jacobi / project / total


def operator_device(op: LinearOperator) -> torch.device:
    """The device an operator's data lives on."""
    dev = getattr(op, "device", None)
    if dev is not None:
        return torch.device(dev)
    eng = getattr(op, "engine", None)
    if eng is not None:
        return torch.device(eng.device)
    return op.a.device


def ritz_decompose(lres: LanczosResult, policy: PrecisionPolicy, jacobi: str = "host"):
    """Phase 2: Jacobi on the Lanczos tridiagonal, on the host (``"host"``)
    or on the basis's device in the ritz-phase dtype (``"jax"``, the
    reference's name for its device placement).

    Returns ``(evals, w, evals_f64, w_f64, beta_m)``: ``evals`` / ``w`` on
    the basis's device in the ritz-phase dtype (|lambda| descending), the
    f64 host copies for the residual arithmetic, and the final residual norm
    ``beta_m``.
    """
    if jacobi not in JACOBI_PLACEMENTS:
        raise ValueError(f"jacobi must be one of {JACOBI_PLACEMENTS}, got {jacobi!r}")
    rzdt = policy.phase_dtype("ritz")
    dev = lres.basis.device
    # The host Jacobi and the f64 host copies are NumPy work in the
    # reference, outside its traces: hidden from the op counter.
    if jacobi == "host":
        with host_scope():
            t_host = tridiag_to_dense(lres.alpha.cpu().to(torch.float64).numpy(),
                                      lres.beta.cpu().to(torch.float64).numpy())
            evals_f64, w_host = jacobi_eigh_host(t_host)
            evals = torch.as_tensor(evals_f64).to(device=dev, dtype=rzdt)
            w = torch.as_tensor(w_host).to(device=dev, dtype=rzdt)
    else:
        evals, w = jacobi_eigh(tridiag_to_dense(lres.alpha, lres.beta).to(rzdt))
        with host_scope():
            evals_f64 = evals.cpu().to(torch.float64).numpy()
    with host_scope():
        # Residual arithmetic sees W as the solver uses it: rounded through rzdt.
        w_f64 = w.cpu().to(torch.float64).numpy()
        beta_m = (float(lres.beta_last.cpu().to(torch.float64))
                  if lres.beta_last is not None else 0.0)
    return evals, w, np.asarray(evals_f64, dtype=np.float64), w_f64, beta_m


def ritz_extract(lres: LanczosResult, evals, w, w_f64: np.ndarray, beta_m: float, k: int,
                 policy: PrecisionPolicy):
    """Phase 3: Top-K selection + back-projection ``X = V^T W`` + residuals."""
    m = int(w_f64.shape[0])
    rzdt = policy.phase_dtype("ritz")
    evals_k = evals[:k]
    w_k = w[:, :k].to(rzdt)
    x = (lres.basis.to(rzdt).T @ w_k).to(policy.output)
    # Classical Ritz residual bound: ||A x_i - theta_i x_i|| = |beta_m W[m-1,i]|.
    residuals = np.abs(beta_m * w_f64[m - 1, :k])
    return evals_k.to(policy.output), x, residuals


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def solve_fixed(
    op: LinearOperator,
    k: int,
    policy: PrecisionPolicy = FDF,
    reorth: str = "half",
    num_iters: Optional[int] = None,
    v1=None,
    seed: int = 0,
    jacobi: str = "host",
    ops=None,
    probe: bool = True,
    checkpoint=None,
) -> FixedSolveOutput:
    """The K eigenpairs of largest |lambda| of a symmetric operator.

    ``num_iters`` defaults to ``k`` (the paper's configuration).  ``v1`` is
    the start vector (any array-like of length n); without one, it is drawn
    from a ``torch.Generator`` seeded with ``seed`` on the operator's device
    (the reference draws from ``jax.random``, which PyTorch cannot
    reproduce: pass the same ``v1`` to both to compare them).  ``jacobi``
    places phase 2 (see :func:`ritz_decompose`); ``checkpoint`` goes to
    :func:`~repro_torch.core.lanczos.lanczos_tridiag`.
    """
    policy = policy.effective()
    m = num_iters or k
    if m < k:
        raise ValueError("num_iters must be >= k")
    n = op.n
    dev = operator_device(op)
    if v1 is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        v1 = torch.randn((n,), generator=gen, dtype=policy.compute, device=dev)
    else:
        v1 = v1 if isinstance(v1, torch.Tensor) else torch.as_tensor(np.asarray(v1))
        if tuple(v1.shape) != (n,):
            raise ValueError(f"start vector has shape {tuple(v1.shape)}, expected ({n},)")
        v1 = v1.to(device=dev)

    t0 = time.perf_counter()
    if ops is None:
        ops = ops_for_operator(op, policy, device=dev)
    lres = lanczos_tridiag(op.bound_matvec(policy), v1, m, policy, reorth=reorth, ops=ops,
                           checkpoint=checkpoint)
    _sync(dev)
    if probe:
        check_tridiag_health(lres, policy)
    t_lanczos = time.perf_counter() - t0

    t1 = time.perf_counter()
    evals, w, evals_f64, w_f64, beta_m = ritz_decompose(lres, policy, jacobi)
    t_jacobi = time.perf_counter() - t1

    t2 = time.perf_counter()
    evals_k, x, residuals = ritz_extract(lres, evals, w, w_f64, beta_m, k, policy)
    _sync(dev)
    t_project = time.perf_counter() - t2

    return FixedSolveOutput(
        eigenvalues=evals_k,
        eigenvectors=x,
        residuals=residuals,
        eigenvalues_f64=np.asarray(evals_f64[:k], dtype=np.float64),
        tridiag=lres,
        iterations=m,
        timings={
            "lanczos_s": t_lanczos,
            "jacobi_s": t_jacobi,
            "project_s": t_project,
            "total_s": time.perf_counter() - t0,
        },
    )


def topk_eigs(
    op: LinearOperator,
    k: int,
    policy: PrecisionPolicy = FDF,
    reorth: str = "half",
    num_iters: Optional[int] = None,
    v1=None,
    seed: int = 0,
    jacobi: str = "host",
) -> EigResult:
    """Deprecated: use :func:`repro_torch.eigsh` (the unified frontend).
    Runs on the operator's device."""
    warnings.warn(
        "topk_eigs is deprecated; use repro_torch.eigsh(A, k, backend='single', ...)",
        DeprecationWarning,
        stacklevel=2,
    )
    from ..api import eigsh

    res = eigsh(op, k, policy=policy, backend="single", reorth=reorth, num_iters=num_iters,
                v0=v1, seed=seed, jacobi=jacobi, device=str(operator_device(op)))
    return EigResult(eigenvalues=res.eigenvalues, eigenvectors=res.eigenvectors,
                     tridiag=res.tridiag, wall_time_s=res.timings["total_s"])
