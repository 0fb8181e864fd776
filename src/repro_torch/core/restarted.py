"""Thick-restart Lanczos (Wu & Simon 2000), the engine behind every ``tol=``.

The paper runs exactly K Lanczos steps, which caps the accuracy it can
reach.  This engine restarts instead, as ARPACK does: it compresses the
subspace to the best Ritz directions and continues until every pair meets
the requested tolerance.

  * a subspace of m vectors (m >= k + 2); a restart keeps the top-k Ritz
    vectors plus the residual direction;
  * after a restart the projected matrix is an arrowhead plus a
    tridiagonal, solved densely by the host Jacobi of phase 2;
  * per-pair convergence: ``|beta_m W[m-1, i]| <= tol * |theta_i|`` (the
    Ritz residual bound, no extra SpMV);
  * the vector arithmetic follows the precision policy (storage vs compute
    and the per-phase dtypes), as in the reference.

The reference's ``solve_restarted`` (``repro/core/restarted.py``), with the
host loop over tensors: alpha and beta are host floats, so every step reads
two scalars back (the convergence loop is host-orchestrated by design).
The user-facing entry point is ``repro_torch.eigsh`` with ``tol=`` (or
``backend="restarted"``); ``topk_eigs_restarted`` is a deprecated shim.
As in the reference, the engine keeps the host Jacobi whatever ``jacobi=``
the caller asked for.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..testing import faults as _faults
from .eigensolver import EigResult, _sync, operator_device
from .jacobi import jacobi_eigh_host
from .lanczos import LanczosResult, NumericalBreakdown
from .operators import LinearOperator
from .precision import FDF, PrecisionPolicy
from .trace import span

__all__ = [
    "RestartedSolveOutput",
    "restart_kernels",
    "ritz_project",
    "solve_restarted",
    "topk_eigs_restarted",
]


def restart_kernels(policy: PrecisionPolicy):
    """The restarted engine's vector kernels ``(dot, orth)``.

    ``dot`` is a plain sum in the ``alpha_beta`` phase dtype (not the
    compensated sum, even under FCF: the reference's restarted engine sums
    plainly).  ``orth(u, basis_r)`` subtracts from ``u`` its projection on
    the rows of ``basis_r``, the stored rows already cast to the ``reorth``
    phase dtype; ``u`` goes to that dtype as it is, without the round trip
    through the storage dtype that the fixed path's ``project_out`` makes.
    """
    policy = policy.effective()
    cdt = policy.compute
    abdt = policy.phase_dtype("alpha_beta")
    rdt = policy.phase_dtype("reorth")

    def dot(a, b):
        return torch.sum(a.to(abdt) * b.to(abdt)).to(cdt)

    def orth(u, basis_r):
        ur = u.to(rdt)
        coeffs = basis_r @ ur
        return (ur - coeffs @ basis_r).to(cdt)

    return dot, orth


def ritz_project(basis: torch.Tensor, wk: torch.Tensor, policy: PrecisionPolicy, out_dtype=None):
    """Ritz back-projection ``V^T @ W_k`` in the policy's ritz phase dtype,
    shared by the restart compression and the final eigenvectors."""
    rzdt = policy.phase_dtype("ritz")
    x = basis.to(rzdt).T @ wk.to(rzdt)
    return x.to(out_dtype if out_dtype is not None else policy.output)


class RestartedSolveOutput(NamedTuple):
    """Raw engine output consumed by the ``eigsh`` frontend."""

    eigenvalues: torch.Tensor  # (k,) output dtype
    eigenvectors: torch.Tensor  # (n, k) output dtype
    residuals: np.ndarray  # (k,) float64: final Ritz residual bounds
    eigenvalues_f64: np.ndarray  # (k,) float64: before the output cast, for tol checks
    tridiag: LanczosResult
    iterations: int  # Lanczos steps over all cycles
    restarts: int  # restarts performed
    timings: dict  # seconds: lanczos (the fill loops) / jacobi (host) / total


def solve_restarted(
    op: LinearOperator,
    k: int,
    policy: PrecisionPolicy = FDF,
    m: Optional[int] = None,
    max_restarts: int = 30,
    tol: float = 1e-8,
    seed: int = 0,
    v1=None,
    probe: bool = True,
    checkpoint=None,
) -> RestartedSolveOutput:
    """Top-k eigenpairs by |lambda|, restarting until the Ritz residual
    bound meets ``tol`` (relative) for every pair or ``max_restarts`` cycles
    have run.

    Without ``v1`` the start vector is ``np.random.default_rng(seed)
    .standard_normal(n)``, the reference's own draw, so both packages start
    from the same vector.  ``probe`` turns a non-finite alpha or beta, or a
    beta below ``finfo(compute).tiny * 1e3`` before the subspace is full,
    into a :class:`NumericalBreakdown` at the offending step.

    ``checkpoint`` is a ``(store, token)`` pair (see
    :class:`~repro_torch.serving.store.SolveCheckpoint`): the restart state
    (basis block, projected matrix, arrow border, next start vector,
    counters) is saved after every compression, and a rerun with the same
    token resumes at the next cycle bit-identically (each cycle depends only
    on that state); a completed solve clears the snapshot.

    The basis lives in the storage dtype, one preallocated ``(m, n)``
    tensor written row by row.  Where the reorth dtype differs from the
    storage dtype (FDF, BFF), the rows written so far are also kept cast to
    the reorth dtype: a stored row cast up has the same value every time,
    so the mirror spares each step the cast of the whole basis and changes
    no result (the Ritz projections read it too where the ritz dtype is the
    reorth dtype).
    """
    policy = policy.effective()
    cdt, sdt = policy.compute, policy.storage
    rzdt = policy.phase_dtype("ritz")
    rdt = policy.phase_dtype("reorth")
    n = op.n
    m = m or max(2 * k, k + 8)
    if m <= k + 1:
        raise ValueError(f"subspace m={m} must exceed k={k} by at least 2")
    if max_restarts < 1:
        raise ValueError(f"max_restarts must be >= 1, got {max_restarts}")
    dev = operator_device(op)
    mv = op.bound_matvec(policy)
    _dot, _orth = restart_kernels(policy)

    timings = {"lanczos_s": 0.0, "jacobi_s": 0.0}
    with span(None, timings, "total_s"):
        if v1 is None:
            v = torch.as_tensor(np.random.default_rng(seed).standard_normal(n))
            v = v.to(device=dev, dtype=cdt)
        else:
            v1 = v1 if isinstance(v1, torch.Tensor) else torch.as_tensor(np.asarray(v1))
            if tuple(v1.shape) != (n,):
                raise ValueError(f"start vector has shape {tuple(v1.shape)}, expected ({n},)")
            v = v1.to(device=dev, dtype=cdt)
        v = v / torch.sqrt(_dot(v, v))

        basis = torch.zeros((m, n), dtype=sdt, device=dev)
        basis_r = basis if rdt == sdt else torch.zeros((m, n), dtype=rdt, device=dev)
        basis_z = basis_r if rzdt == rdt else basis  # what the Ritz projections read
        t_hat = np.zeros((m, m))
        nkeep = 0  # locked Ritz vectors at the head of the basis
        s_border = np.zeros(0)  # arrow column entries for the kept block
        evals = w = None
        steps = 0
        restarts = 0
        resid = np.zeros(k)
        beta_m = 0.0
        breakdown_tiny = float(torch.finfo(cdt).tiny) * 1e3
        pol_name = getattr(policy, "name", None) or str(policy)

        start_cycle = 0
        if checkpoint is not None:
            store, token = checkpoint
            state = store.load(token)
            if (state is not None and state.get("engine") == "restarted"
                    and int(state.get("n", -1)) == n and int(state.get("m", -1)) == m
                    and int(state.get("k", -1)) == k):
                basis.copy_(state["basis"])
                if basis_r is not basis:  # the mirror, rebuilt from the loaded rows
                    basis_r.copy_(basis)
                t_hat = np.asarray(state["t_hat"], np.float64)
                s_border = np.asarray(state["s_border"], np.float64)
                v = state["v"].to(device=dev, dtype=cdt)
                nkeep = int(state["nkeep"])
                steps = int(state["steps"])
                restarts = int(state["restarts"])
                start_cycle = int(state["cycle"]) + 1

        for cycle in range(start_cycle, max_restarts):
            _faults.check_solve_crash(cycle)
            # --- fill rows nkeep..m-1 with fully re-orthogonalized Lanczos steps ---
            with span("repro_torch.sweep.lanczos", timings, "lanczos_s"):
                beta_prev = 0.0
                v_prev = torch.zeros((n,), dtype=cdt, device=dev)
                for i in range(nkeep, m):
                    basis[i].copy_(v)  # rounded to the storage dtype: the SpMV's input too
                    if basis_r is not basis:
                        basis_r[i].copy_(basis[i])
                    u = mv(basis[i]).to(cdt)
                    u = _faults.tap_spmv(u, i)
                    alpha = float(_dot(v, u))
                    if probe and not np.isfinite(alpha):
                        raise NumericalBreakdown("nonfinite", i, pol_name, f"alpha={alpha!r}")
                    t_hat[i, i] = alpha
                    u = u - alpha * v - beta_prev * v_prev
                    if i == nkeep and nkeep > 0:
                        # arrowhead coupling to the kept Ritz block
                        border = torch.as_tensor(s_border).to(device=dev, dtype=cdt)
                        u = u - border @ basis[:nkeep].to(cdt)
                        t_hat[i, :nkeep] = s_border
                        t_hat[:nkeep, i] = s_border
                    # Full re-orthogonalization against the rows written so far (the
                    # reference masks the rest, which are zero).
                    u = _orth(u, basis_r[: i + 1])
                    beta = float(torch.sqrt(torch.clamp_min(_dot(u, u), 0.0)))
                    beta = float(_faults.tap_beta(beta, i))
                    if probe:
                        if not np.isfinite(beta):
                            raise NumericalBreakdown("nonfinite", i, pol_name, f"beta={beta!r}")
                        if beta <= breakdown_tiny and i < m - 1:
                            raise NumericalBreakdown(
                                "beta_underflow", i, pol_name,
                                f"beta={beta:.3e} <= {breakdown_tiny:.3e}")
                    if i < m - 1:
                        t_hat[i, i + 1] = beta
                        t_hat[i + 1, i] = beta
                    beta_prev, v_prev = beta, v
                    v = u / max(beta, 1e-300)
                    steps += 1
            beta_m = beta_prev

            # --- Ritz pairs of the projected matrix ---
            with span("repro_torch.ritz.jacobi", timings, "jacobi_s"):
                evals, w = jacobi_eigh_host(t_hat)  # |lambda| descending
            resid = np.abs(beta_m * w[m - 1, :k])
            if np.all(resid <= tol * np.maximum(np.abs(evals[:k]), 1e-300)):
                break
            if cycle == max_restarts - 1:
                # Budget spent: stop WITHOUT compressing, so the projection below
                # uses `w` in the coordinates of the current basis.
                break

            # --- thick restart: compress to the top-k Ritz vectors ---
            restarts += 1
            wk = torch.as_tensor(w[:, :k]).to(device=dev, dtype=rzdt)
            ritz = ritz_project(basis_z, wk, policy, out_dtype=rzdt).T  # (k, n)
            basis.zero_()
            basis[:k] = ritz.to(sdt)
            if basis_r is not basis:
                basis_r[:k] = basis[:k].to(rdt)
            t_hat = np.zeros((m, m))
            t_hat[:k, :k] = np.diag(evals[:k])
            s_border = beta_m * w[m - 1, :k]
            nkeep = k
            # v (the next Lanczos vector) already holds the residual direction

            if checkpoint is not None:
                store, token = checkpoint
                store.save(token, {
                    "engine": "restarted", "cycle": cycle, "n": n, "m": m, "k": k,
                    "nkeep": nkeep, "steps": steps, "restarts": restarts,
                    "basis": basis, "t_hat": t_hat, "s_border": s_border, "v": v,
                })

        if checkpoint is not None:
            store, token = checkpoint
            store.clear(token)  # completed: the snapshot must not resurrect
        evals_k = torch.as_tensor(evals[:k]).to(device=dev, dtype=policy.output)
        wk = torch.as_tensor(w[:, :k]).to(device=dev, dtype=rzdt)
        x = ritz_project(basis_z, wk, policy)
        lres = LanczosResult(
            alpha=torch.as_tensor(np.diag(t_hat).copy()).to(device=dev, dtype=cdt),
            beta=torch.as_tensor(np.diag(t_hat, 1).copy()).to(device=dev, dtype=cdt),
            basis=basis,
            beta_last=torch.tensor(beta_m, dtype=cdt, device=dev),
        )
        _sync(dev)
    return RestartedSolveOutput(
        eigenvalues=evals_k,
        eigenvectors=x,
        residuals=np.asarray(resid, dtype=np.float64),
        eigenvalues_f64=np.asarray(evals[:k], dtype=np.float64),
        tridiag=lres,
        iterations=steps,
        restarts=restarts,
        timings=timings,
    )


def topk_eigs_restarted(
    op: LinearOperator,
    k: int,
    policy: PrecisionPolicy = FDF,
    m: Optional[int] = None,
    max_restarts: int = 30,
    tol: float = 1e-8,
    seed: int = 0,
) -> EigResult:
    """Deprecated: use :func:`repro_torch.eigsh` with ``tol=`` (or
    ``backend="restarted"``)."""
    warnings.warn(
        "topk_eigs_restarted is deprecated; use "
        "repro_torch.eigsh(A, k, backend='restarted', tol=..., subspace=m, ...)",
        DeprecationWarning,
        stacklevel=2,
    )
    from ..api import eigsh

    res = eigsh(op, k, policy=policy, backend="restarted", tol=tol, subspace=m,
                max_restarts=max_restarts, seed=seed, device=str(operator_device(op)))
    return EigResult(eigenvalues=res.eigenvalues, eigenvectors=res.eigenvectors,
                     tridiag=res.tridiag, wall_time_s=res.timings["total_s"])
