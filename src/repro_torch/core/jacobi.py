"""Phase 2 of the eigensolver: the Jacobi eigenvalue algorithm, on the host.

The Lanczos phase reduces the n x n problem to a K x K tridiagonal matrix T
(K ~ 8..32), too small to occupy a GPU; the paper solves it with cyclic
Jacobi rotations on the host CPU (its Sec. III-B).  This is the reference's
NumPy implementation, verbatim; eigenpairs come back sorted by |lambda|
descending (the paper's "largest in modulo").
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["jacobi_eigh_host", "tridiag_to_dense"]


def tridiag_to_dense(alpha: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """Dense symmetric tridiagonal T from Lanczos alpha (k,), beta (k-1,)."""
    k = alpha.shape[0]
    t = np.diag(alpha)
    if k > 1:
        t = t + np.diag(beta, 1) + np.diag(beta, -1)
    return t


def jacobi_eigh_host(
    a: np.ndarray, max_sweeps: int = 30, tol: float = 1e-14
) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy cyclic Jacobi — the paper's host-CPU placement of phase 2."""
    a = np.array(a, dtype=np.float64, copy=True)
    k = a.shape[0]
    v = np.eye(k)
    for _ in range(max_sweeps):
        off = np.sqrt(np.sum(np.tril(a, -1) ** 2) * 2)
        if off <= tol:
            break
        for p in range(k - 1):
            for q in range(p + 1, k):
                apq = a[p, q]
                if abs(apq) < 1e-300:
                    continue
                tau = (a[q, q] - a[p, p]) / (2.0 * apq)
                if abs(tau) > 1e150:  # rotation angle ~ 1/(2 tau) -> identity
                    continue
                t = np.sign(tau) / (abs(tau) + np.sqrt(1.0 + tau * tau)) if tau != 0 else 1.0
                c = 1.0 / np.sqrt(1.0 + t * t)
                s = t * c
                ap = a[p, :].copy()
                aq = a[q, :].copy()
                a[p, :] = c * ap - s * aq
                a[q, :] = s * ap + c * aq
                ap = a[:, p].copy()
                aq = a[:, q].copy()
                a[:, p] = c * ap - s * aq
                a[:, q] = s * ap + c * aq
                vp = v[:, p].copy()
                vq = v[:, q].copy()
                v[:, p] = c * vp - s * vq
                v[:, q] = s * vp + c * vq
    evals = np.diag(a).copy()
    order = np.argsort(-np.abs(evals))
    return evals[order], v[:, order]
