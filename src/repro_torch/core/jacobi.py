"""Phase 2 of the eigensolver: the Jacobi eigenvalue algorithm.

The Lanczos phase reduces the n x n problem to a K x K tridiagonal matrix T
(K ~ 8..32), too small to occupy a GPU; the paper solves it with cyclic
Jacobi rotations on the host CPU (its Sec. III-B).  Both of the reference's
placements:

  * ``jacobi_eigh_host``: its NumPy implementation, verbatim (the default,
    ``jacobi="host"``);
  * ``jacobi_eigh``: the tensor version (``jacobi="jax"`` in the
    reference, one XLA while-loop there), here eager torch on the matrix's
    device: each rotation is a handful of small kernels, and the sweep loop
    reads the off-diagonal norm back once per sweep.

Both run cyclic-by-row Jacobi and return eigenpairs sorted by |lambda|
descending (the paper's "largest in modulo").
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["jacobi_eigh", "jacobi_eigh_host", "tridiag_to_dense"]


def tridiag_to_dense(alpha, beta):
    """Dense symmetric tridiagonal T from Lanczos alpha (k,), beta (k-1,):
    an ndarray from ndarrays, a tensor (on their device) from tensors."""
    lib = torch if isinstance(alpha, torch.Tensor) else np
    k = alpha.shape[0]
    t = lib.diag(alpha)
    if k > 1:
        t = t + lib.diag(beta, 1) + lib.diag(beta, -1)
    return t


def jacobi_eigh(a: torch.Tensor, max_sweeps: int = 30, tol: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cyclic Jacobi eigendecomposition of a symmetric tensor, on its device
    and in its dtype: the reference's ``jacobi_eigh``.

    The same rotation order (cyclic by row over p < q), the same rotation
    (skipped while ``|a_pq| < eps``, ``eps = 10 * finfo(dtype).eps``) and the
    same rule: sweep while ``sweeps < max_sweeps`` and the off-diagonal
    Frobenius norm exceeds ``max(tol, eps)``.  Returns (eigenvalues (k,),
    eigenvectors (k, k) column-wise), sorted by |lambda| descending.
    """
    k = a.shape[0]
    dtype, dev = a.dtype, a.device
    if k == 1:
        return a[0:1, 0].clone(), torch.ones((1, 1), dtype=dtype, device=dev)
    eps = 10.0 * float(torch.finfo(dtype).eps)
    stop = max(float(tol), eps)
    a = a.clone()
    v = torch.eye(k, dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    pairs = [(p, q) for p in range(k - 1) for q in range(p + 1, k)]
    off_mask = ~torch.eye(k, dtype=torch.bool, device=dev)
    for _ in range(max_sweeps):
        # The one read-back of a sweep (the loop condition).
        if float(torch.sqrt(torch.sum(a[off_mask] ** 2))) <= stop:
            break
        for p, q in pairs:
            idx = [p, q]
            app, aqq, apq = a[p, p], a[q, q], a[p, q]
            skip = torch.abs(apq) < eps
            tau = (aqq - app) / (2.0 * torch.where(skip, one, apq))
            t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            c = torch.where(skip, one, c)
            s = torch.where(skip, zero, s)
            # A <- J^T A J, V <- V J with J = G(p, q, c, s): rows, then columns.
            rows = a[idx, :]
            a[idx, :] = torch.stack((c * rows[0] - s * rows[1], s * rows[0] + c * rows[1]))
            cols = a[:, idx]
            a[:, idx] = torch.stack((c * cols[:, 0] - s * cols[:, 1],
                                     s * cols[:, 0] + c * cols[:, 1]), dim=1)
            vc = v[:, idx]
            v[:, idx] = torch.stack((c * vc[:, 0] - s * vc[:, 1],
                                     s * vc[:, 0] + c * vc[:, 1]), dim=1)
    evals = torch.diagonal(a).clone()
    order = torch.argsort(-torch.abs(evals), stable=True)
    return evals[order], v[:, order]


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
