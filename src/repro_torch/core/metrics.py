"""Result-quality metrics of the paper's evaluation (its §IV-D, Fig. 3b/4).

* ``reconstruction_error``: mean L2 norm of ``M x - lambda x`` over the K
  eigenpairs (the paper's "L2 error", from the eigenvalue definition).
* ``pairwise_orthogonality_deg``: mean angle in degrees between eigenvector
  pairs (90 for perfect results).
* ``eigsh_reference``: ARPACK through SciPy, the paper's CPU baseline.
"""

from __future__ import annotations

import numpy as np
import torch

from .operators import LinearOperator

__all__ = ["reconstruction_error", "pairwise_orthogonality_deg", "eigsh_reference"]


def _np64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().to(torch.float64).numpy()
    return np.asarray(a, dtype=np.float64)


def reconstruction_error(op: LinearOperator, evals, evecs, accum_dtype=torch.float32) -> float:
    """Mean over j of || M x_j - lambda_j x_j ||_2 / || x_j ||_2, the matvec
    run by the operator in ``accum_dtype``."""
    errs = []
    lam = _np64(evals)
    for j in range(lam.shape[0]):
        x = evecs[:, j]
        mx = _np64(op.matvec(x, accum_dtype=accum_dtype))
        xs = _np64(x)
        nrm = np.linalg.norm(xs)
        errs.append(np.linalg.norm(mx - lam[j] * xs) / max(nrm, 1e-300))
    return float(np.mean(errs))


def pairwise_orthogonality_deg(evecs) -> float:
    """Mean pairwise angle (degrees) between eigenvector columns."""
    x = _np64(evecs)
    x = x / np.maximum(np.linalg.norm(x, axis=0, keepdims=True), 1e-300)
    g = x.T @ x
    iu = np.triu_indices(g.shape[0], 1)
    cosines = np.clip(np.abs(g[iu]), 0.0, 1.0)
    return float(np.degrees(np.mean(np.arccos(cosines))))


def eigsh_reference(csr, k: int):
    """ARPACK reference (SciPy wraps the library the paper benchmarks):
    eigenpairs sorted by |lambda| descending."""
    import scipy.sparse.linalg as spla

    evals, evecs = spla.eigsh(csr.to_scipy().astype(np.float64), k=k, which="LM")
    order = np.argsort(-np.abs(evals))
    return evals[order], evecs[:, order]
