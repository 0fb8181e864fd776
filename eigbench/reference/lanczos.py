"""The plain reference of a fixed-subspace Top-K solve.

``m`` steps of Lanczos from a given start vector, with full
re-orthogonalisation (classical Gram-Schmidt, twice) against every earlier
basis vector, then the eigenpairs of the ``m`` x ``m`` tridiagonal by a
dense symmetric eigensolver (LAPACK through NumPy), the Ritz vectors
``X = Q^T W``, and the ``k`` pairs of largest ``|lambda|``, with the
tridiagonal itself.  The matrix
product is PyTorch's own sparse CSR product.

:class:`Precision` says in which dtypes it runs: the matrix and the basis
are held in ``storage``, the product's input is rounded to ``storage``,
the carried vectors and every sum are in ``compute``, and the results are
rounded to ``output``.  The reference proper is float64 throughout; a
lower precision gives the control that the comparison has to fail.

Imports nothing of the program: it gets the benchmark's CSR arrays and
start vector and works out everything else itself.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32, "bfloat16": torch.bfloat16}


class Precision(NamedTuple):
    storage: torch.dtype
    compute: torch.dtype
    output: torch.dtype

    @classmethod
    def parse(cls, spec: dict) -> "Precision":
        return cls(*(DTYPES[spec[key]] for key in ("storage", "compute", "output")))


F64 = Precision(torch.float64, torch.float64, torch.float64)


class RitzPairs(NamedTuple):
    """A solve's answer, the program's or the reference's."""

    eigenvalues: torch.Tensor  # (k,) output dtype, |lambda| descending, on the host
    eigenvectors: torch.Tensor  # (n, k) output dtype
    alpha: torch.Tensor  # (m,) the tridiagonal's diagonal, compute dtype
    beta: torch.Tensor  # (m - 1,) its off-diagonal, compute dtype


def sparse_matrix(indptr: torch.Tensor, indices: torch.Tensor, data: torch.Tensor,
                  prec: Precision) -> torch.Tensor:
    """The CSR as a PyTorch sparse tensor whose values are ``data`` rounded
    to ``prec.storage`` and held in ``prec.compute``."""
    n = int(indptr.numel()) - 1
    vals = data.to(prec.storage).to(prec.compute)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(indptr.to(torch.int64), indices.to(torch.int64), vals,
                                       size=(n, n), check_invariants=False)


def ritz_pairs(a: torch.Tensor, v: torch.Tensor, m: int, k: int, prec: Precision = F64
               ) -> RitzPairs:
    """The ``k`` Ritz pairs of largest ``|lambda|`` after ``m`` Lanczos
    steps of the sparse matrix ``a`` (from :func:`sparse_matrix`) from the
    start vector ``v``."""
    sdt, cdt = prec.storage, prec.compute
    n = v.numel()
    basis = torch.empty((m, n), dtype=sdt, device=v.device)
    alpha = np.zeros(m)
    beta = np.zeros(m)
    q = v.to(cdt)
    q = q / torch.linalg.vector_norm(q)
    q_prev = torch.zeros_like(q)
    b_prev = torch.zeros((), dtype=cdt, device=v.device)
    for j in range(m):
        basis[j] = q.to(sdt)
        w = torch.mv(a, q.to(sdt).to(cdt))
        a_j = torch.dot(q, w)
        w = w - a_j * q - b_prev * q_prev
        qs = basis[: j + 1].to(cdt)
        for _ in range(2):
            w = w - qs.T @ (qs @ w)
        del qs
        b_j = torch.linalg.vector_norm(w)
        alpha[j], beta[j] = float(a_j), float(b_j)
        q_prev, q, b_prev = q, w / b_j, b_j
    np_dt = np.float64 if cdt == torch.float64 else np.float32
    t = np.diag(alpha.astype(np_dt)) + np.diag(beta[: m - 1].astype(np_dt), 1) \
        + np.diag(beta[: m - 1].astype(np_dt), -1)
    evals, w = np.linalg.eigh(t)
    order = np.argsort(-np.abs(evals), kind="stable")[:k]
    w_k = torch.from_numpy(np.ascontiguousarray(w[:, order])).to(device=v.device, dtype=cdt)
    x = basis.to(cdt).T @ w_k
    return RitzPairs(torch.from_numpy(evals[order]).to(prec.output), x.to(prec.output),
                     torch.from_numpy(alpha).to(cdt), torch.from_numpy(beta[: m - 1]).to(cdt))
