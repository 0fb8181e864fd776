"""Input coercion for the port's ``eigsh`` frontend.

Accepted problem descriptions in this slice: dense arrays (NumPy or torch),
the port's host :class:`~repro_torch.sparse.CSR`, a
:class:`~repro_torch.sparse.DiskCSR` or the path of a diskcsr directory,
any scipy sparse matrix/array, and the port's own :class:`LinearOperator`
subclasses.  Coercion returns the operator (when the input already is one)
and the host CSR (when the input is an explicit sparse matrix; a DiskCSR
stays a memory mapping).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..configs import env as envcfg
from ..core.operators import DenseOperator, LinearOperator
from ..sparse.diskcsr import DiskCSR, open_diskcsr
from ..sparse.formats import CSR

__all__ = ["CoercedInput", "coerce_input"]


class CoercedInput(NamedTuple):
    operator: Optional[LinearOperator]  # None when only a host CSR was given
    csr: Optional[object]  # CSR or DiskCSR; None for dense / operator inputs
    n: int


def _validate_values(data, storage_dtype, what: str) -> None:
    """Fail fast on NaN/Inf entries, or on values the storage dtype cannot
    hold finitely (``REPRO_VALIDATE_INPUT=0`` skips the check)."""
    if not envcfg.get_bool("REPRO_VALIDATE_INPUT"):
        return
    arr = data.detach().cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
    if not np.issubdtype(arr.dtype, np.floating):
        return
    finite = np.isfinite(arr)
    if not finite.all():
        bad = int(arr.size - np.count_nonzero(finite))
        raise ValueError(
            f"input matrix contains {bad} non-finite value(s) in its {what}; "
            "eigsh requires finite input (set REPRO_VALIDATE_INPUT=0 to bypass)"
        )
    limit = float(torch.finfo(storage_dtype).max)
    peak = float(np.max(np.abs(arr))) if arr.size else 0.0
    if peak > limit:
        raise ValueError(
            f"input matrix peak magnitude {peak:.3e} overflows the requested "
            f"storage dtype {storage_dtype} (finite max {limit:.3e}): rescale the "
            "matrix or pick a wider storage policy (set REPRO_VALIDATE_INPUT=0 to bypass)"
        )


def _csr_from_scipy(a) -> CSR:
    m = a.tocsr()
    m.sort_indices()
    if m.shape[0] != m.shape[1]:
        raise ValueError(f"eigsh needs a square matrix, got shape {m.shape}")
    return CSR(
        indptr=np.asarray(m.indptr, dtype=np.int64),
        indices=np.asarray(m.indices, dtype=np.int32),
        data=np.asarray(m.data, dtype=np.float64),
        shape=(m.shape[0], m.shape[1]),
    )


def coerce_input(a, *, storage_dtype=torch.float32, device="cpu") -> CoercedInput:
    """Normalize an accepted input into (operator, csr, n); dense inputs
    become a :class:`DenseOperator` on ``device`` in ``storage_dtype``."""
    if isinstance(a, LinearOperator):
        return CoercedInput(operator=a, csr=None, n=int(a.n))
    if isinstance(a, CSR):
        _validate_values(a.data, storage_dtype, "CSR data")
        return CoercedInput(operator=None, csr=a, n=a.n)
    # A diskcsr directory or an open DiskCSR stays a mapping.  Its values
    # are not scanned: that would read the whole payload from disk, the
    # very thing the out-of-core path exists to avoid.
    if isinstance(a, (str, os.PathLike)):
        a = open_diskcsr(a)  # raises FileNotFoundError with a hint otherwise
    if isinstance(a, DiskCSR):
        return CoercedInput(operator=None, csr=a, n=a.n)
    if hasattr(a, "tocsr") and hasattr(a, "shape"):  # scipy sparse, duck-typed
        csr = _csr_from_scipy(a)
        _validate_values(csr.data, storage_dtype, "sparse data")
        return CoercedInput(operator=None, csr=csr, n=csr.n)
    if isinstance(a, (np.ndarray, torch.Tensor)):
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"eigsh needs a square 2-D array, got shape {tuple(a.shape)}")
        _validate_values(a, storage_dtype, "entries")
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return CoercedInput(
            operator=DenseOperator(t.to(device=device, dtype=storage_dtype)),
            csr=None,
            n=int(a.shape[0]),
        )
    raise TypeError(
        f"eigsh does not understand input of type {type(a).__name__}: expected a "
        "dense array, a repro_torch CSR or DiskCSR (or a diskcsr path), a scipy sparse "
        "matrix, or a LinearOperator"
    )
