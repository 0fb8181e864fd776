"""Input coercion for the port's ``eigsh`` frontend.

Accepted problem descriptions: dense arrays (NumPy or torch), the port's
host :class:`~repro_torch.sparse.CSR`, a :class:`~repro_torch.sparse.DiskCSR`
or the path of a diskcsr directory, any scipy sparse matrix/array, the
port's own :class:`LinearOperator` subclasses, scipy ``LinearOperator``s and
bare matvec callables (``n=`` required).  Coercion returns the operator
(when the input already is one, or is dense or matrix-free) and the host CSR
(when the input is an explicit sparse matrix; a DiskCSR stays a memory
mapping).

:func:`matrix_fingerprint` is the content digest that keys the session
cache: the reference's blake2b over the same bytes in the same order, so a
matrix has the same digest in both packages.
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..configs import env as envcfg
from ..core.operators import CallableOperator, DenseOperator, LinearOperator
from ..core.trace import to_host
from ..sparse.diskcsr import DiskCSR, diskcsr_fingerprint, is_diskcsr, open_diskcsr
from ..sparse.formats import CSR

__all__ = ["CoercedInput", "coerce_input", "matrix_fingerprint"]


class CoercedInput(NamedTuple):
    operator: Optional[LinearOperator]  # None when only a host CSR was given
    csr: Optional[object]  # CSR or DiskCSR; None for dense / operator inputs
    n: int
    # Content digest of the problem data (the matrix half of the session
    # cache key); None for matrix-free inputs, or when not asked for.
    fingerprint: Optional[str] = None


def _host_array(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return to_host(a).numpy()
    return np.asarray(a)


def matrix_fingerprint(a) -> Optional[str]:
    """Content digest of an explicit matrix: blake2b over the CSR's indptr,
    indices and data bytes and its shape, or over a dense array's dtype,
    shape and bytes; a DiskCSR (or its path) gets the sampled
    :func:`~repro_torch.sparse.diskcsr.diskcsr_fingerprint`.  Mutating a
    matrix in place changes its digest; None for anything else."""
    if isinstance(a, DiskCSR):
        return diskcsr_fingerprint(a.path)
    if isinstance(a, (str, os.PathLike)) and is_diskcsr(a):
        return diskcsr_fingerprint(a)
    h = hashlib.blake2b(digest_size=16)
    if isinstance(a, CSR):
        h.update(b"csr")
        h.update(np.ascontiguousarray(a.indptr).tobytes())
        h.update(np.ascontiguousarray(a.indices).tobytes())
        h.update(np.ascontiguousarray(a.data).tobytes())
        h.update(repr(a.shape).encode())
        return h.hexdigest()
    if isinstance(a, (np.ndarray, torch.Tensor)):
        arr = _host_array(a)
        h.update(b"dense")
        h.update(str(arr.dtype).encode())
        h.update(repr(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()
    return None


def _validate_values(data, storage_dtype, what: str) -> None:
    """Fail fast on NaN/Inf entries, or on values the storage dtype cannot
    hold finitely (``REPRO_VALIDATE_INPUT=0`` skips the check)."""
    if not envcfg.get_bool("REPRO_VALIDATE_INPUT"):
        return
    arr = _host_array(data)
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


def _scipy_matvec(mv):
    """A host matvec (scipy ``LinearOperator.matvec``) as a callable on
    tensors; bf16, which NumPy lacks, goes over as f32 (exact)."""

    def fn(x):
        xh = x.detach().cpu()
        return mv((xh.float() if xh.dtype == torch.bfloat16 else xh).numpy())

    return fn


def coerce_input(
    a,
    *,
    n: Optional[int] = None,
    storage_dtype=torch.float32,
    device="cuda",
    fingerprint: Optional[str] = None,
    want_fingerprint: bool = False,
) -> CoercedInput:
    """Normalize an accepted input into (operator, csr, n); dense inputs
    become a :class:`DenseOperator` on ``device`` in ``storage_dtype`` (a
    copy: the caller's array is never aliased).

    Fingerprinting is opt-in: pass ``fingerprint=`` when the digest is
    already known (the session cache probes before coercing), or
    ``want_fingerprint=True`` to compute it here (scipy inputs, whose digest
    is of the converted CSR)."""
    device = resolve_device(device)
    if isinstance(a, LinearOperator):
        return CoercedInput(operator=a, csr=None, n=int(a.n))

    def _fp(x):
        if fingerprint is not None:
            return fingerprint
        return matrix_fingerprint(x) if want_fingerprint else None

    if isinstance(a, CSR):
        _validate_values(a.data, storage_dtype, "CSR data")
        return CoercedInput(operator=None, csr=a, n=a.n, fingerprint=_fp(a))
    # A diskcsr directory or an open DiskCSR stays a mapping.  Its values
    # are not scanned: that would read the whole payload from disk, the
    # very thing the out-of-core path exists to avoid.
    if isinstance(a, (str, os.PathLike)):
        a = open_diskcsr(a)  # raises FileNotFoundError with a hint otherwise
    if isinstance(a, DiskCSR):
        return CoercedInput(operator=None, csr=a, n=a.n, fingerprint=_fp(a))
    if hasattr(a, "tocsr") and hasattr(a, "shape"):  # scipy sparse, duck-typed
        csr = _csr_from_scipy(a)
        _validate_values(csr.data, storage_dtype, "sparse data")
        return CoercedInput(operator=None, csr=csr, n=csr.n, fingerprint=_fp(csr))
    if isinstance(a, (np.ndarray, torch.Tensor)):
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"eigsh needs a square 2-D array, got shape {tuple(a.shape)}")
        _validate_values(a, storage_dtype, "entries")
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return CoercedInput(
            operator=DenseOperator(t.to(device=device, dtype=storage_dtype, copy=True)),
            csr=None,
            n=int(a.shape[0]),
            fingerprint=_fp(a),
        )
    # scipy.sparse.linalg.LinearOperator look-alikes: .matvec + .shape.
    if hasattr(a, "matvec") and hasattr(a, "shape"):
        if a.shape[0] != a.shape[1]:
            raise ValueError(f"eigsh needs a square operator, got shape {a.shape}")
        dim = int(a.shape[0])
        op = CallableOperator(fn=_scipy_matvec(a.matvec), n=dim, device=str(device))
        return CoercedInput(operator=op, csr=None, n=dim)
    if callable(a):
        if n is None:
            raise ValueError("eigsh(matvec_callable, ...) needs the problem size: pass n=<dim>")
        return CoercedInput(
            operator=CallableOperator(fn=a, n=int(n), device=str(device)), csr=None, n=int(n)
        )
    raise TypeError(
        f"eigsh does not understand input of type {type(a).__name__}: expected a "
        "dense array, a repro_torch CSR or DiskCSR (or a diskcsr path), a scipy sparse "
        "matrix, a LinearOperator, or a matvec callable"
    )
