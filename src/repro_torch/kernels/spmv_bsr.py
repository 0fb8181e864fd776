"""Hopper blocked-ELL (BSR) SpMV kernel (``csrc/spmv_bsr.cu``).

Replaces ``src/repro/kernels/spmv_bsr.py:spmv_bsr_kernel_call``: one thread
per output row of a block-row, plain multiply-adds over the slots.  Bound
by bytes.  The plain version is ``ref.spmv_bsr_ref``.
"""

from __future__ import annotations

import torch

from . import build as _b

__all__ = ["spmv_bsr_kernel_call", "blocked_ell_from_csr"]


def spmv_bsr_kernel_call(
    val: torch.Tensor, bcol: torch.Tensor, x: torch.Tensor, *, accum_dtype
) -> torch.Tensor:
    """``y = BSR(val, bcol) @ x`` on the card; ``x`` has ``nbr * BS``
    entries (zero-padded by the caller).  Returns ``(nbr * BS,)``."""
    _b.require_cuda("spmv_bsr", val, bcol, x)
    if val.dim() != 4 or bcol.shape != val.shape[:2] or bcol.dtype != torch.int32:
        raise ValueError(f"spmv_bsr: bad layout val {tuple(val.shape)} bcol {tuple(bcol.shape)}")
    nbr, slots, bs, _ = val.shape
    if x.dtype != val.dtype or x.shape[0] != nbr * bs:
        raise ValueError(f"spmv_bsr: x must be {val.dtype} of length {nbr * bs}")
    y = torch.empty(nbr * bs, dtype=accum_dtype, device=val.device)
    rc = _b.load().repro_spmv_bsr(
        _b.dtype_code(val.dtype), _b.dtype_code(accum_dtype),
        _b.ptr(val), _b.ptr(bcol), _b.ptr(x), _b.ptr(y),
        nbr, slots, bs, _b.stream_of(val),
    )
    _b.check(rc, "spmv_bsr")
    spmv_bsr_kernel_call.launches += 1
    return y


spmv_bsr_kernel_call.launches = 0


def blocked_ell_from_csr(csr, block_size: int = 8, dtype=torch.float32, device="cuda"):
    """Host conversion CSR -> ``(val, bcol, n_rows)``, zero-padded to uniform
    slots: the reference's tuple-returning shim over ``to_device_bsr``."""
    from ..sparse.formats import to_device_bsr

    bsr = to_device_bsr(csr, block_size=block_size, dtype=dtype, device=device)
    return bsr.val, bsr.bcol, bsr.n_rows
