"""Hopper blocked-ELL (BSR) SpMV kernel (``csrc/spmv_bsr.cu``).

Replaces ``src/repro/kernels/spmv_bsr.py:spmv_bsr_kernel_call``: one thread
per output row of a block-row, plain multiply-adds over the slots.  Bound
by bytes.  The plain version is ``ref.spmv_bsr_ref``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build as _b

__all__ = ["spmv_bsr_kernel_call", "check_bsr_operands", "blocked_ell_from_csr"]


def check_bsr_operands(val: torch.Tensor, bcol: torch.Tensor, x: torch.Tensor,
                       n_cols: Optional[int] = None) -> None:
    """Raise on operands the kernel does not take.  ``x`` holds the
    matrix's ``n_cols`` columns zero-padded to whole ``BS``-blocks: ``nbr *
    BS`` for a square matrix (the default), ``G * n_pad`` for a row shard of
    the distributed layout, whose block columns index the all-gathered
    vector.  A shorter ``x`` would let the kernel read past its end."""
    if val.dim() != 4 or bcol.shape != val.shape[:2] or bcol.dtype != torch.int32:
        raise ValueError(f"spmv_bsr: bad layout val {tuple(val.shape)} bcol {tuple(bcol.shape)}")
    nbr, _, bs, _ = val.shape
    n_cols = nbr * bs if n_cols is None else int(n_cols)
    want = -(-n_cols // bs) * bs
    if x.dtype != val.dtype or x.dim() != 1 or x.shape[0] != want:
        raise ValueError(f"spmv_bsr: x must be a {val.dtype} vector of {want} entries ({n_cols} "
                         f"columns in whole {bs}-blocks), got {x.dtype} {tuple(x.shape)}")


def spmv_bsr_kernel_call(
    val: torch.Tensor, bcol: torch.Tensor, x: torch.Tensor, *, accum_dtype,
    n_cols: Optional[int] = None,
) -> torch.Tensor:
    """``y = BSR(val, bcol) @ x`` on the card; ``x`` holds the ``n_cols``
    columns in whole blocks (see :func:`check_bsr_operands`; the caller
    zero-pads).  Returns ``(nbr * BS,)``."""
    _b.require_cuda("spmv_bsr", val, bcol, x)
    check_bsr_operands(val, bcol, x, n_cols)
    nbr, slots, bs, _ = val.shape
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
