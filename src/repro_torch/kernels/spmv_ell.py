"""Hopper ELL SpMV kernel (``csrc/spmv_ell.cu``).

Replaces ``src/repro/kernels/spmv_ell.py:spmv_ell_kernel_call``.  Bound on the
card by bytes: the design reads ``val``/``col`` coalesced (a group of lanes
per row), gathers ``x`` through L2, and stores no TPU width padding.  See the
source for the details; the plain version is ``ref.spmv_ell_ref``.
"""

from __future__ import annotations

import torch

from . import build as _b

__all__ = ["spmv_ell_kernel_call", "ell_group"]


def ell_group(width: int) -> int:
    """Lanes per ELL row: the padded width rounded up to a power of two,
    at most a warp."""
    g = 1
    while g < min(width, 32):
        g *= 2
    return g


def spmv_ell_kernel_call(
    val: torch.Tensor, col: torch.Tensor, x: torch.Tensor, *, accum_dtype
) -> torch.Tensor:
    """``y = ELL(val, col) @ x`` in ``accum_dtype`` on the card; ``(rows_pad,)``.

    ``val`` and ``x`` share the storage dtype; ``col`` is int32 and every
    index must lie inside ``x``.
    """
    _b.require_cuda("spmv_ell", val, col, x)
    if val.dim() != 2 or col.shape != val.shape or col.dtype != torch.int32:
        raise ValueError(f"spmv_ell: bad ELL layout val {tuple(val.shape)} col {col.dtype}")
    if x.dtype != val.dtype:
        raise TypeError(f"spmv_ell: x dtype {x.dtype} != val dtype {val.dtype}")
    rows, width = val.shape
    y = torch.empty(rows, dtype=accum_dtype, device=val.device)
    lib = _b.load()
    rc = lib.repro_spmv_ell(
        _b.dtype_code(val.dtype), _b.dtype_code(accum_dtype),
        _b.ptr(val), _b.ptr(col), _b.ptr(x), _b.ptr(y),
        rows, width, ell_group(width), _b.stream_of(val),
    )
    _b.check(rc, "spmv_ell")
    spmv_ell_kernel_call.launches += 1
    return y


spmv_ell_kernel_call.launches = 0
