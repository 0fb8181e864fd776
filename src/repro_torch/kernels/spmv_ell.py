"""Hopper ELL SpMV kernel (``csrc/spmv_ell.cu``).

Replaces ``src/repro/kernels/spmv_ell.py:spmv_ell_kernel_call``.  Bound on the
card by bytes: each lane reads 16 B of ``val`` and the matching columns with
evict-first loads, several rows per thread in flight, and gathers ``x``
through L2.  :func:`ell_launch_plan` picks the kernel's path from the shapes;
see the source for the details.  The plain version is ``ref.spmv_ell_ref``.
"""

from __future__ import annotations

import torch

from . import build as _b

__all__ = ["spmv_ell_kernel_call", "ell_group", "ell_launch_plan", "ELL_PATHS", "sm_count"]

# The kernel's paths (csrc/spmv_ell.cu: EllPath).
ELL_PATHS = {"vector": 0, "wide": 1, "scalar": 2}

_SM_COUNT: dict = {}


def ell_group(width: int) -> int:
    """Lanes per ELL row: the padded width rounded up to a power of two,
    at most a warp."""
    g = 1
    while g < min(width, 32):
        g *= 2
    return g


def ell_launch_plan(width: int, elem_size: int, aligned: bool) -> tuple:
    """``(lanes per row, path)`` of one launch.

    A lane reads ``16 // elem_size`` slots as one 16-byte vector.  The
    ``"vector"`` path takes ``width / slots`` lanes a row, rounded up to a
    power of two; past 32 vectors a row, the ``"wide"`` path gives each row
    a warp that walks its vectors.  A width that is not a whole number of
    vectors, or a base pointer of ``val`` or ``col`` that is not 16-byte
    aligned (``aligned`` False), takes the ``"scalar"`` path: one slot per
    lane and step, ``ell_group(width)`` lanes a row.
    """
    vec = 16 // elem_size
    if not aligned or width % vec:
        return ell_group(width), "scalar"
    nvec = width // vec
    if nvec > 32:
        return 32, "wide"
    return ell_group(nvec), "vector"


def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    n = _SM_COUNT.get(idx)
    if n is None:
        n = _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


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
    aligned = (val.data_ptr() | col.data_ptr()) % 16 == 0
    lanes, path = ell_launch_plan(width, val.element_size(), aligned)
    y = torch.empty(rows, dtype=accum_dtype, device=val.device)
    rc = _b.load().repro_spmv_ell(
        _b.dtype_code(val.dtype), _b.dtype_code(accum_dtype),
        _b.ptr(val), _b.ptr(col), _b.ptr(x), _b.ptr(y),
        rows, width, lanes, ELL_PATHS[path], sm_count(val.device), _b.stream_of(val),
    )
    _b.check(rc, "spmv_ell")
    spmv_ell_kernel_call.launches += 1
    return y


spmv_ell_kernel_call.launches = 0
