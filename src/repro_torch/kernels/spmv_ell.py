"""Hopper ELL SpMV kernel (``csrc/spmv_ell.cu``).

Replaces ``src/repro/kernels/spmv_ell.py:spmv_ell_kernel_call``.  Bound on the
card by bytes: each lane reads 16 B of ``val`` and the matching columns with
evict-first loads, several rows per thread in flight, and gathers ``x``
through L2.  :func:`ell_launch_plan` picks the kernel's path from the shapes;
the row code (``csrc/ell_row.cuh``) is shared with ``spmv_ell_alpha``.  The
plain version is ``ref.spmv_ell_ref``; :func:`spmv_ell_contract` declares
what a launch executes, for the op counter (``analysis/op_count.py``).
"""

from __future__ import annotations

import torch

from ..analysis.op_count import dtype_name, widened
from . import build as _b

__all__ = [
    "spmv_ell_kernel_call",
    "spmv_ell_contract",
    "ell_group",
    "ell_launch_plan",
    "lane_plan",
    "ell_max_blocks",
    "ELL_PATHS",
    "sm_count",
]

# The row code's paths (csrc/ell_row.cuh: EllPath).
ELL_PATHS = {"vector": 0, "wide": 1, "scalar": 2}
# Mirrors of csrc/common.cuh kThreads and csrc/ell_row.cuh kRows, and the
# most 256-thread blocks a Hopper SM holds (2,048 resident threads).
THREADS = 256
ROWS_IN_FLIGHT = 4
MAX_BLOCKS_PER_SM = 2048 // THREADS

_SM_COUNT: dict = {}


def ell_group(width: int) -> int:
    """Lanes per ELL row: the padded width rounded up to a power of two,
    at most a warp."""
    g = 1
    while g < min(width, 32):
        g *= 2
    return g


def lane_plan(width: int, slots: int, aligned: bool) -> tuple:
    """``(lanes per row, path)`` of the row code when a lane reads ``slots``
    slots as whole vectors.

    The ``"vector"`` path takes ``width / slots`` lanes a row, rounded up to
    a power of two; past 32 vectors a row, the ``"wide"`` path gives each
    row a warp that walks its vectors.  A width that is not a whole number
    of vectors, or a base pointer that is not 16-byte aligned (``aligned``
    False), takes the ``"scalar"`` path: one slot per lane and step,
    ``ell_group(width)`` lanes a row.
    """
    if not aligned or width % slots:
        return ell_group(width), "scalar"
    nvec = width // slots
    if nvec > 32:
        return 32, "wide"
    return ell_group(nvec), "vector"


def ell_launch_plan(width: int, elem_size: int, aligned: bool) -> tuple:
    """``(lanes per row, path)`` of one ``spmv_ell`` or ``spmv_ell_alpha``
    launch: a lane reads ``16 // elem_size`` slots of ``val`` as one 16-byte
    vector (see :func:`lane_plan`); ``aligned`` says whether the bases of
    ``val`` and ``col`` are 16-byte aligned."""
    return lane_plan(width, 16 // elem_size, aligned)


def ell_max_blocks(rows: int, lanes: int, path: str, sms: int) -> int:
    """The most blocks one launch of the row code can have: enough to cover
    the rows once, at most ``sms`` times the blocks an SM can hold.  The
    kernel's own grid (``csrc/ell_row.cuh:ell_grid``) takes its occupancy,
    which is at most that; ``spmv_ell_alpha`` sizes its partials by it."""
    step = THREADS // (32 if path == "wide" else lanes)
    per_block = step * ROWS_IN_FLIGHT if path == "vector" else step
    return min(-(-rows // per_block), sms * MAX_BLOCKS_PER_SM)


def spmv_ell_contract(val: torch.Tensor, x: torch.Tensor, accum_dtype):
    """The ops one launch executes: a multiply and an add in ``accum_dtype``
    for each of the ``rows_pad x width`` slots (padding included), with
    ``val`` and ``x`` widened from the storage dtype in registers when it
    is not the accum dtype.  Returns ``(ops_by_dtype, conversions)``."""
    return ({dtype_name(accum_dtype): 2 * val.numel()},
            widened(accum_dtype, val.dtype, x.dtype))


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
