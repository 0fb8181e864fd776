"""Hopper ELL SpMV kernel (``csrc/spmv_ell.cu``).

Replaces ``src/repro/kernels/spmv_ell.py:spmv_ell_kernel_call``.  Bound on the
card by bytes: each lane reads 16 B of ``val`` and the matching columns with
evict-first loads, several rows per thread in flight, and gathers ``x``
through L2.  :func:`ell_launch_plan` picks the kernel's path from the shapes
and the card's SM count: wide rows too few to fill the card take the split
path (a warp a segment of a row); the row code (``csrc/ell_row.cuh``) is
shared with ``spmv_ell_alpha``, which never splits (:func:`lane_plan`).  The
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
    "row_plan",
    "launch",
    "ell_max_blocks",
    "split_plan",
    "split_segs",
    "ELL_PATHS",
    "SPLIT_VECS",
    "SPLIT_ROWS_PER_SM",
    "SPLIT_WARPS_PER_SM",
    "WIDE_VECS",
    "sm_count",
]

# The row code's paths (csrc/ell_row.cuh: EllPath).
ELL_PATHS = {"vector": 0, "wide": 1, "scalar": 2, "split": 3}
# The most 16-byte vectors a lane takes in one split segment (csrc/ell_row.cuh
# kSplitVecs): a segment is 32 lanes x 1 to SPLIT_VECS vectors.
SPLIT_VECS = 4
# Wide rows take the split path while they are fewer than SPLIT_ROWS_PER_SM
# a SM and longer than one step of the wide path (32 lanes x WIDE_VECS
# vectors): a card's worth of rows, or rows the wide path reads in one
# step, run faster a warp a row.  A split segment takes the most vectors a
# lane (at most SPLIT_VECS) that still give the launch SPLIT_WARPS_PER_SM
# warps a SM: larger segments mean fewer partials and look-backs.  All
# from the sweep of bench_torch/wide_rows.py (PERF.md).
SPLIT_ROWS_PER_SM = 4
SPLIT_WARPS_PER_SM = 8
WIDE_VECS = 4
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
    """``(lanes per row, path)`` of the row code without the split path (all
    of ``spmv_ell_alpha``'s plans) when a lane reads ``slots`` slots as
    whole vectors.

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


def split_plan(width: int, slots: int, rows: int, sms: int) -> int:
    """Vectors a lane of a split segment (1 to :data:`SPLIT_VECS`) for
    ``rows`` wide rows of ``width`` slots (``slots`` a vector) on a card of
    ``sms`` SMs, or 0 where the wide path keeps them: ``SPLIT_ROWS_PER_SM``
    rows a SM or more, or rows of one wide step (``32 * WIDE_VECS``
    vectors) or less.  The segment is the largest that still gives the
    launch ``SPLIT_WARPS_PER_SM`` warps a SM (one vector a lane where none
    does)."""
    if rows < 1 or rows >= SPLIT_ROWS_PER_SM * sms or width // slots <= 32 * WIDE_VECS:
        return 0
    want = SPLIT_WARPS_PER_SM * sms
    return next((v for v in range(SPLIT_VECS, 0, -1)
                 if rows * split_segs(width, slots, v) >= want), 1)


def split_segs(width: int, slots: int, seg_vecs: int) -> int:
    """Segments of a split row (``csrc/ell_row.cuh:split_segs``)."""
    return -(-(width // slots) // (32 * seg_vecs))


def row_plan(width: int, slots: int, aligned: bool, rows: int, sms: int) -> tuple:
    """``(lanes per row, path, slots a split segment)`` of ``spmv_ell`` and
    ``spmv_ell_packed``: :func:`lane_plan`, with the wide path's rows
    that are too few to fill ``sms`` SMs on the ``"split"`` path
    (:func:`split_plan`); the segment is 0 on the other paths."""
    lanes, path = lane_plan(width, slots, aligned)
    if path == "wide":
        vecs = split_plan(width, slots, rows, sms)
        if vecs:
            return 32, "split", 32 * vecs * slots
    return lanes, path, 0


def ell_launch_plan(width: int, elem_size: int, aligned: bool, rows: int, sms: int) -> tuple:
    """``(lanes per row, path, slots a split segment)`` of one ``spmv_ell``
    launch of ``rows`` rows on a card of ``sms`` SMs: a lane reads
    ``16 // elem_size`` slots of ``val`` as one 16-byte vector (see
    :func:`row_plan`); ``aligned`` says whether the bases of ``val`` and
    ``col`` are 16-byte aligned."""
    return row_plan(width, 16 // elem_size, aligned, rows, sms)


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
    ``val`` and ``x`` each widened in registers where its dtype is not the
    accum dtype (an ``x`` the wrapper already widened is not widened
    again).  Returns ``(ops_by_dtype, conversions)``."""
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

    ``x`` is in the storage dtype of ``val`` or in ``accum_dtype`` (the
    ``<S, X = A, A>`` instantiations); ``col`` is int32 and every index must
    lie inside ``x``.
    """
    _b.require_cuda("spmv_ell", val, col, x)
    if val.dim() != 2 or col.shape != val.shape or col.dtype != torch.int32:
        raise ValueError(f"spmv_ell: bad ELL layout val {tuple(val.shape)} col {col.dtype}")
    if x.dtype not in (val.dtype, accum_dtype):
        raise TypeError(f"spmv_ell: x dtype {x.dtype} is neither val's {val.dtype} nor the "
                        f"accum dtype {accum_dtype}")
    rows, width = val.shape
    aligned = (val.data_ptr() | col.data_ptr()) % 16 == 0
    plan = ell_launch_plan(width, val.element_size(), aligned, rows, sm_count(val.device))
    y = launch(val, col, x, accum_dtype, plan)
    spmv_ell_kernel_call.launches += 1
    spmv_ell_kernel_call.paths[plan[1]] += 1
    return y


def launch(val, col, x, accum_dtype, plan) -> torch.Tensor:
    """One launch of ``spmv_ell`` under ``plan`` = ``(lanes, path, slots a
    split segment)`` (:func:`ell_launch_plan`'s, or another for a sweep);
    the operands are checked by the caller.  The split path takes a
    ``(rows, segs)`` scratch of partials in the accum dtype."""
    lanes, path, seg = plan
    rows, width = val.shape
    y = torch.empty(rows, dtype=accum_dtype, device=val.device)
    partials = None
    seg_vecs = 0
    if path == "split":
        slots = 16 // val.element_size()
        seg_vecs = seg // (32 * slots)
        partials = torch.empty((rows, split_segs(width, slots, seg_vecs)), dtype=accum_dtype,
                               device=val.device)
    rc = _b.load().repro_spmv_ell(
        _b.dtype_code(val.dtype), _b.dtype_code(x.dtype), _b.dtype_code(accum_dtype),
        _b.ptr(val), _b.ptr(col), _b.ptr(x), _b.ptr(y), _b.ptr_or_null(partials),
        rows, width, lanes, ELL_PATHS[path], seg_vecs, sm_count(val.device), _b.stream_of(val),
    )
    _b.check(rc, "spmv_ell")
    return y


spmv_ell_kernel_call.launches = 0
# Launches by path (``ELL_PATHS``), beside the count: which path a run took.
spmv_ell_kernel_call.paths = dict.fromkeys(ELL_PATHS, 0)
