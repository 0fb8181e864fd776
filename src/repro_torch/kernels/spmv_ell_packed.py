"""Packed-ELL chunks for compressed out-of-core staging, and their Hopper
SpMV kernel (``csrc/spmv_ell_packed.cu``).

Replaces ``src/repro/kernels/spmv_ell_packed.py``: the host packing
(:func:`pack_ell_chunk`, NumPy + torch) and the kernel that undoes it on
the card (:func:`spmv_ell_packed_kernel_call`).  A packed chunk is

* ``val``   — (rows, width) values in bf16 or fp8 e4m3, divided by
* ``scale`` — (rows, 1) f32, one scale per block of ``SCALE_BLOCK_ROWS`` rows
  (max-abs mapped onto fp8's finite range; 1 for bf16, which has f32's
  exponent range);
* ``base``  — (rows, 1) int32, the first stored column of each row;
* ``dcol``  — (rows, width) int16 or int32 column deltas:
  ``dcol[r, 0] == 0`` and ``dcol[r, s] == col[r, s] - col[r, s - 1]``.

The bytes equal the reference's for the same chunk: the same rounding
order (values rounded to f32 first, divided by the f32 scale in f64, then
cast) and the same int16/int32 choice.  The casts go through torch, whose
f64 -> bf16 / fp8 e4m3 rounding gives the bytes ``ml_dtypes`` gives for
every value the per-block scale can produce (|v| <= 448).  The kernel
reads a row's slots as vectors of :data:`PACKED_SLOTS` in as many lanes as
:func:`packed_launch_plan` gives it (see the source).  The plain version of
the kernel is ``ref.spmv_ell_packed_ref``; :func:`spmv_ell_packed_contract`
declares what a launch executes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..analysis.op_count import dtype_name, widened
from . import build as _b
from .spmv_ell import ELL_PATHS, lane_plan, sm_count

__all__ = [
    "PACKED_VALUE_DTYPES",
    "PACKED_SLOTS",
    "SCALE_BLOCK_ROWS",
    "pack_ell_chunk",
    "packed_launch_plan",
    "spmv_ell_packed_kernel_call",
    "spmv_ell_packed_contract",
]

# staging-mode name -> narrow dtype of the packed values
PACKED_VALUE_DTYPES = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}
# Rows sharing one quantization scale (the "per-row-block" granularity).
SCALE_BLOCK_ROWS = 8
# Slots a lane of the kernel reads as vectors (csrc/spmv_ell_packed.cu: kSlots).
PACKED_SLOTS = 8


def pack_ell_chunk(val: np.ndarray, col: np.ndarray, mode: str):
    """Quantize + delta-encode one host ELL chunk.

    ``val`` is the (rows, width) chunk in f32 (its values already rounded to
    f32, as the staging builds it), ``col`` its int32 columns.  Returns
    ``(val_packed, scale, base, dcol)`` as CPU tensors in the kernel's
    operand layout; ``dcol`` is int16 when every delta fits, else int32.
    """
    vdt = PACKED_VALUE_DTYPES.get(mode)
    if vdt is None:
        raise ValueError(
            f"unknown packed staging mode {mode!r}; expected {tuple(PACKED_VALUE_DTYPES)}"
        )
    rows, width = val.shape
    if rows % SCALE_BLOCK_ROWS:
        raise ValueError(f"packed chunk rows {rows} must be a multiple of {SCALE_BLOCK_ROWS}")
    # The reference's arithmetic in its order, in torch's threaded kernels.
    # Its f64 steps are exact where they are skipped: |v| and the block
    # max of f32 values are f32 values, and with scale 1 (bf16) the f64
    # quotient is the value itself.
    v = torch.from_numpy(np.ascontiguousarray(val, dtype=np.float32))
    if mode == "fp8":
        absmax = v.abs().view(rows // SCALE_BLOCK_ROWS, -1).amax(1).double()
        fmax = float(torch.finfo(vdt).max)
        block_scale = torch.where(absmax > 0, absmax / fmax, torch.ones_like(absmax))
        scale = block_scale.float().repeat_interleave(SCALE_BLOCK_ROWS).view(rows, 1)
        val_packed = (v.double() / scale.double()).to(vdt)
    else:
        scale = torch.ones((rows, 1), dtype=torch.float32)
        val_packed = v.to(vdt)
    c = torch.from_numpy(np.ascontiguousarray(col, dtype=np.int32))
    base = c[:, :1].contiguous()
    dcol32 = torch.diff(c, dim=1, prepend=base)  # int32: |delta| < 2**31
    fits = dcol32.numel() == 0 or (
        int(dcol32.min()) > -(1 << 15) and int(dcol32.max()) < (1 << 15)
    )
    return val_packed, scale, base, dcol32.to(torch.int16) if fits else dcol32


def packed_launch_plan(width: int, delta_size: int, aligned: bool) -> tuple:
    """``(lanes per row, path)`` of one ``spmv_ell_packed`` launch.

    A lane reads :data:`PACKED_SLOTS` slots as whole vectors: 16 B of bf16
    or 8 B of fp8 values, 16 B of int16 or 32 B of int32 deltas.  So the
    plan is the same for both delta sizes (2 or 4 bytes; another raises):
    width / 8 lanes a row rounded up to a power of two, a warp walking the
    row past 32 vectors, and lane groups of one slot a step when the width
    is not a multiple of 8 or a base of ``val`` or ``dcol`` is not 16-byte
    aligned (``aligned`` False).  See :func:`.spmv_ell.lane_plan`.
    """
    if delta_size not in (2, 4):
        raise ValueError(f"spmv_ell_packed: no kernel for {delta_size}-byte deltas")
    return lane_plan(width, PACKED_SLOTS, aligned)


def spmv_ell_packed_contract(val: torch.Tensor, scale: torch.Tensor, x: torch.Tensor,
                             accum_dtype):
    """The ops one launch executes, per slot, in ``accum_dtype``: the
    dequantizing multiply by the row's scale, the multiply by ``x`` and the
    add; the packed values, the f32 scale and ``x`` widened in registers
    where they differ from the accum dtype.  (The column decode is integer
    work.)"""
    return ({dtype_name(accum_dtype): 3 * val.numel()},
            widened(accum_dtype, val.dtype, scale.dtype, x.dtype))


def spmv_ell_packed_kernel_call(
    val: torch.Tensor,
    scale: torch.Tensor,
    base: torch.Tensor,
    dcol: torch.Tensor,
    x: torch.Tensor,
    *,
    accum_dtype,
) -> torch.Tensor:
    """``y = dequant(val, scale) @ x`` at columns ``base + cumsum(dcol)``, in
    ``accum_dtype`` on the card; returns ``(rows,)``.

    ``val`` is bf16 or fp8 e4m3, ``dcol`` int16 or int32 of the same shape,
    ``scale`` f32 and ``base`` int32 of shape ``(rows, 1)``; ``x`` is in a
    storage dtype of the policies and every decoded column must lie in it.
    """
    _b.require_cuda("spmv_ell_packed", val, scale, base, dcol, x)
    if val.dim() != 2 or dcol.shape != val.shape:
        raise ValueError(
            f"spmv_ell_packed: bad packed layout val {tuple(val.shape)} dcol {tuple(dcol.shape)}"
        )
    rows, width = val.shape
    if scale.shape != (rows, 1) or scale.dtype != torch.float32:
        raise ValueError(f"spmv_ell_packed: scale must be f32 ({rows}, 1), got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if base.shape != (rows, 1) or base.dtype != torch.int32:
        raise ValueError(f"spmv_ell_packed: base must be int32 ({rows}, 1), got {base.dtype} "
                         f"{tuple(base.shape)}")
    y = torch.empty(rows, dtype=accum_dtype, device=val.device)
    aligned = (val.data_ptr() | dcol.data_ptr()) % 16 == 0
    lanes, path = packed_launch_plan(width, dcol.element_size(), aligned)
    rc = _b.load().repro_spmv_ell_packed(
        _b.dtype_code(val.dtype), _b.index_code(dcol.dtype),
        _b.dtype_code(x.dtype), _b.dtype_code(accum_dtype),
        _b.ptr(val), _b.ptr(scale), _b.ptr(base), _b.ptr(dcol), _b.ptr(x), _b.ptr(y),
        rows, width, lanes, ELL_PATHS[path], sm_count(val.device), _b.stream_of(val),
    )
    _b.check(rc, "spmv_ell_packed")
    spmv_ell_packed_kernel_call.launches += 1
    return y


spmv_ell_packed_kernel_call.launches = 0
