"""Hopper fused ELL SpMV + alpha kernel (``csrc/lanczos_fused.cu``).

Replaces ``src/repro/kernels/lanczos_fused.py:spmv_ell_alpha_kernel_call``.
Two passes, both deterministic: ``spmv_ell``'s row code (the same launch
plan, so ``w`` has ``spmv_ell``'s bits) writes ``w`` and one partial of
``<v, w>`` per block of a grid of SMs times occupancy; one block then sums
the partials in a fixed order.  Bound on the card by bytes.  The plain
version is ``ref.spmv_ell_alpha_ref``; :func:`spmv_ell_alpha_contract`
declares what a launch executes.
"""

from __future__ import annotations

import torch

from . import build as _b
from .spmv_ell import ELL_PATHS, ell_launch_plan, ell_max_blocks, sm_count, spmv_ell_contract

__all__ = ["spmv_ell_alpha_kernel_call", "spmv_ell_alpha_contract"]


def spmv_ell_alpha_contract(val: torch.Tensor, x: torch.Tensor, v: torch.Tensor, accum_dtype):
    """``spmv_ell``'s contract for ``w`` plus, for alpha, a multiply and an
    add in ``accum_dtype`` per element of ``v``."""
    ops, convs = spmv_ell_contract(val, x, accum_dtype)
    return {dt: n + 2 * v.numel() for dt, n in ops.items()}, convs


def spmv_ell_alpha_kernel_call(
    val: torch.Tensor, col: torch.Tensor, x: torch.Tensor, v: torch.Tensor, *, accum_dtype
):
    """``w = ELL(val, col) @ x`` and ``alpha = <v, w>`` on the card.

    ``x`` is the gather source (storage dtype); ``v`` the alpha operand in
    ``accum_dtype``, of length ``<= rows_pad`` (rows past it count as
    padding).  Returns ``(w (rows_pad,), alpha 0-d)`` in ``accum_dtype``.
    """
    _b.require_cuda("spmv_ell_alpha", val, col, x, v)
    if val.dim() != 2 or col.shape != val.shape or col.dtype != torch.int32:
        raise ValueError(f"spmv_ell_alpha: bad ELL layout val {tuple(val.shape)} col {col.dtype}")
    if x.dtype != val.dtype or v.dtype != accum_dtype:
        raise TypeError(
            f"spmv_ell_alpha: x {x.dtype} must match val {val.dtype}, v {v.dtype} the accum dtype"
        )
    rows, width = val.shape
    if v.shape[0] > rows:
        raise ValueError(f"spmv_ell_alpha: v length {v.shape[0]} > padded rows {rows}")
    aligned = (val.data_ptr() | col.data_ptr()) % 16 == 0
    lanes, path = ell_launch_plan(width, val.element_size(), aligned)
    sms = sm_count(val.device)
    w = torch.empty(rows, dtype=accum_dtype, device=val.device)
    # One partial per block: the grid is at most SMs x the blocks an SM holds.
    partials = torch.empty(max(1, ell_max_blocks(rows, lanes, path, sms)), dtype=accum_dtype,
                           device=val.device)
    alpha = torch.empty(1, dtype=accum_dtype, device=val.device)
    rc = _b.load().repro_spmv_ell_alpha(
        _b.dtype_code(val.dtype), _b.dtype_code(accum_dtype),
        _b.ptr(val), _b.ptr(col), _b.ptr(x), _b.ptr(v), v.shape[0],
        _b.ptr(w), _b.ptr(partials), partials.numel(), _b.ptr(alpha),
        rows, width, lanes, ELL_PATHS[path], sms, _b.stream_of(val),
    )
    _b.check(rc, "spmv_ell_alpha")
    spmv_ell_alpha_kernel_call.launches += 1
    return w, alpha[0]


spmv_ell_alpha_kernel_call.launches = 0
