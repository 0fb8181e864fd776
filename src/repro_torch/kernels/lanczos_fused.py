"""Hopper fused ELL SpMV + alpha kernel (``csrc/lanczos_fused.cu``).

Replaces ``src/repro/kernels/lanczos_fused.py:spmv_ell_alpha_kernel_call``.
Two passes, both deterministic: the SpMV writes ``w`` and one partial of
``<v, w>`` per block; one block then sums the partials in a fixed order.
Bound on the card by bytes.  The plain version is ``ref.spmv_ell_alpha_ref``.
"""

from __future__ import annotations

import torch

from . import build as _b
from .spmv_ell import ell_group

__all__ = ["spmv_ell_alpha_kernel_call"]


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
    group = ell_group(width)
    lib = _b.load()
    w = torch.empty(rows, dtype=accum_dtype, device=val.device)
    partials = torch.empty(max(1, lib.repro_ell_blocks(rows, group)), dtype=accum_dtype,
                           device=val.device)
    alpha = torch.zeros(1, dtype=accum_dtype, device=val.device)
    rc = lib.repro_spmv_ell_alpha(
        _b.dtype_code(val.dtype), _b.dtype_code(accum_dtype),
        _b.ptr(val), _b.ptr(col), _b.ptr(x), _b.ptr(v), v.shape[0],
        _b.ptr(w), _b.ptr(partials), _b.ptr(alpha),
        rows, width, group, _b.stream_of(val),
    )
    _b.check(rc, "spmv_ell_alpha")
    spmv_ell_alpha_kernel_call.launches += 1
    return w, alpha[0]


spmv_ell_alpha_kernel_call.launches = 0
