"""Hopper mixed-precision dot product kernel (``csrc/mixed_dot.cu``).

Replaces ``src/repro/kernels/mixed_dot.py:mixed_dot_kernel_call``: ``a . b``
summed per tile of ``block`` elements in the accum dtype, the tile totals
added in tile order, optionally with a Neumaier compensation term.  One
block per tile reads 16-byte vectors; the last tile may be ragged (its
lanes past the end read zeros, so the result equals a zero-padded call's bit
for bit).  One more block walks the tile totals in order as they finish,
through shared memory, so the bits are the same on every run.  Bound on the
card by bytes.  The plain version is ``ref.mixed_dot_ref``; :func:`mixed_dot_contract`
declares what a launch executes.
"""

from __future__ import annotations

import ctypes

import torch

from ..analysis.op_count import dtype_name, widened
from . import build as _b

__all__ = ["mixed_dot_kernel_call", "mixed_dot_contract"]


def mixed_dot_contract(a: torch.Tensor, accum_dtype, block: int, compensated: bool):
    """The ops one launch executes in ``accum_dtype``: a multiply and an add
    per element, then per tile the running sum's add, or with Neumaier
    compensation its six ops (add, two magnitudes, two corrections, the
    compensation's add); ``a`` and ``b`` widened in registers where they
    differ."""
    n = a.numel()
    tiles = -(-n // block)
    return ({dtype_name(accum_dtype): 2 * n + tiles * (6 if compensated else 1)},
            widened(accum_dtype, a.dtype, a.dtype))


def mixed_dot_kernel_call(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    block: int = 4096,
    accum_dtype=torch.float32,
    compensated: bool = False,
) -> torch.Tensor:
    """Returns ``(2,)`` in ``accum_dtype``: (sum, compensation); the dot is
    their sum.  ``a`` and ``b`` share one dtype (f32, f64, f16 or bf16) and
    any length of at least 1; the last tile of ``block`` elements may be
    ragged."""
    _b.require_cuda("mixed_dot", a, b)
    if a.dim() != 1 or a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(
            f"mixed_dot: a {a.dtype} {tuple(a.shape)} and b {b.dtype} {tuple(b.shape)} must be "
            "1-D of one dtype and length"
        )
    n = a.shape[0]
    if block < 1 or n == 0:
        raise ValueError(f"mixed_dot: length {n} and block {block} must be positive")
    tiles = -(-n // block)
    # One allocation: (sum, comp), the tile totals, and one slot for the
    # kernel's ticket counter (the C entry readies the last two).
    buf = torch.empty(2 + tiles + 1, dtype=accum_dtype, device=a.device)
    base = buf.data_ptr()
    rc = _b.load().repro_mixed_dot(
        _b.dtype_code(a.dtype), _b.dtype_code(accum_dtype), _b.ptr(a), _b.ptr(b),
        ctypes.c_void_p(base), ctypes.c_void_p(base + 2 * buf.element_size()),
        n, block, int(bool(compensated)), _b.stream_of(a),
    )
    _b.check(rc, "mixed_dot")
    mixed_dot_kernel_call.launches += 1
    return buf[:2]


mixed_dot_kernel_call.launches = 0
