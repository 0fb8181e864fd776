"""Hopper mixed-precision dot product kernel (``csrc/mixed_dot.cu``).

Replaces ``src/repro/kernels/mixed_dot.py:mixed_dot_kernel_call``: ``a . b``
summed per tile of ``block`` elements in the accum dtype, the tile totals
added in tile order, optionally with a Neumaier compensation term.  Two
passes, both in a fixed order (one block per tile, then one thread over the
tile totals), so the bits are the same on every run.  Bound on the card by
bytes.  The plain version is ``ref.mixed_dot_ref``.
"""

from __future__ import annotations

import torch

from . import build as _b

__all__ = ["mixed_dot_kernel_call"]


def mixed_dot_kernel_call(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    block: int = 4096,
    accum_dtype=torch.float32,
    compensated: bool = False,
) -> torch.Tensor:
    """Returns ``(2,)`` in ``accum_dtype``: (sum, compensation); the dot is
    their sum.  ``a`` and ``b`` share one dtype (f32, f64, f16 or bf16) and a
    length that ``block`` divides."""
    _b.require_cuda("mixed_dot", a, b)
    if a.dim() != 1 or a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(
            f"mixed_dot: a {a.dtype} {tuple(a.shape)} and b {b.dtype} {tuple(b.shape)} must be "
            "1-D of one dtype and length"
        )
    n = a.shape[0]
    if block < 1 or n == 0 or n % block:
        raise ValueError(f"mixed_dot: length {n} not divisible by block {block}")
    lib = _b.load()
    partials = torch.empty(n // block, dtype=accum_dtype, device=a.device)
    out = torch.empty(2, dtype=accum_dtype, device=a.device)
    rc = lib.repro_mixed_dot(
        _b.dtype_code(a.dtype), _b.dtype_code(accum_dtype),
        _b.ptr(a), _b.ptr(b), _b.ptr(partials), _b.ptr(out),
        n, block, int(bool(compensated)), _b.stream_of(a),
    )
    _b.check(rc, "mixed_dot")
    mixed_dot_kernel_call.launches += 1
    return out


mixed_dot_kernel_call.launches = 0
