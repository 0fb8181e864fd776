"""Hopper fused Lanczos update kernel (``csrc/lanczos_update.cu``).

Replaces ``src/repro/kernels/lanczos_update.py:lanczos_update_kernel_call``:
``u = w - alpha v - beta v_prev`` and ``||u||^2`` in one pass, the norm
reduced in a fixed order (per-block partials, then one block).  ``alpha``
and ``beta`` stay on the card.  Bound by bytes.  The plain version is
``ref.lanczos_update_ref``; :func:`lanczos_update_contract` declares what
a launch executes.
"""

from __future__ import annotations

import torch

from ..analysis.op_count import dtype_name, widened
from . import build as _b

__all__ = ["lanczos_update_kernel_call", "lanczos_update_contract"]


def lanczos_update_contract(w: torch.Tensor, accum_dtype):
    """The ops one launch executes over ``n`` elements, all in
    ``accum_dtype``: two multiplies and two subtractions for ``u``, a
    multiply and an add for ``||u||^2``; ``w``, ``v`` and ``v_prev`` widened
    in registers and ``u`` rounded back to ``w.dtype`` where they differ."""
    return ({dtype_name(accum_dtype): 6 * w.numel()},
            widened(accum_dtype, w.dtype, w.dtype, w.dtype) + widened(w.dtype, accum_dtype))


def _scalar(s, dtype, device) -> torch.Tensor:
    if not isinstance(s, torch.Tensor):
        s = torch.tensor(s)
    return s.to(device=device, dtype=dtype).reshape(1).contiguous()


def lanczos_update_kernel_call(w, v, v_prev, alpha, beta, *, accum_dtype):
    """Returns ``(u (n,) in w.dtype, ||u||^2 0-d in accum_dtype)``.

    ``w``, ``v`` and ``v_prev`` share one dtype; ``alpha`` and ``beta`` are
    0-d tensors on the card (a Python number is copied there first).
    """
    _b.require_cuda("lanczos_update", w, v, v_prev)
    if not (w.dtype == v.dtype == v_prev.dtype) or not (w.shape == v.shape == v_prev.shape):
        raise TypeError("lanczos_update: w, v and v_prev must share one dtype and shape")
    n = w.shape[0]
    a = _scalar(alpha, accum_dtype, w.device)
    b = _scalar(beta, accum_dtype, w.device)
    lib = _b.load()
    u = torch.empty_like(w)
    partials = torch.empty(lib.repro_update_blocks(n), dtype=accum_dtype, device=w.device)
    nrm = torch.zeros(1, dtype=accum_dtype, device=w.device)
    rc = lib.repro_lanczos_update(
        _b.dtype_code(w.dtype), _b.dtype_code(accum_dtype),
        _b.ptr(w), _b.ptr(v), _b.ptr(v_prev), _b.ptr(a), _b.ptr(b),
        _b.ptr(u), _b.ptr(partials), _b.ptr(nrm), n, _b.stream_of(w),
    )
    _b.check(rc, "lanczos_update")
    lanczos_update_kernel_call.launches += 1
    return u, nrm[0]


lanczos_update_kernel_call.launches = 0
