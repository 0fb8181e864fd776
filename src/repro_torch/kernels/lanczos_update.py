"""Hopper fused Lanczos update kernel (``csrc/lanczos_update.cu``).

Replaces ``src/repro/kernels/lanczos_update.py:lanczos_update_kernel_call``:
``u = w - alpha v - beta v_prev`` and ``||u||^2`` in one pass, the norm
reduced in a fixed order (per-block partials, then one block).  ``alpha``
and ``beta`` stay on the card.  Bound by bytes.  The plain version is
``ref.lanczos_update_ref``; :func:`lanczos_update_contract` declares what
a launch executes.

:func:`lanczos_update_multi_kernel_call` is the batched launch of the
multi-start sweep (``jax.vmap`` of the TPU kernel in the reference): the
same kernel over B rows in one launch, row s with the bits of a solo
launch on row s (plain version ``ref.lanczos_update_multi_ref``).
"""

from __future__ import annotations

import torch

from ..analysis.op_count import dtype_name, widened
from . import build as _b

__all__ = ["lanczos_update_kernel_call", "lanczos_update_contract",
           "lanczos_update_multi_kernel_call", "lanczos_update_multi_contract"]

# The most start rows one batched launch takes: the grid's y limit.
MAX_ROWS = 65_535


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


def _launch(name, w, v, v_prev, a, b, rows, n, accum_dtype):
    """One launch of the update over ``rows`` contiguous rows of ``n``:
    ``(u, ||u_s||^2 (rows,))``."""
    lib = _b.load()
    u = torch.empty_like(w)
    partials = torch.empty(rows * lib.repro_update_blocks(n), dtype=accum_dtype, device=w.device)
    nrm = torch.zeros(rows, dtype=accum_dtype, device=w.device)
    rc = lib.repro_lanczos_update(
        _b.dtype_code(w.dtype), _b.dtype_code(accum_dtype),
        _b.ptr(w), _b.ptr(v), _b.ptr(v_prev), _b.ptr(a), _b.ptr(b),
        _b.ptr(u), _b.ptr(partials), _b.ptr(nrm), n, rows, _b.stream_of(w),
    )
    _b.check(rc, name)
    return u, nrm


def _check_operands(name, w, v, v_prev):
    _b.require_cuda(name, w, v, v_prev)
    if not (w.dtype == v.dtype == v_prev.dtype) or not (w.shape == v.shape == v_prev.shape):
        raise TypeError(f"{name}: w, v and v_prev must share one dtype and shape")


def lanczos_update_kernel_call(w, v, v_prev, alpha, beta, *, accum_dtype):
    """Returns ``(u (n,) in w.dtype, ||u||^2 0-d in accum_dtype)``.

    ``w``, ``v`` and ``v_prev`` share one dtype; ``alpha`` and ``beta`` are
    0-d tensors on the card (a Python number is copied there first).
    """
    _check_operands("lanczos_update", w, v, v_prev)
    u, nrm = _launch("lanczos_update", w, v, v_prev, _scalar(alpha, accum_dtype, w.device),
                     _scalar(beta, accum_dtype, w.device), 1, w.shape[0], accum_dtype)
    lanczos_update_kernel_call.launches += 1
    return u, nrm[0]


lanczos_update_kernel_call.launches = 0


def lanczos_update_multi_contract(w: torch.Tensor, accum_dtype):
    """B times the solo contract of one ``(n,)`` row: a batched launch over
    ``(B, n)`` runs the solo launch's element ops on every row, with the
    solo launch's conversions."""
    rows = w.shape[0]
    ops, convs = lanczos_update_contract(w[0], accum_dtype)
    return {k: rows * v for k, v in ops.items()}, convs


def lanczos_update_multi_kernel_call(w, v, v_prev, alpha, beta, *, accum_dtype):
    """Returns ``(u (B, n) in w.dtype, ||u_s||^2 (B,) in accum_dtype)``.

    ``w``, ``v`` and ``v_prev`` are contiguous ``(B, n)`` tensors of one
    dtype; ``alpha`` and ``beta`` hold one value a row, ``(B,)`` on the card.
    The solo launch's kernel with one grid row a start: two launches (the
    update, then one reducing block a row), whatever B.
    """
    _check_operands("lanczos_update_multi", w, v, v_prev)
    if w.ndim != 2 or not 1 <= w.shape[0] <= MAX_ROWS:
        raise ValueError(f"lanczos_update_multi: w must be (B, n) with 1 <= B <= {MAX_ROWS}, "
                         f"got {tuple(w.shape)}")
    rows, n = w.shape
    a = alpha.to(device=w.device, dtype=accum_dtype).reshape(rows).contiguous()
    b = beta.to(device=w.device, dtype=accum_dtype).reshape(rows).contiguous()
    u, nrm = _launch("lanczos_update_multi", w, v, v_prev, a, b, rows, n, accum_dtype)
    lanczos_update_multi_kernel_call.launches += 1
    return u, nrm


lanczos_update_multi_kernel_call.launches = 0
