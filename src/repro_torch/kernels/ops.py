"""Public wrappers around the six kernels.

Each wrapper picks its path from where its tensors lie: a CPU tensor runs
the plain PyTorch version (``ref``), a CUDA tensor launches the Hopper
kernel, which raises if it cannot run.  There is no fallback between the
two.  The wrappers also own the launch shape: they pad what a kernel needs
padded and slice the result back to the logical length.

**The operand rule** (:func:`conform`), applied by every wrapper before it
picks its path, so that the card takes every operand the host takes:

* dtype, on both devices: an operand whose dtype the kernel does not pair
  with the others is cast to the accum dtype, once, before the call.  The
  cast is exact against the reference, which widens every element to the
  accum dtype before any arithmetic (a cast commutes with a gather).  The
  gathering kernels (``spmv_ell``, ``spmv_ell_alpha``, ``spmv_bsr``) take
  ``x`` in the storage dtype or the accum dtype (:func:`gather_dtype`);
  ``spmv_ell_packed`` takes an ``x`` of a policy pair, ``lanczos_update``
  and ``mixed_dot`` operands of one dtype of an instantiated pair
  (:func:`shared_dtype`).  ``lanczos_update`` rounds ``u`` back to ``w``'s
  dtype once, as its plain version does.
* layout, on the card only: a strided operand is copied into a fresh
  contiguous tensor, and one whose base is below the kernel's alignment
  (``spmv_bsr``'s ``val`` and ``x``) into a fresh allocation.  The ELL
  kernels and ``mixed_dot`` have paths of their own for unaligned bases.
* an operand that already fits is passed on as the same object: no cast,
  no copy.

The kernel calls (``*_kernel_call``) keep every refusal they have; the
rule only hands them operands they take.

Each kernel call (or its plain version) runs inside
``analysis.op_count.kernel_scope``: under an active op counter its aten ops
are hidden and the kernel's declared contract is recorded instead, the same
on both devices.  The rule's casts run outside it, on both devices, so the
counter sees each once; the contracts read the dtypes that reach the
kernel.
"""

from __future__ import annotations

import torch

from ..analysis.op_count import kernel_scope
from . import ref
from .lanczos_fused import spmv_ell_alpha_contract, spmv_ell_alpha_kernel_call
from .lanczos_update import (
    lanczos_update_contract,
    lanczos_update_kernel_call,
    lanczos_update_multi_contract,
    lanczos_update_multi_kernel_call,
)
from .mixed_dot import mixed_dot_contract, mixed_dot_kernel_call
from .spmv_bsr import bsr_x_bytes, check_bsr_operands, spmv_bsr_contract, spmv_bsr_kernel_call
from .spmv_ell import spmv_ell_contract, spmv_ell_kernel_call
from .spmv_ell_packed import spmv_ell_packed_contract, spmv_ell_packed_kernel_call

__all__ = [
    "on_cpu",
    "conform",
    "gather_dtype",
    "shared_dtype",
    "PAIRS",
    "DOT_PAIRS",
    "ell_matvec",
    "packed_ell_matvec",
    "bsr_matvec",
    "spmv_ell",
    "spmv_ell_alpha",
    "spmv_ell_packed",
    "spmv_bsr",
    "lanczos_update",
    "lanczos_update_multi",
    "mixed_dot",
]


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel path for device {t.device}")


_F32, _F64 = torch.float32, torch.float64
# The (storage, accum) pairs csrc/common.cuh:dispatch_pair instantiates
# (lanczos_update; spmv_ell_packed's x), and those of csrc/mixed_dot.cu.
PAIRS = frozenset({(_F32, _F32), (_F32, _F64), (_F64, _F64), (torch.bfloat16, _F32),
                   (torch.float16, _F32)})
DOT_PAIRS = frozenset((s, a) for s in (_F32, _F64, torch.float16, torch.bfloat16)
                      for a in (_F32, _F64))


def gather_dtype(val: torch.Tensor, x: torch.Tensor, accum_dtype) -> torch.dtype:
    """The dtype ``x`` reaches a gathering kernel in: its own where that is
    ``val``'s or the accum dtype, else the accum dtype."""
    return x.dtype if x.dtype in (val.dtype, accum_dtype) else accum_dtype


def shared_dtype(tensors, accum_dtype, pairs=PAIRS) -> torch.dtype:
    """The one dtype ``tensors`` reach a kernel in: their own where they
    share it and it pairs with ``accum_dtype`` in ``pairs``, else the
    accum dtype."""
    dt = tensors[0].dtype
    if all(t.dtype == dt for t in tensors) and (dt, accum_dtype) in pairs:
        return dt
    return accum_dtype


def conform(t: torch.Tensor, dtype=None, align: int = 0) -> torch.Tensor:
    """The operand rule for one operand (see the module docstring): ``t``
    cast to ``dtype`` (None: kept), then on the card copied into a fresh
    contiguous tensor if it is strided and into a fresh allocation if its
    base is not ``align``-byte aligned.  ``t`` itself when it fits."""
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    if on_cpu(t):
        return t
    if not t.is_contiguous():
        t = t.contiguous()
    if align and t.data_ptr() % align:
        t = t.clone()
    return t


def ell_matvec(val, col, x, accum_dtype) -> torch.Tensor:
    """``ELL(val, col) @ x`` over the padded rows -> ``(rows_pad,)``."""
    val, col = conform(val), conform(col)
    x = conform(x, gather_dtype(val, x, accum_dtype))
    with kernel_scope("spmv_ell", lambda: spmv_ell_contract(val, x, accum_dtype)):
        if on_cpu(val):
            return ref.spmv_ell_ref(val, col, x, accum_dtype)
        return spmv_ell_kernel_call(val, col, x, accum_dtype=accum_dtype)


def packed_ell_matvec(val, scale, base, dcol, x, accum_dtype) -> torch.Tensor:
    """SpMV of a packed ELL chunk (``spmv_ell_packed``) -> ``(rows,)``."""
    val, scale, base, dcol = (conform(t) for t in (val, scale, base, dcol))
    x = conform(x, shared_dtype((x,), accum_dtype))
    with kernel_scope("spmv_ell_packed",
                      lambda: spmv_ell_packed_contract(val, scale, x, accum_dtype)):
        if on_cpu(val):
            return ref.spmv_ell_packed_ref(val, scale, base, dcol, x, accum_dtype)
        return spmv_ell_packed_kernel_call(val, scale, base, dcol, x, accum_dtype=accum_dtype)


def bsr_matvec(val, bcol, x, accum_dtype, n_cols=None) -> torch.Tensor:
    """``BSR(val, bcol) @ x`` over the padded rows -> ``(nbr * BS,)``.  ``x``
    holds the ``n_cols`` columns (default ``nbr * BS``: a square matrix),
    zero-padded here to whole blocks; any other length raises."""
    nbr, _, bs, _ = val.shape
    n_cols = nbr * bs if n_cols is None else int(n_cols)
    width = -(-n_cols // bs) * bs
    dt = gather_dtype(val, x, accum_dtype)
    val, bcol = conform(val, align=16), conform(bcol)
    x = conform(x, dt, align=bsr_x_bytes(dt.itemsize, bs))
    if x.shape[0] == n_cols < width:
        x = torch.nn.functional.pad(x, (0, width - n_cols))
    with kernel_scope("spmv_bsr", lambda: spmv_bsr_contract(val, x, accum_dtype)):
        if on_cpu(val):
            check_bsr_operands(val, bcol, x, n_cols, accum_dtype)
            return ref.spmv_bsr_ref(val, bcol, x, accum_dtype)
        return spmv_bsr_kernel_call(val, bcol, x, accum_dtype=accum_dtype, n_cols=n_cols)


def spmv_ell(mat, x, accum_dtype=None) -> torch.Tensor:
    """SpMV on a ``DeviceELL``; ``(n_rows,)`` in the accum dtype."""
    acc = accum_dtype or torch.float32
    return ell_matvec(mat.val, mat.col, x, acc)[: mat.n_rows]


def spmv_ell_packed(val, scale, base, dcol, x, n_rows: int, accum_dtype=None) -> torch.Tensor:
    """SpMV over one packed chunk (``spmv_ell_packed.py``'s layout) ->
    ``(n_rows,)`` in the accum dtype.  Unlike the reference, f64
    accumulation runs the kernel too: the card has f64."""
    acc = accum_dtype or torch.float32
    return packed_ell_matvec(val, scale, base, dcol, x, acc)[:n_rows]


def spmv_bsr(blocked, x, accum_dtype=None) -> torch.Tensor:
    """SpMV on a ``DeviceBSR``, or on the reference's ``(val, bcol,
    n_rows)`` tuple of a square matrix; ``(n_rows,)`` in the accum dtype."""
    acc = accum_dtype or torch.float32
    if isinstance(blocked, tuple):
        val, bcol, n_rows = blocked
        return bsr_matvec(val, bcol, x, acc, x.shape[0])[:n_rows]
    return bsr_matvec(blocked.val, blocked.bcol, x, acc, blocked.n_cols)[: blocked.n_rows]


def spmv_ell_alpha(mat, x, v, accum_dtype=None):
    """Fused ``w = A @ x`` and ``alpha = <v, w>`` on a ``DeviceELL``.

    ``x`` is the gather source, ``v`` the alpha operand of length
    ``n_rows`` (the padded rows past it add nothing).  Returns ``(w
    (n_rows,), alpha 0-d)`` in the accum dtype.
    """
    acc = accum_dtype or torch.float32
    val, col = conform(mat.val), conform(mat.col)
    x, v = conform(x, gather_dtype(val, x, acc)), conform(v, acc)
    with kernel_scope("spmv_ell_alpha", lambda: spmv_ell_alpha_contract(val, x, v, acc)):
        if on_cpu(val):
            w, alpha = ref.spmv_ell_alpha_ref(val, col, x, v, acc)
        else:
            w, alpha = spmv_ell_alpha_kernel_call(val, col, x, v, accum_dtype=acc)
    return w[: mat.n_rows], alpha


def lanczos_update(w, v, v_prev, alpha, beta, accum_dtype=None):
    """Fused ``u = w - alpha v - beta v_prev`` and ``||u||^2`` (one pass):
    ``(u in w.dtype, ||u||^2 0-d in the accum dtype)``.  Any length: the
    kernel masks its ragged edge itself."""
    acc = accum_dtype or torch.float32
    out = w.dtype
    dt = shared_dtype((w, v, v_prev), acc)
    w, v, v_prev = (conform(t, dt) for t in (w, v, v_prev))
    with kernel_scope("lanczos_update", lambda: lanczos_update_contract(w, acc)):
        if on_cpu(w):
            u, nrm = ref.lanczos_update_ref(w, v, v_prev, alpha, beta, acc)
        else:
            u, nrm = lanczos_update_kernel_call(w, v, v_prev, alpha, beta, accum_dtype=acc)
    return u.to(out), nrm


def lanczos_update_multi(w, v, v_prev, alpha, beta, accum_dtype=None):
    """:func:`lanczos_update` on every row of ``(B, n)`` ``w``, ``v`` and
    ``v_prev`` with ``(B,)`` ``alpha`` and ``beta``, in one batched launch:
    ``(u (B, n), ||u_s||^2 (B,))``, row s with the bits of a solo launch."""
    acc = accum_dtype or torch.float32
    out = w.dtype
    dt = shared_dtype((w, v, v_prev), acc)
    w, v, v_prev = (conform(t, dt) for t in (w, v, v_prev))
    with kernel_scope("lanczos_update_multi", lambda: lanczos_update_multi_contract(w, acc)):
        if on_cpu(w):
            u, nrm = ref.lanczos_update_multi_ref(w, v, v_prev, alpha, beta, acc)
        else:
            u, nrm = lanczos_update_multi_kernel_call(w, v, v_prev, alpha, beta,
                                                      accum_dtype=acc)
    return u.to(out), nrm


def mixed_dot(a, b, accum_dtype=None, compensated: bool = False, block: int = 4096):
    """``a . b`` as a 0-d tensor in ``accum_dtype`` (f32 by default): per-tile
    sums, then the tiles in order, with Neumaier compensation when asked.
    Any length.  On the card the kernel masks the ragged last tile itself,
    with no copy of the operands, and gives the bits of a call on operands
    zero-padded to whole tiles; the plain version pads them, as the
    reference wrapper does (padding adds nothing to the sum or its
    compensation).  Unlike the reference, f64 accumulation runs the kernel
    too: the card has f64."""
    acc = accum_dtype or torch.float32
    n = a.shape[0]
    if n == 0:
        raise ValueError("mixed_dot: empty operands")
    block = min(block, n)
    dt = shared_dtype((a, b), acc, DOT_PAIRS)
    a, b = conform(a, dt), conform(b, dt)
    with kernel_scope("mixed_dot", lambda a=a: mixed_dot_contract(a, acc, block, compensated)):
        if on_cpu(a):
            pad = (-n) % block
            if pad:
                a, b = torch.nn.functional.pad(a, (0, pad)), torch.nn.functional.pad(b, (0, pad))
            out = ref.mixed_dot_ref(a, b, acc, block=block, compensated=compensated)
        else:
            out = mixed_dot_kernel_call(a, b, block=block, accum_dtype=acc,
                                        compensated=compensated)
    return out.sum()
