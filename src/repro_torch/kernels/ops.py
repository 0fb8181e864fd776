"""Public wrappers around the six kernels.

Each wrapper picks its path from where its tensors lie: a CPU tensor runs
the plain PyTorch version (``ref``), a CUDA tensor launches the Hopper
kernel, which raises if it cannot run.  There is no fallback between the
two.  The wrappers also own the launch shape: they pad what a kernel needs
padded and slice the result back to the logical length.

Each kernel call (or its plain version) runs inside
``analysis.op_count.kernel_scope``: under an active op counter its aten ops
are hidden and the kernel's declared contract is recorded instead, the same
on both devices.
"""

from __future__ import annotations

import torch

from ..analysis.op_count import kernel_scope
from . import ref
from .lanczos_fused import spmv_ell_alpha_contract, spmv_ell_alpha_kernel_call
from .lanczos_update import lanczos_update_contract, lanczos_update_kernel_call
from .mixed_dot import mixed_dot_contract, mixed_dot_kernel_call
from .spmv_bsr import check_bsr_operands, spmv_bsr_contract, spmv_bsr_kernel_call
from .spmv_ell import spmv_ell_contract, spmv_ell_kernel_call
from .spmv_ell_packed import spmv_ell_packed_contract, spmv_ell_packed_kernel_call

__all__ = [
    "on_cpu",
    "ell_matvec",
    "packed_ell_matvec",
    "bsr_matvec",
    "spmv_ell",
    "spmv_ell_alpha",
    "spmv_ell_packed",
    "spmv_bsr",
    "lanczos_update",
    "mixed_dot",
]


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel path for device {t.device}")


def ell_matvec(val, col, x, accum_dtype) -> torch.Tensor:
    """``ELL(val, col) @ x`` over the padded rows -> ``(rows_pad,)``."""
    with kernel_scope("spmv_ell", lambda: spmv_ell_contract(val, x, accum_dtype)):
        if on_cpu(val):
            return ref.spmv_ell_ref(val, col, x, accum_dtype)
        return spmv_ell_kernel_call(val, col, x, accum_dtype=accum_dtype)


def packed_ell_matvec(val, scale, base, dcol, x, accum_dtype) -> torch.Tensor:
    """SpMV of a packed ELL chunk (``spmv_ell_packed``) -> ``(rows,)``."""
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
    if x.shape[0] == n_cols < width:
        x = torch.nn.functional.pad(x, (0, width - n_cols))
    with kernel_scope("spmv_bsr", lambda: spmv_bsr_contract(val, x, accum_dtype)):
        if on_cpu(val):
            check_bsr_operands(val, bcol, x, n_cols)
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


def spmv_bsr(mat, x, accum_dtype=None) -> torch.Tensor:
    """SpMV on a ``DeviceBSR``; ``(n_rows,)`` in the accum dtype."""
    acc = accum_dtype or torch.float32
    return bsr_matvec(mat.val, mat.bcol, x, acc, mat.n_cols)[: mat.n_rows]


def spmv_ell_alpha(mat, x, v, accum_dtype=None):
    """Fused ``w = A @ x`` and ``alpha = <v, w>`` on a ``DeviceELL``.

    ``x`` is the gather source (storage dtype), ``v`` the alpha operand of
    length ``n_rows`` (the padded rows past it add nothing).  Returns
    ``(w (n_rows,), alpha 0-d)`` in the accum dtype.
    """
    acc = accum_dtype or torch.float32
    v = v.to(acc)
    with kernel_scope("spmv_ell_alpha", lambda: spmv_ell_alpha_contract(mat.val, x, v, acc)):
        if on_cpu(mat.val):
            w, alpha = ref.spmv_ell_alpha_ref(mat.val, mat.col, x, v, acc)
        else:
            w, alpha = spmv_ell_alpha_kernel_call(mat.val, mat.col, x, v, accum_dtype=acc)
    return w[: mat.n_rows], alpha


def lanczos_update(w, v, v_prev, alpha, beta, accum_dtype=None):
    """Fused ``u = w - alpha v - beta v_prev`` and ``||u||^2`` (one pass).
    Any length: the kernel masks its ragged edge itself."""
    acc = accum_dtype or torch.float32
    with kernel_scope("lanczos_update", lambda: lanczos_update_contract(w, acc)):
        if on_cpu(w):
            return ref.lanczos_update_ref(w, v, v_prev, alpha, beta, acc)
        return lanczos_update_kernel_call(w, v, v_prev, alpha, beta, accum_dtype=acc)


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
