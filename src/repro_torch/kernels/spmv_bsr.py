"""Hopper blocked-ELL (BSR) SpMV kernel (``csrc/spmv_bsr.cu``).

Replaces ``src/repro/kernels/spmv_bsr.py:spmv_bsr_kernel_call``.  Bound by
bytes (0.5 flop a byte of f32 values: tensor cores buy nothing).  A group of
lanes owns a block-row and reads its contiguous values as 16-byte vectors,
neighbouring lanes on neighbouring addresses; each lane keeps one column
group of every block, so it widens its slice of ``x`` once a slot for all
the rows it serves, and the lanes of a row add up in one fixed shuffle tree.
:data:`BSR_PLAN` mirrors the lanes a block-row and slots a step of each
instantiation.  The plain version is ``ref.spmv_bsr_ref``;
:func:`spmv_bsr_contract` declares what a launch executes.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..analysis.op_count import dtype_name, widened
from . import build as _b

__all__ = ["spmv_bsr_kernel_call", "spmv_bsr_contract", "check_bsr_operands",
           "blocked_ell_from_csr", "BSR_PLAN", "bsr_x_bytes"]

# Mirror of csrc/spmv_bsr.cu kBsrPlan: (element bytes, BS) -> (lanes a
# block-row, slots a step).
BSR_PLAN = {
    (4, 4): (4, 2), (4, 8): (4, 4), (4, 16): (16, 2),
    (8, 4): (4, 2), (8, 8): (8, 2), (8, 16): (16, 1),
    (2, 4): (2, 4), (2, 8): (4, 2), (2, 16): (8, 2),
}


def bsr_x_bytes(elem_size: int, bs: int) -> int:
    """The alignment ``x`` needs, from its own element size: a lane loads
    its slice of ``x`` as 16-byte vectors (two where an ``x`` widened to the
    accum dtype makes the slice 32 bytes), or as the whole ``BS``-slice
    where that is shorter (8 bytes at BS 4 in 16-bit types).  ``val`` must
    be aligned to 16 bytes."""
    return min(16, bs * elem_size)


def spmv_bsr_contract(val: torch.Tensor, x: torch.Tensor, accum_dtype):
    """The ops one launch executes: a multiply and an add in ``accum_dtype``
    per stored block value (``nbr * slots * BS * BS``, padding slots
    included), ``val`` and ``x`` widened in registers where they differ.
    (The plain version contracts through ``einsum``, a batched matmul that
    counts one op a multiply-accumulate: half this count.)"""
    return ({dtype_name(accum_dtype): 2 * val.numel()},
            widened(accum_dtype, val.dtype, x.dtype))


def check_bsr_operands(val: torch.Tensor, bcol: torch.Tensor, x: torch.Tensor,
                       n_cols: Optional[int] = None, accum_dtype=None) -> None:
    """Raise on operands the kernel does not take.  ``x`` holds the
    matrix's ``n_cols`` columns zero-padded to whole ``BS``-blocks: ``nbr *
    BS`` for a square matrix (the default), ``G * n_pad`` for a row shard of
    the distributed layout, whose block columns index the all-gathered
    vector.  A shorter ``x`` would let the kernel read past its end.  ``x``
    is in ``val``'s dtype or, where ``accum_dtype`` is given, in that (the
    ``<S, X = A, A>`` instantiations)."""
    if val.dim() != 4 or bcol.shape != val.shape[:2] or bcol.dtype != torch.int32:
        raise ValueError(f"spmv_bsr: bad layout val {tuple(val.shape)} bcol {tuple(bcol.shape)}")
    nbr, _, bs, _ = val.shape
    n_cols = nbr * bs if n_cols is None else int(n_cols)
    want = -(-n_cols // bs) * bs
    dtypes = (val.dtype,) if accum_dtype in (None, val.dtype) else (val.dtype, accum_dtype)
    if x.dtype not in dtypes or x.dim() != 1 or x.shape[0] != want:
        kinds = " or ".join(str(dt) for dt in dtypes)
        raise ValueError(f"spmv_bsr: x must be a {kinds} vector of {want} entries ({n_cols} "
                         f"columns in whole {bs}-blocks), got {x.dtype} {tuple(x.shape)}")


def spmv_bsr_kernel_call(
    val: torch.Tensor, bcol: torch.Tensor, x: torch.Tensor, *, accum_dtype,
    n_cols: Optional[int] = None,
) -> torch.Tensor:
    """``y = BSR(val, bcol) @ x`` on the card; ``x`` holds the ``n_cols``
    columns in whole blocks (see :func:`check_bsr_operands`; the caller
    zero-pads).  Returns ``(nbr * BS,)``."""
    _b.require_cuda("spmv_bsr", val, bcol, x)
    check_bsr_operands(val, bcol, x, n_cols, accum_dtype)
    nbr, slots, bs, _ = val.shape
    x_align = bsr_x_bytes(x.element_size(), bs)
    if val.data_ptr() % 16 or x.data_ptr() % x_align:
        raise ValueError(f"spmv_bsr: val must be 16-byte aligned and x {x_align}-byte aligned, "
                         f"got addresses {val.data_ptr():#x} and {x.data_ptr():#x}")
    y = torch.empty(nbr * bs, dtype=accum_dtype, device=val.device)
    rc = _b.load().repro_spmv_bsr(
        _b.dtype_code(val.dtype), _b.dtype_code(x.dtype), _b.dtype_code(accum_dtype),
        _b.ptr(val), _b.ptr(bcol), _b.ptr(x), _b.ptr(y),
        nbr, slots, bs, _b.stream_of(val),
    )
    _b.check(rc, "spmv_bsr")
    spmv_bsr_kernel_call.launches += 1
    return y


spmv_bsr_kernel_call.launches = 0


def blocked_ell_from_csr(csr, block_size: int = 8, dtype=torch.float32, device="cuda"):
    """Host conversion CSR -> ``(val, bcol, n_rows)``, zero-padded to uniform
    slots: the reference's tuple-returning shim over ``to_device_bsr``."""
    from ..sparse.formats import to_device_bsr

    bsr = to_device_bsr(csr, block_size=block_size, dtype=dtype, device=device)
    return bsr.val, bsr.bcol, bsr.n_rows
