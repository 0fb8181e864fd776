"""Plain PyTorch versions of the six Hopper kernels.

Each is the semantic ground truth its CUDA kernel must match.  They run on
any device: the wrappers in ``ops`` take them for CPU tensors, and
``chip_smoke.py`` runs them on the card to hold each kernel against them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "spmv_ell_ref",
    "spmv_ell_alpha_ref",
    "lanczos_update_ref",
    "spmv_bsr_ref",
    "spmv_ell_packed_ref",
    "mixed_dot_ref",
]


def spmv_ell_ref(val: torch.Tensor, col: torch.Tensor, x: torch.Tensor, accum_dtype) -> torch.Tensor:
    """ELL SpMV: ``y[r] = sum_s val[r, s] * x[col[r, s]]`` in ``accum_dtype``.
    Returns ``(rows_pad,)``."""
    gathered = x[col.long()].to(accum_dtype)
    return (val.to(accum_dtype) * gathered).sum(dim=1)


def spmv_ell_alpha_ref(
    val: torch.Tensor, col: torch.Tensor, x: torch.Tensor, v: torch.Tensor, accum_dtype
):
    """``w = ELL(val, col) @ x`` and ``alpha = <v, w>`` over the first
    ``len(v)`` rows (padding rows hold zero values: they add nothing).
    Returns ``(w (rows_pad,), alpha 0-d)`` in ``accum_dtype``."""
    w = spmv_ell_ref(val, col, x, accum_dtype)
    return w, torch.sum(v.to(accum_dtype) * w[: v.shape[0]])


def lanczos_update_ref(w, v, v_prev, alpha, beta, accum_dtype):
    """Three-term recurrence plus the squared norm of its result:
    ``u = w - alpha v - beta v_prev`` in ``accum_dtype``; returns
    ``(u in w.dtype, ||u||^2 0-d in accum_dtype)``."""
    acc = accum_dtype
    u = w.to(acc) - alpha.to(acc) * v.to(acc) - beta.to(acc) * v_prev.to(acc)
    return u.to(w.dtype), torch.sum(u * u)


def spmv_bsr_ref(val: torch.Tensor, bcol: torch.Tensor, x: torch.Tensor, accum_dtype) -> torch.Tensor:
    """Blocked-ELL SpMV: ``y_i = sum_s val[i, s] @ x[bcol[i, s]*BS : +BS]``.
    ``x`` has ``n_block_rows * BS`` entries; returns ``(n_block_rows * BS,)``."""
    nbr, slots, bs, _ = val.shape
    gathered = x.reshape(-1, bs)[bcol.long()].to(accum_dtype)  # (nbr, slots, bs)
    y = torch.einsum("rsij,rsj->ri", val.to(accum_dtype), gathered)
    return y.reshape(nbr * bs)


def spmv_ell_packed_ref(val, scale, base, dcol, x, accum_dtype) -> torch.Tensor:
    """Packed-ELL SpMV: values ``val * scale`` at columns
    ``base + cumsum(dcol)`` along each row, times ``x``, summed in
    ``accum_dtype``.  Returns ``(rows,)``."""
    vals = val.to(accum_dtype) * scale.to(accum_dtype)
    # int32 running sum (torch.cumsum of int16 would widen to int64).
    cols = base + torch.cumsum(dcol.to(torch.int32), 1, dtype=torch.int32)
    return torch.sum(vals * x[cols.long()].to(accum_dtype), 1)


def mixed_dot_ref(a, b, accum_dtype, block: int = 4096, compensated: bool = False) -> torch.Tensor:
    """``(sum, comp)`` of ``a . b``: per-tile sums of ``block`` products in
    ``accum_dtype``, then a running sum over the tiles in order, with the
    Neumaier compensation term when ``compensated`` (the TPU grid's
    recurrence).  ``block`` must divide the length.  Returns ``(2,)``."""
    n = a.shape[0]
    if n == 0 or n % block:
        raise ValueError(f"mixed_dot: length {n} not divisible by block {block}")
    tiles = (a.to(accum_dtype) * b.to(accum_dtype)).reshape(-1, block).sum(1)
    # The recurrence is serial: run it on host scalars of the accum dtype,
    # which round every operation as the accum dtype does.
    part = tiles.cpu().numpy()
    s, comp = part[0], part.dtype.type(0)
    for p in part[1:]:
        if compensated:
            t = s + p
            comp = comp + ((s - t) + p if abs(s) >= abs(p) else (p - t) + s)
            s = t
        else:
            s = s + p
    return torch.from_numpy(np.array([s, comp], dtype=part.dtype)).to(a.device)
