"""Linear operators consumed by the eigensolver (in-core part).

The Lanczos phase needs only ``y = A @ x``.  ``SparseOperator`` runs it
through an :class:`~repro_torch.kernels.engine.SpmvEngine` on the layout
the engine chose; ``DenseOperator`` is a plain matrix product.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..kernels.engine import SpmvEngine
from ..sparse.formats import CSR, to_device_bsr, to_device_coo, to_device_ell, to_device_hybrid
from .precision import PrecisionPolicy

__all__ = ["LinearOperator", "DenseOperator", "SparseOperator", "make_operator"]


class LinearOperator:
    """Protocol: symmetric square operator with policy-aware matvec."""

    n: int

    def matvec(self, x: torch.Tensor, accum_dtype=None) -> torch.Tensor:
        raise NotImplementedError

    def bound_matvec(self, policy: PrecisionPolicy) -> Callable:
        # The SpMV accumulator runs in its own phase dtype; the Lanczos loop
        # rounds the product back to the carried compute dtype.
        acc = policy.phase_dtype("spmv")

        def mv(x):
            return self.matvec(x, accum_dtype=acc)

        return mv


@dataclasses.dataclass
class DenseOperator(LinearOperator):
    a: torch.Tensor

    @property
    def n(self) -> int:
        return self.a.shape[0]

    def matvec(self, x, accum_dtype=None):
        acc = accum_dtype or x.dtype
        return self.a.to(acc) @ x.to(acc)


@dataclasses.dataclass
class SparseOperator(LinearOperator):
    """Explicit sparse matrix on a device container, run by its engine."""

    mat: object  # DeviceCOO | DeviceELL | DeviceBSR | DeviceHybrid
    engine: SpmvEngine

    @property
    def n(self) -> int:
        return self.mat.n_rows

    @property
    def spmv_format(self) -> str:
        return self.engine.format

    def matvec(self, x, accum_dtype=None):
        return self.engine.spmv(self.mat, x, accum_dtype=accum_dtype)


def make_operator(csr: CSR, dtype=torch.float32, engine: SpmvEngine = None) -> SparseOperator:
    """Build the device layout the engine chose, on the engine's device."""
    if engine is None:
        raise ValueError("make_operator needs an SpmvEngine (see kernels.engine.make_engine)")
    dev, t = engine.device, engine.tiles
    if engine.format == "ell":
        mat = to_device_ell(csr, dtype=dtype, row_tile=t.block_r, slot_tile=t.block_w, device=dev)
    elif engine.format == "bsr":
        mat = to_device_bsr(csr, block_size=t.block_size, dtype=dtype, device=dev)
    elif engine.format == "hybrid":
        # Reuse the cap the selection statistics were computed with, so the
        # built layout matches the overhead the selector accepted.
        cap = max(s.hyb_width for s in engine.stats) if engine.stats else None
        mat = to_device_hybrid(
            csr, dtype=dtype, width_cap=cap, row_tile=t.block_r, slot_tile=t.block_w, device=dev
        )
    else:
        mat = to_device_coo(csr, dtype=dtype, device=dev)
    return SparseOperator(mat, engine=engine)
