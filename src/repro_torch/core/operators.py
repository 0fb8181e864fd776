"""Linear operators consumed by the eigensolver.

The Lanczos phase needs only ``y = A @ x``.  ``SparseOperator`` runs it
through an :class:`~repro_torch.kernels.engine.SpmvEngine` on the layout
the engine chose; ``DenseOperator`` is a plain matrix product;
:class:`CallableOperator` wraps a matrix-free matvec;
:class:`ChunkedOperator` streams a matrix that stays on the host (an
in-RAM CSR or a memory-mapped :class:`~repro_torch.sparse.DiskCSR`) to the
device chunk by chunk, the paper's out-of-core mode.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..analysis.op_count import host_scope
from ..kernels.engine import SpmvEngine
from ..sparse.diskcsr import DiskCSR
from ..sparse.formats import (
    CSR,
    count_conversions,
    segment_sum,
    to_device_bsr,
    to_device_coo,
    to_device_ell,
    to_device_hybrid,
)
from ..testing import faults as _faults
from . import tree as _tree
from .precision import PrecisionPolicy

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "SparseOperator",
    "CallableOperator",
    "ChunkedOperator",
    "HvpOperator",
    "chunk_row_bounds",
    "chunk_rows_pad",
    "make_operator",
]


def chunk_row_bounds(indptr: np.ndarray, n: int, chunk_nnz: int) -> list:
    """Row-contiguous chunk bounds holding <= ``chunk_nnz`` non-zeros each
    (single rows larger than the budget get a chunk of their own).  The
    reference's function, verbatim: the same chunks mean the same fp8 scale
    blocks."""
    starts = [0]
    while starts[-1] < n:
        r0 = starts[-1]
        r1 = int(np.searchsorted(indptr, indptr[r0] + chunk_nnz, side="right")) - 1
        starts.append(min(n, max(r1, r0 + 1)))
    return list(zip(starts[:-1], starts[1:]))


def chunk_rows_pad(rows: int, block_r: int = 8) -> int:
    """Padded row count of one staged ELL chunk: rows round up to a multiple
    of ``block_r`` (8, also the packed chunks' scale block).  The reference
    also floors the tile at the TPU sublane minimum of the staged dtype and
    caps it at a power of two; neither means anything on the card."""
    return -(-rows // block_r) * block_r


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
    """Explicit sparse matrix on a device container, run by its engine, or
    without one by a legacy ``impl``: ``"coo"`` (the segmented sum),
    ``"ell"`` / ``"ell_kernel"`` (``spmv_ell``) or ``"bsr_kernel"``
    (``spmv_bsr`` on a ``(val, bcol, n_rows)`` tuple)."""

    mat: object  # DeviceCOO | DeviceELL | DeviceBSR | DeviceHybrid | (val, bcol, n_rows)
    engine: Optional[SpmvEngine] = None
    impl: str = "engine"

    @property
    def n(self) -> int:
        if isinstance(self.mat, tuple):  # blocked ELL: (val, bcol, n_rows)
            return int(self.mat[2])
        return self.mat.n_rows

    @property
    def device(self) -> torch.device:
        if self.engine is not None:
            return torch.device(self.engine.device)
        return (self.mat[0] if isinstance(self.mat, tuple) else self.mat.val).device

    @property
    def spmv_format(self) -> str:
        if self.engine is not None:
            return self.engine.format
        return {"ell_kernel": "ell", "bsr_kernel": "bsr"}.get(self.impl, self.impl)

    def matvec(self, x, accum_dtype=None):
        if self.engine is not None:
            return self.engine.spmv(self.mat, x, accum_dtype=accum_dtype)
        from ..kernels import ops as kops

        if self.impl == "coo":
            return self.mat.matvec(x, accum_dtype=accum_dtype)
        if self.impl in ("ell", "ell_kernel"):
            # The reference's "ell" is a plain gather; here both run the kernel.
            return kops.spmv_ell(self.mat, x, accum_dtype=accum_dtype)
        if self.impl == "bsr_kernel":
            val, bcol, n_rows = self.mat
            acc = accum_dtype or torch.float32
            return kops.bsr_matvec(val, bcol, x, acc, n_rows)[:n_rows]
        raise ValueError(f"unknown SpMV impl {self.impl!r}")


@dataclasses.dataclass
class CallableOperator(LinearOperator):
    """A bare symmetric matvec ``fn(x) -> A @ x``: how ``eigsh`` takes a
    matrix-free problem (a scipy ``LinearOperator`` or any function).  The
    callable is a black box, so the precision policy governs only the
    Lanczos arithmetic around it.

    ``fn`` gets a tensor on ``device`` in the storage dtype.  A tensor it
    returns keeps its dtype; anything else (a NumPy array from a host
    callable) is cast to the input's dtype, as the reference's host bridge
    (``jax.pure_callback``) casts it.
    """

    fn: Callable
    n: int
    device: str = "cpu"

    def matvec(self, x, accum_dtype=None):
        y = self.fn(x)
        if not isinstance(y, torch.Tensor):
            y = torch.as_tensor(np.asarray(y)).to(dtype=x.dtype)
        if tuple(y.shape) != (self.n,):
            raise ValueError(
                f"matvec callable returned shape {tuple(y.shape)}, expected ({self.n},)"
            )
        y = y.to(device=x.device)
        return y.to(accum_dtype) if accum_dtype is not None else y


class HvpOperator(LinearOperator):
    """Matrix-free Hessian-vector product of ``loss_fn(params)`` (the
    framework integration of the paper's solver; see
    ``training/spectral.py``).

    ``params`` is a tree of tensors (dicts, lists); the operator's vector is
    the tree flattened in ``jax.flatten_util.ravel_pytree``'s order (dict
    keys sorted, lists by index: :mod:`repro_torch.core.tree`), so a NumPy
    start vector and the eigenvectors map element for element onto the
    reference's.  ``matvec`` is reverse over reverse, as the reference's:
    ``H x = d/dp <grad loss(p), x>``, the gradient taken with
    ``create_graph=True``, so every op on the loss path must be twice
    differentiable.  It runs on the params' device in their dtype.
    ``ggn`` is accepted and ignored, as in the reference: the product is
    always the full Hessian's.
    """

    def __init__(self, loss_fn: Callable, params, ggn: bool = False):
        self._loss = loss_fn
        self._params = params
        self._leaves = _tree.leaves(params)
        self.n = sum(t.numel() for t in self._leaves)
        self.device = self._leaves[0].device
        dt = self._leaves[0].dtype
        for t in self._leaves[1:]:
            dt = torch.promote_types(dt, t.dtype)
        self.dtype = dt

    def matvec(self, x, accum_dtype=None):
        x = x.to(device=self.device, dtype=self.dtype)
        ps = [p.detach().requires_grad_(True) for p in self._leaves]
        with torch.enable_grad():
            loss = self._loss(_tree.unflatten(self._params, ps))
            gs = torch.autograd.grad(loss, ps, create_graph=True)
            gv = torch.zeros((), dtype=self.dtype, device=self.device)
            off = 0
            for g in gs:
                k = g.numel()
                gv = gv + torch.dot(g.reshape(-1).to(self.dtype), x[off:off + k])
                off += k
            hv = torch.autograd.grad(gv, ps)
        y = torch.cat([h.reshape(-1).to(self.dtype) for h in hv])
        return y.to(accum_dtype) if accum_dtype else y


_IMPLS = ("coo", "ell", "ell_kernel", "bsr_kernel", "chunked")


def make_operator(csr: CSR, impl: str = "coo", dtype=torch.float32,
                  engine: Optional[SpmvEngine] = None, device=None) -> LinearOperator:
    """Build a solver operator for an explicit sparse matrix.

    With an :class:`SpmvEngine`, the engine's format drives the layout, on
    the engine's device (``impl`` is ignored); otherwise ``impl`` picks one
    of the reference's legacy paths (``"coo"``, ``"ell"``, ``"ell_kernel"``,
    ``"bsr_kernel"``, ``"chunked"``) on ``device`` ("cuda" unless given).
    """
    if engine is None:
        if impl not in _IMPLS:
            raise ValueError(f"unknown operator impl {impl!r}; expected one of {_IMPLS}")
        dev = torch.device(device if device is not None else "cuda")
        if impl == "coo":
            return SparseOperator(to_device_coo(csr, dtype=dtype, device=dev), impl="coo")
        if impl in ("ell", "ell_kernel"):
            return SparseOperator(to_device_ell(csr, dtype=dtype, device=dev), impl=impl)
        if impl == "bsr_kernel":
            from ..kernels.spmv_bsr import blocked_ell_from_csr

            return SparseOperator(blocked_ell_from_csr(csr, dtype=dtype, device=dev), impl=impl)
        return ChunkedOperator(csr, dtype=dtype, device=dev)
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


def _numpy_view(t: torch.Tensor) -> Optional[np.ndarray]:
    """A NumPy view of a host tensor, or None for dtypes NumPy lacks."""
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        return None
    return t.numpy()


class _Window:
    """One staging slot: a host buffer (pinned when the device is a card)
    and a device buffer per operand, sized for the largest chunk, plus the
    events that order its reuse."""

    def __init__(self, sizes, device: torch.device):
        cuda = device.type == "cuda"
        self.host = [torch.empty(nb, dtype=torch.uint8, pin_memory=cuda) for nb in sizes]
        self.dev = [torch.empty(nb, dtype=torch.uint8, device=device) for nb in sizes]
        self.chunk: Optional[int] = None  # chunk held, until its kernel is known done
        self.copied = torch.cuda.Event() if cuda else None  # after its H2D copy
        self.done = torch.cuda.Event() if cuda else None  # after the kernel that read it
        self.pending = False  # `done` recorded and not yet waited on


def _view(buf: torch.Tensor, dtype, shape) -> torch.Tensor:
    """The leading bytes of a uint8 buffer as a contiguous ``shape`` tensor."""
    count = int(np.prod(shape))
    nbytes = count * torch.empty((), dtype=dtype).element_size()
    return buf[:nbytes].view(dtype).view(shape)


class ChunkedOperator(LinearOperator):
    """Out-of-core SpMV: the matrix stays on the host (an in-RAM CSR or a
    memory-mapped :class:`~repro_torch.sparse.DiskCSR`); each matvec streams
    fixed-size chunks to the device and accumulates their partial products.

    The reference's ``ChunkedOperator`` (``repro/core/operators.py``), with
    the TPU's ``device_put`` + ``block_until_ready`` throttle replaced by
    CUDA streams and events:

    * ``stage_depth + 1`` staging windows, each a pinned host buffer and a
      preallocated device buffer per operand, sized for the largest chunk
      (the caching allocator never hands back memory a copy or kernel on
      another stream still reads).  Chunk buffers are built straight into
      the pinned host window, copied on a side stream (``non_blocking``),
      and the kernel waits on the copy's event.
    * Before a window is reused, the host waits on the event of the kernel
      that last read it: the only host syncs of the loop, one per window
      reuse.  So at most ``stage_depth + 1`` chunks are resident on either
      side (``staging["max_resident"]``), while the host builds chunk
      ``i + stage_depth`` as the card runs chunk ``i``.
    * On the CPU (``device="cpu"``) the same code runs with plain copies.

    **Host residency.**  Chunk buffers are built lazily per staged window
    from the source, never as a second full copy of the matrix.
    ``own_data=True`` opts into the eager pre-pin (each chunk built once,
    into pinned memory on a card) and in exchange drops the source: only one
    host copy survives construction.

    **Formats and staging.**  With an ELL engine, chunks are row ranges
    staged as per-chunk-width ELL tiles (width padded to the engine's
    ``block_w``, 8; rows to a multiple of 8), run by ``spmv_ell``; with
    ``staging="bf16" | "fp8"`` their values travel quantized with per-row-
    block scales and their columns delta-encoded (``kernels/
    spmv_ell_packed.py``), and ``spmv_ell_packed`` decodes them in
    registers.  ``"auto"`` packs when the storage dtype is already narrow.
    Without an ELL engine, COO slices of ``chunk_nnz`` triplets stream
    (plain staging only: packed modes demote to ``"f32"``), summed per row
    by the ordered segmented sum and added into ``y``.  Counters accumulate
    in ``self.staging`` (``staging_stats()`` adds bandwidth and compression).

    **Faults.**  Staging chunk ``j`` first consults the fault harness
    (``check_chunk_io``).  A stream that raises drains the copy stream and
    frees every window before the error leaves, so no later stream (nor the
    allocator, once the operator is dropped) meets a copy still in flight.

    **Sharded chunks.**  With a ``mesh`` (a 1-D ``DeviceMesh`` with the
    dimension ``axis``; ``core/distributed.py``), every rank runs the
    chunked Lanczos on the replicated vector, and an ELL chunk's padded
    rows (a multiple of 8 G) split into G equal shares: each rank builds,
    stages and multiplies only its share, plain or packed, into a local
    accumulator of its shares of every chunk, and one all-gather per
    matvec reassembles ``y``.  A row's product is the one the unsharded
    operator computes, bit for bit.  COO chunks stream whole on every rank,
    as in the reference.
    """

    STAGING_MODES = ("f32", "bf16", "fp8", "auto")

    def __init__(
        self,
        csr,
        chunk_nnz: int = 1 << 20,
        dtype=torch.float32,
        engine: Optional[SpmvEngine] = None,
        stage_depth: int = 1,
        own_data: bool = False,
        staging: str = "f32",
        device=None,
        mesh=None,
        axis: str = "data",
    ):
        from ..kernels.spmv_ell_packed import PACKED_VALUE_DTYPES

        self.n = csr.n
        self._dtype = dtype
        self.engine = engine
        self.device = torch.device(device if device is not None else
                                   (engine.device if engine is not None else "cuda"))
        self.stage_depth = max(0, int(stage_depth))
        self.spmv_format = engine.format if engine is not None else "coo"
        if self.spmv_format in ("bsr", "hybrid"):
            raise ValueError(
                "ChunkedOperator stages chunks as COO or ELL; per-chunk "
                f"{self.spmv_format.upper()} is not supported (pick format='ell' or 'coo')"
            )
        if staging not in self.STAGING_MODES:
            raise ValueError(
                f"unknown staging mode {staging!r}; expected one of {self.STAGING_MODES}"
            )
        if staging == "auto":
            # Pack when the storage dtype is already narrow: the quantization
            # the policy accepted is the quantization the staging ships.
            itemsize = torch.empty((), dtype=dtype).element_size()
            staging = "bf16" if itemsize == 2 else ("fp8" if itemsize == 1 else "f32")
        if staging != "f32" and self.spmv_format != "ell":
            staging = "f32"  # packed staging is an ELL-kernel path
        self.staging_mode = staging
        self._packed_dtype = PACKED_VALUE_DTYPES.get(staging)
        self._comm = None  # set when ELL chunks are row-sharded over a mesh
        if mesh is not None and self.spmv_format == "ell":
            from .distributed import ShardComm  # lazy: distributed imports this module

            self._comm = ShardComm(mesh, axis)
        self.disk_backed = isinstance(csr, DiskCSR)
        self.source_path = csr.path if self.disk_backed else None
        self.staging = {
            "conversions": 0,
            "transfers": 0,
            "max_resident": 0,
            "bytes_staged": 0,
            "bytes_plain": 0,
            "stage_s": 0.0,
            "mode": self.staging_mode,
        }
        self._csr = csr
        self._row_nnz = np.asarray(csr.row_nnz())  # O(n), not O(nnz)
        if self.spmv_format == "ell":
            self._init_ell_meta(csr, chunk_nnz, engine)
        else:
            self._init_coo_meta(csr, chunk_nnz)
        self._built = np.zeros(self.num_chunks, dtype=bool)
        self._windows = None
        self._copy_stream = None
        self._pinned = None
        # Chunk-cursor bindings (``set_step_hook`` / ``set_resume``): one
        # streamed matvec per step can hand out or restore its cursor.
        self._step_hook = None
        self._resume = None
        if own_data and not self.disk_backed:
            self._pinned = [self._build_chunk(j, None) for j in range(self.num_chunks)]
            self._csr = None
            self._row_nnz = None

    # ------------------------------ chunk planning ------------------------------

    def _init_coo_meta(self, csr, chunk_nnz: int):
        nnz = csr.nnz
        self._coo_chunk_nnz = int(chunk_nnz)
        self._coo_bounds = [
            (lo, min(lo + chunk_nnz, nnz)) for lo in range(0, max(nnz, 1), chunk_nnz)
        ]
        indptr = csr.indptr
        # Rows overlapping each [lo, hi): a row may span two chunks.
        self._coo_rows = [
            (
                int(np.searchsorted(indptr, lo, side="right")) - 1,
                int(np.searchsorted(indptr, hi, side="left")),
            )
            for lo, hi in self._coo_bounds
        ]
        self.num_chunks = len(self._coo_bounds)
        item = torch.empty((), dtype=self._dtype).element_size()
        self._sizes = [4 * chunk_nnz, 4 * chunk_nnz, item * chunk_nnz]  # row, col, val

    def _init_ell_meta(self, csr, chunk_nnz: int, engine: SpmvEngine):
        bounds = chunk_row_bounds(csr.indptr, csr.n, chunk_nnz)
        bw, br = engine.tiles.block_w, engine.tiles.block_r
        g = self._comm.size if self._comm is not None else 1
        self._bounds, self._widths, self._rows_pads, self._r0s = [], [], [], []
        n_out_pad = 0
        self.padded_slots = 0
        for r0, r1 in bounds:
            local_nnz = self._row_nnz[r0:r1]
            # Per-chunk width: a hub row pays for its own chunk only.
            width = int(max(1, local_nnz.max() if local_nnz.size else 1))
            width = -(-width // bw) * bw
            # Sharded, each rank's share is a whole number of row tiles
            # (and of the packed chunks' 8-row scale blocks).
            rows_pad = chunk_rows_pad(r1 - r0, br * g)
            self._bounds.append((r0, r1))
            self._widths.append(width)
            self._rows_pads.append(rows_pad)
            self._r0s.append(r0)
            n_out_pad = max(n_out_pad, r0 + rows_pad)
            self.padded_slots += rows_pad * width
        self.num_chunks = len(self._bounds)
        self._n_out_pad = n_out_pad
        self._shares = [rp // g for rp in self._rows_pads]  # rows this process stages
        self._share_offs = np.concatenate([[0], np.cumsum(self._shares)]).astype(np.int64)
        self._gather_idx = None
        slots = max(rp * w for rp, w in zip(self._shares, self._widths))
        rows = max(self._shares)
        if self._packed_dtype is None:
            item = torch.empty((), dtype=self._dtype).element_size()
            self._sizes = [item * slots, 4 * slots]  # val, col
        else:
            vitem = torch.empty((), dtype=self._packed_dtype).element_size()
            # val, scale, base, dcol (int32 at most)
            self._sizes = [vitem * slots, 4 * rows, 4 * rows, 4 * slots]

    # ------------------------------ chunk building ------------------------------

    def _build_chunk(self, j: int, bufs):
        """Build chunk ``j``'s host staging buffers from the source CSR or
        mapping, into ``bufs`` (a window's host buffers) or, with ``None``,
        into buffers of its own (the ``own_data`` pre-pin).  Returns the
        operand tensors in kernel order."""
        if bufs is None:
            pinned = self.device.type == "cuda"
            bufs = [torch.empty(nb, dtype=torch.uint8, pin_memory=pinned) for nb in self._sizes]
        if self.spmv_format == "ell":
            arrs = self._build_ell_chunk(j, bufs)
        else:
            arrs = self._build_coo_chunk(j, bufs)
        if not self._built[j]:
            # Once per chunk per operator: rebuilding a window on a later
            # sweep is staging traffic, not a new layout conversion.
            self._built[j] = True
            self.staging["conversions"] += 1
            count_conversions(1)
        return arrs

    def _fill_values(self, out: torch.Tensor, flat: np.ndarray, vals: np.ndarray) -> None:
        """Zero ``out`` and scatter f64 ``vals`` into its flat positions,
        rounding once to ``out``'s dtype (nearest even, as the reference's
        casts)."""
        view = _numpy_view(out)
        if view is not None:
            v = view.reshape(-1)
            v[:] = 0
            v[flat] = vals
            return
        tmp = np.zeros(out.numel(), dtype=np.float64)
        tmp[flat] = vals
        out.view(-1).copy_(torch.from_numpy(tmp))

    def _build_coo_chunk(self, j: int, bufs):
        lo, hi = self._coo_bounds[j]
        r_lo, r_hi = self._coo_rows[j]
        indptr = self._csr.indptr
        cnt, size = hi - lo, self._coo_chunk_nnz
        counts = np.minimum(indptr[r_lo + 1 : r_hi + 1], hi) - np.maximum(indptr[r_lo:r_hi], lo)
        row = _view(bufs[0], torch.int32, (size,))
        col = _view(bufs[1], torch.int32, (size,))
        val = _view(bufs[2], self._dtype, (size,))
        r, c = row.numpy(), col.numpy()
        r[:cnt] = np.repeat(np.arange(r_lo, r_hi, dtype=np.int32), counts)
        r[cnt:] = 0
        c[:cnt] = self._csr.indices[lo:hi]
        c[cnt:] = 0
        self._fill_values(val, np.arange(cnt), self._csr.values(lo, hi))
        return [row, col, val]

    def _share_rows(self, j: int) -> Tuple[int, int]:
        """Rows ``[a, b)`` of chunk ``j`` that this process stages: the whole
        chunk, or this rank's share of its padded rows (empty past the
        chunk's last row)."""
        r0, r1 = self._bounds[j]
        if self._comm is None:
            return r0, r1
        a = min(r1, r0 + self._comm.rank * self._shares[j])
        return a, min(r1, a + self._shares[j])

    def _build_ell_chunk(self, j: int, bufs):
        from ..kernels.spmv_ell_packed import pack_ell_chunk

        r0, r1 = self._share_rows(j)
        indptr = self._csr.indptr
        lo, hi = int(indptr[r0]), int(indptr[r1])
        width, rows_pad = self._widths[j], self._shares[j]
        # Flat ELL position of every stored entry: row * width + position.
        starts = np.arange(r1 - r0, dtype=np.int64) * width - (np.asarray(indptr[r0:r1]) - lo)
        flat = np.repeat(starts, self._row_nnz[r0:r1]) + np.arange(hi - lo)
        vals = self._csr.values(lo, hi)
        shape = (rows_pad, width)
        if self._packed_dtype is None:
            val = _view(bufs[0], self._dtype, shape)
            col = _view(bufs[1], torch.int32, shape)
            c = col.numpy().reshape(-1)
            c[:] = 0
            c[flat] = self._csr.indices[lo:hi]
            self._fill_values(val, flat, vals)
            return [val, col]
        col_np = np.zeros(shape, dtype=np.int32)
        col_np.reshape(-1)[flat] = self._csr.indices[lo:hi]
        val_np = np.zeros(shape, dtype=np.float32)
        val_np.reshape(-1)[flat] = vals  # rounded to f32 first, as the reference
        packed = pack_ell_chunk(val_np, col_np, self.staging_mode)
        out = []
        for buf, t in zip(bufs, packed):
            v = _view(buf, t.dtype, tuple(t.shape))
            v.copy_(t)
            out.append(v)
        return out

    def _plain_chunk_bytes(self, j: int) -> int:
        """Bytes plain staging ships for chunk ``j`` (the numerator of the
        compression ratio)."""
        item = torch.empty((), dtype=self._dtype).element_size()
        if self.spmv_format == "ell":
            return self._shares[j] * self._widths[j] * (item + 4)  # val + int32 col
        return self._coo_chunk_nnz * (8 + item)

    # ------------------------------- staging loop -------------------------------

    def _row_index(self) -> torch.Tensor:
        """``(n,)`` position of every row in the all-gathered ``(G * L,)``
        accumulators of a sharded operator (rank-major, then each rank's
        shares in chunk order); built once."""
        if self._gather_idx is None:
            length = int(self._share_offs[-1])
            idx = np.empty(self.n, dtype=np.int64)
            for j, (r0, r1) in enumerate(self._bounds):
                q = np.arange(r1 - r0, dtype=np.int64)
                s = self._shares[j]
                idx[r0:r1] = (q // s) * length + self._share_offs[j] + q % s
            self._gather_idx = torch.from_numpy(idx).to(self.device)
        return self._gather_idx

    def _ensure_windows(self) -> None:
        if self._windows is None:
            self._windows = [_Window(self._sizes, self.device) for _ in range(self.stage_depth + 1)]
            if self.device.type == "cuda":
                self._copy_stream = torch.cuda.Stream(device=self.device)

    def _release(self, win: _Window) -> None:
        """Free a window for its next chunk: wait (on the host) for the
        kernel that last read it.  That kernel ran after the window's copy,
        so the pinned host buffer is free too."""
        if win.pending:
            win.done.synchronize()
            win.pending = False
        win.chunk = None

    def _stream(self, consume, start: int = 0) -> None:
        """Stream chunks ``start..`` through ``consume(i, operands)``, staging
        up to ``stage_depth`` chunks ahead of the one computing."""
        self._ensure_windows()
        wins, depth = self._windows, self.stage_depth
        cuda = self.device.type == "cuda"
        staged = {}

        def stage(j):
            if j >= self.num_chunks or j in staged:
                return
            with host_scope():  # the chunk build is host work (NumPy in the reference)
                _stage(j)

        def _stage(j):
            _faults.check_chunk_io(j)
            t0 = time.perf_counter()
            win = wins[j % len(wins)]
            self._release(win)
            src = self._pinned[j] if self._pinned is not None else self._build_chunk(j, win.host)
            dev = [_view(d, h.dtype, tuple(h.shape)) for d, h in zip(win.dev, src)]
            if cuda:
                with torch.cuda.stream(self._copy_stream):
                    for d, h in zip(dev, src):
                        d.copy_(h, non_blocking=True)
                    win.copied.record(self._copy_stream)
            else:
                for d, h in zip(dev, src):
                    d.copy_(h)
            win.chunk = j
            staged[j] = dev
            self.staging["stage_s"] += time.perf_counter() - t0
            self.staging["transfers"] += 1
            self.staging["bytes_staged"] += sum(h.numel() * h.element_size() for h in src)
            self.staging["bytes_plain"] += self._plain_chunk_bytes(j)
            resident = sum(w.chunk is not None for w in wins)
            self.staging["max_resident"] = max(self.staging["max_resident"], resident)

        try:
            for j in range(start, min(start + depth, self.num_chunks)):
                stage(j)
            for i in range(start, self.num_chunks):
                stage(i)
                win = wins[i % len(wins)]
                if cuda:
                    torch.cuda.current_stream(self.device).wait_event(win.copied)
                consume(i, staged.pop(i))
                if cuda:
                    win.done.record(torch.cuda.current_stream(self.device))
                    win.pending = True
                if depth:
                    stage(i + depth)  # into the window of chunk i - 1, while chunk i computes
        except BaseException:
            self._abort_stream()
            raise

    def _abort_stream(self) -> None:
        """After a failed stream: wait for every copy and kernel it queued,
        then mark every window free.  A staged chunk that no kernel consumed
        has no ``done`` event, so nothing else would order a later write of
        its pinned buffer after its copy."""
        if self.device.type == "cuda":
            self._copy_stream.synchronize()
            torch.cuda.current_stream(self.device).synchronize()
        for win in self._windows or ():
            win.chunk = None
            win.pending = False

    def resident_bytes(self) -> int:
        """Bytes this operator holds: its staging windows (host and device
        buffers, once allocated), with ``own_data`` its pinned chunks, and
        a sharded operator's row index."""
        ts = [t for w in self._windows or () for t in (*w.host, *w.dev)]
        ts += [t for chunk in self._pinned or () for t in chunk]
        ts += [t for t in (getattr(self, "_gather_idx", None),) if t is not None]
        return sum(t.numel() * t.element_size() for t in ts)

    def staging_stats(self, since: Optional[dict] = None) -> dict:
        """Staging counters plus bandwidth and compression (what
        ``partition["spmv"]["staging"]`` reports).  With ``since`` (an
        earlier copy of ``self.staging``), the per-call costs (transfers,
        bytes, seconds) are the differences; ``conversions`` and
        ``max_resident`` stay the plan's own."""
        out = dict(self.staging)
        for key in ("transfers", "bytes_staged", "bytes_plain", "stage_s"):
            out[key] -= (since or {}).get(key, 0)
        staged = out["bytes_staged"]
        out["effective_bandwidth_gbps"] = (
            out["bytes_plain"] / out["stage_s"] / 1e9 if out["stage_s"] > 0 else 0.0
        )
        out["compression_ratio"] = out["bytes_plain"] / staged if staged else 1.0
        return out

    # --------------------------------- matvec -----------------------------------

    def set_step_hook(self, hook) -> None:
        """Install ``hook(chunk_index, partial_accumulator)`` to observe the
        running accumulator of the next matvecs after each chunk (the
        chunk-cursor checkpoint writer)."""
        self._step_hook = hook

    def set_resume(self, start_chunk: int, partial_y) -> None:
        """Arm the next matvec to skip chunks ``< start_chunk`` and seed its
        accumulator from ``partial_y``; consumed by exactly one matvec."""
        self._resume = (int(start_chunk), partial_y)

    def matvec(self, x, accum_dtype=None, *, start_chunk: int = 0, partial_y=None,
               on_chunk=None):
        """Streamed SpMV.  ``start_chunk`` / ``partial_y`` resume a partial
        product (chunks run in a fixed order, so a resume is bit-identical to
        an uninterrupted sweep); ``on_chunk(i, y)`` gets a copy of the
        running accumulator after each chunk."""
        if start_chunk == 0 and partial_y is None and self._resume is not None:
            start_chunk, partial_y = self._resume
            self._resume = None
        if on_chunk is None:
            on_chunk = self._step_hook
        acc = accum_dtype or self._dtype
        if self._comm is not None:
            length = int(self._share_offs[-1])  # this rank's shares of every chunk
        else:
            length = self._n_out_pad if self.spmv_format == "ell" else self.n
        if partial_y is not None:
            y = torch.as_tensor(partial_y).to(device=self.device, dtype=acc, copy=True)
        else:
            y = torch.zeros(length, dtype=acc, device=self.device)
        if self.spmv_format == "ell":
            eng = self.engine
            if eng.accum_dtype != acc:
                eng = dataclasses.replace(eng, accum_dtype=acc)
            packed = self._packed_dtype is not None

            offs = self._share_offs if self._comm is not None else self._r0s

            def consume(i, arrs):
                yk = eng.packed_ell_matvec(*arrs, x) if packed else eng.ell_matvec(*arrs, x)
                r0 = int(offs[i])
                y[r0 : r0 + yk.shape[0]] += yk
                if on_chunk is not None:
                    on_chunk(i, y.clone())

            self._stream(consume, start=start_chunk)
            if self._comm is not None:
                return self._comm.all_gather(y).index_select(0, self._row_index())
            return y[: self.n]

        def consume(i, arrs):
            row, col, val = arrs
            lo, hi = self._coo_bounds[i]
            r_lo, r_hi = self._coo_rows[i]
            cnt = hi - lo
            prod = val[:cnt].to(acc) * x.index_select(0, col[:cnt]).to(acc)
            # Row offsets of this slice, found on the device from its sorted
            # rows; the ordered segmented sum, not index_add_'s atomics.
            bounds = torch.arange(r_lo, r_hi + 1, dtype=torch.int32, device=self.device)
            offsets = torch.searchsorted(row[:cnt], bounds)
            y[r_lo:r_hi] += segment_sum(prod, offsets)
            if on_chunk is not None:
                on_chunk(i, y.clone())

        self._stream(consume, start=start_chunk)
        return y
