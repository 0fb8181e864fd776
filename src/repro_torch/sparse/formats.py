"""Sparse matrix containers of the PyTorch port.

Host-side construction is NumPy (:class:`CSR`); the device containers are
dataclasses of tensors on an explicit ``device``:

* ``DeviceCOO``    — (row, col, val) triplets plus the CSR row offsets; SpMV is
  a deterministic segmented sum (the reference's ``segment_sum`` path).
* ``DeviceELL``    — uniform-width ELLPACK ``(rows_pad, width)``, the layout
  of the ``spmv_ell`` / ``spmv_ell_alpha`` kernels.
* ``DeviceHybrid`` — quantile-capped ELL plus a COO overflow tail.
* ``DeviceBSR``    — blocked ELL ``(n_block_rows, slots, BS, BS)``, the layout
  of the ``spmv_bsr`` kernel.

Padding: rows round up to ``row_tile`` and the ELL width to ``slot_tile``,
both 8 by default.  The reference pads the ELL width to 128 TPU lanes; on a
road network (max row 6) that stores 128 slots a row instead of 8, so the
port does not carry that constant over.  Padding slots hold val 0 / col 0
and contribute nothing.

:func:`from_reference` builds a container from a reference container's
arrays (as NumPy), so both packages can compute on identical data.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "CSR",
    "DeviceCOO",
    "DeviceELL",
    "DeviceBSR",
    "DeviceHybrid",
    "csr_from_coo",
    "to_device_coo",
    "to_device_ell",
    "to_device_bsr",
    "to_device_hybrid",
    "blocked_ell_from_triplets",
    "segment_sum",
    "from_reference",
    "conversion_count",
    "count_conversions",
]

# Process-wide census of host->device format conversions (one tick per
# converted layout), as in the reference.
_CONVERSIONS = {"count": 0}


def conversion_count() -> int:
    """Total format conversions performed by this process so far."""
    return _CONVERSIONS["count"]


def count_conversions(n: int = 1) -> None:
    _CONVERSIONS["count"] += int(n)


@dataclasses.dataclass
class CSR:
    """Host-side CSR (NumPy). Always square, symmetric matrices here."""

    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (nnz,) int32
    data: np.ndarray  # (nnz,) float64
    shape: Tuple[int, int]

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def values(self, lo: int, hi: int) -> np.ndarray:
        """Stored values ``[lo, hi)`` as float64 (as ``DiskCSR.values``)."""
        return np.asarray(self.data[lo:hi], dtype=np.float64)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix((self.data, self.indices, self.indptr), shape=self.shape)


def csr_from_coo(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n: int, sum_dups: bool = True
) -> CSR:
    """Build CSR from COO triplets (NumPy), summing duplicates."""
    import scipy.sparse as sp

    m = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    if sum_dups:
        m.sum_duplicates()
    m = m.tocsr()
    m.sort_indices()
    return CSR(
        indptr=m.indptr.astype(np.int64),
        indices=m.indices.astype(np.int32),
        data=m.data.astype(np.float64),
        shape=(n, n),
    )


def segment_sum(prod: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Sum ``prod[offsets[r]:offsets[r+1]]`` for every row r (empty rows -> 0);
    ``prod`` holds exactly ``offsets[-1]`` entries.

    ``torch.segment_reduce`` reduces each segment in a fixed order (one
    thread per segment, or CUB's segmented reduce, on CUDA): no float
    atomics, so the result is the same bits on every run — unlike
    ``index_add_``, whose CUDA atomics add in whatever order they land.
    The offsets were built by the converters, so the op's own validation
    (a device->host read) is skipped.
    """
    return torch.segment_reduce(prod, "sum", offsets=offsets, unsafe=True)


def _offsets(rows_sorted: np.ndarray, n_rows: int) -> np.ndarray:
    """CSR-style offsets of a row-sorted index array."""
    return np.searchsorted(rows_sorted, np.arange(n_rows + 1), side="left").astype(np.int64)


@dataclasses.dataclass
class DeviceCOO:
    """COO triplets; SpMV = segmented sum of val * x[col] by row."""

    row: torch.Tensor  # (nnz,) int32, sorted by row
    col: torch.Tensor  # (nnz,) int32
    val: torch.Tensor  # (nnz,) storage dtype
    offsets: torch.Tensor  # (n_rows + 1,) int64 row offsets into the triplets
    n_rows: int
    n_cols: int

    def matvec(self, x: torch.Tensor, accum_dtype=None) -> torch.Tensor:
        acc = accum_dtype or self.val.dtype
        prod = self.val.to(acc) * x.index_select(0, self.col).to(acc)
        return segment_sum(prod, self.offsets)


@dataclasses.dataclass
class DeviceELL:
    """Uniform-width ELLPACK, row-major ``(rows_pad, width)``, zero-padded."""

    val: torch.Tensor  # (rows_pad, width) storage dtype
    col: torch.Tensor  # (rows_pad, width) int32
    n_rows: int
    n_cols: int

    @property
    def width(self) -> int:
        return int(self.val.shape[1])


@dataclasses.dataclass
class DeviceHybrid:
    """Hub-row split: capped-width ELL + COO overflow tail.

    The tail triplets are in CSR row order; ``tail_offsets`` indexes the
    first ``tail_nnz`` of them by output row (the zero padding behind them
    is never read).
    """

    ell_val: torch.Tensor  # (rows_pad, width_cap) storage dtype
    ell_col: torch.Tensor  # (rows_pad, width_cap) int32
    tail_row: torch.Tensor  # (tail_pad,) int32
    tail_col: torch.Tensor  # (tail_pad,) int32
    tail_val: torch.Tensor  # (tail_pad,) storage dtype
    tail_offsets: torch.Tensor  # (n_rows + 1,) int64
    tail_nnz: int  # real tail entries (host int: slicing them needs no sync)
    n_rows: int
    n_cols: int

    @property
    def width(self) -> int:
        return int(self.ell_val.shape[1])


@dataclasses.dataclass
class DeviceBSR:
    """Blocked ELL: dense (BS, BS) blocks at sparse block coordinates, a
    uniform slot count per block-row, zero-padded (bcol 0 on padding)."""

    val: torch.Tensor  # (n_block_rows, slots, BS, BS) storage dtype
    bcol: torch.Tensor  # (n_block_rows, slots) int32
    n_rows: int
    n_cols: int


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    """Host array -> tensor of ``dtype`` on ``device`` (cast on the host, so
    the device holds only the storage-dtype copy; rounding is to nearest
    even, as in the reference's casts)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(device)


def _row_positions(csr: CSR) -> Tuple[np.ndarray, np.ndarray]:
    """(row index, position-within-row) of every stored nnz, in CSR order."""
    row_nnz = csr.row_nnz()
    rix = np.repeat(np.arange(csr.n, dtype=np.int64), row_nnz)
    pos = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], row_nnz)
    return rix, pos


def to_device_coo(csr: CSR, dtype=torch.float32, device="cpu") -> DeviceCOO:
    n = csr.n
    count_conversions()
    row = np.repeat(np.arange(n, dtype=np.int32), csr.row_nnz())
    return DeviceCOO(
        row=_tensor(row, torch.int32, device),
        col=_tensor(csr.indices, torch.int32, device),
        val=_tensor(np.asarray(csr.data, np.float64), dtype, device),
        offsets=_tensor(np.asarray(csr.indptr, np.int64), torch.int64, device),
        n_rows=n,
        n_cols=n,
    )


def to_device_ell(
    csr: CSR, dtype=torch.float32, row_tile: int = 8, slot_tile: int = 8, device="cpu"
) -> DeviceELL:
    """Convert CSR to uniform-width padded ELL (kernel layout)."""
    n = csr.n
    count_conversions()
    width = int(max(1, csr.row_nnz().max() if n else 1))
    width = -(-width // slot_tile) * slot_tile
    rows_pad = -(-n // row_tile) * row_tile
    val = np.zeros((rows_pad, width), dtype=np.float64)
    col = np.zeros((rows_pad, width), dtype=np.int32)
    rix, pos = _row_positions(csr)
    val[rix, pos] = csr.data
    col[rix, pos] = csr.indices
    return DeviceELL(
        val=_tensor(val, dtype, device), col=_tensor(col, torch.int32, device), n_rows=n, n_cols=n
    )


def to_device_hybrid(
    csr: CSR,
    dtype=torch.float32,
    width_cap: Optional[int] = None,
    quantile: Optional[float] = None,
    row_tile: int = 8,
    slot_tile: int = 8,
    tail_align: int = 8,
    device="cpu",
) -> DeviceHybrid:
    """Convert CSR to the hub-split hybrid layout (capped ELL + COO tail);
    the same split as the reference (``width_cap`` defaults to the
    ``quantile`` of the row lengths, aligned up to ``slot_tile``)."""
    from ..kernels.engine import hybrid_width_cap  # lazy: sparse sits below kernels

    n = csr.n
    count_conversions()
    row_nnz = csr.row_nnz()
    cap = hybrid_width_cap(row_nnz, quantile) if width_cap is None else int(width_cap)
    cap = max(1, min(cap, int(row_nnz.max()) if row_nnz.size else 1))
    width = -(-cap // slot_tile) * slot_tile
    rows_pad = -(-n // row_tile) * row_tile

    rix, pos = _row_positions(csr)
    keep = pos < width  # padded cap: the aligned slots might as well hold nnz
    val = np.zeros((rows_pad, width), dtype=np.float64)
    col = np.zeros((rows_pad, width), dtype=np.int32)
    val[rix[keep], pos[keep]] = csr.data[keep]
    col[rix[keep], pos[keep]] = csr.indices[keep]

    spill = ~keep
    tail_n = int(spill.sum())
    tail_pad = -(-max(tail_n, 1) // tail_align) * tail_align
    trow = np.zeros((tail_pad,), dtype=np.int32)
    tcol = np.zeros((tail_pad,), dtype=np.int32)
    tval = np.zeros((tail_pad,), dtype=np.float64)
    trow[:tail_n] = rix[spill]
    tcol[:tail_n] = csr.indices[spill]
    tval[:tail_n] = csr.data[spill]
    return DeviceHybrid(
        ell_val=_tensor(val, dtype, device),
        ell_col=_tensor(col, torch.int32, device),
        tail_row=_tensor(trow, torch.int32, device),
        tail_col=_tensor(tcol, torch.int32, device),
        tail_val=_tensor(tval, dtype, device),
        tail_offsets=_tensor(_offsets(trow[:tail_n], n), torch.int64, device),
        tail_nnz=tail_n,
        n_rows=n,
        n_cols=n,
    )


def blocked_ell_from_triplets(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_cols: int,
    block_size: int = 8,
    slots: Optional[int] = None,
    dtype=torch.float32,
    device="cpu",
) -> DeviceBSR:
    """Build a blocked-ELL layout from COO triplets (host, vectorized)."""
    bs = block_size
    nbr = max(1, -(-n_rows // bs))
    nbc = max(1, -(-n_cols // bs))
    br = rows.astype(np.int64) // bs
    bc = cols.astype(np.int64) // bs
    keys = np.unique(br * nbc + bc)  # sorted: groups contiguous per block-row
    kbr = keys // nbc
    counts = np.bincount(kbr, minlength=nbr)
    needed = int(counts.max()) if keys.size else 1
    if slots is None:
        slots = max(1, needed)
    elif slots < needed:
        raise ValueError(f"slots={slots} < required {needed}")

    val = np.zeros((nbr, slots, bs, bs), dtype=np.float64)
    bcol = np.zeros((nbr, slots), dtype=np.int32)
    if keys.size:
        # Slot index of each stored block = its rank within its block-row.
        first = np.searchsorted(kbr, np.arange(nbr), side="left")
        slot_of_key = np.arange(keys.size) - first[kbr]
        bcol[kbr, slot_of_key] = (keys % nbc).astype(np.int32)
        kidx = np.searchsorted(keys, br * nbc + bc)
        val[br, slot_of_key[kidx], rows % bs, cols % bs] = vals
    return DeviceBSR(
        val=_tensor(val, dtype, device),
        bcol=_tensor(bcol, torch.int32, device),
        n_rows=n_rows,
        n_cols=n_cols,
    )


def to_device_bsr(csr: CSR, block_size: int = 8, dtype=torch.float32, device="cpu") -> DeviceBSR:
    """Convert CSR to the blocked-ELL/BSR kernel layout."""
    count_conversions()
    rows = np.repeat(np.arange(csr.n, dtype=np.int64), csr.row_nnz())
    return blocked_ell_from_triplets(
        rows, csr.indices, csr.data, csr.n, csr.n, block_size=block_size, dtype=dtype,
        device=device,
    )


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """NumPy -> tensor (a copy), including bfloat16 arrays (whose NumPy dtype
    comes from an extension package): their bits travel as int16."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_reference(container_arrays: Mapping, device="cpu"):
    """Port container from a reference container's arrays (as NumPy).

    ``container_arrays`` maps the reference dataclass's field names to
    arrays (``val``/``col`` for ELL, ``ell_*``/``tail_*`` for hybrid,
    ``val``/``bcol`` for BSR, ``row``/``col``/``val`` for COO); ``n_rows`` /
    ``n_cols`` may ride along and default to the layout's own extent.  The
    arrays are taken as they are (dtype, padding), so both packages compute
    on identical data.
    """
    a = dict(container_arrays)
    t = {k: _from_numpy(np.asarray(v), device) for k, v in a.items() if k not in ("n_rows", "n_cols")}
    if "ell_val" in a:
        n = int(a.get("n_rows", t["ell_val"].shape[0]))
        trow = np.asarray(a["tail_row"])
        # Real tail entries come first (row-sorted); the zero padding follows.
        nonzero = np.flatnonzero(np.asarray(a["tail_val"]))
        tail_n = int(nonzero[-1]) + 1 if nonzero.size else 0
        return DeviceHybrid(
            ell_val=t["ell_val"],
            ell_col=t["ell_col"],
            tail_row=t["tail_row"],
            tail_col=t["tail_col"],
            tail_val=t["tail_val"],
            tail_offsets=_tensor(_offsets(trow[:tail_n], n), torch.int64, device),
            tail_nnz=tail_n,
            n_rows=n,
            n_cols=int(a.get("n_cols", n)),
        )
    if "bcol" in a:
        nbr, _, bs, _ = t["val"].shape
        n = int(a.get("n_rows", nbr * bs))
        return DeviceBSR(val=t["val"], bcol=t["bcol"], n_rows=n, n_cols=int(a.get("n_cols", n)))
    if "row" in a:
        n = int(a["n_rows"])
        row = np.asarray(a["row"])
        return DeviceCOO(
            row=t["row"],
            col=t["col"],
            val=t["val"],
            offsets=_tensor(_offsets(row, n), torch.int64, device),
            n_rows=n,
            n_cols=int(a.get("n_cols", n)),
        )
    n = int(a.get("n_rows", t["val"].shape[0]))
    return DeviceELL(val=t["val"], col=t["col"], n_rows=n, n_cols=int(a.get("n_cols", n)))
