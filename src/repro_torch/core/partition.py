"""nnz-balanced row partitioning (paper §III-A).

The paper partitions the matrix by *balancing the number of non-zeros per
device* (not rows), partitions every vector the same way, and replicates
only the SpMV input vector.  As in the reference (``repro/core/partition.py``):

  1. split rows so each shard holds ~nnz/G non-zeros (a greedy prefix split
     of the CSR row pointer, the paper's scheme);
  2. pad each shard to the largest shard's row count ``n_pad`` (rounded up
     to ``row_align``, the row tile of the port's layouts);
  3. remap columns to the *padded-global* coordinates
     ``g = shard * n_pad + local_row`` so the all-gathered vector is indexed
     directly.

The port runs SPMD (``core/distributed.py``): a rank holds only its own
shard's arrays, with the global ``splits`` and ``n_pad``.  A
:class:`PartitionedMatrix` therefore names the shards it holds (all of them
when it is built for inspection, as the reference's stacked one).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..sparse.formats import CSR, padded_col_map

__all__ = ["PartitionedMatrix", "nnz_balanced_splits", "partition_matrix"]


def nnz_balanced_splits(indptr: np.ndarray, num_shards: int) -> np.ndarray:
    """Row split points so each shard gets ~equal nnz. Returns (G+1,) rows."""
    nnz = int(indptr[-1])
    targets = (np.arange(1, num_shards) * nnz) / num_shards
    cuts = np.searchsorted(indptr, targets, side="left")
    splits = np.concatenate([[0], cuts, [len(indptr) - 1]]).astype(np.int64)
    # Monotone non-decreasing (degenerate cases: empty shards allowed).
    return np.maximum.accumulate(splits)


@dataclasses.dataclass
class PartitionedMatrix:
    """Row shards of a square sparse matrix in padded-COO form.

    Tensors stack the held shards on a leading axis ``(S, nnz_pad)``:
      row: int32 local row within the shard (CSR order)
      col: int32 *padded-global* column (see the module doc)
      val: storage dtype, 0 on padding
    Padding entries (row 0, col 0, val 0) follow each shard's ``nnz`` real
    ones.  ``shards`` names the held shards (``S`` of the ``num_shards``).
    """

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    n: int  # logical size
    n_pad: int  # padded rows per shard
    num_shards: int  # G
    shards: Tuple[int, ...]
    nnz: Tuple[int, ...]
    _splits: np.ndarray = dataclasses.field(repr=False, default=None)

    def splits(self) -> np.ndarray:
        return self._splits

    def rows_of(self, s: int) -> Tuple[int, int]:
        """Global row range ``[lo, hi)`` of shard ``s``."""
        return int(self._splits[s]), int(self._splits[s + 1])

    def pad_vector(self, x: torch.Tensor) -> torch.Tensor:
        """(n,) logical -> (G, n_pad) padded-shard layout."""
        xp = x.new_zeros((self.num_shards, self.n_pad))
        for s in range(self.num_shards):
            lo, hi = self.rows_of(s)
            xp[s, : hi - lo] = x[lo:hi]
        return xp

    def unpad_vector(self, xp: torch.Tensor) -> torch.Tensor:
        """(G, n_pad, ...) padded -> (n, ...) logical."""
        parts = []
        for s in range(self.num_shards):
            lo, hi = self.rows_of(s)
            parts.append(xp[s, : hi - lo])
        return torch.cat(parts)


def partition_matrix(
    csr: CSR,
    num_shards: int,
    dtype=torch.float32,
    nnz_align: int = 8,
    row_align: int = 1,
    with_coo: bool = True,
    splits: Optional[np.ndarray] = None,
    shards: Optional[Sequence[int]] = None,
    device="cpu",
) -> PartitionedMatrix:
    """Build the paper's nnz-balanced partition as padded COO shards.

    ``row_align`` rounds ``n_pad`` up to a multiple (the ELL row tile or the
    BSR block edge: local block rows must line up with the padded-global
    stride).  ``with_coo=False`` skips the COO triplets when the SpMV runs a
    kernel format (``sparse.formats.shard_to_*``).  ``splits`` takes
    precomputed split rows; ``shards`` the shards to materialize (default
    all).  ``nnz_align`` pads each shard's triplets to a common multiple
    (the reference's 128 is a TPU lane count; the port's layouts pad to 8).
    """
    n = csr.n
    if splits is None:
        splits = nnz_balanced_splits(csr.indptr, num_shards)
    ids = tuple(range(num_shards)) if shards is None else tuple(int(s) for s in shards)
    n_pad = int(max(1, (splits[1:] - splits[:-1]).max()))
    n_pad = -(-n_pad // row_align) * row_align
    local_nnz = tuple(
        int(csr.indptr[splits[s + 1]] - csr.indptr[splits[s]]) for s in range(num_shards))
    if with_coo:
        nnz_pad = int(max(nnz_align, -(-max(local_nnz) // nnz_align) * nnz_align))
        col_map = padded_col_map(splits, n_pad, n).astype(np.int32)
        rows = np.zeros((len(ids), nnz_pad), dtype=np.int32)
        cols = np.zeros((len(ids), nnz_pad), dtype=np.int32)
        vals = np.zeros((len(ids), nnz_pad), dtype=np.float64)
        for i, s in enumerate(ids):
            r0, r1 = int(splits[s]), int(splits[s + 1])
            lo, hi = int(csr.indptr[r0]), int(csr.indptr[r1])
            local = np.repeat(np.arange(r1 - r0, dtype=np.int32), np.diff(csr.indptr[r0 : r1 + 1]))
            rows[i, : hi - lo] = local  # padding: row 0, col 0, val 0
            cols[i, : hi - lo] = col_map[csr.indices[lo:hi]]
            vals[i, : hi - lo] = csr.data[lo:hi]
    else:
        rows = np.zeros((len(ids), 0), dtype=np.int32)
        cols = np.zeros((len(ids), 0), dtype=np.int32)
        vals = np.zeros((len(ids), 0), dtype=np.float64)
    return PartitionedMatrix(
        row=torch.from_numpy(rows).to(device),
        col=torch.from_numpy(cols).to(device),
        val=torch.from_numpy(vals).to(dtype).to(device),
        n=n,
        n_pad=n_pad,
        num_shards=num_shards,
        shards=ids,
        nnz=tuple(local_nnz[s] for s in ids),
        _splits=np.asarray(splits),
    )
