"""CSR assembly shared by the benchmark's graph generators.

A generator yields the undirected edges of a graph (each once, no self
loops, no repeats) on a device; :func:`csr_from_edges` makes the symmetric
CSR of its adjacency with the values of the ``"normalized"`` rule of
``repro.sparse.generate`` (D^-1/2 A D^-1/2, degrees from the row counts),
copied here so that the yardstick does not move with the program.
Everything is vectorised PyTorch, so a graph of tens of millions of
edges is made on the card in well under a second.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Graph(NamedTuple):
    """Symmetric CSR on one device: int64 row pointers, int32 columns,
    float64 values."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    n: int

    @property
    def nnz(self) -> int:
        return int(self.indices.numel())


def csr_from_edges(src: torch.Tensor, dst: torch.Tensor, n: int) -> Graph:
    """The symmetric normalized adjacency of the undirected edges
    ``(src[i], dst[i])``: both directions of every edge, rows sorted,
    columns sorted within a row."""
    key = torch.cat([src * n + dst, dst * n + src])
    key = torch.sort(key).values
    rows = torch.div(key, n, rounding_mode="floor")
    cols = key - rows * n
    del key
    counts = torch.bincount(rows, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    dinv = counts.clamp(min=1).to(torch.float64).rsqrt()
    data = dinv[rows] * dinv[cols]
    return Graph(indptr, cols.to(torch.int32), data, n)
