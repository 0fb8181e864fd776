"""Planar mesh of degree 3: a brick-wall (honeycomb) lattice.

Nodes sit on a grid of ``cols`` columns, filled row by row to ``n``
nodes (the last row may be partial).  Each node joins its left and right
neighbours, and node ``(r, c)`` joins ``(r + 1, c)`` where ``r + c`` is
even, so every interior node has exactly 3 neighbours, as in the dual of
a triangle mesh.  Rows are numbered in lattice order.  The lattice is
fixed; the seed permutes nothing and the benchmark's start vectors carry
the randomness, so every seed solves the same matrix.
"""

from __future__ import annotations

import torch

from eigbench.reference.graphs import Graph, csr_from_edges


def make(cfg: dict, seed: int, device) -> Graph:
    C, n = int(cfg["lattice_cols"]), int(cfg["rows"])
    idx = torch.arange(n, device=device)
    c = idx % C
    right = (c < C - 1) & (idx + 1 < n)
    down = ((torch.div(idx, C, rounding_mode="floor") + c) % 2 == 0) & (idx + C < n)
    src = torch.cat([idx[right], idx[down]])
    dst = torch.cat([idx[right] + 1, idx[down] + C])
    return csr_from_edges(src, dst, n)


def nnz(cfg: dict) -> int:
    """The nonzeros :func:`make` gives, counted row by row."""
    C, n = int(cfg["lattice_cols"]), int(cfg["rows"])
    full, rem = divmod(n, C)
    right = full * (C - 1) + max(rem - 1, 0)
    down = 0
    for r in range(full):  # row r joins row r + 1 where that node exists
        width = C if r < full - 1 else rem
        down += (width + 1) // 2 if r % 2 == 0 else width // 2
    return 2 * (right + down)
