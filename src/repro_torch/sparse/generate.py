"""Synthetic sparse-matrix suite mirroring the paper's Table I.

The paper evaluates on 15 SuiteSparse graph matrices (web crawls, road
networks, a Kronecker graph and a uniform-random graph).  The collection is
not shipped offline, so we generate *structure-matched* synthetic replicas at
CPU-tractable scale: matched family (power-law web graph / near-planar road
lattice / R-MAT Kronecker / Erdos-Renyi uniform), symmetric, zero-free
diagonal optional.  Matrix IDs reuse the paper's names with an ``@n`` scale
suffix.

Value models:
  * ``unit``        — adjacency (all ones), like the paper's graphs;
  * ``normalized``  — symmetric normalized adjacency D^-1/2 A D^-1/2, the
                       operator spectral clustering/PageRank-style methods use
                       (eigenvalues in [-1, 1] — convenient for accuracy
                       studies);
  * ``uniform``     — U(0,1) weights.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

from .formats import CSR, csr_from_coo

__all__ = ["generate", "SUITE", "suite_matrix", "SuiteEntry"]


def _dedupe_symmetrize(rows, cols, n, rng, values: str) -> CSR:
    """Symmetrize, drop self loops, dedupe, attach values."""
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    key = r.astype(np.int64) * n + c
    _, idx = np.unique(key, return_index=True)
    r, c = r[idx], c[idx]
    if values == "uniform":
        # Symmetric weights: derive from the unordered pair key so (i,j),(j,i)
        # get identical values.
        lo = np.minimum(r, c).astype(np.uint64)
        hi = np.maximum(r, c).astype(np.uint64)
        mix = lo * np.uint64(2654435761) + hi * np.uint64(40503)
        v = ((mix % np.uint64(2**31)).astype(np.float64) / 2**31) + 1e-3
    else:
        v = np.ones(r.shape[0], dtype=np.float64)
    csr = csr_from_coo(r, c, v, n)
    if values == "normalized":
        deg = np.maximum(csr.row_nnz(), 1).astype(np.float64)
        dinv = 1.0 / np.sqrt(deg)
        rix = np.repeat(np.arange(n), csr.row_nnz())
        csr.data = csr.data * dinv[rix] * dinv[csr.indices]
    return csr


def _rmat_edges(n_log2: int, nnz: int, rng: np.random.Generator, a=0.57, b=0.19, c=0.19):
    """R-MAT / Kronecker edge generator (GAP-kron analogue)."""
    n = 1 << n_log2
    rows = np.zeros(nnz, dtype=np.int64)
    cols = np.zeros(nnz, dtype=np.int64)
    for level in range(n_log2):
        r = rng.random(nnz)
        bit_r = (r >= a + b).astype(np.int64) * ((r < a + b + c).astype(np.int64) * 0 + 1)
        # quadrant: [a | b; c | d]
        row_bit = (r >= a + b).astype(np.int64)
        col_bit = ((r >= a) & (r < a + b)).astype(np.int64) | (r >= a + b + c).astype(np.int64)
        rows = rows * 2 + row_bit
        cols = cols * 2 + col_bit
        del bit_r
    return rows, cols, n


def _er_edges(n: int, nnz: int, rng: np.random.Generator):
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    return rows, cols


def _powerlaw_edges(n: int, nnz: int, rng: np.random.Generator, alpha=2.1):
    """Web-graph-like: endpoint probability ~ zipf(alpha)."""
    # Sample endpoints with probability proportional to rank^-alpha via
    # inverse-CDF on a precomputed table.
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    cdf = np.cumsum(p / p.sum())
    rows = np.searchsorted(cdf, rng.random(nnz))
    cols = rng.integers(0, n, nnz)  # one heavy endpoint, one uniform
    perm = rng.permutation(n)  # decorrelate id from degree
    return perm[rows], perm[cols]


def _road_edges(n: int, rng: np.random.Generator):
    """Road-network-like: 2-D lattice + sparse random chords (OSM analogue)."""
    side = int(np.sqrt(n))
    n = side * side
    ids = np.arange(n).reshape(side, side)
    right = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], axis=1)
    down = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], axis=1)
    edges = np.concatenate([right, down], axis=0)
    # A few chords to break perfect regularity (~1% of edges).
    k = max(1, n // 100)
    chords = np.stack([rng.integers(0, n, k), rng.integers(0, n, k)], axis=1)
    edges = np.concatenate([edges, chords], axis=0)
    return edges[:, 0], edges[:, 1], n


def generate(
    kind: str, n: int, avg_deg: float = 8.0, seed: int = 0, values: str = "normalized"
) -> CSR:
    """Generate a symmetric sparse matrix of the given family."""
    rng = np.random.default_rng(seed)
    target_nnz = int(n * avg_deg)
    if kind == "kron":
        n_log2 = int(np.ceil(np.log2(max(n, 2))))
        rows, cols, n_eff = _rmat_edges(n_log2, target_nnz, rng)
        return _dedupe_symmetrize(rows, cols, n_eff, rng, values)
    if kind == "urand":
        rows, cols = _er_edges(n, target_nnz, rng)
        return _dedupe_symmetrize(rows, cols, n, rng, values)
    if kind == "web":
        rows, cols = _powerlaw_edges(n, target_nnz, rng)
        return _dedupe_symmetrize(rows, cols, n, rng, values)
    if kind == "road":
        rows, cols, n_eff = _road_edges(n, rng)
        return _dedupe_symmetrize(rows, cols, n_eff, rng, values)
    raise ValueError(f"unknown matrix family: {kind!r}")


@dataclasses.dataclass(frozen=True)
class SuiteEntry:
    paper_id: str  # paper Table I ID
    kind: str  # generator family
    n: int  # scaled row count
    avg_deg: float


# Paper Table I, structure-matched and scaled to CPU testbed size.  The two
# GAP matrices keep their role as the "largest / out-of-core" entries.
SUITE: Dict[str, SuiteEntry] = {
    "WB-TA": SuiteEntry("wiki-Talk", "web", 1 << 14, 2.1),
    "WB-GO": SuiteEntry("web-Google", "web", 1 << 14, 5.6),
    "WB-BE": SuiteEntry("web-Berkstan", "web", 1 << 14, 11.0),
    "FL": SuiteEntry("Flickr", "web", 1 << 14, 12.0),
    "IT": SuiteEntry("italy_osm", "road", 1 << 15, 2.1),
    "PA": SuiteEntry("patents", "urand", 1 << 15, 4.0),
    "VL3": SuiteEntry("venturiLevel3", "road", 1 << 15, 4.0),
    "DE": SuiteEntry("germany_osm", "road", 1 << 16, 2.1),
    "ASIA": SuiteEntry("asia_osm", "road", 1 << 16, 2.1),
    "RC": SuiteEntry("road_central", "road", 1 << 16, 2.4),
    "WK": SuiteEntry("Wikipedia", "web", 1 << 15, 12.6),
    "HT": SuiteEntry("hugetrace-00020", "road", 1 << 16, 3.0),
    "WB": SuiteEntry("wb-edu", "web", 1 << 16, 5.8),
    "KRON": SuiteEntry("GAP-kron", "kron", 1 << 17, 16.0),
    "URAND": SuiteEntry("GAP-urand", "urand", 1 << 17, 16.0),
}


def suite_matrix(mid: str, values: str = "normalized", seed: int = 0, scale: float = 1.0) -> CSR:
    e = SUITE[mid]
    n = max(256, int(e.n * scale))
    return generate(e.kind, n, e.avg_deg, seed=seed + hash(mid) % 1000, values=values)
