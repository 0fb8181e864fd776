"""Peaks of the card and the bytes a sparse product has to move.

The bytes are reckoned from the benchmark's own CSR (its rows, its
nonzeros and the cell's dtypes), never from the program's layout, so a
change of format, padding or kernel leaves the yardstick where it is.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet),
# at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}

ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2}
INDEX_BYTES = 4  # a column index


def spmv_bytes(n: int, nnz: int, value: str, x: str, y: str) -> int:
    """Bytes that one product ``y = A x`` has to move: each stored value
    and its column index once, ``x`` read once, ``y`` written once."""
    return nnz * (ITEMSIZE[value] + INDEX_BYTES) + n * ITEMSIZE[x] + n * ITEMSIZE[y]


def least_seconds(nbytes: float, kind: str):
    """The least time the card ``kind`` needs to move ``nbytes``; None for
    a card whose peak the table lacks."""
    peak = PEAKS.get(kind)
    return None if peak is None else nbytes / peak["hbm_bytes_per_s"]
