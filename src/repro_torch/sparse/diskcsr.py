"""Disk-native CSR: the reference's on-disk directory format, read and
written with NumPy alone.

    <path>/
      header.json   {"format": "repro-diskcsr", "version": 1, "shape": [n, n],
                     "nnz": ..., "indptr_dtype": "int64", "indices_dtype":
                     "int32", "data_dtype": ...}
      indptr.npy    (n+1,) int64
      indices.npy   (nnz,) int32
      data.npy      (nnz,) value dtype (f64 / f32 / bf16)

The same format as ``repro/sparse/diskcsr.py``, so each package opens the
other's directories.  :func:`open_diskcsr` maps the arrays read-only
(``np.load(mmap_mode="r")``): slicing a row window reads only its pages, so
the chunked operator's host residency stays one staging window at a time.
:class:`DiskCSR` duck-types the cheap part of :class:`~.formats.CSR`
(``n``, ``nnz``, ``shape``, ``row_nnz``, ``indptr``, ``indices``, ``data``);
:meth:`DiskCSR.to_csr` materializes, and callers gate it on size.

bf16 payloads: NumPy has no bfloat16 of its own, and a ``.npy`` file the
reference writes in ``ml_dtypes.bfloat16`` loads here as raw 2-byte words
(``|V2``).  The header's ``data_dtype`` says what they are;
:meth:`DiskCSR.values` decodes them (a bf16 word is the high half of the
f32 with the same value, so the decode is exact).  The port writes bf16
payloads the same way, from torch's round-to-nearest-even cast.

:func:`diskcsr_fingerprint` is the reference's sampled content digest of a
directory (the same bytes hashed in the same order, so both packages give
the same digest); it keys the session cache, as the full-payload
``matrix_fingerprint`` would read the whole file back.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Union

import numpy as np
import torch

from .formats import CSR

__all__ = ["DiskCSR", "save_diskcsr", "open_diskcsr", "is_diskcsr", "diskcsr_fingerprint"]

_HEADER = "header.json"
_FORMAT = "repro-diskcsr"
_VERSION = 1
_ARRAYS = ("indptr", "indices", "data")
# Elements per window of the streaming writer: bounds its own peak host
# bytes when persisting an in-RAM CSR.
_COPY_ELEMS = 1 << 22


def _bf16_words_to_f64(words: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (2-byte words) -> float64, exactly."""
    w = np.ascontiguousarray(words).view(np.uint16)
    return (w.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


class DiskCSR:
    """``np.memmap``-backed CSR view over a diskcsr directory (read-only:
    touching a slice faults in only the pages it covers)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(str(path))
        header_path = os.path.join(self.path, _HEADER)
        with open(header_path, "r") as f:
            header = json.load(f)
        if header.get("format") != _FORMAT:
            raise ValueError(f"{header_path}: not a {_FORMAT} header")
        if int(header.get("version", 0)) > _VERSION:
            raise ValueError(
                f"{header_path}: version {header['version']} is newer than this reader ({_VERSION})"
            )
        self.header = header
        self.shape = tuple(int(s) for s in header["shape"])
        self.data_dtype = str(header.get("data_dtype", "float64"))
        self.indptr = np.load(os.path.join(self.path, "indptr.npy"), mmap_mode="r")
        self.indices = np.load(os.path.join(self.path, "indices.npy"), mmap_mode="r")
        self.data = np.load(os.path.join(self.path, "data.npy"), mmap_mode="r")
        if self.data.dtype.kind == "V" and self.data_dtype != "bfloat16":
            raise ValueError(
                f"{self.path}: payload dtype {self.data_dtype!r} has no NumPy reader here"
            )
        if self.indptr.shape[0] != self.shape[0] + 1:
            raise ValueError(
                f"{self.path}: indptr length {self.indptr.shape[0]} != n+1 for shape {self.shape}"
            )
        if int(header["nnz"]) != self.indices.shape[0]:
            raise ValueError(
                f"{self.path}: header nnz {header['nnz']} != indices length "
                f"{self.indices.shape[0]}"
            )

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row_nnz(self) -> np.ndarray:
        # O(n): row counts, not nnz.
        return np.diff(self.indptr)

    def values(self, lo: int, hi: int) -> np.ndarray:
        """Stored values ``[lo, hi)`` as float64 (bf16 payloads decoded)."""
        window = self.data[lo:hi]
        if self.data_dtype == "bfloat16":
            return _bf16_words_to_f64(window)
        return np.asarray(window, dtype=np.float64)

    def nbytes_on_disk(self) -> int:
        """Bytes of the three array payloads (the estimate ``backend="auto"``
        compares with free host memory)."""
        return int(self.indptr.nbytes + self.indices.nbytes + self.data.nbytes)

    def to_csr(self) -> CSR:
        """Materialize into an in-RAM :class:`CSR` (loads everything)."""
        return CSR(
            indptr=np.asarray(self.indptr, dtype=np.int64),
            indices=np.asarray(self.indices, dtype=np.int32),
            data=self.values(0, self.nnz),
            shape=self.shape,
        )

    def __repr__(self) -> str:
        return (
            f"DiskCSR(path={self.path!r}, shape={self.shape}, nnz={self.nnz}, "
            f"data_dtype={self.data_dtype})"
        )


def save_diskcsr(path: str, csr, data_dtype=None) -> str:
    """Persist a CSR (or a DiskCSR) as a diskcsr directory; returns its path.

    ``data_dtype`` narrows the on-disk values: a NumPy dtype, or
    ``"bfloat16"`` / ``torch.bfloat16`` (stored as 2-byte words, as the
    reference stores ``ml_dtypes.bfloat16``).  Default: the source's dtype.
    The arrays are written in bounded windows, so persisting never doubles
    the source's host footprint; the header goes last, as the commit point.
    """
    path = os.path.abspath(str(path))
    os.makedirs(path, exist_ok=True)
    if data_dtype is None:
        bf16 = getattr(csr, "data_dtype", None) == "bfloat16"
    else:
        bf16 = data_dtype is torch.bfloat16 or str(data_dtype) == "bfloat16"
    if bf16:
        ddt, name = np.dtype("V2"), "bfloat16"
    else:
        ddt = np.dtype(data_dtype) if data_dtype is not None else np.asarray(csr.data[:0]).dtype
        name = ddt.name

    def data_window(lo, hi):
        if bf16:
            t = torch.from_numpy(csr.values(lo, hi)).to(torch.bfloat16)
            return t.view(torch.int16).numpy().view(ddt)
        return np.asarray(csr.data[lo:hi])

    arrays = {
        "indptr": (np.dtype(np.int64), lambda lo, hi: csr.indptr[lo:hi], csr.n + 1),
        "indices": (np.dtype(np.int32), lambda lo, hi: csr.indices[lo:hi], csr.nnz),
        "data": (ddt, data_window, csr.nnz),
    }
    for fname, (dtype, window, length) in arrays.items():
        out = np.lib.format.open_memmap(
            os.path.join(path, f"{fname}.npy"), mode="w+", dtype=dtype, shape=(length,)
        )
        for lo in range(0, length, _COPY_ELEMS):
            hi = min(lo + _COPY_ELEMS, length)
            out[lo:hi] = np.asarray(window(lo, hi)).astype(dtype, copy=False)
        out.flush()
        del out
    header = {
        "format": _FORMAT,
        "version": _VERSION,
        "shape": [int(s) for s in csr.shape],
        "nnz": int(csr.nnz),
        "indptr_dtype": "int64",
        "indices_dtype": "int32",
        "data_dtype": name,
    }
    tmp = os.path.join(path, _HEADER + ".tmp")
    with open(tmp, "w") as f:
        json.dump(header, f, indent=1, sort_keys=True)
    os.replace(tmp, os.path.join(path, _HEADER))
    return path


def is_diskcsr(path) -> bool:
    """True when ``path`` looks like a diskcsr directory (committed header)."""
    try:
        p = os.fspath(path)
    except TypeError:
        return False
    return os.path.isdir(p) and os.path.isfile(os.path.join(p, _HEADER))


def open_diskcsr(path: Union[str, os.PathLike]) -> DiskCSR:
    p = os.fspath(path)
    if not is_diskcsr(p):
        raise FileNotFoundError(
            f"{p!r} is not a repro diskcsr directory (missing {_HEADER}; write one with "
            "repro_torch.sparse.save_diskcsr)"
        )
    return DiskCSR(p)


def _sample_file(h, fpath: str, blocks: int, block_bytes: int) -> None:
    """Feed strided sample windows of a file into a running hash: the first
    and last blocks always, plus evenly spaced interior blocks (O(blocks)
    reads however large the file is)."""
    size = os.path.getsize(fpath)
    h.update(np.int64(size).tobytes())
    with open(fpath, "rb") as f:
        if size <= blocks * block_bytes:
            h.update(f.read())  # small file: exact
            return
        stride = (size - block_bytes) // max(1, blocks - 1)
        for b in range(blocks):
            off = min(b * stride, size - block_bytes)
            f.seek(off)
            h.update(np.int64(off).tobytes())
            h.update(f.read(block_bytes))


def diskcsr_fingerprint(
    path: Union[str, os.PathLike],
    blocks: Optional[int] = None,
    block_bytes: int = 1 << 16,
) -> str:
    """Sampled content fingerprint of a diskcsr directory: the header bytes,
    then per array its file size and ``blocks`` strided 64 KiB windows
    (``REPRO_DISKCSR_FP_BLOCKS``, 16).  Any header or size change
    invalidates it; a content change does where it touches a sampled window
    (callers that rewrite data in place should save anew)."""
    if blocks is None:
        from ..configs import env as envcfg

        blocks = envcfg.get_int("REPRO_DISKCSR_FP_BLOCKS")
    p = os.fspath(path)
    h = hashlib.blake2b(digest_size=16)
    h.update(b"repro-diskcsr-fp-v1")
    with open(os.path.join(p, _HEADER), "rb") as f:
        h.update(f.read())
    for name in _ARRAYS:
        h.update(name.encode())
        _sample_file(h, os.path.join(p, f"{name}.npy"), int(blocks), block_bytes)
    return h.hexdigest()
