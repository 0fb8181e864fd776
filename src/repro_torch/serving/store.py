"""Mid-solve snapshots: :class:`SolveCheckpoint`, the store behind
``eigsh(..., checkpoint_dir=...)``.

The reference's ``repro/serving/store.py`` ``SolveCheckpoint``, with the
same on-disk layout and schema id.  Tensors are written through NumPy:
bf16 (which NumPy lacks) is widened to f32, losslessly, with its dtype
recorded, and narrowed back by torch on load.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..configs import env as envcfg

__all__ = ["SolveCheckpoint", "default_checkpoint_root"]

_HEADER = "header.json"
# Bump on any incompatible change to the snapshot layout.
_CKPT_SCHEMA = 1


def default_checkpoint_root() -> str:
    """``REPRO_SOLVE_CHECKPOINTS`` if set, else a ``solve_checkpoints``
    directory under the port's cache directory (``build/repro_torch_cache``
    of the checkout, beside the kernels' build)."""
    env = envcfg.get_str("REPRO_SOLVE_CHECKPOINTS")
    if env:
        return env
    # src/repro_torch/serving/store.py -> the repository root.
    root = Path(__file__).resolve().parents[3]
    return str(root / "build" / "repro_torch_cache" / "solve_checkpoints")


def _to_numpy(val):
    """(array, dtype name) of a tensor or ndarray for the npz; bf16 widens
    to f32 (exact)."""
    if isinstance(val, torch.Tensor):
        t = val.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy(), name
    arr = np.asarray(val)
    return arr, str(arr.dtype)


def _atomic_write(path: Path, suffix: str, write) -> None:
    """Write through a temp file in ``path.parent``, then ``os.replace``: a
    crash mid-save leaves the previous file whole, never a torn one."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class SolveCheckpoint:
    """Mid-solve snapshot store.

    The restarted engine saves its full restart state (basis block,
    projected matrix, arrow border, next start vector, counters) after
    every compression; the chunked engine's Lanczos loop saves its carry
    every N steps and, mid-step, its chunk cursor.  A killed run re-invoked
    with the same token resumes from the last snapshot bit-identically.

    Layout on disk (one directory per solve token)::

        <root>/<token>/
            header.json   # schema + scalar state (engine, cycle/step, dims)
            state.npz     # the array state

    Writes are atomic (temp file + ``os.replace``).  A completed solve
    ``clear``s its entry so a finished token cannot resurrect.  ``load``
    returns the arrays as CPU tensors in their saved dtypes.
    """

    _STATE = "state.npz"

    def __init__(self, root: Optional[str] = None):
        self.root = Path(root if root is not None else default_checkpoint_root())
        self.root.mkdir(parents=True, exist_ok=True)

    @staticmethod
    def token(matrix_fp: Optional[str], **params) -> str:
        """Deterministic solve identity: matrix fingerprint + the solve
        parameters that shape the trajectory (backend, policy, k, m, start,
        tol, reorth; NOT budget knobs like max_restarts, which only decide
        where the trajectory stops)."""
        h = hashlib.blake2b(digest_size=12)
        h.update((matrix_fp or "anon").encode())
        for key in sorted(params):
            h.update(f"|{key}={params[key]!r}".encode())
        return h.hexdigest()

    def path_for(self, token: str) -> Path:
        return self.root / token

    def entries(self) -> list:
        return sorted(p.name for p in self.root.iterdir() if (p / _HEADER).exists())

    def save(self, token: str, state: dict) -> Path:
        """Persist one snapshot: tensor and ndarray values go to the npz
        (bf16 widened to f32, the dtype recorded), the rest to the header."""
        path = self.path_for(token)
        path.mkdir(parents=True, exist_ok=True)
        arrays, dtypes = {}, {}
        header = {"schema": _CKPT_SCHEMA}
        for key, val in state.items():
            if isinstance(val, (torch.Tensor, np.ndarray)):
                arrays[key], dtypes[key] = _to_numpy(val)
            else:
                header[key] = val
        header["array_dtypes"] = dtypes
        _atomic_write(path / self._STATE, ".npz.tmp", lambda f: np.savez(f, **arrays))
        _atomic_write(path / _HEADER, ".json.tmp",
                      lambda f: f.write(json.dumps(header, indent=1).encode()))
        return path

    def load(self, token: str) -> Optional[dict]:
        """The last snapshot for ``token``, or None when absent or corrupt
        (a corrupt entry warns and reads as absent: the solve starts over)."""
        path = self.path_for(token)
        if not (path / _HEADER).exists():
            return None
        try:
            with open(path / _HEADER) as f:
                header = json.load(f)
            if header.get("schema") != _CKPT_SCHEMA:
                return None
            dtypes = header.pop("array_dtypes", {})
            state = dict(header)
            with np.load(path / self._STATE) as z:
                for key in z.files:
                    t = torch.from_numpy(z[key])
                    if dtypes.get(key) == "bfloat16":
                        t = t.to(torch.bfloat16)  # exact narrowing back
                    state[key] = t
            return state
        except Exception as exc:
            warnings.warn(
                f"corrupt solve checkpoint {path.name} ignored "
                f"({type(exc).__name__}: {exc}); the solve restarts from zero",
                stacklevel=2,
            )
            return None

    def clear(self, token: str) -> bool:
        """Remove ``token``'s snapshot; True when something was deleted."""
        path = self.path_for(token)
        if not path.exists():
            return False
        for name in (self._STATE, _HEADER):
            try:
                (path / name).unlink()
            except FileNotFoundError:
                pass
        try:
            path.rmdir()
        except OSError:
            pass  # stray tmp files: leave the directory, the entry is gone
        return True
