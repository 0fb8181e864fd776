"""Serving-side persistence: the warm-session store (:class:`SessionStore`)
and the mid-solve snapshot store (:class:`SolveCheckpoint`).

The reference's ``repro/serving/store.py``.  A served matrix's expensive
state (the converted device layouts, the tuned tiles and iteration plan per
policy) is a function of the matrix bytes, the layout config and the
package version.  ``SessionStore`` keeps exactly that, keyed by matrix
fingerprint + layout fingerprint, so a restarted server warms at once: the
containers are rebuilt from the saved arrays with the plain constructors
(``conversion_count()`` does not move) and the saved tiles ride in
(``tuner_probe_count()`` does not move either).  Stale or foreign entries
(another package, version or layout) are rejected by
:meth:`EigenSession.import_plans` with a warning, and the session
cold-builds.

Both stores write tensors through NumPy: bf16 (which NumPy lacks) is
widened to f32, losslessly, with its dtype recorded, and narrowed back by
torch on load.  Their default roots sit under the port's cache directory
(``build/repro_torch_cache`` of the checkout), beside the tune cache.
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

__all__ = ["SessionStore", "SolveCheckpoint", "default_store_root", "default_checkpoint_root"]

_HEADER = "header.json"
_PLANS = "plans.npz"
# Bump on any incompatible change to the snapshot layout.
_CKPT_SCHEMA = 1


def _cache_dir() -> Path:
    """The port's cache directory: ``build/repro_torch_cache`` of the
    checkout (src/repro_torch/serving/store.py -> the repository root)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_cache"


def default_store_root() -> str:
    """``REPRO_SERVING_STORE`` if set, else a ``serving_store`` directory
    under the port's cache directory."""
    env = envcfg.get_str("REPRO_SERVING_STORE")
    if env:
        return env
    return str(_cache_dir() / "serving_store")


def default_checkpoint_root() -> str:
    """``REPRO_SOLVE_CHECKPOINTS`` if set, else a ``solve_checkpoints``
    directory under the port's cache directory (``build/repro_torch_cache``
    of the checkout, beside the kernels' build)."""
    env = envcfg.get_str("REPRO_SOLVE_CHECKPOINTS")
    if env:
        return env
    return str(_cache_dir() / "solve_checkpoints")


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


class SessionStore:
    """Fingerprint-keyed persistent store of exported session plans.

    Layout on disk (one directory per (matrix, layout) pair)::

        <root>/<matrix_fp>-<layout_fp>/
            header.json   # schema, package, version, fingerprints, n, plan configs
            plans.npz     # the device-container arrays, one prefix per plan
    """

    def __init__(self, root: Optional[str] = None):
        self.root = Path(root if root is not None else default_store_root())
        self.root.mkdir(parents=True, exist_ok=True)

    def path_for(self, session) -> Optional[Path]:
        """Directory this session persists under, or None when it has no
        matrix fingerprint (a matrix-free input: nothing to key by)."""
        from ..api.session import _LAYOUT_FIELDS, config_fingerprint

        matrix_fp = session.ensure_fingerprint()
        if matrix_fp is None:
            return None
        return self.root / f"{matrix_fp}-{config_fingerprint(session.cfg, _LAYOUT_FIELDS)}"

    def entries(self) -> list:
        """Persisted (matrix, layout) keys on disk."""
        return sorted(p.name for p in self.root.iterdir() if (p / _HEADER).exists())

    def save(self, session) -> Optional[Path]:
        """Persist the session's built plans; returns the entry path, or
        None when there is nothing to persist (no fingerprint, or no
        exportable plan).  A DiskCSR session persists even with no plan: its
        entry is a header-only pointer to the directory (path + sampled
        fingerprint), never a copy of the payload.  Each file is written
        through a temp file and ``os.replace``, so a reader never sees a torn
        entry."""
        path = self.path_for(session)
        if path is None:
            return None
        state = session.export_state()
        if not state["plans"] and not state.get("matrix_ref"):
            return None
        arrays, plan_headers = {}, []
        for i, plan in enumerate(state["plans"]):
            rec = {k: v for k, v in plan.items() if k != "arrays"}
            rec["array_names"] = sorted(plan["arrays"])
            plan_headers.append(rec)
            for name, a in plan["arrays"].items():
                arrays[f"p{i}.{name}"] = np.asarray(a)
        header = {k: v for k, v in state.items() if k != "plans"}
        header["plans"] = plan_headers
        path.mkdir(parents=True, exist_ok=True)
        _atomic_write(path / _PLANS, ".npz.tmp", lambda f: np.savez(f, **arrays))
        _atomic_write(path / _HEADER, ".json.tmp",
                      lambda f: f.write(json.dumps(header, indent=1).encode()))
        return path

    def load_state(self, session) -> Optional[dict]:
        """This session's persisted state in ``export_state`` form (arrays
        read back from the npz), or None when absent or corrupt (a corrupt
        entry warns).  The header is validated by ``import_plans``."""
        path = self.path_for(session)
        if path is None or not (path / _HEADER).exists():
            return None
        try:
            with open(path / _HEADER) as f:
                header = json.load(f)
            with np.load(path / _PLANS) as z:
                plans = []
                for i, rec in enumerate(header.get("plans", [])):
                    plan = dict(rec)
                    plan["arrays"] = {name: z[f"p{i}.{name}"] for name in rec.get("array_names", [])}
                    plans.append(plan)
            header["plans"] = plans
            return header
        except Exception as exc:
            warnings.warn(
                f"corrupt serving-store entry {path.name} ignored "
                f"({type(exc).__name__}: {exc}); the session will cold-build",
                stacklevel=2,
            )
            return None

    def load_into(self, session) -> int:
        """Warm a session from its entry: the plans imported (0 when absent,
        stale, foreign or corrupt: the session cold-builds lazily)."""
        state = self.load_state(session)
        if state is None:
            return 0
        return session.import_plans(state)

    @staticmethod
    def revive_matrix(state: dict):
        """Reopen the diskcsr directory an entry's ``matrix_ref`` points at,
        after checking its sampled fingerprint: a moved, rewritten or deleted
        directory warns and reads as absent (None), so a revived server never
        serves plans for bytes that changed under it.  Returns a
        :class:`~repro_torch.sparse.DiskCSR` or None."""
        ref = (state or {}).get("matrix_ref")
        if not ref or ref.get("kind") != "diskcsr":
            return None
        from ..sparse.diskcsr import diskcsr_fingerprint, is_diskcsr, open_diskcsr

        path = ref.get("path")
        if not path or not is_diskcsr(path):
            warnings.warn(
                f"persisted matrix_ref points at {path!r}, which is no longer a diskcsr "
                "directory; the entry reads as absent",
                stacklevel=2,
            )
            return None
        if diskcsr_fingerprint(path) != ref.get("fingerprint"):
            warnings.warn(
                f"on-disk matrix at {path!r} changed since this entry was persisted "
                "(sampled fingerprint mismatch); refusing to revive",
                stacklevel=2,
            )
            return None
        return open_diskcsr(path)


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
