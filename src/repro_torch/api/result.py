"""The solver result type of the PyTorch port.

The same schema as ``repro.api.EigenResult``: eigenpairs plus the
convergence, precision, placement and timing facts of a solve.  Eigenpairs
are tensors on the device the solve ran on; the rest is host data.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..core.lanczos import LanczosResult

__all__ = ["EigenResult"]


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _jsonify(obj):
    """Recursively convert numpy scalars/arrays and tensors to JSON-safe types."""
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, (np.bool_, bool)):
        return bool(obj)
    if isinstance(obj, (np.integer, int)):
        return int(obj)
    if isinstance(obj, (np.floating, float)):
        return float(obj)
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        arr = _np(obj)
        if arr.dtype == np.bool_:
            return arr.tolist()
        if np.issubdtype(arr.dtype, np.integer):
            return arr.astype(np.int64).tolist()
        return arr.astype(np.float64).tolist()
    return obj


@dataclasses.dataclass(frozen=True)
class EigenResult:
    """Result of :func:`repro_torch.eigsh`; unpacks as ``evals, evecs``.

    See ``repro.api.result.EigenResult`` for the meaning of every field.
    ``eigenvalues`` / ``eigenvectors`` are tensors (output dtype, on the
    solve's device); ``residuals`` (Ritz bounds ``|beta_m W[m-1, i]|``) and
    ``converged`` are NumPy.
    """

    eigenvalues: torch.Tensor
    eigenvectors: torch.Tensor
    residuals: np.ndarray
    converged: np.ndarray
    iterations: int
    restarts: int
    k: int
    n: int
    backend: str
    policy: str
    tol: float
    num_devices: int
    partition: Optional[dict]
    timings: Dict[str, float]
    spmv_format: Optional[object] = None
    tridiag: Optional[LanczosResult] = None
    session_reuse: bool = False
    policy_escalations: Optional[list] = None
    recovery_trail: Optional[list] = None

    def __iter__(self):
        yield self.eigenvalues
        yield self.eigenvectors

    @property
    def all_converged(self) -> bool:
        return bool(np.all(self.converged))

    @property
    def wall_time_s(self) -> float:
        return float(self.timings.get("total_s", 0.0))

    def to_dict(self) -> dict:
        """JSON-safe dict (``tridiag`` dropped); :meth:`from_dict` inverts it."""
        return {
            "schema": 1,
            "eigenvalues": _np(self.eigenvalues).astype(np.float64).tolist(),
            "eigenvectors": _np(self.eigenvectors).astype(np.float64).tolist(),
            "residuals": np.asarray(self.residuals, dtype=np.float64).tolist(),
            "converged": np.asarray(self.converged, dtype=bool).tolist(),
            "dtypes": {
                "eigenvalues": str(_np(self.eigenvalues).dtype),
                "eigenvectors": str(_np(self.eigenvectors).dtype),
            },
            "iterations": int(self.iterations),
            "restarts": int(self.restarts),
            "k": int(self.k),
            "n": int(self.n),
            "backend": self.backend,
            "policy": self.policy,
            "tol": float(self.tol),
            "num_devices": int(self.num_devices),
            "partition": _jsonify(self.partition) if self.partition is not None else None,
            "timings": {k: float(v) for k, v in self.timings.items()},
            "spmv_format": _jsonify(self.spmv_format),
            "session_reuse": bool(self.session_reuse),
            "policy_escalations": _jsonify(self.policy_escalations),
            "recovery_trail": _jsonify(self.recovery_trail),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "EigenResult":
        """Rebuild a result from :meth:`to_dict` output (on the CPU; ``tridiag`` is None)."""
        dtypes = d.get("dtypes", {})
        ev_dt = getattr(torch, dtypes.get("eigenvalues", "float32"))
        x_dt = getattr(torch, dtypes.get("eigenvectors", "float32"))
        fmt = d.get("spmv_format")
        return cls(
            eigenvalues=torch.tensor(d["eigenvalues"], dtype=ev_dt),
            eigenvectors=torch.tensor(d["eigenvectors"], dtype=x_dt),
            residuals=np.asarray(d["residuals"], dtype=np.float64),
            converged=np.asarray(d["converged"], dtype=bool),
            iterations=int(d["iterations"]),
            restarts=int(d["restarts"]),
            k=int(d["k"]),
            n=int(d["n"]),
            backend=d["backend"],
            policy=d["policy"],
            tol=float(d["tol"]),
            num_devices=int(d["num_devices"]),
            partition=d.get("partition"),
            timings=dict(d.get("timings", {})),
            spmv_format=tuple(fmt) if isinstance(fmt, list) else fmt,
            tridiag=None,
            session_reuse=bool(d.get("session_reuse", False)),
            policy_escalations=d.get("policy_escalations"),
            recovery_trail=d.get("recovery_trail"),
        )

    def summary(self) -> str:
        """One-paragraph human-readable report."""
        lam = _np(self.eigenvalues).astype(np.float64)
        fmt = self.spmv_format
        if isinstance(fmt, (tuple, list)):
            fmt = fmt[0] if fmt else None
        lines = [
            f"eigsh: k={self.k} n={self.n:,} backend={self.backend} "
            f"policy={self.policy} devices={self.num_devices}"
            + (f" spmv={fmt}" if fmt else ""),
            f"  iterations={self.iterations} restarts={self.restarts} "
            f"tol={self.tol:.1e} converged={int(self.converged.sum())}/{self.k} "
            f"wall={self.wall_time_s:.3f}s",
            f"  |lambda| range [{np.abs(lam).min():.4e}, {np.abs(lam).max():.4e}] "
            f"max residual {self.residuals.max():.2e}",
        ]
        return "\n".join(lines)
