"""``eigsh`` — the SciPy-style frontend of the PyTorch port.

    import repro_torch
    res = repro_torch.eigsh(A, k=8)                 # FDF on the card
    res = repro_torch.eigsh(A, k=8, device="cpu")   # plain versions on the host

The call coerces the input, picks the backend, builds the SpMV layout on
``device`` and runs the fixed-subspace solve, reporting in the
:class:`EigenResult` schema of the reference (``repro.api.eigsh``).  The
default ``device="cuda"`` raises when no card is visible: the port never
falls back to the host silently.  This slice runs ``backend="single"`` and
the out-of-core ``backend="chunked"``, which streams an in-RAM CSR or a
diskcsr directory (a path or a ``DiskCSR``) to the device chunk by chunk.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Optional, Union

import torch

from ..core.precision import POLICIES, PrecisionPolicy
from .result import EigenResult

__all__ = ["SolverConfig", "eigsh", "resolve_policy"]


def resolve_policy(policy: Union[str, Mapping, PrecisionPolicy]) -> PrecisionPolicy:
    """A policy name from ``POLICIES`` (case-insensitive), a
    ``PrecisionPolicy``, or a phase-override mapping ``{"base": "FDF",
    "reorth": "f32", ...}``."""
    if isinstance(policy, PrecisionPolicy):
        return policy
    if isinstance(policy, str):
        if policy.strip().lower() == "auto":
            raise NotImplementedError(
                'policy="auto" (the accuracy-driven ladder) is not ported yet '
                "(ROADMAP queue A, item 8)"
            )
        try:
            return POLICIES[policy.strip().upper()]
        except KeyError:
            raise ValueError(
                f"unknown precision policy {policy!r}; known: {sorted(POLICIES)} "
                "(case-insensitive) or a {'base': name, <phase>: dtype} mapping"
            ) from None
    if isinstance(policy, Mapping):
        spec = dict(policy)
        base = resolve_policy(spec.pop("base", "FDF"))
        return base.with_phases(**spec)
    raise TypeError(
        f"policy must be a str, PrecisionPolicy, or phase-override mapping, "
        f"got {type(policy).__name__}"
    )


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """The solver knobs of :func:`eigsh` as one value (the reference's
    fields that this slice runs, plus ``device``)."""

    policy: Union[str, PrecisionPolicy] = "FDF"
    backend: str = "auto"
    reorth: Optional[str] = None  # None = the paper's "half" on one device
    tol: Optional[float] = None
    num_iters: Optional[int] = None
    seed: int = 0
    format: str = "auto"
    chunk_nnz: int = 1 << 20  # chunked backend: device-resident nnz per chunk
    stage_depth: int = 1  # chunked backend: chunks staged ahead of compute
    # Chunked backend: how staged ELL chunks travel host -> device.  "f32"
    # ships the storage dtype; "bf16" / "fp8" quantize the values (per-row-
    # block scales) and delta-encode the columns, decoded in the
    # spmv_ell_packed kernel; "auto" packs when the storage dtype is narrow.
    staging: str = "f32"
    jacobi: str = "host"
    recovery: Optional[str] = None  # None/"raise" (health probe on) or "none"
    # Solve snapshots (the chunked engine's chunk-cursor checkpoints among
    # them): not ported yet (ROADMAP queue A, item 12); setting one raises.
    checkpoint_dir: Optional[str] = None
    device: str = "cuda"


def _resolve_reorth(reorth: Optional[str], backend: str) -> str:
    if reorth is not None:
        return reorth
    return "full" if backend == "distributed" else "half"


def _default_tol(policy: PrecisionPolicy) -> float:
    """sqrt(eps) of the compute dtype: the reporting tolerance when none is given."""
    return float(math.sqrt(float(torch.finfo(policy.compute).eps)))


def eigsh(
    A,
    k: int = 6,
    *,
    config: Optional[SolverConfig] = None,
    policy: Union[str, PrecisionPolicy] = "FDF",
    backend: str = "auto",
    reorth: Optional[str] = None,
    tol: Optional[float] = None,
    num_iters: Optional[int] = None,
    v0=None,
    seed: int = 0,
    format: str = "auto",
    chunk_nnz: int = 1 << 20,
    stage_depth: int = 1,
    staging: str = "f32",
    jacobi: str = "host",
    recovery: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    device: str = "cuda",
) -> EigenResult:
    """Top-K eigenpairs (largest |lambda|) of a symmetric matrix.

    Arguments mean what they mean in ``repro.api.eigsh``; ``device`` is
    where the solve runs ("cuda" by default; "cpu" runs the kernels' plain
    versions).  ``v0`` is an optional start vector of length n; without
    one it is drawn from a ``torch.Generator`` seeded with ``seed``.
    ``chunk_nnz``, ``stage_depth`` and ``staging`` shape the chunked
    backend: nnz per staged chunk, chunks staged ahead of the one computing
    (at most ``stage_depth + 1`` resident), and the chunks' wire format
    ("f32", "bf16", "fp8" or "auto"; ``REPRO_CHUNK_STAGING`` pins it).
    """
    cfg = config or SolverConfig(
        policy=policy,
        backend=backend,
        reorth=reorth,
        tol=tol,
        num_iters=num_iters,
        seed=seed,
        format=format,
        chunk_nnz=chunk_nnz,
        stage_depth=stage_depth,
        staging=staging,
        jacobi=jacobi,
        recovery=recovery,
        checkpoint_dir=checkpoint_dir,
        device=device,
    )
    from .session import EigenSession  # lazy: session imports this module

    return EigenSession(A, cfg).eigsh(k, v0=v0)
