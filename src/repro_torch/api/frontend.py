"""``eigsh`` — the SciPy-style frontend of the PyTorch port.

    import repro_torch
    res = repro_torch.eigsh(A, k=8)                 # FDF on the card
    res = repro_torch.eigsh(A, k=8, device="cpu")   # plain versions on the host

    res = repro_torch.eigsh(A, k=8, tol=1e-7)       # thick restart to a residual
    res = repro_torch.eigsh(A, k=8, policy="auto", tol=1e-4)  # cheapest policy that meets tol

The call coerces the input, picks the backend, builds the SpMV layout on
``device`` and runs the solve, reporting in the :class:`EigenResult` schema
of the reference (``repro.api.eigsh``).  The default ``device="cuda"``
raises when no card is visible: the port never falls back to the host
silently.  Backends: ``"single"`` (fixed subspace, in core),
``"restarted"`` (thick restart, selected by any ``tol=``), the
out-of-core ``"chunked"``, which streams an in-RAM CSR or a diskcsr
directory (a path or a ``DiskCSR``) to the device chunk by chunk, and
``"distributed"``: the nnz-balanced row partition over the ranks of a
``torch.distributed`` process group, SPMD (every rank calls ``eigsh`` on
the same matrix and gets the whole result)::

    # torchrun --nproc-per-node 2 script.py, each rank on its own card
    dist.init_process_group("nccl", timeout=datetime.timedelta(minutes=5))
    mesh = init_device_mesh("cuda", (dist.get_world_size(),), mesh_dim_names=("data",))
    res = repro_torch.eigsh(A, k=8, mesh=mesh)     # backend="distributed"

``eigsh`` goes through a small fingerprint-keyed cache of prepared
sessions (``api/session.py``), as the reference's does: a repeat call on a
byte-identical matrix with the same layout settings reuses the built
layout (``session_reuse`` set, ``timings["prepare_s"]`` 0).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from collections.abc import Mapping
from typing import Optional, Union

import torch

from ..core.precision import POLICIES, PrecisionPolicy
from .result import EigenResult

__all__ = ["SolverConfig", "eigsh", "is_auto_policy", "resolve_policy"]


def is_auto_policy(policy) -> bool:
    """True for the ``policy="auto"`` sentinel: not a resolvable policy but a
    request for the accuracy-driven escalation ladder (see ``eigsh``)."""
    return isinstance(policy, str) and policy.strip().lower() == "auto"


def resolve_policy(policy: Union[str, Mapping, PrecisionPolicy]) -> PrecisionPolicy:
    """A policy name from ``POLICIES`` (case-insensitive), a
    ``PrecisionPolicy``, or a phase-override mapping ``{"base": "FDF",
    "reorth": "f32", ...}``.  ``"auto"`` is a selection mode, not a policy:
    resolving it is an error pointing back at ``eigsh(policy="auto")``."""
    if isinstance(policy, PrecisionPolicy):
        return policy
    if isinstance(policy, str):
        if is_auto_policy(policy):
            raise ValueError(
                'policy="auto" is the accuracy-driven selection mode, not a resolvable '
                "policy: pass it to eigsh() or EigenSession.eigsh() (ideally with tol=) "
                "and the solver escalates through repro_torch.core.precision.auto_ladder()"
            )
        try:
            return POLICIES[policy.strip().upper()]
        except KeyError:
            raise ValueError(
                f"unknown precision policy {policy!r}; known: {sorted(POLICIES)} "
                "(case-insensitive), \"auto\", or a {'base': name, <phase>: dtype} mapping"
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
    fields, plus ``device``).  The fields that change what a session builds
    (``backend``, ``format``, ``chunk_nnz``, ``stage_depth``, ``axis``,
    ``staging``, ``device``) key the session cache; the rest are per-query
    defaults."""

    policy: Union[str, PrecisionPolicy] = "FDF"
    backend: str = "auto"
    # None = the paper's per-engine default: "half" on one device, "full" on
    # the distributed backend; the restarted backend always re-orthogonalizes
    # fully.
    reorth: Optional[str] = None
    tol: Optional[float] = None
    num_iters: Optional[int] = None
    subspace: Optional[int] = None  # restarted backend: m (defaults to max(2k, k+8))
    max_restarts: int = 30
    seed: int = 0
    format: str = "auto"
    chunk_nnz: int = 1 << 20  # chunked backend: device-resident nnz per chunk
    stage_depth: int = 1  # chunked backend: chunks staged ahead of compute
    # Chunked backend: how staged ELL chunks travel host -> device.  "f32"
    # ships the storage dtype; "bf16" / "fp8" quantize the values (per-row-
    # block scales) and delta-encode the columns, decoded in the
    # spmv_ell_packed kernel; "auto" packs when the storage dtype is narrow.
    staging: str = "f32"
    jacobi: str = "host"  # phase-2 placement: "host" (paper) or "jax" (the device)
    axis: str = "data"  # the mesh dimension the distributed backend shards over
    # Breakdown handling: "raise" (default: the health probe turns NaN/Inf
    # and beta underflow into a typed NumericalBreakdown), "auto" (probe and
    # escalate: reseed / policy rung up / unfuse / chunked fallback, trail on
    # EigenResult.recovery_trail) or "none" (probes off).
    recovery: Optional[str] = None
    # Solve checkpointing (restarted and chunked engines): a directory turns
    # on snapshots through serving.store.SolveCheckpoint; an interrupted
    # solve resumes from the last completed restart cycle or step block.
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 8  # chunked Lanczos loop: steps between snapshots
    device: str = "cuda"


def _resolve_reorth(reorth: Optional[str], backend: str) -> str:
    if reorth is not None:
        return reorth
    return "full" if backend == "distributed" else "half"


def _default_tol(policy: PrecisionPolicy) -> float:
    """sqrt(eps) of the compute dtype: the reporting tolerance when none is given."""
    return float(math.sqrt(float(torch.finfo(policy.compute).eps)))


# Legacy ``impl=`` spellings -> the ``format=`` knob that replaced them (the
# reference's table).
_IMPL_TO_FORMAT = {
    "coo": "coo",
    "ell": "ell",
    "ell_kernel": "ell",
    "bsr_kernel": "bsr",
}


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
    n: Optional[int] = None,
    subspace: Optional[int] = None,
    max_restarts: int = 30,
    format: str = "auto",
    impl: Optional[str] = None,
    chunk_nnz: int = 1 << 20,
    stage_depth: int = 1,
    staging: str = "f32",
    jacobi: str = "host",
    mesh=None,
    axis: str = "data",
    recovery: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 8,
    device: str = "cuda",
) -> EigenResult:
    """Top-K eigenpairs (largest |lambda|) of a symmetric matrix.

    Arguments mean what they mean in ``repro.api.eigsh``; ``device`` is
    where the solve runs ("cuda" by default; "cpu" runs the kernels' plain
    versions).  ``A`` may also be a scipy ``LinearOperator`` or a bare
    matvec callable (then pass ``n=``), which gets a tensor on ``device``.
    ``v0`` is an optional start vector of length n; without one, the
    fixed-subspace backends draw it from a ``torch.Generator`` seeded with
    ``seed`` and the restarted backend from
    ``np.random.default_rng(seed)``, as the reference does.  ``tol`` is the
    relative Ritz residual target: under ``backend="auto"`` it selects the
    restarted backend (a subspace of ``subspace`` vectors, at most
    ``max_restarts`` cycles; ``num_iters`` caps the total steps).
    ``policy="auto"`` tries the ladder BFF -> FFF -> FCF -> FDF -> DDD and
    stops at the first policy whose verified f64 residuals meet ``tol``
    (the trail is ``EigenResult.policy_escalations``).  ``chunk_nnz``,
    ``stage_depth`` and ``staging`` shape the chunked backend: nnz per
    staged chunk, chunks staged ahead of the one computing (at most
    ``stage_depth + 1`` resident), and the chunks' wire format ("f32",
    "bf16", "fp8" or "auto"; ``REPRO_CHUNK_STAGING`` pins it).
    ``jacobi="jax"`` runs phase 2 on ``device`` (the restarted backend
    keeps the host Jacobi, as in the reference).  ``recovery="auto"``
    retries a failed solve along the reference's escalation axes and
    records each action in ``EigenResult.recovery_trail``.
    ``checkpoint_dir`` snapshots the restarted engine after every
    compression and the chunked engine every ``checkpoint_every`` steps
    (and every ``REPRO_CHUNK_CKPT_EVERY`` chunks within a step): a solve
    killed mid-run and called again with the same arguments resumes and
    gives the same bits.  ``mesh`` is a 1-D
    ``torch.distributed.device_mesh.DeviceMesh`` whose dimension is named
    ``axis``: under ``backend="auto"`` it requests the distributed backend,
    and with ``backend="chunked"`` each rank stages its share of every
    chunk.  Without one, ``backend="auto"`` picks the distributed backend
    when the default process group has more than one rank.  The
    distributed backend re-orthogonalizes fully by default.  ``impl`` is
    deprecated: the legacy SpMV knob maps onto ``format=`` ("ell" /
    "ell_kernel" -> "ell", "bsr_kernel" -> "bsr", "coo" -> "coo") with a
    ``DeprecationWarning``; an explicit ``format=`` wins.
    """
    if impl is not None:
        warnings.warn(
            "impl= is deprecated and now maps onto format= (impl='ell'/'ell_kernel' -> "
            "format='ell', 'bsr_kernel' -> format='bsr', 'coo' -> format='coo'); pass "
            "format= directly",
            DeprecationWarning,
            stacklevel=2,
        )
        mapped = _IMPL_TO_FORMAT.get(impl)
        if mapped is None:
            raise ValueError(
                f"unknown legacy impl {impl!r}; expected one of {sorted(_IMPL_TO_FORMAT)}")
        if format == "auto":
            format = mapped
    cfg = config or SolverConfig(
        policy=policy,
        backend=backend,
        reorth=reorth,
        tol=tol,
        num_iters=num_iters,
        subspace=subspace,
        max_restarts=max_restarts,
        seed=seed,
        format=format,
        chunk_nnz=chunk_nnz,
        stage_depth=stage_depth,
        staging=staging,
        jacobi=jacobi,
        axis=axis,
        recovery=recovery,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
        device=device,
    )
    from .session import EigQuery, get_session  # lazy: session imports this module

    session, _hit = get_session(A, cfg, mesh=mesh, n=n)
    # Per-query fields come from THIS call's config: a cached session may
    # have been prepared under other solver defaults.
    q = EigQuery(
        k=k,
        policy=cfg.policy,
        tol=cfg.tol,
        num_iters=cfg.num_iters,
        reorth=cfg.reorth,
        v0=v0,
        seed=cfg.seed,
        subspace=cfg.subspace,
        max_restarts=cfg.max_restarts,
        jacobi=cfg.jacobi,
        recovery=cfg.recovery,
    )
    return session.eigsh_many([q], defaults=cfg)[0]
