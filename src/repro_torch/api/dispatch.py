"""Backend selection for the ``eigsh`` frontend.

The paper's design goal is a *transparent* solver: the caller states the
problem, the solver decides placement (§III).  ``select_backend`` encodes
that decision as an explicit, testable function of the input:

  1. ``"restarted"``   — a convergence tolerance was requested: fixed-m
     Lanczos cannot promise a residual, thick-restart can, so an explicit
     ``tol`` always wins (use ``backend="distributed"`` explicitly to keep
     the multi-device path; ``tol`` then only defines the converged flags).
  2. ``"distributed"`` — an explicit sparse matrix and >1 visible device:
     the paper's nnz-balanced multi-GPU partition (its headline mode).
  3. ``"chunked"``     — an explicit sparse matrix too large to keep
     device-resident: the paper's out-of-core unified-memory mode.  Triggered
     above ``CHUNKED_NNZ_THRESHOLD`` non-zeros (~25M nnz ≈ 300 MB of COO
     triplets at f32 values) or when the estimated device working set
     exceeds half the free host RAM (this CPU container stands in for HBM).
  4. ``"single"``      — everything else: the paper's single-device pipeline.

Explicit ``backend=`` requests skip the policy but are validated (the
distributed and chunked paths need an explicit sparse matrix).

This is the reference's ``select_backend``, verbatim.  The port runs
``"single"``, ``"restarted"`` and ``"chunked"``; the session raises
``NotImplementedError`` for ``"distributed"``, naming the ROADMAP item that
brings it.  The session passes ``disk_bytes`` for a DiskCSR input, as the
reference's does.
"""

from __future__ import annotations

import os
from typing import Optional

from ..configs import env as envcfg

__all__ = ["BACKENDS", "CHUNKED_NNZ_THRESHOLD", "select_backend", "host_available_bytes"]

BACKENDS = ("single", "distributed", "restarted", "chunked")

# nnz above which an in-core COO copy (val f32 + row/col i32 = 12 B/nnz) is
# deemed too large to keep device-resident; overridable for experiments.
CHUNKED_NNZ_THRESHOLD = envcfg.get_int("REPRO_EIGSH_CHUNK_NNZ")

_MATRIX_BACKENDS = ("distributed", "chunked")


def host_available_bytes() -> Optional[int]:
    """Free host memory, or None when the platform doesn't expose it."""
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        return None


def select_backend(
    requested: str,
    *,
    has_matrix: bool,
    nnz: int = 0,
    tol: Optional[float] = None,
    device_count: int = 1,
    free_bytes: Optional[int] = None,
    mesh_given: bool = False,
    disk_bytes: Optional[int] = None,
) -> str:
    """Resolve ``backend="auto"`` (or validate an explicit request).

    Args:
      requested: "auto" or one of BACKENDS.
      has_matrix: input coerced to an explicit host CSR (disk-backed DiskCSR
        mappings count: they can be re-partitioned/chunked from disk).
      nnz: non-zeros of that CSR (0 for matrix-free inputs).
      tol: requested convergence tolerance (None = fixed-iteration mode).
      device_count: visible (or mesh-provided) device count.
      free_bytes: host-memory budget; defaults to the live reading.
      mesh_given: the caller passed an explicit ``jax.sharding.Mesh`` — under
        "auto" that is an explicit request for the distributed path and must
        not be silently dropped (e.g. when ``tol`` would pick restarted).
      disk_bytes: on-disk payload size of a disk-backed (DiskCSR) input, or
        None for in-RAM inputs.  Under "auto", a disk matrix whose payload
        exceeds half the free host memory MUST stream: every other backend
        would materialize it.
    """
    if requested != "auto":
        if requested not in BACKENDS:
            raise ValueError(f"unknown backend {requested!r}; expected one of {BACKENDS}")
        if requested in _MATRIX_BACKENDS and not has_matrix:
            raise ValueError(
                f"backend={requested!r} needs a host-side sparse matrix (repro "
                "CSR or scipy sparse) so it can be re-partitioned/chunked; "
                "device containers (DeviceCOO/DeviceELL) and matrix-free "
                "operators can't be — pass the host CSR instead"
            )
        return requested

    # Host-memory pressure rule for disk-backed inputs: a mapping bigger than
    # the budget cannot be materialized by ANY other backend, so it overrides
    # even tol/device-count preferences (the chunked engine honors tol=None
    # fixed-m semantics; restarted-on-disk would page-thrash or OOM).
    if disk_bytes is not None and has_matrix:
        free = free_bytes if free_bytes is not None else host_available_bytes()
        if free is None or disk_bytes > free // 2:
            return "chunked"

    if mesh_given:
        if not has_matrix:
            raise ValueError(
                "mesh= requests the distributed backend, which needs a host-side "
                "sparse matrix (repro CSR or scipy sparse) so it can be "
                "re-partitioned; device containers (DeviceCOO/DeviceELL) and "
                "matrix-free operators can't be — pass the host CSR instead"
            )
        return "distributed"

    # A requested tolerance is a convergence *requirement*: only the restarted
    # engine iterates until it holds, so it wins even over multiple devices.
    # (Pass backend="distributed" explicitly to keep the fixed-m multi-device
    # path; tol then only defines the converged flags.)
    if tol is not None:
        return "restarted"
    if has_matrix and device_count > 1:
        return "distributed"
    if has_matrix:
        if nnz >= CHUNKED_NNZ_THRESHOLD:
            return "chunked"
        free = free_bytes if free_bytes is not None else host_available_bytes()
        if free is not None and nnz * 12 > free // 2:
            return "chunked"
    return "single"
