"""Prepared solve state: ``prepare`` -> :class:`EigenSession` (thin slice).

A session owns what is a function of the matrix and the layout config (the
coerced input, the chosen backend, the SpMV engine and device layout per
precision policy) and runs queries against it:

    sess = prepare(A, device="cuda")     # coerce, select format, convert
    r = sess.eigsh(8)                     # execute: no conversion

Backends: ``"single"`` (the in-core layout on one device) and
``"chunked"`` (:class:`~repro_torch.core.operators.ChunkedOperator`: the
matrix stays on the host, in RAM or memory-mapped from a diskcsr directory,
and streams to the device chunk by chunk).

Not ported yet: the process-wide session cache, ``eigsh_many`` grouping,
``policy="auto"`` and ``recovery="auto"`` (ROADMAP queue A, item 8).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.eigensolver import solve_fixed
from ..core.lanczos import ops_for_operator, resolve_update_mode
from ..configs import env as envcfg
from ..core.operators import ChunkedOperator, DenseOperator, LinearOperator, make_operator
from ..core.precision import PrecisionPolicy
from ..kernels.engine import FORMATS, SpmvEngine, ell_overhead_bound, make_engine
from ..sparse.diskcsr import DiskCSR
from ..sparse.formats import conversion_count
from .coerce import coerce_input
from .dispatch import select_backend
from .frontend import SolverConfig, _default_tol, _resolve_reorth, resolve_policy
from .result import EigenResult

__all__ = ["EigenSession", "prepare", "resolve_device"]

_UNSET = object()  # "inherit the session default"

# Backends the reference runs that this port does not yet, and the ROADMAP
# item (queue A) that brings each.
_NOT_PORTED = {"restarted": 7, "distributed": 10}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must be visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is visible; pass device='cpu' "
            "to run the plain versions on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass
class _Prepared:
    """One built execution plan: a device operator and what it cost."""

    operator: LinearOperator
    spmv_format: str
    engine: Optional[SpmvEngine]
    build_s: float = 0.0
    conversions: int = 0
    ops_cache: Dict[tuple, object] = dataclasses.field(default_factory=dict)

    def ops_for(self, pol: PrecisionPolicy, device):
        plan = getattr(self.engine, "iteration_plan", None)
        mode = resolve_update_mode(pol, plan=plan, device=device)
        key = (pol, mode)
        if key not in self.ops_cache:
            self.ops_cache[key] = ops_for_operator(self.operator, pol, device=device)
        return self.ops_cache[key]


class EigenSession:
    """Prepared solve state for one matrix on one device (see module doc)."""

    def __init__(self, A, config: Optional[SolverConfig] = None):
        cfg = config or SolverConfig()
        if cfg.format not in ("auto",) + FORMATS:
            raise ValueError(f"unknown SpMV format {cfg.format!r}; expected 'auto' or one of {FORMATS}")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        t0 = time.perf_counter()
        pol0 = resolve_policy(cfg.policy)
        ci = coerce_input(A, storage_dtype=pol0.storage, device=self.device)
        self.op, self.csr, self.n = ci.operator, ci.csr, ci.n
        # Dense inputs keep the source so another storage dtype re-casts from it.
        self._dense = A if isinstance(A, (np.ndarray, torch.Tensor)) else None
        self._prepared: Dict[Tuple[str, str], _Prepared] = {}
        self.prepare_s = time.perf_counter() - t0

    def warmup(self) -> "EigenSession":
        """Build the plan for the configured policy now (so :func:`prepare`,
        not the first query, pays the conversion)."""
        pol = resolve_policy(self.cfg.policy)
        prep, built = self._ensure(self._resolve_backend(self.cfg.tol), pol)
        if built:
            self.prepare_s += prep.build_s
        return self

    def _resolve_backend(self, tol: Optional[float]) -> str:
        backend = select_backend(
            self.cfg.backend,
            has_matrix=self.csr is not None,
            nnz=self.csr.nnz if self.csr is not None else 0,
            tol=tol,
            # One device per solve until the distributed backend is ported.
            device_count=1,
            disk_bytes=self.csr.nbytes_on_disk() if isinstance(self.csr, DiskCSR) else None,
        )
        if backend in _NOT_PORTED:
            raise NotImplementedError(
                f"backend {backend!r} is not ported to PyTorch yet (ROADMAP queue A, "
                f"item {_NOT_PORTED[backend]})"
            )
        return backend

    def _ensure(self, backend: str, pol: PrecisionPolicy) -> Tuple[_Prepared, bool]:
        key = (backend, f"{pol.storage}-{pol.phase_dtype('spmv')}")
        if backend == "chunked":  # the staging pin is part of the plan
            key += (envcfg.raw("REPRO_CHUNK_STAGING") or self.cfg.staging,)
        hit = self._prepared.get(key)
        if hit is not None:
            return hit, False
        t0 = time.perf_counter()
        conv0 = conversion_count()
        prep = self._build_chunked(pol) if backend == "chunked" else self._build_single(pol)
        prep.build_s = time.perf_counter() - t0
        prep.conversions = conversion_count() - conv0
        self._prepared[key] = prep
        return prep, True

    def _build_single(self, pol: PrecisionPolicy) -> _Prepared:
        if self.op is not None:
            op = self.op
            if isinstance(op, DenseOperator):
                if self._dense is not None and op.a.dtype != pol.storage:
                    src = self._dense
                    t = src if isinstance(src, torch.Tensor) else torch.from_numpy(np.asarray(src))
                    op = DenseOperator(t.to(device=self.device, dtype=pol.storage))
                return _Prepared(op, "dense", None)
            return _Prepared(op, getattr(op, "spmv_format", "matfree"), getattr(op, "engine", None))
        # An in-core layout holds the whole matrix anyway: a mapping that
        # reached this backend fits, and is read once.
        csr = self.csr.to_csr() if isinstance(self.csr, DiskCSR) else self.csr
        engine = make_engine(
            csr, self.cfg.format, accum_dtype=pol.phase_dtype("spmv"), device=self.device
        )
        op = make_operator(csr, dtype=pol.storage, engine=engine)
        return _Prepared(op, engine.format, engine)

    def _build_chunked(self, pol: PrecisionPolicy) -> _Prepared:
        """The out-of-core plan: a :class:`ChunkedOperator` over the host CSR
        or mapping, which stays where it is, with ELL chunks (or COO)."""
        cfg, csr = self.cfg, self.csr
        acc = pol.phase_dtype("spmv")
        # REPRO_CHUNK_STAGING pins the staged-chunk encoding for A/B runs,
        # over the config (ChunkedOperator validates the value).
        kw = dict(chunk_nnz=cfg.chunk_nnz, dtype=pol.storage, stage_depth=cfg.stage_depth,
                  staging=envcfg.raw("REPRO_CHUNK_STAGING") or cfg.staging, device=self.device)
        fmt = cfg.format if cfg.format != "auto" else "ell"
        # Per-chunk BSR / hybrid staging does not exist: ELL or COO.
        engine = make_engine(csr, fmt, accum_dtype=acc, allowed=("coo", "ell"), device=self.device)
        op = ChunkedOperator(csr, engine=engine, **kw)  # O(n) planning, nothing staged
        if cfg.format == "auto":
            # ELL when the chunks' padded slots stay within the ELL overhead
            # bound and their bytes do not dwarf the COO triplets they
            # replace: the reference's rule, charged with the operator's own
            # padding (width and rows to 8), not the TPU's 128 lanes, under
            # which the reference's rule sends a road network to COO.
            nnz = max(1, csr.nnz)
            itemsize = torch.empty((), dtype=pol.storage).element_size()
            ell_bytes = op.padded_slots * (itemsize + 4)
            if not (op.padded_slots / nnz <= ell_overhead_bound() and ell_bytes <= 4 * nnz * 12):
                engine = make_engine(csr, "coo", stats=engine.stats, accum_dtype=acc,
                                     device=self.device)
                op = ChunkedOperator(csr, engine=engine, **kw)
        return _Prepared(op, engine.format, engine)

    @staticmethod
    def _chunked_partition(op: ChunkedOperator, staging_before: dict) -> dict:
        """The chunked result's ``partition``: the plan's shape and this
        call's staging costs (the operator's counters run over a session's
        queries)."""
        return {
            "num_chunks": op.num_chunks,
            "stage_depth": op.stage_depth,
            "disk_backed": bool(op.disk_backed),
            "staging": op.staging_stats(since=staging_before),
        }

    def eigsh(
        self,
        k: int,
        *,
        policy=None,
        tol=_UNSET,
        num_iters=_UNSET,
        reorth=_UNSET,
        v0=None,
        seed=_UNSET,
        jacobi=_UNSET,
        recovery=_UNSET,
    ) -> EigenResult:
        """Solve one query; unset keywords inherit the session configuration."""

        def pick(v, dflt):
            return dflt if v is _UNSET else v

        cfg = self.cfg
        k = int(k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if k > self.n:
            raise ValueError(f"k={k} exceeds the operator dimension n={self.n}")
        pol = resolve_policy(policy if policy is not None else cfg.policy)
        tol_req = pick(tol, cfg.tol)
        backend = self._resolve_backend(tol_req)
        reorth = _resolve_reorth(pick(reorth, cfg.reorth), backend)
        num_iters = pick(num_iters, cfg.num_iters)
        if num_iters is not None and num_iters < k:
            raise ValueError(f"num_iters must be >= k (got {num_iters} < {k})")
        if pick(jacobi, cfg.jacobi) != "host":
            raise NotImplementedError(
                "only jacobi='host' is ported; the device Jacobi waits (ROADMAP queue A, item 5)"
            )
        if cfg.checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpoint_dir= (solve snapshots, the chunked engine's chunk-cursor "
                "checkpoints among them) is not ported yet (ROADMAP queue A, item 12)"
            )
        rec = pick(recovery, cfg.recovery) or "raise"
        if rec not in ("raise", "none"):
            raise NotImplementedError(
                f"recovery={rec!r} is not ported (only None/'raise'/'none'; ROADMAP queue A, item 8)"
            )
        prep, built = self._ensure(backend, pol)
        chunked = isinstance(prep.operator, ChunkedOperator)
        staging0 = dict(prep.operator.staging) if chunked else {}
        m = int(num_iters) if num_iters is not None else k
        sweep = solve_fixed(
            prep.operator,
            k,
            policy=pol,
            reorth=reorth,
            num_iters=m,
            v1=v0,
            seed=int(pick(seed, cfg.seed)),
            ops=prep.ops_for(pol, self.device),
            probe=rec != "none",
        )
        tol_eff = tol_req if tol_req is not None else _default_tol(pol)
        lam = np.abs(np.asarray(sweep.eigenvalues_f64, dtype=np.float64))
        converged = np.asarray(sweep.residuals) <= tol_eff * np.maximum(lam, 1e-300)
        t = dict(sweep.timings)
        t["solve_s"] = t["total_s"]
        t["prepare_s"] = prep.build_s if built else 0.0
        t["total_s"] = t["prepare_s"] + t["solve_s"]
        part = self._chunked_partition(prep.operator, staging0) if chunked else {}
        spmv = prep.engine.describe() if prep.engine is not None else {"format": prep.spmv_format}
        if chunked:
            spmv["staging"] = part["staging"]
        spmv["conversions"] = prep.conversions if built else 0
        spmv["reused"] = not built
        if prep.engine is not None:
            rec_plan = prep.engine.iteration_plan.as_dict()
            rec_plan["effective"] = resolve_update_mode(
                pol, plan=prep.engine.iteration_plan, device=self.device
            )
            spmv["iteration_plan"] = rec_plan
        return EigenResult(
            eigenvalues=sweep.eigenvalues,
            eigenvectors=sweep.eigenvectors,
            residuals=np.asarray(sweep.residuals, dtype=np.float64),
            converged=converged,
            iterations=int(sweep.iterations),
            restarts=0,
            k=k,
            n=self.n,
            backend=backend,
            policy=pol.name,
            tol=tol_eff,
            num_devices=1,
            partition={**part, "spmv": spmv},
            timings=t,
            spmv_format=prep.spmv_format,
            tridiag=sweep.tridiag,
            session_reuse=not built,
        )


def prepare(
    A,
    *,
    config: Optional[SolverConfig] = None,
    policy="FDF",
    backend: str = "auto",
    format: str = "auto",
    reorth: Optional[str] = None,
    tol: Optional[float] = None,
    num_iters: Optional[int] = None,
    seed: int = 0,
    chunk_nnz: int = 1 << 20,
    stage_depth: int = 1,
    staging: str = "f32",
    jacobi: str = "host",
    recovery: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    device: str = "cuda",
) -> EigenSession:
    """Plan phase of :func:`repro_torch.eigsh`: coerce, select, convert —
    once — and return the session; the solver knobs become its defaults."""
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
    return EigenSession(A, cfg).warmup()
