"""Prepared solve state: ``prepare`` -> :class:`EigenSession` (thin slice).

A session owns what is a function of the matrix and the layout config (the
coerced input, the chosen backend, the SpMV engine and device layout per
precision policy) and runs queries against it:

    sess = prepare(A, device="cuda")     # coerce, select format, convert
    r = sess.eigsh(8)                     # execute: no conversion

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
from ..core.operators import DenseOperator, LinearOperator, make_operator
from ..core.precision import PrecisionPolicy
from ..kernels.engine import FORMATS, SpmvEngine, make_engine
from ..sparse.formats import conversion_count
from .coerce import coerce_input
from .dispatch import select_backend
from .frontend import SolverConfig, _default_tol, _resolve_reorth, resolve_policy
from .result import EigenResult

__all__ = ["EigenSession", "prepare", "resolve_device"]

_UNSET = object()  # "inherit the session default"

# Backends the reference runs that this port does not yet, and the ROADMAP
# item (queue A) that brings each.
_NOT_PORTED = {"restarted": 7, "distributed": 10, "chunked": 11}


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
        )
        if backend in _NOT_PORTED:
            raise NotImplementedError(
                f"backend {backend!r} is not ported to PyTorch yet (ROADMAP queue A, "
                f"item {_NOT_PORTED[backend]})"
            )
        return backend

    def _ensure(self, backend: str, pol: PrecisionPolicy) -> Tuple[_Prepared, bool]:
        key = (backend, f"{pol.storage}-{pol.phase_dtype('spmv')}")
        hit = self._prepared.get(key)
        if hit is not None:
            return hit, False
        t0 = time.perf_counter()
        conv0 = conversion_count()
        prep = self._build_single(pol)
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
        engine = make_engine(
            self.csr, self.cfg.format, accum_dtype=pol.phase_dtype("spmv"), device=self.device
        )
        op = make_operator(self.csr, dtype=pol.storage, engine=engine)
        return _Prepared(op, engine.format, engine)

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
        rec = pick(recovery, cfg.recovery) or "raise"
        if rec not in ("raise", "none"):
            raise NotImplementedError(
                f"recovery={rec!r} is not ported (only None/'raise'/'none'; ROADMAP queue A, item 8)"
            )
        prep, built = self._ensure(backend, pol)
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
        spmv = prep.engine.describe() if prep.engine is not None else {"format": prep.spmv_format}
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
            partition={"spmv": spmv},
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
    jacobi: str = "host",
    recovery: Optional[str] = None,
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
        jacobi=jacobi,
        recovery=recovery,
        device=device,
    )
    return EigenSession(A, cfg).warmup()
