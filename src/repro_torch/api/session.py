"""Prepared solve state: ``prepare`` -> :class:`EigenSession`, queries and
the session cache.

A session owns what is a function of the matrix and the layout config (the
coerced input, the SpMV engine and device layout per precision policy) and
runs queries against it:

    sess = prepare(A, device="cuda")             # coerce, select format, convert
    r1 = sess.eigsh(8)                            # execute: no conversion
    r2 = sess.eigsh(4, tol=1e-7)                  # restarted, same layout
    rs = sess.eigsh_many([{"k": 4}, {"k": 8}])    # one shared sweep

Backends: ``"single"`` (the in-core layout on one device), ``"restarted"``
(thick restart on the same in-core layout, selected by any ``tol=``),
``"chunked"`` (:class:`~repro_torch.core.operators.ChunkedOperator`: the
matrix stays on the host and streams to the device chunk by chunk; with
``mesh=`` each rank stages its share of every chunk) and ``"distributed"``
(``core/distributed.py``: the nnz-balanced row partition over the ranks of
a ``DeviceMesh`` axis or the default process group, one
:class:`~repro_torch.core.distributed.PreparedShards` per policy's dtypes).
The port is SPMD: every rank builds its own session on the same matrix and
gets the whole result.

``eigsh_many`` groups queries by (backend, policy, reorth, jacobi,
recovery); each group runs ONE sweep at its largest subspace per start
vector and every query slices its Ritz pairs from it.  ``recovery="auto"``
retries a failed group along the reference's axes (reseed, a policy rung
up, unfuse, chunked fallback; ``EigenResult.recovery_trail``), and
``checkpoint_dir=`` snapshots the restarted and chunked sweeps so a killed
solve resumes bit-identically.  On dense and COO operators the start
vectors of one group run as one multi-start sweep, as in the reference
(``lanczos_tridiag_multi``); on the kernel layouts each runs its own
sweep.  ``policy="auto"``
queries run the precision ladder one rung at a time and never group.

``repro_torch.eigsh`` goes through :func:`get_session`, a small LRU of
sessions keyed by the matrix's content digest and the layout fields of the
config (``REPRO_EIGSH_SESSION_CACHE`` entries, ``REPRO_EIGSH_SESSION_CACHE_MB``
of host data and device plans): a repeat call on a byte-identical matrix
reuses the built layout.  An evicted session, and every session on
:func:`session_cache_clear`, drops its plans and so their device memory.

A session's built in-core plans export (:meth:`EigenSession.export_state`)
and import (:meth:`EigenSession.import_plans`) as host NumPy arrays plus
their engine configuration: the serving layer's ``SessionStore`` warms a
restarted server from them with no conversion and no tuner probe.

This is the reference's ``repro/api/session.py``.  Its default mesh (all
visible devices) becomes the default process group here, and the world
size stands in for the device count that lets ``backend="auto"`` pick the
distributed path.
"""

from __future__ import annotations

import atexit
import dataclasses
import hashlib
import math
import os
import threading
import time
import warnings
from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from ..configs import env as envcfg
from ..core.distributed import PreparedShards, ShardComm, prepare_sharded, solve_sharded
from ..core.eigensolver import (
    JACOBI_PLACEMENTS,
    ritz_decompose,
    ritz_extract,
    solve_fixed,
    start_vector,
)
from ..core.lanczos import (
    LanczosResult,
    NumericalBreakdown,
    lanczos_tridiag_multi,
    ops_for_operator,
    resolve_update_mode,
)
from ..core.operators import (
    ChunkedOperator,
    DenseOperator,
    LinearOperator,
    SparseOperator,
    make_operator,
)
from ..core.precision import PrecisionPolicy, auto_ladder, dtype_name, phase_op_counts
from ..core.restarted import solve_restarted
from ..core.trace import HOST_COPY_BYTES, START_COMPARES, V0_DIGESTS, count, counting, span
from ..kernels.engine import (
    FORMATS,
    IterationPlan,
    SpmvEngine,
    TileConfig,
    ell_overhead_bound,
    make_engine,
    tuner_probe_count,
)
from ..sparse.diskcsr import DiskCSR, is_diskcsr
from ..sparse.formats import CSR, conversion_count
from ..testing.faults import InjectedKernelError
from .coerce import CoercedInput, _host_array, coerce_input, matrix_fingerprint
from .dispatch import select_backend
from .frontend import SolverConfig, _default_tol, _resolve_reorth, is_auto_policy, resolve_policy
from .result import EigenResult

__all__ = [
    "EigQuery",
    "EigenSession",
    "prepare",
    "eigsh_many",
    "policy_key",
    "config_fingerprint",
    "get_session",
    "session_cache_clear",
    "session_cache_info",
    "resolve_device",
]

_UNSET = object()  # "inherit the session default", as distinct from None

# SolverConfig fields that change what a session builds; the per-query
# fields (k, policy, tol, num_iters, reorth, seed, subspace, max_restarts,
# jacobi, recovery) are resolved per query.  ``device`` is the port's own:
# a session's layouts live on one device.
_LAYOUT_FIELDS = ("backend", "format", "chunk_nnz", "stage_depth", "axis", "staging", "device")

# Largest on-disk payload the auto ladder's f64 residual check will
# materialize: a bigger DiskCSR stays on disk and the ladder judges the
# Ritz bounds instead.
_DISK_VERIFY_MAX_BYTES = 1 << 28

# The policy a session plans and coerces with under policy="auto": the
# ladder's f32-storage rung, so coercion never rounds the input below what
# any rung needs; each rung builds its own plan lazily.
_AUTO_PLAN_POLICY = "FFF"

# Bump on any incompatible change to what export_state writes.  The header
# also names the package: the port pads ELL slots to 8, the reference to 128
# lanes, so neither package imports the other's plans.
_EXPORT_SCHEMA = 1
_PACKAGE = "repro_torch"


def policy_key(policy: Union[str, PrecisionPolicy]) -> str:
    """Identity key of a policy: its dtype triple and compensation, plus any
    per-phase override that differs from ``compute``, never its spelling
    (``"FDF"`` and the ``FDF`` instance key alike)."""
    p = resolve_policy(policy).effective()
    parts = [dtype_name(p.storage), dtype_name(p.compute), dtype_name(p.output),
             f"c{int(p.compensated)}"]
    if not p.is_uniform():
        parts.append("ph[" + ",".join(f"{ph}:{dt}" for ph, dt in p.phase_map().items()) + "]")
    return "-".join(parts)


def _plan_key(pol: PrecisionPolicy) -> str:
    """What a built plan depends on: the storage dtype (the device layout)
    and the SpMV-phase accumulator (the engine).  Narrower than
    :func:`policy_key` on purpose: FFF and FCF, or FDF and FDF[reorth=f32],
    share one plan."""
    return f"{dtype_name(pol.storage)}-{dtype_name(pol.phase_dtype('spmv'))}"


def _plan_policy(policy) -> PrecisionPolicy:
    return resolve_policy(_AUTO_PLAN_POLICY if is_auto_policy(policy) else policy)


def config_fingerprint(cfg: SolverConfig, fields: Optional[Sequence[str]] = None) -> str:
    """Digest of a :class:`SolverConfig` (or of the ``fields`` subset); a
    policy hashes by name and :func:`policy_key`, so ``policy=FDF`` and
    ``policy="FDF"`` fingerprint alike."""
    names = tuple(fields) if fields is not None else tuple(f.name for f in dataclasses.fields(cfg))
    parts = []
    for name in sorted(names):
        v = getattr(cfg, name)
        if name == "policy":
            if is_auto_policy(v):
                v = ("auto", "auto")  # the ladder, not any one rung
            else:
                p = resolve_policy(v)
                v = (p.name, policy_key(p))
        elif name == "device":
            v = str(torch.device(v))
        parts.append(f"{name}={v!r}")
    return hashlib.blake2b("|".join(parts).encode(), digest_size=12).hexdigest()


@dataclasses.dataclass(frozen=True, eq=False)
class EigQuery:
    """One solve request against a prepared session.

    Every field but ``k`` defaults to the session's configuration
    (``_UNSET``); explicit values, ``None`` included where it means
    something (``tol=None``: fixed-subspace mode), override it.  Plain dicts
    and bare ints coerce.  ``policy="auto"`` queries solve individually.
    """

    k: int
    policy: Any = None
    tol: Any = _UNSET
    num_iters: Any = _UNSET
    reorth: Any = _UNSET
    seed: Any = _UNSET
    v0: Any = None
    subspace: Any = _UNSET
    max_restarts: Any = _UNSET
    jacobi: Any = _UNSET
    recovery: Any = _UNSET


def _as_query(q) -> EigQuery:
    if isinstance(q, EigQuery):
        return q
    if isinstance(q, dict):
        return EigQuery(**q)
    if isinstance(q, (int, np.integer)):
        return EigQuery(k=int(q))
    raise TypeError(
        f"eigsh_many query must be an EigQuery, a dict of its fields, or an int k; "
        f"got {type(q).__name__}"
    )


# recovery="auto" bounds: total attempts (the first solve plus up to five
# recovery actions) and how many fresh start vectors a lucky breakdown may
# burn before it is treated as structural and re-raised.
_MAX_RECOVERY_ATTEMPTS = 6
_MAX_RESEEDS = 2


def _classify_failure(exc) -> Optional[str]:
    """Map an in-solve exception to a ``recovery="auto"`` action, or None
    when no documented recovery applies (the error re-raises unchanged).

    As conservative as the reference's: a breakdown reseeds (beta
    underflow) or escalates the policy (non-finite); an allocation failure
    (``MemoryError`` or "out of memory" in the message, which
    ``torch.cuda.OutOfMemoryError`` carries) falls back to the chunked
    backend; an injected kernel error unfuses.  A real CUDA error maps to
    nothing: it may have poisoned the context, and all six kernels live in
    one library, so unfusing could not escape it.
    """
    if isinstance(exc, NumericalBreakdown):
        return "reseed" if exc.kind == "beta_underflow" else "escalate_policy"
    if isinstance(exc, MemoryError) or "out of memory" in str(exc).lower():
        return "fallback_chunked"
    if isinstance(exc, InjectedKernelError):
        return "unfuse"
    return None


def _policy_rank(pol: PrecisionPolicy) -> tuple:
    """Orderable cost/headroom rank of a policy: compute width first (what
    breakdown escalation buys), then compensation, then storage width, as
    :func:`auto_ladder` orders its rungs."""
    p = pol.effective()

    def size(dt):
        return torch.empty((), dtype=dt).element_size()

    return (size(p.compute), int(bool(p.compensated)), size(p.storage))


def _next_rung(pol: PrecisionPolicy) -> Optional[PrecisionPolicy]:
    """The cheapest :func:`auto_ladder` rung strictly above ``pol`` in
    compute headroom, or None when ``pol`` already tops the ladder."""
    cur = _policy_rank(pol)
    for rung in auto_ladder():
        cand = resolve_policy(rung).effective()
        if _policy_rank(cand) > cur:
            return cand
    return None


class _NormQuery(NamedTuple):
    """A query with every field resolved against the session defaults."""

    idx: int
    k: int
    pol: PrecisionPolicy  # effective()
    pkey: str
    backend: str
    reorth: str
    tol_req: Optional[float]
    tol_eff: float
    num_iters: Optional[int]
    m: int  # fixed-m subspace this query needs
    subspace: Optional[int]
    max_restarts: int
    seed: int
    v0: Any
    jacobi: str
    start_key: str  # "seed:<n>", or "v0#<idx>" of the call's first query with these v0 bytes
    recovery: str  # "none" | "raise" | "auto"
    ckpt_dir: Optional[str]  # solve-checkpoint directory (None = off)
    ckpt_every: int  # chunked Lanczos loop: steps between snapshots


def _norm_group_key(q: _NormQuery) -> tuple:
    """Queries sharing this key are answered by ONE sweep (per start)."""
    return (q.backend, q.pkey, q.pol.name, q.reorth, q.jacobi, q.recovery)


def _start_bytes(v0):
    """``v0``'s bytes in the order ``np.asarray(v0).tobytes()`` gives them,
    as a flat uint8 view where they live: a tensor on a card stays there,
    anything else is a NumPy array."""
    if isinstance(v0, torch.Tensor):
        flat = v0.detach().reshape(-1).contiguous().view(torch.uint8)
        return flat if flat.device.type != "cpu" else flat.numpy()
    return np.ascontiguousarray(np.asarray(v0)).reshape(-1).view(np.uint8)


def _same_bytes(a, b, block: int = 1 << 22) -> bool:
    """Are two :func:`_start_bytes` views equal?  Two host views compare in
    blocks and stop at the first that differs; otherwise the host view
    moves to the card and one ``torch.equal`` decides."""
    if a.shape[0] != b.shape[0]:
        return False
    count(START_COMPARES, 1)
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return all(np.array_equal(a[i: i + block], b[i: i + block])
                   for i in range(0, a.shape[0], block))
    a, b = (torch.from_numpy(x if x.flags.writeable else x.copy())
            if isinstance(x, np.ndarray) else x for x in (a, b))
    if a.device != b.device:
        a, b = (a.to(b.device), b) if a.device.type == "cpu" else (a, b.to(a.device))
    return bool(torch.equal(a, b))


def _key_starts(group: List[_NormQuery]) -> List[_NormQuery]:
    """The group's queries, each ``v0`` query keyed ``v0#<idx>`` of the
    first query whose ``v0`` has the same bytes: the reference's rule (its
    key hashes ``np.asarray(v0).tobytes()``) without a hash or a copy off
    the card.  The same object needs no read; a lone ``v0`` none at all."""
    firsts: List[list] = []  # [first query of a start, its bytes once read]
    out = []
    for q in group:
        if q.v0 is not None:
            mine = None
            for first in firsts:
                if first[0].v0 is not q.v0:
                    if first[1] is None:
                        first[1] = _start_bytes(first[0].v0)
                    if mine is None:
                        mine = _start_bytes(q.v0)
                    if not _same_bytes(first[1], mine):
                        continue
                q = q._replace(start_key=first[0].start_key)
                break
            else:
                firsts.append([q, mine])
        out.append(q)
    return out


def _content_key(q: _NormQuery) -> str:
    """The start's key where it leaves the call (a checkpoint token, a
    reseed trail): ``seed:<n>``, or ``v0:`` and the blake2b of the ``v0``'s
    host bytes, as the reference names it.  A digest adds to the call's
    ``v0_digests`` and ``v0_digest_s``."""
    if q.v0 is None:
        return q.start_key
    took: Dict[str, float] = {}
    with span("repro_torch.query.v0_digest", took, "v0_digest_s"):
        digest = hashlib.blake2b(_host_array(q.v0).tobytes(), digest_size=8)
    count(V0_DIGESTS, 1)
    count("v0_digest_s", took["v0_digest_s"])
    return f"v0:{digest.hexdigest()}"


def _tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def _multistart_batch(op, pol: PrecisionPolicy, m: int, dev: torch.device) -> int:
    """The most start vectors one multi-start sweep takes: the batched
    update's row limit and, on the card, what half the free memory holds of
    each start's working set, its (m, n) basis in storage, ``project_out``'s
    masked copy of it in the reorth dtype, a few (n,) vectors and, on COO,
    its (nnz,) gathered products."""
    from ..kernels.lanczos_update import MAX_ROWS

    if dev.type != "cuda":
        return MAX_ROWS
    n = op.n
    mat = getattr(op, "mat", None)
    nnz = mat.val.numel() if isinstance(getattr(mat, "val", None), torch.Tensor) else 0
    per_start = (m * n * (pol.storage.itemsize + pol.phase_dtype("reorth").itemsize)
                 + 8 * n * pol.compute.itemsize
                 + nnz * (pol.storage.itemsize + pol.phase_dtype("spmv").itemsize))
    free, _ = torch.cuda.mem_get_info(dev)
    free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return max(1, min(MAX_ROWS, free // 2 // per_start))


@dataclasses.dataclass
class _Prepared:
    """One built execution plan: a device operator (single, chunked) or this
    rank's shard set (distributed), and what it cost."""

    operator: Optional[LinearOperator]
    spmv_format: str
    engine: Optional[SpmvEngine]
    shards: Optional[PreparedShards] = None
    build_s: float = 0.0
    conversions: int = 0
    tuner_probes: int = 0
    ops_cache: Dict[tuple, object] = dataclasses.field(default_factory=dict)

    def ops_for(self, pol: PrecisionPolicy, device, fused: Optional[bool] = None):
        """The solve's kernel set, memoized per (policy, pin, resolved mode);
        ``fused=False`` pins the plain update (``recovery="auto"``'s
        unfuse)."""
        plan = getattr(self.engine, "iteration_plan", None)
        mode = resolve_update_mode(pol, plan=plan, device=device, fused=fused)
        key = (pol, fused, mode)
        if key not in self.ops_cache:
            self.ops_cache[key] = ops_for_operator(self.operator, pol, device=device, fused=fused)
        return self.ops_cache[key]

    def nbytes(self) -> int:
        """Bytes of the plan's own tensors (the device layout, or a chunked
        operator's staging windows)."""
        op = self.operator
        if self.shards is not None:
            return sum(_tensor_bytes(*vars(m).values()) for m in self.shards.mats)
        if isinstance(op, SparseOperator):
            return _tensor_bytes(*vars(op.mat).values())
        if isinstance(op, DenseOperator):
            return _tensor_bytes(op.a)
        if isinstance(op, ChunkedOperator):
            return op.resident_bytes()
        return 0


class EigenSession:
    """Prepared solve state for one matrix on one device (see module doc);
    ``mesh`` is an optional 1-D ``DeviceMesh`` for the distributed backend.

    Queries on one session run one batch at a time (an internal lock: the
    operators and counters are single-stream); distinct sessions run in
    parallel.  ``stats`` counts ``queries``, ``sweeps`` and ``cache_hits``
    (queries whose plan was already built).
    """

    # Lock discipline, verified by repro_torch.analysis (rule C001).
    _GUARDED_BY = {"_prepared": "_build_lock"}

    def __init__(self, A, config: Optional[SolverConfig] = None, *, mesh=None,
                 n: Optional[int] = None, _coerced: Optional[CoercedInput] = None):
        cfg = config or SolverConfig()
        if cfg.format not in ("auto",) + FORMATS:
            raise ValueError(
                f"unknown SpMV format {cfg.format!r}; expected 'auto' or one of {FORMATS}"
            )
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.mesh = _check_mesh(mesh)
        # The counterpart of the reference's visible device count: the
        # mesh's size, else the default process group's world size.
        self.device_count = mesh.size() if mesh is not None else ShardComm().size
        t0 = time.perf_counter()
        conv0, probes0 = conversion_count(), tuner_probe_count()
        pol0 = _plan_policy(cfg.policy)
        ci = _coerced or coerce_input(A, n=n, storage_dtype=pol0.storage, device=self.device)
        self.op, self.csr, self.n = ci.operator, ci.csr, ci.n
        # Dense inputs keep the source so another storage dtype re-casts
        # from it, not from an already-rounded copy.
        self._dense = A if isinstance(A, (np.ndarray, torch.Tensor)) else None
        self.matrix_fingerprint = ci.fingerprint
        self._prepared: Dict[tuple, _Prepared] = {}
        self._verify_a = None  # lazy f64 host matrix of the auto ladder's check
        self._build_lock = threading.Lock()
        self._query_lock = threading.RLock()
        self.stats = {"queries": 0, "sweeps": 0, "cache_hits": 0}
        self.prepare_s = time.perf_counter() - t0
        self.prepare_conversions = conversion_count() - conv0
        self.prepare_tuner_probes = tuner_probe_count() - probes0
        # Coercion cost no result has reported yet: the first query that
        # builds a plan claims it (warmup() charges it to prepare_s).
        self._unclaimed_init_s = self.prepare_s

    def warmup(self) -> "EigenSession":
        """Build the plan for the configured policy now (so :func:`prepare`,
        not the first query, pays the conversion)."""
        backend = self._resolve_backend(self.cfg.tol)
        prep, built = self._ensure(backend, _plan_policy(self.cfg.policy))
        if built:
            self.prepare_s += prep.build_s
            self.prepare_conversions += prep.conversions
            self.prepare_tuner_probes += prep.tuner_probes
        self._unclaimed_init_s = 0.0
        return self

    def _claim_init_s(self) -> float:
        s, self._unclaimed_init_s = self._unclaimed_init_s, 0.0
        return s

    # ------------------------------------------------------ cache support

    def _own_data(self) -> None:
        """Snapshot the host problem data so the session stops aliasing the
        caller's buffers (called when the session enters the cache: its key
        pins the bytes it was built from, and lazily built plans must not
        see a later in-place mutation).  A DiskCSR stays a mapping."""
        if isinstance(self.csr, CSR):
            self.csr = CSR(indptr=np.array(self.csr.indptr, copy=True),
                           indices=np.array(self.csr.indices, copy=True),
                           data=np.array(self.csr.data, copy=True), shape=self.csr.shape)
        if isinstance(self._dense, torch.Tensor):  # a host copy, as the reference's
            self._dense = self._dense.detach().to("cpu", copy=True)
        elif self._dense is not None:
            self._dense = np.array(self._dense, copy=True)
        self._verify_a = None

    def approx_bytes(self) -> int:
        """What caching this session pins: the host problem data (a DiskCSR:
        its row pointers only) plus the tensors of every built plan."""
        if isinstance(self.csr, DiskCSR):
            base = int(self.csr.indptr.nbytes)
        elif self.csr is not None:
            base = self.csr.indptr.nbytes + self.csr.indices.nbytes + self.csr.data.nbytes
        elif isinstance(self._dense, torch.Tensor):
            base = _tensor_bytes(self._dense)
        elif self._dense is not None:
            base = int(self._dense.nbytes)
        else:
            base = 0
        return int(base) + sum(p.nbytes() for p in list(self._prepared.values()))

    def release(self) -> None:
        """Drop the built plans (and with them their device memory) and the
        verification matrix; a later query rebuilds what it needs."""
        with self._build_lock:
            self._prepared.clear()
            if self._dense is not None:
                self.op = None  # the device copy; plans re-cast from the source
        self._verify_a = None

    # ----------------------------------------------------------- planning

    def _resolve_backend(self, tol: Optional[float]) -> str:
        return select_backend(
            self.cfg.backend,
            has_matrix=self.csr is not None,
            nnz=self.csr.nnz if self.csr is not None else 0,
            tol=tol,
            device_count=self.device_count,
            mesh_given=self.mesh is not None,
            disk_bytes=self.csr.nbytes_on_disk() if isinstance(self.csr, DiskCSR) else None,
        )

    def _ensure(self, backend: str, pol: PrecisionPolicy) -> Tuple[_Prepared, bool]:
        """The plan for (placement, policy dtypes): built once, then reused.
        Restarted queries run on the in-core plan of fixed ones."""
        kind = backend if backend in ("distributed", "chunked") else "single"
        key = (kind, _plan_key(pol))
        if kind == "chunked":  # the staging pin is part of the plan
            key += (envcfg.raw("REPRO_CHUNK_STAGING") or self.cfg.staging,)
        with self._build_lock:
            hit = self._prepared.get(key)
            if hit is not None:
                return hit, False
            t0 = time.perf_counter()
            conv0, probes0 = conversion_count(), tuner_probe_count()
            if kind == "distributed":
                prep = self._build_distributed(pol)
            elif kind == "chunked":
                prep = self._build_chunked(pol)
            else:
                prep = self._build_single(pol)
            prep.build_s = time.perf_counter() - t0
            prep.conversions = conversion_count() - conv0
            prep.tuner_probes = tuner_probe_count() - probes0
            self._prepared[key] = prep
        # A lazy build grew this session: let the cache re-check its budget.
        _cache_enforce_budget()
        return prep, True

    def _build_single(self, pol: PrecisionPolicy) -> _Prepared:
        if self._dense is not None:
            op = self.op
            if op is None or op.a.dtype != pol.storage:
                src = self._dense
                t = src if isinstance(src, torch.Tensor) else torch.from_numpy(np.asarray(src))
                op = DenseOperator(t.to(device=self.device, dtype=pol.storage, copy=True))
            return _Prepared(op, "dense", None)
        if self.op is not None:
            op = self.op
            return _Prepared(op, getattr(op, "spmv_format", "matfree"), getattr(op, "engine", None))
        # An in-core layout holds the whole matrix anyway: a mapping that
        # reached this backend fits, and is read once.
        csr = self.csr.to_csr() if isinstance(self.csr, DiskCSR) else self.csr
        engine = make_engine(csr, self.cfg.format, accum_dtype=pol.phase_dtype("spmv"),
                             storage_dtype=pol.storage, device=self.device)
        op = make_operator(csr, "coo", pol.storage, engine)
        return _Prepared(op, engine.format, engine)

    def _build_chunked(self, pol: PrecisionPolicy) -> _Prepared:
        """The out-of-core plan: a :class:`ChunkedOperator` over the host CSR
        or mapping, which stays where it is, with ELL chunks (or COO)."""
        cfg, csr = self.cfg, self.csr
        acc = pol.phase_dtype("spmv")
        # REPRO_CHUNK_STAGING pins the staged-chunk encoding for A/B runs,
        # over the config (ChunkedOperator validates the value).
        kw = dict(chunk_nnz=cfg.chunk_nnz, dtype=pol.storage, stage_depth=cfg.stage_depth,
                  staging=envcfg.raw("REPRO_CHUNK_STAGING") or cfg.staging, device=self.device,
                  mesh=self.mesh, axis=cfg.axis)
        fmt = cfg.format if cfg.format != "auto" else "ell"
        # Per-chunk BSR / hybrid staging does not exist: ELL or COO.
        engine = make_engine(csr, fmt, accum_dtype=acc, allowed=("coo", "ell"),
                             storage_dtype=pol.storage, device=self.device)
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
                                     storage_dtype=pol.storage, device=self.device)
                op = ChunkedOperator(csr, engine=engine, **kw)
        return _Prepared(op, engine.format, engine)

    def _build_distributed(self, pol: PrecisionPolicy) -> _Prepared:
        """This rank's shard of the nnz-balanced partition (a DiskCSR is
        read once: every rank partitions the whole matrix)."""
        # The mesh's ``axis`` group, else the default process group, else a
        # world of one (the reference's ``_mesh_for_solve``).
        comm = ShardComm(self.mesh, self.cfg.axis)
        csr = self.csr.to_csr() if isinstance(self.csr, DiskCSR) else self.csr
        shards = prepare_sharded(csr, comm.size, pol, self.cfg.format, device=self.device,
                                 comm=comm)
        return _Prepared(None, shards.engine.format, shards.engine, shards=shards)

    # ---------------------------------------------------------- execution

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
        subspace=_UNSET,
        max_restarts=_UNSET,
        jacobi=_UNSET,
        recovery=_UNSET,
    ) -> EigenResult:
        """Solve one query; unset keywords inherit the session configuration."""
        q = EigQuery(k=k, policy=policy, tol=tol, num_iters=num_iters, reorth=reorth, seed=seed,
                     v0=v0, subspace=subspace, max_restarts=max_restarts, jacobi=jacobi,
                     recovery=recovery)
        return self.eigsh_many([q])[0]

    def eigsh_many(self, queries, defaults: Optional[SolverConfig] = None) -> List[EigenResult]:
        """Batched execute: many ``(k, policy, tol, ...)`` queries, one matrix.

        Queries group by :meth:`group_key`; each group runs one sweep per
        start vector at its largest subspace and every member slices its
        Ritz pairs from it.  A merged group runs under its most permissive
        cost settings (largest ``num_iters`` / ``subspace`` /
        ``max_restarts``) and its tightest ``tol``: per-query budgets are
        advisory under batching (submit a query alone where its budget must
        bind).  Results come back in input order.

        Queries with a ``v0`` share a start where their ``v0`` bytes are
        equal, compared where the vectors live (on the card for a card
        tensor), with no copy to the host and no hash.  Only a key that
        leaves the call, a checkpoint token or a reseed trail's ``"from"``,
        takes the host digest ``v0:<blake2b>``.

        Every result's ``timings`` carry the call's ``query_s`` (from taking
        the query lock to the return) and its counters: ``host_copy_bytes``
        (what the call copied from a card to the host), ``start_compares``
        (byte-wise comparisons of two distinct start vectors) and
        ``v0_digests`` (host digests taken), with ``v0_digest_s`` where one
        was taken; and its own query's spans (``normalize_s``, ``plan_s``,
        ``finish_s``; see :mod:`repro_torch.core.trace`).
        """
        if not queries:
            return []
        cfg = defaults or self.cfg
        call = {HOST_COPY_BYTES: 0.0, START_COMPARES: 0.0, V0_DIGESTS: 0.0}
        with self._query_lock:
            # The range's argument is the call's first query ordinal, so
            # one request's spans can be found together in a trace.
            with span("repro_torch.query", call, "query_s",
                      args=(self.stats["queries"] + 1,)), counting(call):
                results = self._answer_locked([_as_query(q) for q in queries], cfg)
        for res in results:
            res.timings.update(call)
        return results

    def _answer_locked(self, raw: List[EigQuery], cfg: SolverConfig) -> List[EigenResult]:
        self.stats["queries"] += len(raw)
        results: List[Optional[EigenResult]] = [None] * len(raw)
        spans: List[Dict[str, float]] = [{} for _ in raw]
        normal: List[_NormQuery] = []
        for i, rq in enumerate(raw):
            requested = rq.policy if rq.policy is not None else cfg.policy
            if is_auto_policy(requested):
                results[i] = self._solve_auto(rq, cfg)
            else:
                with span("repro_torch.query.normalize", spans[i], "normalize_s"):
                    normal.append(self._normalize(rq, i, cfg))
        groups: Dict[tuple, List[_NormQuery]] = {}
        for q in normal:
            groups.setdefault(_norm_group_key(q), []).append(q)
        for group in groups.values():
            for idx, res in self._solve_group(_key_starts(group)):
                results[idx] = res
        for res, own in zip(results, spans):
            res.timings.update(own)
        return results  # type: ignore[return-value]

    def ensure_fingerprint(self) -> Optional[str]:
        """Content digest of this session's matrix, computed on first need
        (a session built outside the cache has none; the checkpoint tokens
        need it).  None for matrix-free inputs."""
        if self.matrix_fingerprint is None:
            src = self.csr if self.csr is not None else self._dense
            if src is not None:
                self.matrix_fingerprint = matrix_fingerprint(src)
        return self.matrix_fingerprint

    def group_key(self, query, defaults: Optional[SolverConfig] = None) -> Optional[tuple]:
        """The key :meth:`eigsh_many` groups by: two queries with equal keys
        (on one session) share one sweep.  None for ``policy="auto"``
        queries, which never group.  Raises what submitting the query would
        (``k`` out of range, an infeasible ``num_iters``)."""
        cfg = defaults or self.cfg
        rq = _as_query(query)
        requested = rq.policy if rq.policy is not None else cfg.policy
        if is_auto_policy(requested):
            return None
        return _norm_group_key(self._normalize(rq, 0, cfg))

    # --------------------------------------------------- persistence hooks

    def export_state(self) -> dict:
        """Serializable snapshot of this session's built in-core plans (the
        warm state a restarted server needs): each plan's device-container
        arrays as host NumPy (bf16 widened to f32, its dtype recorded) and
        its engine configuration (format, accumulator, tiles and their
        provenance, iteration plan).  The header names the package and its
        version, the matrix fingerprint and the layout-config fingerprint,
        so :meth:`import_plans` can reject stale or foreign artifacts.

        Only "single" plans over a device container (COO / ELL / BSR /
        hybrid) or a dense operator export: chunked plans keep the matrix on
        the host anyway, and rebuild on demand.  A DiskCSR session also
        records a pointer to its directory (``matrix_ref``), never a copy
        of the payload.
        """
        from .. import __version__

        with self._build_lock:
            items = list(self._prepared.items())
        plans = []
        for key, prep in items:
            if key[0] != "single":
                continue
            exported = _export_operator(prep.operator)
            if exported is None:
                continue
            container, tensors, extra = exported
            arrays, dtypes = {}, {}
            for name, t in tensors.items():
                arrays[name], dtypes[name] = _host_numpy(t)
            e = prep.engine
            engine_cfg = None if e is None else {
                "format": e.format,
                "accum_dtype": dtype_name(e.accum_dtype),
                "tiles": dataclasses.asdict(e.tiles),
                "requested": e.requested,
                "tiles_from": e.tiles_from,
                "iteration_plan": (
                    e.iteration_plan.as_dict() if e.iteration_plan is not None else None
                ),
            }
            plans.append({
                "plan_key": key[1],
                "container": container,
                "spmv_format": str(prep.spmv_format),
                "engine": engine_cfg,
                "dtypes": dtypes,
                "arrays": arrays,
                **extra,
            })
        state = {
            "schema": _EXPORT_SCHEMA,
            "package": _PACKAGE,
            "repro_version": __version__,
            "matrix_fingerprint": self.ensure_fingerprint(),
            "layout_fingerprint": config_fingerprint(self.cfg, _LAYOUT_FIELDS),
            "layout": {f: repr(getattr(self.cfg, f)) for f in _LAYOUT_FIELDS},
            "n": int(self.n),
            "plans": plans,
        }
        if isinstance(self.csr, DiskCSR):
            state["matrix_ref"] = {
                "kind": "diskcsr",
                "path": self.csr.path,
                "fingerprint": self.ensure_fingerprint(),
            }
        return state

    def import_plans(self, state: dict) -> int:
        """Install plans exported by :meth:`export_state`; returns how many
        were imported.  Containers are rebuilt on the session's device with
        the plain constructors, never the ``to_device_*`` converters, so
        ``conversion_count()`` does not move; the persisted tiles and plan
        ride in, so ``tuner_probe_count()`` does not either.

        Stale or foreign artifacts are rejected, not trusted: a mismatched
        schema, package, version, matrix fingerprint, layout fingerprint or
        dimension warns and returns 0, and the session cold-builds lazily.
        """
        from .. import __version__

        header_checks = (
            ("schema", state.get("schema"), _EXPORT_SCHEMA),
            ("package", state.get("package"), _PACKAGE),
            ("repro_version", state.get("repro_version"), __version__),
            ("matrix_fingerprint", state.get("matrix_fingerprint"), self.ensure_fingerprint()),
            ("layout_fingerprint", state.get("layout_fingerprint"),
             config_fingerprint(self.cfg, _LAYOUT_FIELDS)),
            ("n", state.get("n"), int(self.n)),
        )
        for field, got, want in header_checks:
            if got != want:
                warnings.warn(
                    f"stale persisted session rejected ({field}: saved {got!r} != "
                    f"current {want!r}); falling back to a cold rebuild",
                    stacklevel=2,
                )
                return 0
        imported = 0
        for plan in state.get("plans", ()):
            try:
                prep = _import_plan(plan, int(self.n), self.device)
            except Exception as exc:  # a corrupt payload: warn, keep serving
                warnings.warn(
                    f"corrupt persisted plan {plan.get('plan_key')!r} skipped "
                    f"({type(exc).__name__}: {exc}); it will cold-rebuild on demand",
                    stacklevel=2,
                )
                continue
            key = ("single", str(plan["plan_key"]))
            with self._build_lock:
                if key not in self._prepared:
                    self._prepared[key] = prep
                    imported += 1
        return imported

    # ---------------------------------------------------------- internals

    def _normalize(self, q: EigQuery, idx: int, cfg: SolverConfig) -> _NormQuery:
        def pick(v, dflt):
            return dflt if v is _UNSET else v

        k = int(q.k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if k > self.n:
            raise ValueError(f"k={k} exceeds the operator dimension n={self.n}")
        pol = resolve_policy(q.policy if q.policy is not None else cfg.policy).effective()
        tol_req = pick(q.tol, cfg.tol)
        backend = self._resolve_backend(tol_req)
        reorth_raw = pick(q.reorth, cfg.reorth)
        num_iters = pick(q.num_iters, cfg.num_iters)
        if backend == "restarted":
            if reorth_raw not in (None, "full"):
                warnings.warn(
                    f"reorth={reorth_raw!r} is ignored by the restarted backend: thick "
                    "restart requires full re-orthogonalization to keep the locked Ritz "
                    "block orthogonal",
                    stacklevel=4,
                )
            reorth = "full"
            if num_iters is not None and num_iters < k + 2:
                raise ValueError(
                    f"num_iters={num_iters} cannot fund a restarted solve for k={k} (the "
                    f"subspace needs at least k + 2 = {k + 2} steps); raise num_iters or use "
                    "backend='single'"
                )
        else:
            reorth = _resolve_reorth(reorth_raw, backend)
            if num_iters is not None and num_iters < k:
                # Per query: a merged group's larger subspace must not mask
                # an individually infeasible request.
                raise ValueError(f"num_iters must be >= k (got {num_iters} < {k})")
        max_restarts = int(pick(q.max_restarts, cfg.max_restarts))
        if backend == "restarted" and max_restarts < 1:
            raise ValueError(f"max_restarts must be >= 1, got {max_restarts}")
        jacobi = pick(q.jacobi, cfg.jacobi)
        if jacobi not in JACOBI_PLACEMENTS:
            raise ValueError(f"jacobi must be one of {JACOBI_PLACEMENTS}, got {jacobi!r}")
        recovery = pick(q.recovery, cfg.recovery) or "raise"
        if recovery not in ("none", "raise", "auto"):
            raise ValueError(f"recovery must be 'none', 'raise', or 'auto'; got {recovery!r}")
        seed = int(pick(q.seed, cfg.seed))
        # A v0's key is this query's own until _key_starts finds its equals.
        start_key = f"v0#{idx}" if q.v0 is not None else f"seed:{seed}"
        return _NormQuery(
            idx=idx,
            k=k,
            pol=pol,
            pkey=policy_key(pol),
            backend=backend,
            reorth=reorth,
            tol_req=tol_req,
            tol_eff=tol_req if tol_req is not None else _default_tol(pol),
            num_iters=num_iters,
            m=int(num_iters) if num_iters is not None else k,
            subspace=pick(q.subspace, cfg.subspace),
            max_restarts=max_restarts,
            seed=seed,
            v0=q.v0,
            jacobi=jacobi,
            start_key=start_key,
            recovery=recovery,
            ckpt_dir=cfg.checkpoint_dir,
            ckpt_every=int(cfg.checkpoint_every or 8),
        )

    def _solve_auto(self, rq: EigQuery, cfg: SolverConfig) -> EigenResult:
        """Accuracy-driven policy selection: solve on each rung of
        :func:`auto_ladder`, cheapest first, until the measured residuals
        meet the query's tolerance.  An explicit matrix is judged on f64
        reconstruction residuals ``||A x - lambda x|| / |lambda|`` on the
        host (the Ritz bound converges whatever the storage precision, so it
        cannot expose a too-narrow rung); a matrix-free input on the Ritz
        bounds.  Each rung reuses the session's plan for its dtypes.  The
        trail (policy, max relative residual, what it was judged on, tol,
        accepted) is ``EigenResult.policy_escalations``."""
        attempts: List[dict] = []
        res: Optional[EigenResult] = None
        for rung in auto_ladder():
            nq = self._normalize(dataclasses.replace(rq, policy=rung), 0, cfg)
            ((_, res),) = self._solve_group([nq])
            verified = self._verified_rel_residuals(res)
            if verified is None:
                lam = np.abs(res.eigenvalues.detach().cpu().to(torch.float64).numpy())
                max_rel = float(np.max(res.residuals / np.maximum(lam, 1e-300)))
                accepted = bool(res.all_converged)
                kind = "ritz_bound"
            else:
                max_rel = float(np.max(verified))
                accepted = bool(np.all(verified <= nq.tol_eff))
                kind = "verified"
            attempts.append({"policy": res.policy, "max_residual": max_rel, "residual_kind": kind,
                             "tol": float(nq.tol_eff), "converged": accepted})
            if accepted:
                break
        return dataclasses.replace(res, policy_escalations=attempts)

    def _verified_rel_residuals(self, res: EigenResult) -> Optional[np.ndarray]:
        """(k,) relative residuals ``||A x_i - lambda_i x_i|| / |lambda_i|`` in
        f64 against the host matrix (SciPy); None for matrix-free inputs.
        No normalization by ``||x||``: the Ritz bound's convention."""
        a = self._verify_matrix()
        if a is None:
            return None
        x = res.eigenvectors.detach().cpu().to(torch.float64).numpy()
        lam = res.eigenvalues.detach().cpu().to(torch.float64).numpy()
        r = a @ x - x * lam
        return np.linalg.norm(r, axis=0) / np.maximum(np.abs(lam), 1e-300)

    def _verify_matrix(self):
        """f64 host copy of the matrix for the auto ladder's check, built
        once per session (every rung reuses it); None for matrix-free inputs
        and for a DiskCSR too large to materialize."""
        if self._verify_a is None:
            if isinstance(self.csr, DiskCSR) and self.csr.nbytes_on_disk() > _DISK_VERIFY_MAX_BYTES:
                return None
            if self.csr is not None:
                import scipy.sparse as sp

                csr = self.csr.to_csr() if isinstance(self.csr, DiskCSR) else self.csr
                self._verify_a = sp.csr_matrix(
                    (np.asarray(csr.data, dtype=np.float64), np.asarray(csr.indices),
                     np.asarray(csr.indptr)),
                    shape=csr.shape,
                )
            elif self._dense is not None:
                self._verify_a = _host_array(self._dense).astype(np.float64)
        return self._verify_a

    def _nnz_estimate(self) -> int:
        """Matrix work per matvec for the precision audit: nnz for a sparse
        matrix, n^2 for dense, n for matrix-free (one pass over the vector)."""
        if self.csr is not None:
            return int(self.csr.nnz)
        if self._dense is not None:
            return int(self.n) * int(self.n)
        return int(self.n)

    def _solve_group(self, group: List[_NormQuery]):
        if group[0].recovery == "auto":
            return self._solve_group_recovering(group)
        return self._solve_group_inner(group)

    def _solve_group_inner(self, group: List[_NormQuery], fused_pin: Optional[bool] = None):
        backend, pol = group[0].backend, group[0].pol
        plan: Dict[str, float] = {}
        with span("repro_torch.query.plan", plan, "plan_s"):
            prep, built = self._ensure(backend, pol)
        if not built:
            self.stats["cache_hits"] += 1
        starts: "OrderedDict[str, List[_NormQuery]]" = OrderedDict()
        for q in group:
            starts.setdefault(q.start_key, []).append(q)
        if backend == "restarted":
            out = self._run_restarted(starts, prep, built)
        elif backend == "distributed":
            out = self._run_distributed(starts, prep, built)
        else:
            out = self._run_fixed(starts, prep, built, backend, fused_pin=fused_pin)
        for _, res in out:
            res.timings.update(plan)
        return out

    def _solve_group_recovering(self, group: List[_NormQuery]):
        """``recovery="auto"``: run the group, catching in-solve failures and
        escalating along the reference's axes: a new start vector on a lucky
        breakdown (beta underflow), one :func:`auto_ladder` rung up on a
        non-finite value, the plain update on a kernel error, the chunked
        backend on an allocation failure.  Each action lands in the trail
        that rides out on the results as ``recovery_trail``; an
        unrecoverable (or exhausted) failure re-raises, a
        :class:`NumericalBreakdown` with the trail attached."""
        trail: List[dict] = []
        qs = list(group)
        fused_pin: Optional[bool] = None
        reseeds = 0
        last_exc: Optional[BaseException] = None
        for attempt in range(_MAX_RECOVERY_ATTEMPTS):
            try:
                out = self._solve_group_inner(qs, fused_pin=fused_pin)
            except Exception as exc:
                last_exc = exc
                action = _classify_failure(exc)
                if action is None:
                    raise self._attach_trail(exc, trail)
                entry = {"action": action, "error": f"{type(exc).__name__}: {exc}",
                         "attempt": attempt}
                if isinstance(exc, NumericalBreakdown):
                    entry["kind"] = exc.kind
                    entry["iteration"] = exc.iteration
                if action == "reseed":
                    if reseeds >= _MAX_RESEEDS:
                        raise self._attach_trail(exc, trail)
                    reseeds += 1
                    seed2 = qs[0].seed + 1000 + attempt
                    entry["from"] = _content_key(qs[0])
                    entry["to"] = f"seed:{seed2}"
                    qs = [q._replace(seed=seed2, v0=None, start_key=f"seed:{seed2}") for q in qs]
                elif action == "escalate_policy":
                    nxt = _next_rung(qs[0].pol)
                    if nxt is None:  # already at the top of the ladder
                        raise self._attach_trail(exc, trail)
                    entry["from"] = qs[0].pol.name
                    entry["to"] = nxt.name
                    qs = [q._replace(pol=nxt, pkey=policy_key(nxt)) for q in qs]
                elif action == "unfuse":
                    # The distributed loop has no unfused pin (as in the
                    # reference): a kernel error there re-raises.
                    if fused_pin is False or qs[0].backend == "distributed":
                        raise self._attach_trail(exc, trail)
                    entry["from"] = "fused"
                    entry["to"] = "unfused"
                    fused_pin = False
                elif action == "fallback_chunked":
                    if qs[0].backend == "chunked" or self.csr is None:
                        raise self._attach_trail(exc, trail)
                    entry["from"] = qs[0].backend
                    entry["to"] = "chunked"
                    qs = [q._replace(backend="chunked") for q in qs]
                trail.append(entry)
                self.stats["recoveries"] = self.stats.get("recoveries", 0) + 1
                continue
            if trail:
                out = [(idx, dataclasses.replace(res, recovery_trail=list(trail)))
                       for idx, res in out]
            return out
        raise self._attach_trail(last_exc, trail)

    @staticmethod
    def _attach_trail(exc, trail):
        if isinstance(exc, NumericalBreakdown) and trail:
            exc.recovery_trail = list(trail)
        return exc

    @staticmethod
    def _measured(solve, *args, **kwargs):
        """``(solve(*args, **kwargs), ops per dtype or None)``: with
        ``REPRO_PRECISION_MEASURE=1`` the solve runs under the op counter,
        which changes no bit of its result."""
        if not envcfg.get_bool("REPRO_PRECISION_MEASURE"):
            return solve(*args, **kwargs), None
        from ..analysis.precision_flow import measure_solve

        return measure_solve(solve, *args, **kwargs)

    def _finish(self, q: _NormQuery, prep: _Prepared, built: bool, *, eigenvalues, eigenvectors,
                residuals, evals_f64, iterations, restarts, timings, partition, tridiag,
                group_size, spmv_format=None, measured=None) -> Tuple[int, EigenResult]:
        own: Dict[str, float] = {}
        with span("repro_torch.query.finish", own, "finish_s"):
            # Flags from the engines' f64 eigenvalues, so they agree with the
            # restarted engine's own stopping decision.
            lam = np.abs(np.asarray(evals_f64, dtype=np.float64))
            converged = np.asarray(residuals) <= q.tol_eff * np.maximum(lam, 1e-300)
            t = dict(timings)
            t["solve_s"] = float(t.get("total_s", 0.0))
            # A building call also claims the session's unreported coercion
            # time; a pure execute reports 0.
            t["prepare_s"] = (prep.build_s + self._claim_init_s()) if built else 0.0
            t["total_s"] = t["prepare_s"] + t["solve_s"]
            if group_size > 1:
                t["amortized_over"] = float(group_size)
            part = dict(partition) if partition else {}
            spmv = dict(part.get("spmv") or (prep.engine.describe() if prep.engine is not None
                                             else {"format": prep.spmv_format}))
            # The reuse contract, verified: what THIS call paid.
            spmv["conversions"] = prep.conversions if built else 0
            spmv["tuner_probes"] = prep.tuner_probes if built else 0
            spmv["reused"] = not built
            if prep.engine is not None:
                rec = prep.engine.iteration_plan.as_dict()
                rec["effective"] = resolve_update_mode(q.pol, plan=prep.engine.iteration_plan,
                                                       device=self.device)
                spmv["iteration_plan"] = rec
            # Per-phase precision audit: the phase map this solve ran and a
            # model count of element ops per dtype; with REPRO_PRECISION_MEASURE
            # also the counts the op counter saw this solve execute (the
            # reference traces its operator on the side; here the solve itself
            # ran under the counter).  A distributed plan has the reference's note.
            spmv["precision"] = {
                "policy": q.pol.name,
                "phase_map": q.pol.phase_map(),
                "compensated": bool(q.pol.compensated),
                "uniform": q.pol.is_uniform(),
                "ops_by_dtype": phase_op_counts(q.pol, n=self.n, nnz=self._nnz_estimate(),
                                                m=int(iterations), k=q.k, reorth=q.reorth),
            }
            if envcfg.get_bool("REPRO_PRECISION_MEASURE"):
                spmv["precision"]["ops_by_dtype_measured"] = measured if measured is not None else {
                    "error": "no single-device operator to trace (distributed plan)"}
                spmv["precision"]["counts"] = {
                    "ops_by_dtype": "model: core.precision.phase_op_counts",
                    "ops_by_dtype_measured": "counted: analysis.op_count over this solve",
                }
            part["spmv"] = spmv
            res = EigenResult(
                eigenvalues=eigenvalues,
                eigenvectors=eigenvectors,
                residuals=np.asarray(residuals, dtype=np.float64),
                converged=converged,
                iterations=int(iterations),
                restarts=int(restarts),
                k=q.k,
                n=self.n,
                backend=q.backend,
                policy=q.pol.name,
                tol=q.tol_eff,
                num_devices=self.device_count if q.backend == "distributed" else 1,
                partition=part,
                timings=t,
                spmv_format=spmv_format if spmv_format is not None else prep.spmv_format,
                tridiag=tridiag,
                session_reuse=not built,
            )
        res.timings.update(own)
        return q.idx, res

    @staticmethod
    def _chunked_partition(op: ChunkedOperator, staging_before: dict) -> dict:
        """The chunked result's ``partition``: the plan's shape and this
        call's staging costs (the operator's counters run over a session's
        queries)."""
        staging = op.staging_stats(since=staging_before)
        spmv = op.engine.describe() if op.engine is not None else {"format": "coo"}
        spmv["staging"] = staging
        return {
            "num_chunks": op.num_chunks,
            "stage_depth": op.stage_depth,
            "disk_backed": bool(op.disk_backed),
            "staging": staging,
            "spmv": spmv,
        }

    def _solve_checkpoint(self, q: _NormQuery, pol, backend: str, k: int, m: int):
        """(store, token) for this sweep's snapshots, or None when solve
        checkpointing is off.  The token hashes the matrix fingerprint and
        every parameter that shapes the trajectory, plus ``package``: the
        reference's tokens never name one, so neither package resumes the
        other's snapshot under a shared root.  Budget knobs (max_restarts,
        the snapshot period) stay out, so a run relaunched with another
        budget still resumes."""
        if q.ckpt_dir is None:
            return None
        from ..serving.store import SolveCheckpoint

        store = SolveCheckpoint(q.ckpt_dir)
        token = SolveCheckpoint.token(
            self.ensure_fingerprint(), backend=backend, policy=pol.name, k=k, m=m,
            start=_content_key(q), tol=q.tol_eff, reorth=q.reorth, package="repro_torch",
        )
        return store, token

    def _run_fixed(self, starts, prep: _Prepared, built: bool, backend: str,
                   fused_pin: Optional[bool] = None):
        all_qs = [q for qs in starts.values() for q in qs]
        pol, reorth, jacobi = all_qs[0].pol, all_qs[0].reorth, all_qs[0].jacobi
        chunked = backend == "chunked"
        if len(starts) > 1 and self._vmappable(prep):
            return self._run_fixed_multistart(starts, prep, built, fused_pin)
        out = []
        for qs in starts.values():
            k_max = max(q.k for q in qs)
            m = max(q.m for q in qs)
            staging0 = dict(prep.operator.staging) if chunked else {}
            ckpt = None
            if chunked:  # as in the reference, only the chunked sweep snapshots
                if self.mesh is not None and qs[0].ckpt_dir is not None:
                    raise ValueError("checkpoint_dir= is not supported on the sharded chunk "
                                     "path (mesh= with backend='chunked')")
                pair = self._solve_checkpoint(qs[0], pol, backend, k_max, m)
                if pair is not None:
                    # The operator rides along so the loop can save and
                    # restore its chunk cursor inside a step.
                    ckpt = (*pair, qs[0].ckpt_every, prep.operator)
            sweep, measured = self._measured(
                solve_fixed,
                prep.operator,
                k_max,
                policy=pol,
                reorth=reorth,
                num_iters=m,
                v1=qs[0].v0,
                seed=qs[0].seed,
                jacobi=jacobi,
                ops=prep.ops_for(pol, self.device, fused=fused_pin),
                probe=qs[0].recovery != "none",
                checkpoint=ckpt,
            )
            self.stats["sweeps"] += 1
            partition = self._chunked_partition(prep.operator, staging0) if chunked else {}
            for q in qs:
                out.append(self._finish(
                    q, prep, built,
                    eigenvalues=sweep.eigenvalues[: q.k],
                    eigenvectors=sweep.eigenvectors[:, : q.k],
                    residuals=sweep.residuals[: q.k],
                    evals_f64=sweep.eigenvalues_f64[: q.k],
                    iterations=sweep.iterations,
                    restarts=0,
                    timings=sweep.timings,
                    partition=partition,
                    tridiag=sweep.tridiag,
                    group_size=len(qs),
                    measured=measured,
                ))
        return out

    def _vmappable(self, prep: _Prepared) -> bool:
        """Does this operator's matvec take an ``(n, B)`` block, so one
        sweep can run all start vectors of a group (the reference's name:
        there, what ``jax.vmap`` batches)?  The dense product and the COO
        segmented sum do; the kernel layouts and the chunked operator run
        one start at a time."""
        op = prep.operator
        if isinstance(op, DenseOperator):
            return True
        if isinstance(op, SparseOperator):
            if op.engine is not None:
                return op.engine.format == "coo"
            return op.impl == "coo"
        return False

    def _run_fixed_multistart(self, starts, prep: _Prepared, built: bool,
                              fused_pin: Optional[bool] = None):
        """Multi-start sweeps over the start vectors of a group
        (:func:`~repro_torch.core.lanczos.lanczos_tridiag_multi`), with the
        reference's accounting: one sweep a batch, ``lanczos_s`` shared by
        the batch, ``amortized_over`` the whole group, no health probe, no
        partition.  A group that :func:`_multistart_batch` says does not fit
        one batch runs in several, each start's result as in one.  A query
        without ``v0`` draws from its ``seed`` as a lone sweep does."""
        out = []
        all_qs = [q for qs in starts.values() for q in qs]
        pol, reorth, jacobi = all_qs[0].pol, all_qs[0].reorth, all_qs[0].jacobi
        m = max(q.m for q in all_qs)
        op = prep.operator
        groups = list(starts.values())
        cap = _multistart_batch(op, pol, m, self.device)
        for lo in range(0, len(groups), cap):
            chunk = groups[lo: lo + cap]
            v1s = torch.stack([start_vector(op, pol, qs[0].v0, qs[0].seed).to(pol.compute)
                               for qs in chunk])
            dev = v1s.device
            sweep: Dict[str, float] = {}
            with span("repro_torch.sweep.lanczos", sweep, "lanczos_s"):
                batch, measured = self._measured(
                    lanczos_tridiag_multi, op.bound_matvec(pol), v1s, m, pol, reorth=reorth,
                    ops=prep.ops_for(pol, self.device, fused=fused_pin))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            self.stats["sweeps"] += 1
            for s, qs in enumerate(chunk):
                lres = LanczosResult(alpha=batch.alpha[s], beta=batch.beta[s],
                                     basis=batch.basis[s], beta_last=batch.beta_last[s])
                # lanczos_s is shared across all starts of the batch.
                timings = dict(sweep)
                with span("repro_torch.ritz.jacobi", timings, "jacobi_s"):
                    evals, w, evals_f64, w_f64, beta_m = ritz_decompose(lres, pol, jacobi)
                    k_max = max(q.k for q in qs)
                    evals_k, x, resid = ritz_extract(lres, evals, w, w_f64, beta_m, k_max, pol)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                timings["total_s"] = timings["lanczos_s"] + timings["jacobi_s"]
                for q in qs:
                    out.append(self._finish(
                        q, prep, built,
                        eigenvalues=evals_k[: q.k],
                        eigenvectors=x[:, : q.k],
                        residuals=resid[: q.k],
                        evals_f64=np.asarray(evals_f64[: q.k], dtype=np.float64),
                        iterations=m,
                        restarts=0,
                        timings=timings,
                        partition={},
                        tridiag=lres,
                        group_size=len(all_qs),
                        measured=measured,
                    ))
            del batch
        return out

    def _run_distributed(self, starts, prep: _Prepared, built: bool):
        """One sharded sweep per start vector on the session's shard set."""
        out = []
        for qs in starts.values():
            q0 = qs[0]
            k_max = max(q.k for q in qs)
            m = max(q.m for q in qs)
            sweep = solve_sharded(
                self.csr, k_max, self.mesh, policy=q0.pol, reorth=q0.reorth, num_iters=m,
                seed=q0.seed, axis=self.cfg.axis, v1=q0.v0, prepared=prep.shards,
                probe=q0.recovery != "none", device=self.device,
            )
            self.stats["sweeps"] += 1
            for q in qs:
                out.append(self._finish(
                    q, prep, built,
                    eigenvalues=sweep.eigenvalues[: q.k],
                    eigenvectors=sweep.eigenvectors[:, : q.k],
                    residuals=sweep.residuals[: q.k],
                    evals_f64=sweep.eigenvalues_f64[: q.k],
                    iterations=sweep.iterations,
                    restarts=0,
                    timings=sweep.timings,
                    partition=sweep.partition,
                    tridiag=sweep.tridiag,
                    group_size=len(qs),
                    spmv_format=sweep.spmv_format,
                ))
        return out

    def _run_restarted(self, starts, prep: _Prepared, built: bool):
        out = []
        for qs in starts.values():
            q0 = qs[0]
            k_max = max(q.k for q in qs)
            m = max(q.subspace or max(2 * q.k, q.k + 8) for q in qs)
            m = max(m, k_max + 2)
            max_restarts = max(q.max_restarts for q in qs)
            budgets = [q.num_iters for q in qs]
            if all(b is not None for b in budgets):
                # num_iters is a total step budget: the first cycle costs m
                # steps, each further cycle refills m - k rows; take only the
                # cycles that fit entirely (floor), never overshoot.
                budget = max(budgets)
                m = min(m, budget)
                extra = max(0, math.floor((budget - m) / max(m - k_max, 1)))
                max_restarts = min(max_restarts, extra + 1)
            sweep, measured = self._measured(
                solve_restarted,
                prep.operator,
                k_max,
                policy=q0.pol,
                m=m,
                max_restarts=max_restarts,
                tol=min(q.tol_eff for q in qs),
                seed=q0.seed,
                v1=q0.v0,
                probe=q0.recovery != "none",
                checkpoint=self._solve_checkpoint(q0, q0.pol, "restarted", k_max, m),
            )
            self.stats["sweeps"] += 1
            for q in qs:
                out.append(self._finish(
                    q, prep, built,
                    eigenvalues=sweep.eigenvalues[: q.k],
                    eigenvectors=sweep.eigenvectors[:, : q.k],
                    residuals=sweep.residuals[: q.k],
                    evals_f64=sweep.eigenvalues_f64[: q.k],
                    iterations=sweep.iterations,
                    restarts=sweep.restarts,
                    timings=sweep.timings,
                    partition={},
                    tridiag=sweep.tridiag,
                    group_size=len(qs),
                    measured=measured,
                ))
        return out


# ------------------------------------------------- plan (de)serialization


def _host_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host array, dtype name) of a tensor; bf16 widens to f32 (exact)."""
    t = t.detach().cpu()
    name = str(t.dtype).replace("torch.", "")
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy(), name


def _export_operator(op) -> Optional[Tuple[str, Dict[str, torch.Tensor], dict]]:
    """(container type, tensors, scalar fields) of a single-placement
    operator, or None when it is not persistable (matrix-free, chunked, a
    legacy blocked-ELL tuple)."""
    from ..sparse.formats import DeviceBSR, DeviceCOO, DeviceELL, DeviceHybrid

    if isinstance(op, DenseOperator):
        return "dense", {"a": op.a}, {}
    if not isinstance(op, SparseOperator):
        return None
    m, extra = op.mat, {"impl": op.impl}
    if isinstance(m, DeviceCOO):
        return "coo", {"row": m.row, "col": m.col, "val": m.val, "offsets": m.offsets}, extra
    if isinstance(m, DeviceELL):
        return "ell", {"val": m.val, "col": m.col}, extra
    if isinstance(m, DeviceBSR):
        return "bsr", {"val": m.val, "bcol": m.bcol}, extra
    if isinstance(m, DeviceHybrid):
        tensors = {name: getattr(m, name) for name in
                   ("ell_val", "ell_col", "tail_row", "tail_col", "tail_val", "tail_offsets")}
        return "hybrid", tensors, {**extra, "tail_nnz": int(m.tail_nnz)}
    return None


def _import_plan(plan: dict, n: int, device: torch.device) -> _Prepared:
    """Rebuild a :class:`_Prepared` from one exported plan record on
    ``device``, with the plain container constructors (no conversion) and
    the persisted tiles and plan (no tuner probe)."""
    from ..sparse.formats import DeviceBSR, DeviceCOO, DeviceELL, DeviceHybrid

    dtypes = plan.get("dtypes", {})

    def arr(name):
        t = torch.from_numpy(np.ascontiguousarray(plan["arrays"][name]))
        want = dtypes.get(name)
        if want:
            t = t.to(getattr(torch, want))
        return t.to(device)

    engine = None
    ecfg = plan.get("engine")
    if ecfg:
        ip = ecfg.get("iteration_plan")
        iter_plan = None if not ip else IterationPlan(
            update=ip["update"],
            tiles=TileConfig(block_r=int(ip["block_r"]), block_w=int(ip["block_w"]),
                             block_size=int(ip["block_size"])),
            source=ip.get("source", "tuned"),
        )
        engine = SpmvEngine(
            format=ecfg["format"],
            accum_dtype=getattr(torch, ecfg["accum_dtype"]),
            tiles=TileConfig(**{k: int(v) for k, v in ecfg["tiles"].items()}),
            device=str(device),
            requested=ecfg.get("requested", ecfg["format"]),
            stats=None,
            tiles_from=ecfg.get("tiles_from", "override"),
            iteration_plan=iter_plan,
        )
    ctype = plan["container"]
    if ctype == "dense":
        return _Prepared(DenseOperator(arr("a")), "dense", None)
    if ctype == "coo":
        mat = DeviceCOO(arr("row"), arr("col"), arr("val"), arr("offsets"), n, n)
    elif ctype == "ell":
        mat = DeviceELL(arr("val"), arr("col"), n, n)
    elif ctype == "bsr":
        mat = DeviceBSR(arr("val"), arr("bcol"), n, n)
    elif ctype == "hybrid":
        mat = DeviceHybrid(arr("ell_val"), arr("ell_col"), arr("tail_row"), arr("tail_col"),
                           arr("tail_val"), arr("tail_offsets"), int(plan["tail_nnz"]), n, n)
    else:
        raise ValueError(f"unknown persisted container type {ctype!r}")
    op = SparseOperator(mat, engine=engine, impl=plan.get("impl", "engine"))
    return _Prepared(op, plan.get("spmv_format") or op.spmv_format, engine)


# --------------------------------------------------------------- frontends


def prepare(
    A,
    *,
    config: Optional[SolverConfig] = None,
    n: Optional[int] = None,
    mesh=None,
    policy="FDF",
    backend: str = "auto",
    format: str = "auto",
    reorth: Optional[str] = None,
    tol: Optional[float] = None,
    num_iters: Optional[int] = None,
    subspace: Optional[int] = None,
    max_restarts: int = 30,
    seed: int = 0,
    chunk_nnz: int = 1 << 20,
    stage_depth: int = 1,
    staging: str = "f32",
    jacobi: str = "host",
    axis: str = "data",
    recovery: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 8,
    device: str = "cuda",
) -> EigenSession:
    """Plan phase of :func:`repro_torch.eigsh`: coerce, select, convert, once,
    and return the session; the solver knobs become its per-query defaults.
    The session keeps a reference to the host matrix for lazy per-policy
    builds: do not mutate it in place while holding the session."""
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
    return EigenSession(A, cfg, mesh=mesh, n=n).warmup()


def eigsh_many(A, queries, *, config: Optional[SolverConfig] = None, n: Optional[int] = None,
               mesh=None, **solver_kwargs) -> List[EigenResult]:
    """Module-level batched solve: the cached session (or a fresh one), then
    :meth:`EigenSession.eigsh_many`.  ``solver_kwargs`` are the
    :class:`SolverConfig` fields; queries are dicts, :class:`EigQuery` or ints."""
    cfg = config or SolverConfig(**solver_kwargs)
    session, _ = get_session(A, cfg, mesh=mesh, n=n)
    return session.eigsh_many(queries, defaults=cfg)


# ------------------------------------------------------------ session cache

_SESSION_CACHE: "OrderedDict[str, EigenSession]" = OrderedDict()
_CACHE_LOCK = threading.Lock()  # eigsh() stays safe to call from several threads


def _cache_limit() -> int:
    return envcfg.get_int("REPRO_EIGSH_SESSION_CACHE")


def _cache_budget_bytes() -> int:
    """Byte budget over the cached sessions (default 2048 MB).  A session
    larger than all of it is served but never cached."""
    return int(envcfg.get_float("REPRO_EIGSH_SESSION_CACHE_MB") * 1e6)


def _check_mesh(mesh):
    """``mesh`` if it is None or a ``DeviceMesh``."""
    if mesh is None:
        return None
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got {type(mesh).__name__}")
    return mesh


def _mesh_key(mesh) -> str:
    """The mesh part of a session's identity: its dimension names, the
    ranks of its group, its device type and backend; without a mesh, the
    default group's size and backend (what the default mesh would be)."""
    if mesh is None:
        comm = ShardComm()
        return f"mesh:none:world{comm.size}:{comm.backend}"
    ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
    backend = torch.distributed.get_backend(mesh.get_group())
    return f"mesh:{tuple(mesh.mesh_dim_names)}:{ranks}:{mesh.device_type}:{backend}"


def _session_key(matrix_fp: str, cfg: SolverConfig, mesh=None) -> str:
    # The staging pin rebuilds the chunked operator, so it is part of the
    # session identity: flipping it between calls must not serve the old plan.
    staging_pin = envcfg.raw("REPRO_CHUNK_STAGING") or ""
    layout = config_fingerprint(cfg, _LAYOUT_FIELDS)
    return "|".join((matrix_fp, layout, _mesh_key(mesh), f"staging_pin:{staging_pin}"))


def _cache_lookup(key: str) -> Optional[EigenSession]:
    with _CACHE_LOCK:
        hit = _SESSION_CACHE.get(key)
        if hit is not None:
            _SESSION_CACHE.move_to_end(key)
        return hit


def _evict(victims: List[EigenSession]) -> None:
    for s in victims:
        s.release()


def _cache_enforce_budget() -> None:
    """Evict least recently used sessions until the cache fits its byte
    budget (on store, and after a lazy plan build grew a cached session)."""
    budget = _cache_budget_bytes()
    victims = []
    with _CACHE_LOCK:
        while _SESSION_CACHE and sum(s.approx_bytes() for s in _SESSION_CACHE.values()) > budget:
            victims.append(_SESSION_CACHE.popitem(last=False)[1])
    _evict(victims)


def _cache_store(key: str, session: EigenSession) -> None:
    if session.approx_bytes() > _cache_budget_bytes():
        return  # larger than the whole budget: serve it, do not pin it
    session._own_data()  # cached plans must not alias caller-mutable buffers
    victims = []
    with _CACHE_LOCK:
        _SESSION_CACHE[key] = session
        while len(_SESSION_CACHE) > _cache_limit():
            victims.append(_SESSION_CACHE.popitem(last=False)[1])
    _evict(victims)
    _cache_enforce_budget()


def get_session(A, config: Optional[SolverConfig] = None, *, mesh=None,
                n: Optional[int] = None) -> Tuple[EigenSession, bool]:
    """Session for (matrix, layout config): from the LRU when the input has
    hashable bytes (CSR, dense, DiskCSR, scipy), a fresh one otherwise.

    Returns ``(session, cache_hit)``.  CSR, dense and disk inputs are probed
    by their digest BEFORE any coercion, so a hit pays one hash and nothing
    else; scipy inputs pay their ``tocsr`` copy first.  At most
    ``REPRO_EIGSH_SESSION_CACHE`` sessions (default 8; 0 disables) within
    ``REPRO_EIGSH_SESSION_CACHE_MB``.  Mutating a matrix in place changes
    its digest, so a stale plan is never served.
    """
    cfg = config or SolverConfig()
    device = resolve_device(cfg.device)  # fail fast without a card
    limit = _cache_limit()
    key = fp = None
    if limit > 0 and (
        isinstance(A, (CSR, np.ndarray, torch.Tensor, DiskCSR))
        or (isinstance(A, (str, os.PathLike)) and is_diskcsr(A))
    ):
        fp = matrix_fingerprint(A)
        if fp is not None:
            key = _session_key(fp, cfg, _check_mesh(mesh))
            hit = _cache_lookup(key)
            if hit is not None:
                return hit, True
    ci = coerce_input(A, n=n, storage_dtype=_plan_policy(cfg.policy).storage, device=device,
                      fingerprint=fp, want_fingerprint=limit > 0)
    if key is None and limit > 0 and ci.fingerprint is not None:
        key = _session_key(ci.fingerprint, cfg, mesh)
        hit = _cache_lookup(key)
        if hit is not None:
            return hit, True
    session = EigenSession(A, cfg, mesh=mesh, n=n, _coerced=ci)
    if key is not None:
        _cache_store(key, session)
    return session, False


def session_cache_clear() -> None:
    """Drop every cached session and its plans (and so their device memory)."""
    with _CACHE_LOCK:
        victims = list(_SESSION_CACHE.values())
        _SESSION_CACHE.clear()
    _evict(victims)


# Cached sessions may hold a DeviceMesh: drop them while the interpreter is
# still whole, or a process group that outlived destroy_process_group is
# destroyed during finalization, which aborts the process.
atexit.register(session_cache_clear)


def session_cache_info() -> dict:
    with _CACHE_LOCK:
        size = len(_SESSION_CACHE)
        total = sum(s.approx_bytes() for s in _SESSION_CACHE.values())
    return {"size": size, "limit": _cache_limit(), "bytes": total,
            "budget_bytes": _cache_budget_bytes()}
