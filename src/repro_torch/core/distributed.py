"""Multi-device Top-K eigensolver (the paper's §III-A partition scheme).

The reference (``repro/core/distributed.py``) runs one controller over a
``jax.sharding.Mesh`` with the Lanczos loop inside one ``shard_map``.  The
port runs SPMD over ``torch.distributed``, one process per rank:

  paper                                 | here
  --------------------------------------+----------------------------------
  row partitions balanced by nnz        | ``core/partition.py``; each rank
                                        | converts and uploads its own shard
  every vector partitioned like M       | vectors live as (n_pad,) locals
  SpMV input v_i replicated per GPU     | one all-gather of x per iteration
  sync points alpha / beta (A / B)      | two scalar reductions per iteration
  reorth sync (C)                       | one vector reduction per reorth pass
  out-of-core unified memory            | ChunkedOperator(mesh=) (operators.py)

Every rank calls ``eigsh`` on the same host matrix and returns the whole
result: X is reassembled from the ranks' ``(n_pad, k)`` blocks by one
all-gather after the loop.

:class:`ShardComm` holds the collectives of a solve, over the group of a
1-D ``DeviceMesh`` axis, the default process group, or (with neither) a
world of one that calls nothing.  A reduction all-gathers the G partials
and sums them in shard order in the phase dtype, so every rank gets the
same bits under gloo and NCCL alike: each rank runs the host Jacobi on its
own tridiagonal, and ranks that differed in the last bit of alpha would
return different eigenvectors.  ``ShardComm.calls`` counts the calls (the
per-iteration budget: one all-gather, two scalar reductions, one vector
reduction per reorth pass).  Under gloo a CUDA tensor travels through the
host (the collective copies it out and back); under NCCL it stays on the
card.

The per-shard SpMV runs the port's kernels through the
:class:`~repro_torch.kernels.engine.SpmvEngine`: ELL, BSR or the hybrid hub
split, chosen by ``format="auto"`` from per-shard statistics
(``kernels.engine.shard_stats``); COO stays an explicit opt-out.  With
``REPRO_SPMV_TUNE=1`` rank 0 tunes and broadcasts its engine (tiles and
iteration plan) before any rank converts: ranks that chose different update
modes would run different sequences of collectives and deadlock.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..analysis.op_count import host_scope
from ..kernels import ops as kops
from ..kernels.engine import SpmvEngine, make_engine, shard_stats
from ..sparse.formats import (
    CSR,
    DeviceBSR,
    DeviceCOO,
    DeviceELL,
    _offsets,
    shard_hybrid_container,
    shard_to_blocked_ell,
    shard_to_ell,
    shard_to_hybrid,
)
from ..testing import faults as _faults
from .eigensolver import EigResult
from .jacobi import jacobi_eigh_host, tridiag_to_dense
from .lanczos import (
    LanczosResult,
    Ops,
    _lanczos_loop,
    _local_reduce,
    check_tridiag_health,
    resolve_update_mode,
)
from .partition import PartitionedMatrix, nnz_balanced_splits, partition_matrix
from .precision import FDF, PrecisionPolicy

__all__ = [
    "DISTRIBUTED_FORMATS",
    "ShardComm",
    "PreparedShards",
    "prepare_sharded",
    "ShardedSolveOutput",
    "solve_sharded",
    "topk_eigs_sharded",
    "sharded_lanczos",
]

# Formats the distributed hot loop may auto-select: kernel-backed only (the
# paper's design point; hybrid's tail is bounded by the hub split).  "coo"
# stays available as an explicit request.
DISTRIBUTED_FORMATS = ("ell", "bsr", "hybrid")


def _ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` in shard order (a left fold), the same
    association on every rank and for every backend."""
    acc = parts[0]
    for g in range(1, parts.shape[0]):
        acc = acc + parts[g]
    return acc


class ShardComm:
    """The collectives of one sharded solve (see the module doc).

    ``mesh`` is a 1-D ``DeviceMesh`` whose dimension ``axis`` names the
    group; without one, the default group, or, when there is none, a world
    of one whose collectives return their input.  The group is looked up at
    each call, never held: a cached session that kept a ProcessGroup past
    ``destroy_process_group`` would run its destructor at interpreter exit,
    which aborts the process.  ``calls`` is a process-wide census of the
    calls, like the kernels' launch counters.  ``take_seconds`` returns the
    time spent in collectives since the last take: CUDA events around each
    call on the card (no sync until the take), the host clock on the CPU.
    """

    calls = {"all_gather": 0, "reduce_scalar": 0, "reduce_vector": 0, "gather_x": 0,
             "broadcast": 0}

    def __init__(self, mesh=None, axis: str = "data"):
        if mesh is not None:
            names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
            if axis not in names:
                raise ValueError(f"mesh has no dimension named {axis!r} (its names: {names})")
            if mesh.ndim != 1:
                raise ValueError(f"the distributed backend takes a 1-D mesh, got {mesh.ndim} dims")
        self._mesh, self._axis = mesh, axis
        self.local = mesh is None and not (dist.is_available() and dist.is_initialized())
        if self.local:
            self.size, self.rank, self.backend = 1, 0, "none"
        else:
            group = self.group
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.backend = str(dist.get_backend(group))
        self._events = []
        self._host_s = 0.0

    @property
    def group(self):
        """The process group of the collectives (None: the default group)."""
        return None if self._mesh is None else self._mesh.get_group(self._axis)

    @staticmethod
    def reset_calls() -> None:
        for key in ShardComm.calls:
            ShardComm.calls[key] = 0

    # ------------------------------------------------------------ transport

    def _timed(self, fn, device: torch.device):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            self._events.append((start, end))
            return out
        t0 = time.perf_counter()
        out = fn()
        self._host_s += time.perf_counter() - t0
        return out

    def take_seconds(self) -> float:
        """Seconds spent in collectives since the last call (syncs on the
        recorded events)."""
        s = self._host_s
        for start, end in self._events:
            end.synchronize()
            s += start.elapsed_time(end) / 1e3
        self._events, self._host_s = [], 0.0
        return s

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(G * len(t), ...)``: every rank's ``t`` in rank order."""
        t = t.contiguous()

        def run():
            # gloo stages a CUDA tensor through the host; NCCL keeps it on the card.
            src = t.cpu() if (self.backend == "gloo" and t.is_cuda) else t
            out = src.new_empty((self.size * src.shape[0], *src.shape[1:]))
            gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
            gather(out, src, group=self.group)
            return out.to(t.device)

        return self._timed(run, t.device)

    # ---------------------------------------------------------- collectives

    def all_gather(self, x_local: torch.Tensor) -> torch.Tensor:
        """The replicated SpMV input: ``(n_pad,)`` locals -> ``(G * n_pad,)``."""
        ShardComm.calls["all_gather"] += 1
        return x_local if self.local else self._gather(x_local)

    def reduce_scalar(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of a 0-d partial over the ranks (sync points A and B)."""
        ShardComm.calls["reduce_scalar"] += 1
        if self.local:
            return x
        return _ordered_sum(self._gather(x.reshape(1)))

    def reduce_vector(self, v: torch.Tensor) -> torch.Tensor:
        """Sum of a ``(k,)`` partial over the ranks (sync point C)."""
        ShardComm.calls["reduce_vector"] += 1
        if self.local:
            return v
        return _ordered_sum(self._gather(v).view(self.size, -1))

    def gather_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """``(G, *x.shape)``: every rank's block (the reassembly of X)."""
        ShardComm.calls["gather_x"] += 1
        if self.local:
            return x[None]
        return self._gather(x).view(self.size, *x.shape)

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s picklable ``obj`` on every rank."""
        ShardComm.calls["broadcast"] += 1
        if self.local:
            return obj
        box, group = [obj], self.group
        if group is None:
            dist.broadcast_object_list(box, src=src)
        else:
            dist.broadcast_object_list(box, src=dist.get_global_rank(group, src), group=group)
        return box[0]


# ------------------------------------------------------------------- ops


def _make_sharded_ops(mat, n_pad: int, policy: PrecisionPolicy, comm: ShardComm,
                      engine: SpmvEngine, reorth: str) -> Ops:
    """The Lanczos kernel set of one rank's shard.  The norm of a fused
    update is reduced only when the loop uses it (``reorth="none"``; with
    re-orthogonalization the loop recomputes beta after the projection, and
    an extra reduction would break the paper's budget)."""
    cdt, sdt = policy.compute, policy.storage
    abdt = policy.phase_dtype("alpha_beta")
    rdt = policy.phase_dtype("reorth")
    acc = policy.phase_dtype("spmv")
    need_norm = reorth == "none"

    def matvec(x_local):
        # Replicate the SpMV input: the paper's round-robin partition swap.
        return engine.spmv(mat, comm.all_gather(x_local), accum_dtype=acc).to(cdt)

    def dot(a, b):
        local = _local_reduce(a.to(abdt) * b.to(abdt), policy, abdt)
        return comm.reduce_scalar(local).to(cdt)  # sync point A / B

    def project_out(basis, u, mask):
        basis_c = basis.to(rdt) * mask.to(rdt)[:, None]  # ONE (m, n_pad) cast
        # u rounds through the storage dtype first, as on one device.
        coeffs = comm.reduce_vector(basis_c @ u.to(sdt).to(rdt))  # sync point C
        return (u.to(rdt) - coeffs @ basis_c).to(cdt)

    dev = mat.val.device if hasattr(mat, "val") else mat.ell_val.device
    mode = resolve_update_mode(policy, plan=engine.iteration_plan, device=dev)
    fused_iteration = None
    if mode == "fused_spmv" and isinstance(mat, DeviceELL) and acc == cdt:
        zero = torch.zeros((), dtype=cdt, device=dev)

        def fused_iteration(v, v_prev, beta):
            x_full = comm.all_gather(v.to(sdt))
            w, a_loc = kops.spmv_ell_alpha(mat, x_full, v, accum_dtype=acc)
            alpha = comm.reduce_scalar(a_loc).to(cdt)  # sync point A
            # The beta term needs no alpha: (w - beta v_prev) - alpha v, the
            # reference's association on this path.
            t = w.to(cdt) - beta * v_prev
            u, nrm = kops.lanczos_update(t, v, v, alpha, zero, accum_dtype=cdt)
            if need_norm:
                nrm = comm.reduce_scalar(nrm)  # sync point B
            return u, alpha, nrm

    fused_update = None
    if fused_iteration is None and mode in ("fused", "fused_spmv"):

        def fused_update(w, v, v_prev, alpha, beta):
            u, nrm = kops.lanczos_update(w, v, v_prev, alpha, beta, accum_dtype=cdt)
            if need_norm:
                nrm = comm.reduce_scalar(nrm)  # sync point B
            return u, nrm

    return Ops(matvec=matvec, dot=dot, project_out=project_out,
               fused_update=fused_update, fused_iteration=fused_iteration)


def _coo_shard(pm: PartitionedMatrix, i: int) -> DeviceCOO:
    """The segmented-sum container of held shard ``i`` of ``pm``."""
    nnz = pm.nnz[i]
    row = pm.row[i, :nnz]
    return DeviceCOO(
        row=row, col=pm.col[i, :nnz], val=pm.val[i, :nnz],
        offsets=torch.from_numpy(_offsets(row.cpu().numpy(), pm.n_pad)).to(row.device),
        n_rows=pm.n_pad, n_cols=pm.num_shards * pm.n_pad,
    )


def sharded_lanczos(
    pm: PartitionedMatrix,
    v1_padded: torch.Tensor,
    num_iters: int,
    policy: PrecisionPolicy,
    mesh=None,
    reorth: str = "full",
    axis: str = "data",
    engine: Optional[SpmvEngine] = None,
    mats=None,
    comm: Optional[ShardComm] = None,
) -> LanczosResult:
    """Run this rank's part of the distributed Lanczos loop.

    ``v1_padded`` is the start vector in the ``(G, n_pad)`` layout (or this
    rank's ``(n_pad,)`` row); ``mats`` this rank's shard container in
    ``engine.format`` (default: the COO triplets of ``pm``, which must hold
    the rank's shard).  The result's ``basis`` is the rank's ``(m, n_pad)``
    block; alpha and beta are the reduced, rank-identical scalars.
    ``comm`` (default: the mesh's) records the collectives' time.
    """
    policy = policy.effective()
    comm = comm or ShardComm(mesh, axis)
    _faults.check_sweep_entry()
    if mats is None:
        mats = _coo_shard(pm, pm.shards.index(comm.rank))
    if engine is None:
        engine = SpmvEngine(format="coo", accum_dtype=policy.phase_dtype("spmv"),
                            device=str(pm.row.device))
    v1 = v1_padded[comm.rank] if v1_padded.dim() == 2 else v1_padded
    ops = _make_sharded_ops(mats, pm.n_pad, policy, comm, engine, reorth)
    # The loop is eager: the fault taps count their own firing, which is
    # what the reference's consume_lanczos does after its one launch.
    return _lanczos_loop(v1, ops, num_iters, policy, reorth)


# ------------------------------------------------------------------ plan


class PreparedShards(NamedTuple):
    """Plan-time product of the distributed engine: the nnz-balanced
    partition, the held shards' SpMV containers in the engine's format, and
    the engine (tiles + accum dtype).  Building one is the whole per-matrix
    setup of :func:`solve_sharded`; reusing it (``api/session.py``) skips
    every conversion."""

    pm: PartitionedMatrix
    mats: tuple  # one container per held shard (pm.shards)
    engine: SpmvEngine
    spmv_meta: dict  # engine.describe() + conversion stats
    convert_s: float  # partition + conversion wall time


def _shared_engine(csr: CSR, splits, g: int, policy: PrecisionPolicy, spmv_format: str,
                   device, comm: Optional[ShardComm]) -> SpmvEngine:
    """Rank 0's engine on every rank (with the receiving rank's device)."""
    engine = None
    if comm is None or comm.rank == 0:
        allowed = DISTRIBUTED_FORMATS if spmv_format == "auto" else ("coo",) + DISTRIBUTED_FORMATS
        engine = make_engine(
            csr, spmv_format,
            stats=shard_stats(csr, splits, with_blocks=(spmv_format == "auto")),
            accum_dtype=policy.phase_dtype("spmv"), allowed=allowed,
            storage_dtype=policy.storage, device=device,
        )
    if comm is not None and not comm.local:
        engine = comm.broadcast_object(engine)
    return dataclasses.replace(engine, device=str(torch.device(device)))


def prepare_sharded(
    csr: CSR,
    g: int,
    policy: PrecisionPolicy = FDF,
    spmv_format: str = "auto",
    engine: Optional[SpmvEngine] = None,
    *,
    shards=None,
    device="cuda",
    comm: Optional[ShardComm] = None,
) -> PreparedShards:
    """Partition + convert a CSR for a ``g``-shard distributed solve.

    The plan half of :func:`solve_sharded`: a function of (matrix, shard
    count, dtypes, format) only, so one ``PreparedShards`` serves any number
    of solves.  ``shards`` are the shards this process converts (default:
    the rank of ``comm``, or all ``g`` without one); with ``comm``, rank 0
    builds the engine and broadcasts it.
    """
    policy = policy.effective()
    t0 = time.perf_counter()
    splits = nnz_balanced_splits(csr.indptr, g)
    if engine is None:
        engine = _shared_engine(csr, splits, g, policy, spmv_format, device, comm)
    if shards is None:
        shards = (comm.rank,) if comm is not None else tuple(range(g))
    fmt, tiles = engine.format, engine.tiles
    row_align = {"ell": tiles.block_r, "hybrid": tiles.block_r, "bsr": tiles.block_size}.get(fmt, 1)
    pm = partition_matrix(csr, g, dtype=policy.storage, row_align=row_align,
                          with_coo=(fmt == "coo"), splits=splits, shards=shards, device=device)
    n_pad, n_cols, sdt = pm.n_pad, g * pm.n_pad, policy.storage
    spmv_meta = engine.describe()
    if fmt == "ell":
        val, col, stats = shard_to_ell(csr, splits, n_pad, dtype=sdt, row_tile=tiles.block_r,
                                       slot_tile=tiles.block_w, shards=shards, device=device)
        mats = tuple(DeviceELL(val[i], col[i], n_pad, n_cols) for i in range(len(shards)))
    elif fmt == "bsr":
        val, bcol, stats = shard_to_blocked_ell(csr, splits, n_pad, block_size=tiles.block_size,
                                                dtype=sdt, shards=shards, device=device)
        mats = tuple(DeviceBSR(val[i], bcol[i], n_pad, n_cols) for i in range(len(shards)))
    elif fmt == "hybrid":
        cap = max(s.hyb_width for s in engine.stats) if engine.stats else None
        stacked, stats = shard_to_hybrid(csr, splits, n_pad, dtype=sdt, width_cap=cap,
                                         row_tile=tiles.block_r, slot_tile=tiles.block_w,
                                         shards=shards, device=device)
        spill = np.maximum(csr.row_nnz() - stats["width_cap"], 0)
        mats = tuple(
            shard_hybrid_container(stacked, i, int(spill[splits[s]:splits[s + 1]].sum()), n_pad,
                                   n_cols)
            for i, s in enumerate(shards))
    else:
        stats = {}
        mats = tuple(_coo_shard(pm, i) for i in range(len(shards)))
    spmv_meta.update(stats)
    return PreparedShards(pm=pm, mats=mats, engine=engine, spmv_meta=spmv_meta,
                          convert_s=time.perf_counter() - t0)


# ----------------------------------------------------------------- solve


class ShardedSolveOutput(NamedTuple):
    """Raw engine output consumed by the ``eigsh`` frontend (every rank
    holds the whole of it)."""

    eigenvalues: torch.Tensor  # (k,) output dtype
    eigenvectors: torch.Tensor  # (n, k) output dtype
    residuals: np.ndarray  # (k,) float64 — Ritz residual bounds
    eigenvalues_f64: np.ndarray  # (k,) float64 — before the output cast
    tridiag: LanczosResult  # basis: this rank's (m, n_pad) block
    iterations: int
    partition: dict  # num_shards / n_pad / splits / axis / spmv
    timings: dict
    spmv_format: tuple = ()  # per-shard executed SpMV format


def solve_sharded(
    csr: CSR,
    k: int,
    mesh=None,
    policy: PrecisionPolicy = FDF,
    reorth: str = "full",
    num_iters: Optional[int] = None,
    seed: int = 0,
    axis: str = "data",
    v1=None,
    spmv_format: str = "auto",
    engine: Optional[SpmvEngine] = None,
    prepared: Optional[PreparedShards] = None,
    probe: bool = True,
    device="cuda",
) -> ShardedSolveOutput:
    """End-to-end distributed Top-K eigensolver, this rank's part of it.

    ``mesh`` is a 1-D ``DeviceMesh`` with the dimension ``axis`` (default:
    the default process group, or a world of one).  ``spmv_format``:
    "auto" picks ELL, BSR or hybrid from per-shard statistics; "ell" /
    "bsr" / "hybrid" force one; "coo" opts into the segmented-sum path.
    ``prepared`` (see :func:`prepare_sharded`) skips the plan phase.  The
    default start vector is ``np.random.default_rng(seed)``'s, as in the
    reference.  ``timings["collective_s"]`` is the loop's time in
    collectives, by CUDA events around each call on the card (the host
    clock on the CPU); ``timings["lanczos_s"]`` is on the host clock.
    """
    policy = policy.effective()
    comm = ShardComm(mesh, axis)
    g = comm.size
    m = num_iters or k
    dev = torch.device(device)

    t_conv0 = time.perf_counter()
    if prepared is None:
        prepared = prepare_sharded(csr, g, policy, spmv_format, engine=engine, device=dev,
                                   comm=comm)
        t_convert = prepared.convert_s
    else:
        t_convert = 0.0  # plan reused: this call pays no conversion
    pm, engine, spmv_meta = prepared.pm, prepared.engine, dict(prepared.spmv_meta)
    if pm.num_shards != g or comm.rank not in pm.shards:
        raise ValueError(f"prepared shards {pm.shards} of {pm.num_shards} do not fit rank "
                         f"{comm.rank} of {g}")
    mat = prepared.mats[pm.shards.index(comm.rank)]

    if v1 is None:
        v1 = np.random.default_rng(seed).standard_normal(csr.n)
    v1 = v1 if isinstance(v1, torch.Tensor) else torch.as_tensor(np.asarray(v1))
    if tuple(v1.shape) != (csr.n,):
        raise ValueError(f"start vector has shape {tuple(v1.shape)}, expected ({csr.n},)")
    lo, hi = pm.rows_of(comm.rank)
    v1_local = torch.zeros(pm.n_pad, dtype=policy.compute, device=dev)
    v1_local[: hi - lo] = v1[lo:hi].to(device=dev, dtype=policy.compute)

    t0 = time.perf_counter()
    lres = sharded_lanczos(pm, v1_local, m, policy, reorth=reorth, engine=engine, mats=mat,
                           comm=comm)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if probe:
        check_tridiag_health(lres, policy)  # reduced scalars only: every rank agrees
    t_lanczos = time.perf_counter() - t0
    t_collective = comm.take_seconds()

    t1 = time.perf_counter()
    with host_scope():  # NumPy work, as in the reference: not counted
        alpha = lres.alpha.cpu().to(torch.float64).numpy()
        beta = lres.beta.cpu().to(torch.float64).numpy()
        evals, w = jacobi_eigh_host(tridiag_to_dense(alpha, beta))
    t_jacobi = time.perf_counter() - t1

    # X = V^T W on this rank's rows, gathered, then stripped of padding.
    t2 = time.perf_counter()
    rzdt = policy.phase_dtype("ritz")
    w_k = torch.as_tensor(np.ascontiguousarray(w[:, :k])).to(device=dev, dtype=rzdt)
    # Cast before the gather: the same values, in fewer bytes on the wire.
    x_local = (lres.basis.to(rzdt).T @ w_k).to(policy.output)
    x = pm.unpad_vector(comm.gather_blocks(x_local))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_project = time.perf_counter() - t2

    with host_scope():
        beta_m = float(lres.beta_last.cpu().to(torch.float64))
    residuals = np.abs(beta_m * np.asarray(w, dtype=np.float64)[m - 1, :k])
    splits = pm.splits()
    return ShardedSolveOutput(
        eigenvalues=torch.as_tensor(evals[:k]).to(device=dev, dtype=policy.output),
        eigenvectors=x,
        residuals=residuals,
        eigenvalues_f64=np.asarray(evals[:k], dtype=np.float64),
        tridiag=lres,
        iterations=m,
        partition={
            "num_shards": int(g),
            "n_pad": int(pm.n_pad),
            "splits": [int(s) for s in splits],
            "axis": axis,
            "spmv": spmv_meta,
        },
        timings={
            "convert_s": t_convert,
            "lanczos_s": t_lanczos,
            "collective_s": t_collective,
            "jacobi_s": t_jacobi,
            "project_s": t_project,
            "total_s": time.perf_counter() - t_conv0,
        },
        spmv_format=(engine.format,) * int(g),
    )


def topk_eigs_sharded(
    csr: CSR,
    k: int,
    mesh=None,
    policy: PrecisionPolicy = FDF,
    reorth: str = "full",
    num_iters: Optional[int] = None,
    seed: int = 0,
    axis: str = "data",
    device: str = "cuda",
) -> EigResult:
    """Deprecated: use :func:`repro_torch.eigsh` with ``backend="distributed"``."""
    warnings.warn(
        "topk_eigs_sharded is deprecated; use "
        "repro_torch.eigsh(csr, k, backend='distributed', mesh=mesh, ...)",
        DeprecationWarning,
        stacklevel=2,
    )
    from ..api import eigsh

    res = eigsh(csr, k, policy=policy, backend="distributed", reorth=reorth, num_iters=num_iters,
                seed=seed, mesh=mesh, axis=axis, device=device)
    return EigResult(eigenvalues=res.eigenvalues, eigenvectors=res.eigenvectors,
                     tridiag=res.tridiag, wall_time_s=res.timings["total_s"])
