"""Precision-flow verifier: the declared phase map against what a run executes.

The reference traces its solver callables to jaxprs; the port runs them,
under the op counter of :mod:`.op_count` (aten ops per float dtype, the
kernels' declared contracts in place of their hidden arithmetic).  For each
engine (single, restarted, distributed, chunked) and each update mode the
port resolves (``unfused``, ``fused``, ``fused_spmv``) it runs the actual
callables (the ops record of ``core.lanczos.ops_for_operator`` or
``core.distributed._make_sharded_ops``, the restarted engine's
``restart_kernels``, the real solve) on a small problem and checks:

  * **P003** per compute phase: every float arithmetic op of the phase runs
    in the declared phase dtype or the storage dtype;
  * **P001** over the whole solve: every widening conversion lands in a
    dtype the policy declares somewhere;
  * **P002** over the whole solve: a value cast down and back up only
    through the storage dtype or a declared phase dtype;
  * **P004**: the measured per-dtype op counts agree with the
    ``phase_op_counts`` model under its ``executed=True`` convention
    (:func:`core.precision.assert_phase_count_parity`).

The mode is pinned through the engine's iteration plan and the ``fused=``
pin of ``ops_for_operator``, never through the environment.  The executed
nnz is the kernels' own: ELL pads rows and width to 8 (the reference pads
to 128 lanes).  The restarted engine counts one cycle of ``m`` steps; the
distributed engine runs a world of one in this process, the counterpart of
the reference's one-device ``shard_map``.

The counts of a session's own solve are what ``REPRO_PRECISION_MEASURE=1``
surfaces as ``partition["spmv"]["precision"]["ops_by_dtype_measured"]``
(:func:`measure_session_ops`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..core.precision import (
    PHASES,
    POLICIES,
    PrecisionPolicy,
    assert_phase_count_parity,
    dtype_name,
    phase_op_counts,
)
from .findings import Finding, Findings
from .op_count import Conversion, OpCounter, measure

__all__ = [
    "ENGINES",
    "RUNGS",
    "MODES",
    "ENGINE_MODES",
    "policy_dtypes",
    "find_upcasts",
    "find_double_rounding",
    "find_phase_leaks",
    "trace_phases",
    "measure_ops_by_dtype",
    "measure_session_ops",
    "check_run",
    "check_policy",
    "run",
]

ENGINES = ("single", "restarted", "distributed", "chunked")
# The five paper/TPU rungs the sweep covers (the compensated rungs are
# covered by tests; HFF aliases BFF structurally).
RUNGS = ("BFF", "FFF", "FCF", "FDF", "DDD")
MODES = ("unfused", "fused", "fused_spmv")
# The update modes each engine resolves: the restarted engine has no fused
# step, and a chunked operator has no resident ELL for spmv_ell_alpha.
ENGINE_MODES = {
    "single": MODES,
    "restarted": ("unfused",),
    "distributed": MODES,
    "chunked": ("unfused", "fused"),
}
_FUSED_PIN = {"unfused": False, "fused": True, "fused_spmv": None}

_FLOAT_SIZES = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8,
                "float8_e4m3fn": 1, "float8_e5m2": 1}


def _size(name: str) -> int:
    return _FLOAT_SIZES.get(name, 4)


def _policy(policy) -> PrecisionPolicy:
    return (POLICIES[policy] if isinstance(policy, str) else policy).effective()


def policy_dtypes(policy: PrecisionPolicy) -> set:
    """Every dtype name the policy declares anywhere."""
    p = policy
    names = {dtype_name(p.storage), dtype_name(p.compute), dtype_name(p.output)}
    names.update(dtype_name(p.phase_dtype(ph)) for ph in PHASES)
    return names


def find_upcasts(convs: Iterable[Conversion], policy: PrecisionPolicy,
                 context: str = "") -> Findings:
    """P001: widening conversions into undeclared dtypes."""
    declared = policy_dtypes(policy)
    out: List[Finding] = []
    seen = set()
    for conv in convs:
        if _size(conv.dst) > _size(conv.src) and conv.dst not in declared:
            if (conv.src, conv.dst) in seen:
                continue
            seen.add((conv.src, conv.dst))
            out.append(Finding(
                "P001",
                f"upcast {conv.src} -> {conv.dst}, but {conv.dst} is not"
                f" declared anywhere in policy {policy.name}",
                context=context,
            ))
    return out


def find_double_rounding(convs: Iterable[Conversion], policy: PrecisionPolicy,
                         context: str = "") -> Findings:
    """P002: down-then-up cast chains through an undeclared narrow dtype."""
    declared = policy_dtypes(policy)
    out: List[Finding] = []
    seen = set()
    for conv in convs:
        if conv.prev_src is None:
            continue
        a, b, c = conv.prev_src, conv.src, conv.dst
        if _size(b) < _size(a) and _size(c) > _size(b) and b not in declared:
            if (a, b, c) in seen:
                continue
            seen.add((a, b, c))
            out.append(Finding(
                "P002",
                f"value rounded {a} -> {b} -> {c}; the intermediate {b} is"
                f" not the storage or any declared phase dtype of {policy.name}",
                context=context,
            ))
    return out


def find_phase_leaks(counts: Dict[str, int], policy: PrecisionPolicy, phase: str,
                     context: str = "", min_share: float = 0.01) -> Findings:
    """P003: arithmetic in a dtype foreign to the declared phase.

    Allowed in a phase's run: the declared phase dtype and the storage dtype.
    Anything else carrying at least ``min_share`` of the phase's ops leaks.
    """
    allowed = {dtype_name(policy.phase_dtype(phase)), dtype_name(policy.storage)}
    total = sum(counts.values())
    out: List[Finding] = []
    if not total:
        return out
    for dt, cnt in sorted(counts.items()):
        if dt not in allowed and cnt / total >= min_share:
            out.append(Finding(
                "P003",
                f"phase '{phase}' declared {dtype_name(policy.phase_dtype(phase))}"
                f" but executes {cnt} ops ({cnt / total:.0%}) in {dt}",
                context=context,
            ))
    return out


# ------------------------------------------------------------ the runs


def _pinned_engine(engine, mode: str):
    """``engine`` with its iteration plan pinned to ``mode``."""
    from ..kernels.engine import IterationPlan

    plan = IterationPlan(update=mode, tiles=engine.tiles, source="override")
    return dataclasses.replace(engine, iteration_plan=plan)


class _Problem:
    """One small problem on ``device``: a 'road' matrix (near-uniform rows,
    so the ELL padding stays small), an ELL engine pinned to ``mode``, and
    NumPy-seeded sample vectors."""

    def __init__(self, pol: PrecisionPolicy, n: int, m: int, mode: str, device):
        from ..kernels.engine import make_engine
        from ..sparse import generate

        self.pol, self.m, self.mode = pol, m, mode
        self.device = torch.device(device)
        self.csr = generate("road", n, 4.0, seed=3, values="normalized")
        self.n = self.csr.n  # 'road' rounds n up to a grid square
        eng = make_engine(self.csr, "ell", accum_dtype=pol.phase_dtype("spmv"),
                          storage_dtype=pol.storage, device=self.device)
        self.engine = _pinned_engine(eng, mode)
        self.rng = np.random.default_rng(0)
        self.v1 = self.rng.standard_normal(self.n)

    def vec(self, n: int, dtype) -> torch.Tensor:
        return torch.as_tensor(self.rng.standard_normal(n)).to(device=self.device, dtype=dtype)

    def ops_for(self, op):
        from ..core.lanczos import ops_for_operator

        return ops_for_operator(op, self.pol, device=self.device, fused=_FUSED_PIN[self.mode])


def _counts(fn: Callable, *args) -> Dict[str, int]:
    return measure(fn, *args)[1].ops_by_dtype()


def _loop_phases(pr: _Problem, ops, n: int) -> Dict[str, Dict[str, int]]:
    """Per-phase counts of one Lanczos ops record on sample operands."""
    pol, m = pr.pol, pr.m
    sdt, cdt = pol.storage, pol.compute
    v, vp, u = pr.vec(n, cdt), pr.vec(n, cdt), pr.vec(n, cdt)
    beta = torch.ones((), dtype=cdt, device=pr.device)

    def spmv():
        if ops.fused_iteration is not None:
            return ops.fused_iteration(v, vp, beta)
        return ops.matvec(v.to(sdt))

    def alpha_beta():
        alpha = ops.dot(v, u)
        if ops.fused_update is not None:
            return ops.fused_update(u, v, vp, alpha, beta)
        return alpha

    basis = pr.vec(m * n, sdt).reshape(m, n)
    mask = torch.ones((m,), dtype=cdt, device=pr.device)
    return {
        "spmv": _counts(spmv),
        "alpha_beta": _counts(alpha_beta),
        "reorth": _counts(ops.project_out, basis, u, mask),
    }


def _ritz_phase(pr: _Problem, n: int, k: int, jacobi: str) -> Dict[str, int]:
    """Counts of the ritz phase (Jacobi placement + back-projection) on a
    sample tridiagonal and basis."""
    from ..core.eigensolver import ritz_decompose, ritz_extract
    from ..core.lanczos import LanczosResult

    pol, m = pr.pol, pr.m
    cdt = pol.compute
    lres = LanczosResult(alpha=pr.vec(m, cdt), beta=pr.vec(m - 1, cdt).abs(),
                         basis=pr.vec(m * n, pol.storage).reshape(m, n),
                         beta_last=pr.vec(1, cdt)[0].abs())

    def ritz():
        evals, w, _, w_f64, beta_m = ritz_decompose(lres, pol, jacobi)
        return ritz_extract(lres, evals, w, w_f64, beta_m, k, pol)

    return _counts(ritz)


def _build_runs(pol: PrecisionPolicy, engine: str, mode: str, *, n: int, m: int, k: int,
                reorth: str, jacobi: str, device):
    """``(phase counts, full-solve counter, n_model, nnz_exec)`` for one
    (policy, engine, mode)."""
    from ..core.eigensolver import solve_fixed
    from ..core.operators import ChunkedOperator, make_operator

    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    if mode not in ENGINE_MODES[engine]:
        raise ValueError(f"engine {engine!r} runs the modes {ENGINE_MODES[engine]}, "
                         f"not {mode!r}")
    pr = _Problem(pol, n, m, mode, device)
    csr = pr.csr
    if engine == "distributed":
        import torch.distributed as dist

        from ..core.distributed import ShardComm, _make_sharded_ops, prepare_sharded, solve_sharded

        if dist.is_available() and dist.is_initialized():
            raise RuntimeError("the distributed precision run is a world of one: "
                               "call it with no default process group")
        ps = prepare_sharded(csr, 1, pol, "ell", engine=pr.engine, device=pr.device)
        n_pad, mat = ps.pm.n_pad, ps.mats[0]
        ops = _make_sharded_ops(mat, n_pad, pol, ShardComm(), ps.engine, reorth)
        phases = _loop_phases(pr, ops, n_pad)
        phases["ritz"] = _ritz_phase(pr, n_pad, k, jacobi)
        _, full = measure(solve_sharded, csr, k, None, pol, reorth=reorth, num_iters=m,
                          v1=pr.v1, prepared=ps, device=pr.device)
        return phases, full, n_pad, mat.val.numel()
    if engine == "restarted":
        from ..core.restarted import restart_kernels, solve_restarted

        op = make_operator(csr, dtype=pol.storage, engine=pr.engine)
        sdt, cdt, rdt = pol.storage, pol.compute, pol.phase_dtype("reorth")
        dot, orth = restart_kernels(pol)
        mv = op.bound_matvec(pol)
        v, u = pr.vec(pr.n, cdt), pr.vec(pr.n, cdt)
        phases = {
            "spmv": _counts(lambda: mv(v.to(sdt))),
            "alpha_beta": _counts(dot, v, u),
            "reorth": _counts(orth, u, pr.vec(m * pr.n, rdt).reshape(m, pr.n)),
            "ritz": _ritz_phase(pr, pr.n, k, jacobi),
        }
        # One cycle of m steps and the final back-projection.
        _, full = measure(solve_restarted, op, k, pol, m=m, max_restarts=1, v1=pr.v1)
        return phases, full, pr.n, op.mat.val.numel()
    if engine == "chunked":
        # Two chunks: exercises the streaming loop.  Executed nnz is the
        # chunks' padded slots.
        op = ChunkedOperator(csr, chunk_nnz=max(1, (csr.nnz + 1) // 2), dtype=pol.storage,
                             engine=pr.engine, device=pr.device)
        nnz_exec = op.padded_slots
    else:
        op = make_operator(csr, dtype=pol.storage, engine=pr.engine)
        nnz_exec = op.mat.val.numel()
    ops = pr.ops_for(op)
    phases = _loop_phases(pr, ops, pr.n)
    phases["ritz"] = _ritz_phase(pr, pr.n, k, jacobi)
    _, full = measure(solve_fixed, op, k, pol, reorth=reorth, num_iters=m, v1=pr.v1,
                      jacobi=jacobi, ops=ops)
    return phases, full, pr.n, nnz_exec


def trace_phases(policy, engine: str = "single", *, mode: str = "unfused", n: int = 64,
                 m: int = 8, k: int = 4, reorth: str = "full", jacobi: str = "host",
                 device="cuda") -> Dict[str, Dict[str, int]]:
    """{phase: ops per dtype} of one (policy, engine, mode), each phase's
    callable run once on sample operands."""
    phases, _, _, _ = _build_runs(_policy(policy), engine, mode, n=n, m=m, k=k,
                                  reorth=reorth, jacobi=jacobi, device=device)
    return phases


def measure_ops_by_dtype(policy, engine: str = "single", *, mode: str = "unfused",
                         n: int = 64, m: int = 8, k: int = 4, reorth: str = "full",
                         jacobi: str = "host", device="cuda") -> Dict[str, int]:
    """Measured element ops per dtype of one whole solve."""
    _, full, _, _ = _build_runs(_policy(policy), engine, mode, n=n, m=m, k=k,
                                reorth=reorth, jacobi=jacobi, device=device)
    return full.ops_by_dtype()


def check_run(policy, counter: OpCounter, *, n: int, nnz: int, m: int, k: int,
              reorth: str = "full", jacobi: str = "host", steps: Optional[int] = None,
              parity_ratio: float = 8.0, context: str = "", min_share: float = 0.01) -> Findings:
    """The rules one counted solve can answer without a per-phase split:
    P001 and P002 over its conversions, P003 over the whole run (every dtype
    carrying at least ``min_share`` of its ops is some phase's dtype or the
    storage dtype) and P004 against the model under ``executed=True``
    (``n``, ``nnz``: the executed vector length and SpMV slots a matvec).
    ``steps``: the Lanczos steps of a restarted solve, cycles of an ``m``-row
    subspace; the model of one cycle is scaled to them."""
    pol = _policy(policy)
    findings = find_upcasts(counter.conversions, pol, context=context)
    findings += find_double_rounding(counter.conversions, pol, context=context)
    measured = counter.ops_by_dtype()
    total = sum(measured.values())
    allowed = {dtype_name(pol.phase_dtype(ph)) for ph in PHASES} | {dtype_name(pol.storage)}
    for dt, cnt in sorted(measured.items()):
        if dt not in allowed and cnt / total >= min_share:
            findings.append(Finding("P003", f"the solve executes {cnt} ops ({cnt / total:.0%}) in "
                                            f"{dt}, the dtype of no phase of {pol.name}",
                                    context=context))
    model = phase_op_counts(pol, n=n, nnz=nnz, m=m, k=k, reorth=reorth, jacobi=jacobi,
                            executed=True)
    if steps is not None:
        model = {dt: int(c * steps / m) for dt, c in model.items()}
    try:
        assert_phase_count_parity(model, measured, ratio=parity_ratio, context=context)
    except AssertionError as exc:
        findings.append(Finding("P004", str(exc), context=context))
    return findings


def check_policy(policy, engine: str = "single", *, mode: str = "unfused", n: int = 64,
                 m: int = 8, k: int = 4, reorth: str = "full", jacobi: str = "host",
                 parity_ratio: float = 8.0, device="cuda") -> Tuple[Findings, Dict[str, int]]:
    """All four precision rules for one (policy, engine, mode): P003 per
    phase, then :func:`check_run` on the whole solve.  Returns
    ``(findings, measured_ops_by_dtype)``."""
    pol = _policy(policy)
    ctx = f"{pol.name}/{engine}/{mode}"
    phases, full, n_model, nnz_exec = _build_runs(pol, engine, mode, n=n, m=m, k=k,
                                                  reorth=reorth, jacobi=jacobi, device=device)
    findings: List[Finding] = []
    for ph, counts in phases.items():
        findings.extend(find_phase_leaks(counts, pol, ph, context=f"{ctx}/{ph}"))
    findings.extend(check_run(pol, full, n=n_model, nnz=nnz_exec, m=m, k=k, reorth=reorth,
                              jacobi=jacobi, parity_ratio=parity_ratio, context=ctx))
    return findings, full.ops_by_dtype()


def run(rungs: Iterable[str] = RUNGS, engines: Iterable[str] = ENGINES, device="cuda",
        **kw) -> Findings:
    """The sweep: every rung x engine x the update modes the engine resolves."""
    findings: List[Finding] = []
    for name in rungs:
        for eng in engines:
            for mode in ENGINE_MODES[eng]:
                fs, _ = check_policy(POLICIES[name], eng, mode=mode, device=device, **kw)
                findings.extend(fs)
    return findings


# ------------------------------------------------------ session integration


def measure_session_ops(solve: Callable, *args, **kwargs):
    """Run a session's own solve under the op counter (behind
    ``REPRO_PRECISION_MEASURE``): ``(result, ops_by_dtype_measured)``.  The
    counter only observes: the result has the same bits as an uncounted run."""
    with OpCounter() as counter:
        out = solve(*args, **kwargs)
    return out, counter.ops_by_dtype()
