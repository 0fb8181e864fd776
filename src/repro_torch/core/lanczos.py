"""Phase 1 of the eigensolver: the Lanczos algorithm (the paper's Alg. 1).

The reference's loop (``repro/core/lanczos.py``) as a Python loop over
preallocated tensors.  The basis V and the carried vectors live in
``policy.storage``; SpMV accumulation and the alpha / beta / re-orthogonal-
ization reductions run in ``policy.compute`` (or the policy's per-phase
overrides), each result rounded back to the carried compute dtype.

Nothing in the loop reads a value back to the host: the step index is a
Python int, alpha and beta stay 0-d device tensors, and the health probe
(:func:`check_tridiag_health`) runs once, after the loop.  The fault taps
(``testing/faults.py``) are no-ops unless a fault is armed, and a solve
checkpoint (``checkpoint=``, the chunked engine's) reads the carry back
only when it saves.

The update modes of the :class:`~repro_torch.kernels.engine.IterationPlan`:

* ``unfused``    — plain tensor expressions;
* ``fused``      — the ``lanczos_update`` kernel (update + ||u||^2, one pass);
* ``fused_spmv`` — ``spmv_ell_alpha`` + ``lanczos_update`` (ELL only).

:func:`lanczos_tridiag_multi` runs one loop for B start vectors at once
(the reference vmaps the loop): each step one block matvec over an
``(n, B)`` block, row-wise alpha and beta, a batched re-orthogonalization
and, on the card, one batched ``lanczos_update`` launch for all B starts.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..analysis.op_count import host_scope
from ..configs import env as envcfg
from ..testing import faults as _faults
from .precision import PrecisionPolicy, compensated_sum
from .trace import to_host

__all__ = [
    "LanczosResult",
    "NumericalBreakdown",
    "check_tridiag_health",
    "lanczos_tridiag",
    "lanczos_tridiag_multi",
    "make_local_ops",
    "ops_for_operator",
    "fused_update_enabled",
    "resolve_update_mode",
    "Ops",
]


class NumericalBreakdown(ArithmeticError):
    """The Lanczos recurrence produced values no later phase can use
    (``kind``: ``"nonfinite"`` or ``"beta_underflow"``; ``iteration``: the
    first offending step)."""

    def __init__(self, kind: str, iteration: int, policy: Optional[str] = None, detail: str = ""):
        self.kind = kind
        self.iteration = iteration
        self.policy = policy
        self.recovery_trail: Optional[list] = None
        msg = f"Lanczos breakdown: {kind} at iteration {iteration}"
        if policy:
            msg += f" under policy {policy}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


class LanczosResult(NamedTuple):
    alpha: torch.Tensor  # (m,) compute dtype — diagonal of T
    beta: torch.Tensor  # (m-1,) compute dtype — off-diagonal of T
    basis: torch.Tensor  # (m, n) storage dtype — Lanczos vectors, row-major
    beta_last: Optional[torch.Tensor] = None  # residual norm after the last step


def check_tridiag_health(result: LanczosResult, policy: PrecisionPolicy) -> None:
    """Post-sweep health probe: raise :class:`NumericalBreakdown` instead of
    letting garbage flow into the Ritz phase (O(m) host work on the
    tridiagonal scalars, hidden from the op counter; the earliest offending
    step decides the kind)."""
    with host_scope():
        _check_tridiag_health(result, policy)


def _check_tridiag_health(result: LanczosResult, policy: PrecisionPolicy) -> None:
    pol = getattr(policy, "name", None) or str(policy)
    alpha = to_host(result.alpha).to(torch.float64).numpy().reshape(-1)
    beta = to_host(result.beta).to(torch.float64).numpy().reshape(-1)
    m = result.alpha.shape[-1]
    tiny = float(torch.finfo(policy.compute).tiny) * 1e3
    found = []  # (iteration, priority, kind, detail)
    bad = ~np.isfinite(alpha)
    if bad.any():
        j = int(np.argmax(bad))
        found.append((j % m, 0, "nonfinite", f"alpha[{j % m}]={alpha[j]!r}"))
    bad = ~np.isfinite(beta)
    if bad.any():
        j = int(np.argmax(bad))
        found.append((j % max(m - 1, 1), 0, "nonfinite", f"beta[{j % max(m - 1, 1)}]={beta[j]!r}"))
    if result.beta_last is not None:
        bl = to_host(result.beta_last).to(torch.float64).numpy().reshape(-1)
        if not np.isfinite(bl).all():
            found.append((m - 1, 0, "nonfinite", "beta_last"))
    small = beta <= tiny
    if small.any():
        j = int(np.argmax(small))
        found.append((j % max(m - 1, 1), 1, "beta_underflow", f"beta={beta[j]:.3e} <= {tiny:.3e}"))
    if found:
        i, _, kind, detail = min(found)
        raise NumericalBreakdown(kind, i, pol, detail)


@dataclasses.dataclass(frozen=True)
class Ops:
    """Arithmetic kernel set of one solve."""

    matvec: Callable  # storage-in, compute-out
    dot: Callable  # compute-dtype 0-d tensor
    project_out: Callable  # (basis, u, mask) -> u minus its masked projection
    # (w, v, v_prev, alpha, beta) -> (w - alpha v - beta v_prev, ||.||^2) in
    # one pass; None keeps the separate recurrence + dot.
    fused_update: Optional[Callable] = None
    # (v, v_prev, beta_prev) -> (u, alpha, ||u||^2): SpMV + alpha + update in
    # two fused passes; when set it subsumes matvec/dot/fused_update.
    fused_iteration: Optional[Callable] = None


def fused_update_enabled(policy: PrecisionPolicy) -> bool:
    """Policy gate for the fused update: compensated policies need the
    compensated reductions, an ``alpha_beta`` phase split moves the norm's
    dtype away from the recurrence's; ``REPRO_FUSED_LANCZOS=0`` kills it."""
    if not envcfg.get_bool("REPRO_FUSED_LANCZOS"):
        return False
    if policy.compensated:
        return False
    return policy.phase_dtype("alpha_beta") == policy.compute


def resolve_update_mode(policy: PrecisionPolicy, plan=None, device="cuda",
                        fused: Optional[bool] = None) -> str:
    """The update mode of this solve: a caller's ``fused=`` pin (``False``
    is how ``recovery="auto"`` unfuses), the policy gate, then a
    ``REPRO_ITER_UPDATE`` pin, then ``REPRO_FUSED_LANCZOS=1`` set explicitly
    (force fusion), then the engine's plan, or the static table for
    ``device`` when there is no plan."""
    if fused is not None:
        return "fused" if (fused and fused_update_enabled(policy)) else "unfused"
    if not fused_update_enabled(policy):
        return "unfused"
    from ..kernels.engine import ITER_UPDATE_MODES, table_update_mode

    pin = (envcfg.get_str("REPRO_ITER_UPDATE") or "").strip().lower()
    if pin and pin != "auto":
        if pin not in ITER_UPDATE_MODES:
            raise ValueError(f"REPRO_ITER_UPDATE={pin!r}: expected one of {ITER_UPDATE_MODES}")
        return pin
    env = (envcfg.raw("REPRO_FUSED_LANCZOS") or "").strip().lower()
    if env in ("1", "true", "on", "yes"):
        if plan is not None and plan.update != "unfused":
            return plan.update
        return "fused"
    if plan is not None:
        return plan.update
    return table_update_mode(device)


def _local_reduce(x: torch.Tensor, policy: PrecisionPolicy, dtype=None) -> torch.Tensor:
    """The sum of ``x``, or of each row of (B, n) ``x`` (the multi-start
    sweep's B starts)."""
    if x.ndim == 2:
        if policy.compensated:
            return torch.stack([compensated_sum(r, dtype or policy.compute) for r in x])
        return torch.sum(x, dim=-1)
    if policy.compensated:
        return compensated_sum(x.reshape(-1), dtype or policy.compute)
    return torch.sum(x)


def _reductions(policy: PrecisionPolicy):
    """``dot`` and ``project_out`` of one solve, in the per-phase compute
    dtypes, every result cast back to the carried ``compute`` dtype.  Both
    take (n,) vectors or (B, n) rows of B starts, each start against its own
    (B, m, n) basis."""
    cdt = policy.compute
    abdt = policy.phase_dtype("alpha_beta")
    rdt = policy.phase_dtype("reorth")

    def dot(a, b):
        return _local_reduce(a.to(abdt) * b.to(abdt), policy, abdt).to(cdt)

    def project_out(basis, u, mask):
        basis_c = basis.to(rdt) * mask.to(rdt)[:, None]  # ONE (m, n) or (B, m, n) cast
        # u rounds through the storage dtype before the coefficient dot, as
        # in the reference.  Each temporary dies within its statement: at a
        # Hessian's n one (n,) vector is GBs.
        if u.ndim == 1:
            coeffs = basis_c @ u.to(policy.storage).to(rdt)
            return (u.to(rdt) - coeffs @ basis_c).to(cdt)
        coeffs = basis_c @ u.to(policy.storage).to(rdt)[:, :, None]  # (B, m, 1)
        return (u.to(rdt) - (coeffs.transpose(1, 2) @ basis_c)[:, 0]).to(cdt)

    return dot, project_out


def _make_fused_iteration(operator, policy: PrecisionPolicy) -> Optional[Callable]:
    """Whole-iteration fused step for an ELL-backed operator, or None (the
    spmv-phase accumulator must equal the carried compute dtype: the
    kernel's in-pass alpha replaces ``dot(v, w)``)."""
    from ..kernels import ops as kops
    from ..sparse.formats import DeviceELL

    eng = getattr(operator, "engine", None)
    mat = getattr(operator, "mat", None)
    if eng is None or eng.format != "ell" or not isinstance(mat, DeviceELL):
        return None
    cdt, sdt = policy.compute, policy.storage
    acc = policy.phase_dtype("spmv")
    if acc != cdt:
        return None

    def fused_iteration(v, v_prev, beta):
        # Pass 1: w = A v with alpha = <v, w> folded in.
        w, alpha = kops.spmv_ell_alpha(mat, v.to(sdt), v, accum_dtype=acc)
        alpha = alpha.to(cdt)
        # Pass 2: three-term update + squared norm.
        u, nrm = kops.lanczos_update(w.to(cdt), v, v_prev, alpha, beta, accum_dtype=cdt)
        return u, alpha, nrm

    return fused_iteration


def _batched_ops(matvec: Callable, policy: PrecisionPolicy, fused: bool) -> Ops:
    """The multi-start loop's ops over (B, n) rows of B starts: ``matvec``
    takes an ``(n, B)`` block (``DenseOperator`` and ``DeviceCOO`` read the
    matrix once for all B columns), ``dot`` and ``project_out`` are a lone
    sweep's over a leading axis, and with ``fused`` the update is the
    batched ``lanczos_update`` (one launch a step on the card)."""
    cdt = policy.compute
    dot, project_out = _reductions(policy)

    def block_matvec(rows):
        return matvec(rows.T).T.contiguous()

    fused_update = None
    if fused:
        from ..kernels import ops as kops

        def fused_update(w, v, v_prev, alpha, beta):
            return kops.lanczos_update_multi(w, v, v_prev, alpha, beta, accum_dtype=cdt)

    return Ops(matvec=block_matvec, dot=dot, project_out=project_out, fused_update=fused_update)


def make_local_ops(matvec: Callable, policy: PrecisionPolicy, plan=None, operator=None,
                   device="cuda", fused: Optional[bool] = None) -> Ops:
    """Single-device ops: plain reductions in the per-phase compute dtypes,
    every result cast back to the carried ``compute`` dtype; ``fused`` pins
    the update mode (see :func:`resolve_update_mode`)."""
    cdt = policy.compute
    dot, project_out = _reductions(policy)

    mode = resolve_update_mode(policy, plan=plan, device=device, fused=fused)
    fused_iteration = None
    if mode == "fused_spmv":
        fused_iteration = _make_fused_iteration(operator, policy)
        if fused_iteration is None:
            mode = "fused"  # the operator can't supply the fused pass: next rung
    fused_update = None
    if mode in ("fused", "fused_spmv") and fused_iteration is None:
        from ..kernels import ops as kops

        def fused_update(w, v, v_prev, alpha, beta):
            return kops.lanczos_update(w, v, v_prev, alpha, beta, accum_dtype=cdt)

    return Ops(
        matvec=matvec, dot=dot, project_out=project_out,
        fused_update=fused_update, fused_iteration=fused_iteration,
    )


def ops_for_operator(operator, policy: PrecisionPolicy, device="cuda",
                     fused: Optional[bool] = None) -> Ops:
    """Ops routed by the operator's engine plan (or the device's table)."""
    eng = getattr(operator, "engine", None)
    plan = getattr(eng, "iteration_plan", None)
    return make_local_ops(
        operator.bound_matvec(policy), policy, plan=plan, operator=operator, device=device,
        fused=fused,
    )


def _reorth_mask(m: int, i: int, mode: str, dtype, device) -> torch.Tensor:
    """Mask over stored vector indices j (0-based) used for re-orth at step i."""
    j = torch.arange(m, device=device)
    stored = j <= i  # vectors written so far (includes the current v_i)
    if mode == "none":
        return torch.zeros((m,), dtype=dtype, device=device)
    if mode == "half":
        # The paper's parity scheme: the odd-indexed (1-based) half.
        return (stored & (j % 2 == 0)).to(dtype)
    if mode == "half_alt":
        return (stored & (j % 2 == i % 2)).to(dtype)
    if mode in ("full", "full2"):
        return stored.to(dtype)
    raise ValueError(f"unknown reorth mode {mode!r}")


def _lanczos_loop(v1: torch.Tensor, ops: Ops, num_iters: int, policy: PrecisionPolicy,
                  reorth: str, checkpoint=None) -> LanczosResult:
    """The Lanczos sweep from the (n,) ``v1``, or from the (B, n) rows of B
    starts at once (the multi-start sweep, with batched ``ops`` and no
    checkpoint): every carried quantity then has a leading start axis."""
    m = num_iters
    *lead, n = v1.shape
    dev = v1.device
    cdt, sdt = policy.compute, policy.storage
    tiny = float(torch.finfo(cdt).tiny) * 1e3

    v1 = v1.to(cdt)
    v1 = (v1 / torch.sqrt(ops.dot(v1, v1))[..., None]).contiguous()

    basis = torch.zeros((*lead, m, n), dtype=sdt, device=dev)
    alphas = torch.zeros((*lead, m), dtype=cdt, device=dev)
    betas = torch.zeros((*lead, m), dtype=cdt, device=dev)
    v_prev = torch.zeros((*lead, n), dtype=cdt, device=dev)
    w = torch.zeros((*lead, n), dtype=cdt, device=dev)
    beta_prev = torch.zeros(lead, dtype=cdt, device=dev)
    start = 0
    ckpt_op = None
    chunk_every = 0
    if checkpoint is not None:
        store, token, every, *rest = checkpoint
        # Optional 4th element: a ChunkedOperator whose streamed matvec
        # checkpoints its chunk cursor mid-step.
        ckpt_op = rest[0] if rest and hasattr(rest[0], "set_resume") else None
        state = store.load(token)
        if (state is not None and state.get("engine") == "lanczos"
                and int(state.get("n", -1)) == n and int(state.get("m", -1)) == m):
            basis = state["basis"].to(device=dev, dtype=sdt)
            alphas = state["alphas"].to(device=dev, dtype=cdt)
            betas = state["betas"].to(device=dev, dtype=cdt)
            v_prev = state["v_prev"].to(device=dev, dtype=cdt)
            w = state["w"].to(device=dev, dtype=cdt)
            beta_prev = state["beta_prev"].to(device=dev, dtype=cdt)
            if state.get("chunk") is not None and ckpt_op is not None:
                # A mid-step snapshot holds step i's starting carry: re-enter
                # step i with the matvec armed to skip the chunks already
                # summed.  Chunks run in a fixed order, so the resumed
                # sweep is bit-identical.
                start = int(state["i"])
                ckpt_op.set_resume(int(state["chunk"]) + 1, state["partial"])
            else:
                start = int(state["i"]) + 1
        if ckpt_op is not None and ckpt_op.num_chunks > 1:
            chunk_every = envcfg.get_int("REPRO_CHUNK_CKPT_EVERY")

    def snapshot(i, **extra):
        # Step i's carry; basis row i, if already written, is rewritten with
        # the same value on resume.
        store.save(token, {"engine": "lanczos", "i": i, "n": n, "m": m, **extra,
                           "basis": basis, "alphas": alphas, "betas": betas,
                           "v_prev": v_prev, "w": w, "beta_prev": beta_prev})

    for i in range(start, m):
        if chunk_every > 0:
            def chunk_hook(c, partial, _i=i):
                if (c + 1) % chunk_every or c + 1 >= ckpt_op.num_chunks:
                    return  # the end-of-step save covers the last chunk
                snapshot(_i, chunk=c, partial=partial)

            ckpt_op.set_step_hook(chunk_hook)
        try:
            # --- normalize the incoming vector (paper lines 5-7) ---
            v = v1 if i == 0 else w / torch.clamp_min(beta_prev, tiny)[..., None]
            basis[..., i, :] = v.to(sdt)
            nrm_sq = None
            if ops.fused_iteration is not None:
                # --- lines 9-11 in two fused passes ---
                u, alpha, fused_nrm = ops.fused_iteration(v, v_prev, beta_prev)
                u = _faults.tap_spmv(u, i)
                alphas[..., i] = alpha
                if reorth == "none":
                    nrm_sq = fused_nrm
            else:
                # --- projection (line 9): SpMV in compute precision ---
                u = ops.matvec(v.to(sdt)).to(cdt)
                u = _faults.tap_spmv(u, i)
                # --- alpha (line 10) ---
                alpha = ops.dot(v, u)
                alphas[..., i] = alpha
                # --- three-term recurrence (line 11) ---
                if ops.fused_update is not None:
                    u, fused_nrm = ops.fused_update(u, v, v_prev, alpha, beta_prev)
                    if reorth == "none":
                        nrm_sq = fused_nrm
                else:
                    u = u - alpha[..., None] * v - beta_prev[..., None] * v_prev
        finally:
            if chunk_every > 0:
                ckpt_op.set_step_hook(None)
        # --- re-orthogonalization (lines 12-21) ---
        if reorth != "none":
            mask = _reorth_mask(m, i, reorth, cdt, dev)
            for _ in range(2 if reorth == "full2" else 1):
                u = ops.project_out(basis, u, mask)
        # --- beta (line 6, next iteration) ---
        if nrm_sq is not None:
            beta = torch.sqrt(torch.clamp_min(nrm_sq.to(cdt), 0.0))
        else:
            beta = torch.sqrt(torch.clamp_min(ops.dot(u, u), 0.0))
        beta = _faults.tap_beta(beta, i)
        betas[..., i] = beta
        v_prev, w, beta_prev = v, u, beta
        if checkpoint is not None and (i + 1) % every == 0 and i + 1 < m:
            snapshot(i)
    if checkpoint is not None:
        store.clear(token)  # completed: the snapshot must not resurrect
    return LanczosResult(alpha=alphas, beta=betas[..., : m - 1], basis=basis,
                         beta_last=betas[..., m - 1])


def lanczos_tridiag(
    matvec: Callable,
    v1: torch.Tensor,
    num_iters: int,
    policy: PrecisionPolicy,
    reorth: str = "half",
    ops: Optional[Ops] = None,
    jit: bool = True,
    checkpoint=None,
) -> LanczosResult:
    """Run ``num_iters`` Lanczos steps from ``v1`` (see the module docstring).

    ``jit`` is the reference's switch between its compiled and its eager
    loop; the port's loop is always eager, so it is accepted and ignored.

    ``checkpoint`` is ``(store, token, every[, chunked_operator])`` (see
    :class:`~repro_torch.serving.store.SolveCheckpoint`): the loop carry is
    saved every ``every`` completed steps and, with a chunked operator,
    every ``REPRO_CHUNK_CKPT_EVERY`` chunks inside a step; a rerun with the
    same token resumes from the last snapshot bit-identically, and a
    completed sweep clears it.
    """
    policy = policy.effective()
    _faults.check_sweep_entry()
    ops = ops or make_local_ops(matvec, policy, device=v1.device)
    return _lanczos_loop(v1, ops, num_iters, policy, reorth, checkpoint=checkpoint)


def lanczos_tridiag_multi(
    matvec: Callable,
    v1s: torch.Tensor,
    num_iters: int,
    policy: PrecisionPolicy,
    reorth: str = "half",
    ops: Optional[Ops] = None,
) -> LanczosResult:
    """Multi-start Lanczos: ``v1s`` is (s, n) start vectors; every field of
    the result gains a leading start axis ((s, m) alpha, (s, m, n) basis,
    (s,) beta_last).  One loop builds all s bases: each step one block
    matvec (``matvec`` takes an ``(n, s)`` block, as ``DenseOperator`` and
    the COO operator do), one batched re-orthogonalization and, on the card,
    one batched ``lanczos_update`` launch for all starts (compensated
    policies keep the plain update, as a lone sweep does).  ``ops`` are a
    lone sweep's (``make_local_ops``, as the reference takes them): their
    ``matvec`` and whether their update is fused carry over to the batched
    ops; without them, the device's update mode decides.
    """
    policy = policy.effective()
    _faults.check_sweep_entry()
    if v1s.ndim != 2:
        raise ValueError(f"lanczos_tridiag_multi: v1s must be (s, n), got {tuple(v1s.shape)}")
    if ops is None:
        fused = resolve_update_mode(policy, device=v1s.device) != "unfused"
    else:
        matvec = ops.matvec
        fused = ops.fused_update is not None or ops.fused_iteration is not None
    return _lanczos_loop(v1s, _batched_ops(matvec, policy, fused), num_iters, policy, reorth)
