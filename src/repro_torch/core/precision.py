"""Mixed-precision policies of the PyTorch port.

The paper's (storage, compute, output) dtype triple with the reference's
optional per-phase compute overrides (:data:`PHASES`), as torch dtypes.
PyTorch always has float64, so :meth:`PrecisionPolicy.effective` is the
identity: FDF (store f32, compute f64, output f32) runs as written, on the
CPU and on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

__all__ = [
    "PHASES",
    "PrecisionPolicy",
    "FFF",
    "FDF",
    "DDD",
    "BFF",
    "HFF",
    "FCF",
    "BCF",
    "POLICIES",
    "dtype_name",
    "compensated_sum",
    "reduce_sum",
    "dot",
    "norm2",
    "auto_ladder",
    "phase_op_counts",
    "assert_phase_count_parity",
]

# The four compute phases of one solve, in hot-loop order (see the reference).
PHASES = ("spmv", "alpha_beta", "reorth", "ritz")

_DTYPE_ALIASES = {
    "f16": "float16",
    "f32": "float32",
    "f64": "float64",
    "bf16": "bfloat16",
}


def dtype_name(dt) -> str:
    """``torch.float32`` -> ``"float32"`` (the reference's dtype names)."""
    return str(dt).replace("torch.", "")


def _parse_dtype(dt) -> torch.dtype:
    """Accept a torch dtype or a (shorthand) name."""
    if isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, str):
        name = _DTYPE_ALIASES.get(dt.lower(), dt.lower())
        got = getattr(torch, name, None)
        if isinstance(got, torch.dtype) and got.is_floating_point:
            return got
    raise ValueError(f"unparseable phase dtype {dt!r}")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """(storage, compute, output) dtype triple, the paper's precision knob;
    see ``repro.core.precision.PrecisionPolicy`` for the field semantics."""

    name: str
    storage: Any
    compute: Any
    output: Any
    compensated: bool = False
    spmv: Any = None
    alpha_beta: Any = None
    reorth: Any = None
    ritz: Any = None

    def phase_dtype(self, phase: str):
        """Compute dtype of one solver phase (the override, or ``compute``)."""
        if phase not in PHASES:
            raise ValueError(f"unknown precision phase {phase!r}; valid phases: {PHASES}")
        override = getattr(self, phase)
        return self.compute if override is None else override

    def phase_map(self) -> Dict[str, str]:
        return {ph: dtype_name(self.phase_dtype(ph)) for ph in PHASES}

    def is_uniform(self) -> bool:
        """True when every phase runs in the plain ``compute`` dtype."""
        return all(self.phase_dtype(ph) == self.compute for ph in PHASES)

    def with_phases(self, **overrides) -> "PrecisionPolicy":
        """New policy with per-phase compute dtypes, e.g.
        ``FDF.with_phases(reorth="f32")``; ``None`` clears an override."""
        bad = sorted(set(overrides) - set(PHASES))
        if bad:
            raise ValueError(f"unknown precision phase(s) {bad}; valid phases: {PHASES}")
        parsed = {ph: (None if dt is None else _parse_dtype(dt)) for ph, dt in overrides.items()}
        new = dataclasses.replace(self, **parsed)
        tags = ",".join(
            f"{ph}={dtype_name(getattr(new, ph))}" for ph in PHASES if getattr(new, ph) is not None
        )
        base = self.name.split("[")[0]
        return dataclasses.replace(new, name=f"{base}[{tags}]" if tags else base)

    def effective(self) -> "PrecisionPolicy":
        """Identity: float64 is always available in PyTorch."""
        return self

    def short(self) -> str:
        return self.name


FFF = PrecisionPolicy("FFF", torch.float32, torch.float32, torch.float32)
FDF = PrecisionPolicy("FDF", torch.float32, torch.float64, torch.float32)
DDD = PrecisionPolicy("DDD", torch.float64, torch.float64, torch.float64)
BFF = PrecisionPolicy("BFF", torch.bfloat16, torch.float32, torch.float32)
HFF = PrecisionPolicy("HFF", torch.float16, torch.float32, torch.float32)
FCF = PrecisionPolicy("FCF", torch.float32, torch.float32, torch.float32, compensated=True)
BCF = PrecisionPolicy("BCF", torch.bfloat16, torch.float32, torch.float32, compensated=True)

POLICIES = {p.name: p for p in (FFF, FDF, DDD, BFF, HFF, FCF, BCF)}

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def compensated_sum(x: torch.Tensor, dtype) -> torch.Tensor:
    """Neumaier compensated summation of a 1-D tensor, in the reference's
    order: one native sum per 256-element chunk, then the chunk totals
    combined sequentially with Neumaier compensation.

    The sequential combine runs on the host (one device->host copy of the
    n/256 chunk totals); the result comes back as a 0-d tensor on
    ``x.device``.
    """
    x = x.to(dtype)
    n = x.shape[0]
    chunk = 256
    pad = (-n) % chunk
    xp = torch.nn.functional.pad(x, (0, pad))
    parts = xp.reshape(-1, chunk).sum(dim=1).cpu().numpy()
    np_dt = _NP_DTYPES[dtype]
    s = np_dt(0.0)
    c = np_dt(0.0)
    for p in parts:
        t = s + p
        # Neumaier: pick the compensation direction by magnitude.
        comp = (s - t) + p if abs(s) >= abs(p) else (p - t) + s
        s, c = t, c + comp
    return torch.tensor(s + c, dtype=dtype, device=x.device)


def reduce_sum(x: torch.Tensor, policy: PrecisionPolicy) -> torch.Tensor:
    """Policy-directed sum reduction (the paper's alpha/beta accumulators)."""
    if policy.compensated:
        return compensated_sum(x.reshape(-1), policy.compute)
    return torch.sum(x.to(policy.compute))


def dot(a: torch.Tensor, b: torch.Tensor, policy: PrecisionPolicy) -> torch.Tensor:
    """Mixed-precision dot product: storage-dtype inputs, compute-dtype accum."""
    prod = a.to(policy.compute) * b.to(policy.compute)
    return reduce_sum(prod, policy)


def norm2(a: torch.Tensor, policy: PrecisionPolicy) -> torch.Tensor:
    return torch.sqrt(dot(a, a, policy))


# --------------------------- accuracy-driven auto ----------------------------

# Escalation ladder of ``policy="auto"``, cheapest first: the selector probes
# the rungs in order and stops at the first whose measured residuals meet
# the requested tol.  The reference caps it at FCF without x64; PyTorch
# always has float64, so the ladder always has its five rungs.
_AUTO_LADDER = ("BFF", "FFF", "FCF", "FDF", "DDD")


def auto_ladder() -> tuple:
    """Policy names ``policy="auto"`` escalates through, cheapest first."""
    return _AUTO_LADDER


# Fraction of the stored basis each re-orthogonalization mode touches per
# pass (the paper's parity scheme halves it; CGS2 runs two full passes).
_REORTH_PASS_FRAC = {"none": 0.0, "half": 0.5, "half_alt": 0.5, "full": 1.0, "full2": 2.0}
# What the port's ``project_out`` (``core/lanczos.py``) executes, in the
# model's ``2 f m^2 n`` units: each pass multiplies the whole (m, n) basis by
# the mask (the mask zeroes coefficients, not work) and runs two gemvs over
# it, 3 m n ops, so f = 1.5 per pass whatever the mode; CGS2 runs two.
_REORTH_EXEC_FRAC = {"none": 0.0, "half": 1.5, "half_alt": 1.5, "full": 1.5, "full2": 3.0}

# Element ops of one cyclic-Jacobi sweep on an m x m matrix: m(m-1)/2
# rotations, each applying 6 axpy-like updates of length m (two rows, two
# cols, two eigenvector cols at 3 ops/element) => ~9 m^3 per sweep.
_JACOBI_SWEEP_OPS = 9.0


def phase_op_counts(
    policy: PrecisionPolicy,
    *,
    n: int,
    nnz: int,
    m: int,
    k: int,
    reorth: str = "half",
    jacobi: str = "host",
    jacobi_sweeps: float = 6.0,
    executed: bool = False,
) -> Dict[str, int]:
    """Model count of element operations per compute dtype for one solve:
    ``m * nnz`` SpMV accumulations, ``2 m n`` alpha/beta reduction elements,
    ``2 f m^2 n`` re-orthogonalization elements (``f``: the mode's basis
    fraction per pass) and ``n m k`` back-projection elements, each under
    the dtype of the phase that runs it.  A model, not a counter: it is
    what ``partition["spmv"]["precision"]["ops_by_dtype"]`` reports, and
    ``ops_by_dtype_measured`` (``REPRO_PRECISION_MEASURE=1``) is what the op
    counter of ``analysis/op_count.py`` saw the solve execute.

    ``jacobi="jax"`` (the reference's ``"device"``) adds the device Jacobi
    of the m x m projected matrix to the ritz phase, ``~9 m^3`` per sweep x
    ``jacobi_sweeps``; the host placement runs in NumPy and adds nothing.

    ``executed=True`` is the convention under which the model compares with
    the measured counts (:func:`assert_phase_count_parity`): the reorth
    term takes the fractions the port's masked ``project_out`` executes
    (``_REORTH_EXEC_FRAC``) and ``nnz`` should be the slots the kernels run
    (ELL padding included).  The reference counts one Jacobi sweep there,
    since a jaxpr records a ``while`` body once; the port counts a run, so
    the counter sees every sweep, and the model counts ``jacobi_sweeps`` of
    them either way.
    """
    p = policy.effective()
    counts: Dict[str, int] = {}

    def add(phase: str, ops: float) -> None:
        name = dtype_name(p.phase_dtype(phase))
        counts[name] = counts.get(name, 0) + int(ops)

    table = _REORTH_EXEC_FRAC if executed else _REORTH_PASS_FRAC
    frac = table.get(reorth, 1.0)
    add("spmv", m * nnz)
    add("alpha_beta", 2 * m * n)
    add("reorth", 2.0 * frac * m * m * n)
    add("ritz", n * m * k)
    if jacobi in ("jax", "device"):
        add("ritz", _JACOBI_SWEEP_OPS * jacobi_sweeps * m**3)
    return counts


def assert_phase_count_parity(
    model: Dict[str, int],
    measured: Dict[str, int],
    *,
    ratio: float = 8.0,
    min_share: float = 0.02,
    context: str = "",
) -> None:
    """Tripwire pinning the model to the measured counts (the reference's).

    The two count at different granularity, so this demands the same
    *story*, not equality: every dtype carrying at least ``min_share`` of
    either side's work appears on the other, and per-dtype totals agree
    within a factor of ``ratio``.  A wrong phase-dtype attribution moves
    whole ``m^3`` / ``m^2 n`` terms between dtypes and trips either check
    long before any constant-factor slack matters.
    """
    problems = []
    total_meas = sum(measured.values()) or 1
    total_model = sum(model.values()) or 1
    for dt, cnt in sorted(measured.items()):
        if cnt / total_meas >= min_share and model.get(dt, 0) == 0:
            problems.append(
                f"measured dtype {dt} ({cnt} ops, {cnt / total_meas:.0%} of the run)"
                " is absent from the model"
            )
    for dt, cnt in sorted(model.items()):
        if cnt / total_model >= min_share and measured.get(dt, 0) == 0:
            problems.append(
                f"model dtype {dt} ({cnt} ops, {cnt / total_model:.0%} of model)"
                " never appears in the run"
            )
    for dt in sorted(set(model) & set(measured)):
        if model[dt] == 0 or measured[dt] == 0:
            continue
        r = measured[dt] / model[dt]
        if not (1.0 / ratio <= r <= ratio):
            problems.append(
                f"{dt}: measured/model ratio {r:.3g} outside"
                f" [{1.0 / ratio:.3g}, {ratio:.3g}]"
                f" (measured={measured[dt]}, model={model[dt]})"
            )
    if problems:
        where = f" [{context}]" if context else ""
        raise AssertionError(
            f"phase_op_counts parity failure{where}:\n  " + "\n  ".join(problems)
        )
