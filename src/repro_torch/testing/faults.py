"""Deterministic fault injection for the solver layers.

The recovery paths (``recovery="auto"`` escalation, solve checkpoint
resume) are only trustworthy while something exercises them.  This module
is that something: a process-local registry of *armed* faults that the
solver consults at fixed injection points, each firing at a requested
iteration / chunk / cycle and then disarming itself.  The reference's
``repro/testing/faults.py``, with the same grammar, kinds and exceptions.

Two ways to arm a fault:

* context manager (tests)::

      from repro_torch.testing import faults
      with faults.inject("spmv_nan@iter=7"):
          eigsh(a, k=4)           # SpMV output at Lanczos step 7 is NaN

* environment (CI permutations)::

      REPRO_FAULT="beta_collapse@iter=3" python -m ...

Grammar: ``kind[@key=val[,key=val...]]`` with keys ``iter`` / ``chunk`` /
``cycle`` (aliases for the trigger index) and ``count`` (times to fire
before going inert, default 1).  Kinds:

==================  =========================================================
``spmv_nan``        NaN written into the SpMV output at Lanczos step *iter*
``beta_collapse``   beta forced to 0 at step *iter* (lucky-breakdown shape)
``kernel_error``    raises :class:`InjectedKernelError` at sweep entry (the
                    shape of a kernel build or launch failure)
``oom``             raises :class:`InjectedOOMError` at sweep entry (the
                    shape of a device allocation failure)
``chunk_io_error``  raises :class:`InjectedChunkIOError` while staging chunk
                    *chunk* of an out-of-core stream
``solve_crash``     raises :class:`InjectedCrash` at the start of restart
                    cycle *cycle* (checkpoint/resume tests)
``scheduler_crash`` raises :class:`SchedulerThreadDeath`, a BaseException,
                    so it escapes ``except Exception`` wrappers
==================  =========================================================

Every loop of the port is eager: the Lanczos taps get the step as a Python
int and count their own firing when they poison a step.  Nothing reads a
value back from the device to decide: a tap compares host integers, and
the poisoned value is a new tensor.  ``trace_key`` and ``consume_lanczos``
keep the reference's registry semantics (its jitted sweeps count a firing
per launch); no loop of the port calls them.

When nothing is armed every hook is a cheap no-op (one list and one
environment lookup).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Union

from ..configs import env as envcfg

__all__ = [
    "FAULT_KINDS",
    "FaultSpec",
    "parse_fault",
    "inject",
    "fault_spec",
    "trace_key",
    "reset",
    "tap_spmv",
    "tap_beta",
    "consume_lanczos",
    "check_sweep_entry",
    "check_chunk_io",
    "check_solve_crash",
    "check_scheduler",
    "InjectedFault",
    "InjectedKernelError",
    "InjectedOOMError",
    "InjectedChunkIOError",
    "InjectedCrash",
    "SchedulerThreadDeath",
]

FAULT_KINDS = (
    "spmv_nan",
    "beta_collapse",
    "kernel_error",
    "oom",
    "chunk_io_error",
    "solve_crash",
    "scheduler_crash",
)

_ENV_VAR = "REPRO_FAULT"


class InjectedFault:
    """Mixin marking an exception as injected by this harness."""


class InjectedKernelError(InjectedFault, RuntimeError):
    """Stands in for a kernel build or launch failure."""


class InjectedOOMError(InjectedFault, RuntimeError):
    """Stands in for a device allocation failure (the message carries the
    "out of memory" marker recovery classifies on)."""


class InjectedChunkIOError(InjectedFault, OSError):
    """Stands in for an I/O error while staging an out-of-core chunk."""


class InjectedCrash(InjectedFault, RuntimeError):
    """Aborts a solve mid-run (checkpoint/resume tests)."""


class SchedulerThreadDeath(InjectedFault, BaseException):
    """Kills a scheduler thread for real: a BaseException, so a dispatch
    loop's ``except Exception`` guard cannot swallow it."""


@dataclasses.dataclass
class FaultSpec:
    """One armed fault.  ``fired`` counts applications; the spec goes inert
    once ``fired >= count`` so recovery retries run clean."""

    kind: str
    iteration: Optional[int] = None
    count: int = 1
    fired: int = 0

    @property
    def armed(self) -> bool:
        return self.fired < self.count


def parse_fault(text: str) -> FaultSpec:
    """Parse ``kind[@key=val[,key=val...]]`` (see module docstring)."""
    text = text.strip()
    kind, _, params = text.partition("@")
    kind = kind.strip()
    if kind not in FAULT_KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; expected one of {FAULT_KINDS}")
    spec = FaultSpec(kind=kind)
    if params:
        for item in params.split(","):
            key, sep, val = item.partition("=")
            key = key.strip()
            if not sep:
                raise ValueError(f"fault param {item!r} in {text!r}: expected key=value")
            try:
                ival = int(val)
            except ValueError:
                raise ValueError(f"fault param {item!r} in {text!r}: value must be an int") from None
            if key in ("iter", "chunk", "cycle", "iteration"):
                spec.iteration = ival
            elif key == "count":
                spec.count = ival
            else:
                raise ValueError(
                    f"unknown fault param {key!r} in {text!r}; expected iter/chunk/cycle or count"
                )
    return spec


# ---------------------------------------------------------------------------
# registry: a context-manager stack plus a lazily parsed REPRO_FAULT env spec.
# Env specs are cached per raw string so their fired-count survives repeated
# lookups within one process (one process == one deterministic firing).

_lock = threading.Lock()
_stack: list = []
_env_cache: dict = {}


def _env_specs() -> list:
    raw = (envcfg.get_str(_ENV_VAR) or "").strip()
    if not raw:
        return []
    cached = _env_cache.get(raw)
    if cached is None:
        cached = [parse_fault(part) for part in raw.split(";") if part.strip()]
        _env_cache[raw] = cached
    return cached


@contextlib.contextmanager
def inject(spec: Union[str, FaultSpec]):
    """Arm a fault for the duration of the block; yields the live spec so
    tests can assert on ``fired``."""
    fs = parse_fault(spec) if isinstance(spec, str) else spec
    with _lock:
        _stack.append(fs)
    try:
        yield fs
    finally:
        with _lock:
            _stack.remove(fs)


def reset() -> None:
    """Disarm everything (including cached env specs): test teardown."""
    with _lock:
        _stack.clear()
        _env_cache.clear()


def fault_spec(kind: str) -> Optional[FaultSpec]:
    """The innermost armed spec for ``kind``, or None.  Cheap when idle."""
    if _stack:
        with _lock:
            for fs in reversed(_stack):
                if fs.kind == kind and fs.armed:
                    return fs
    for fs in _env_specs():
        if fs.kind == kind and fs.armed:
            return fs
    return None


def trace_key() -> Optional[tuple]:
    """Hashable description of the armed Lanczos-visible faults: None when
    idle, a unique tuple per (spec, fired) state otherwise (the reference
    keys its compiled sweeps on it)."""
    parts = []
    for kind in ("spmv_nan", "beta_collapse"):
        fs = fault_spec(kind)
        if fs is not None:
            parts.append((fs.kind, fs.iteration, fs.count, fs.fired))
    return tuple(parts) if parts else None


# ---------------------------------------------------------------------------
# injection points (called from production code; all cheap no-ops when idle)


def tap_spmv(u, i: int):
    """Poison the SpMV output at the armed step: a copy of ``u`` with a NaN
    in its first entry (never ``u`` itself, which may be a buffer a kernel
    wrote)."""
    fs = fault_spec("spmv_nan")
    if fs is None or i != (fs.iteration or 0):
        return u
    fs.fired += 1
    poisoned = u.clone()
    # fill_ takes the scalar as a kernel argument: no host->device copy,
    # so no sync (an item assignment would copy the scalar and wait).
    poisoned[:1].fill_(float("nan"))
    return poisoned


def tap_beta(beta, i: int):
    """Collapse beta to 0 at the armed step (lucky-breakdown shape).  A host
    float becomes 0.0; a 0-d tensor becomes ``beta * 0`` on its device,
    with nothing read back."""
    fs = fault_spec("beta_collapse")
    if fs is None or i != (fs.iteration or 0):
        return beta
    fs.fired += 1
    return type(beta)(0.0) if isinstance(beta, float) else beta * 0


def consume_lanczos(key: Optional[tuple]) -> None:
    """Count one firing per fault kind in ``key`` (a ``trace_key()``); None
    consumes nothing."""
    if not key:
        return
    for kind, *_ in key:
        fs = fault_spec(kind)
        if fs is not None:
            fs.fired += 1


def check_sweep_entry() -> None:
    """Raise the armed sweep-entry fault (kernel_error / oom), if any.
    Called once per Lanczos sweep, before any device work."""
    fs = fault_spec("kernel_error")
    if fs is not None:
        fs.fired += 1
        raise InjectedKernelError("injected kernel launch failure (fault harness)")
    fs = fault_spec("oom")
    if fs is not None:
        fs.fired += 1
        raise InjectedOOMError(
            "CUDA out of memory while allocating the Krylov basis (fault harness)"
        )


def check_chunk_io(chunk_index: int) -> None:
    """Raise the armed chunk-staging I/O fault when ``chunk_index`` matches."""
    fs = fault_spec("chunk_io_error")
    if fs is None:
        return
    if fs.iteration is not None and chunk_index != fs.iteration:
        return
    fs.fired += 1
    raise InjectedChunkIOError(f"injected I/O error staging chunk {chunk_index}")


def check_solve_crash(cycle: int) -> None:
    """Abort a restarted solve at the armed cycle (checkpoint tests)."""
    fs = fault_spec("solve_crash")
    if fs is None:
        return
    if fs.iteration is not None and cycle != fs.iteration:
        return
    fs.fired += 1
    raise InjectedCrash(f"injected crash at restart cycle {cycle}")


def check_scheduler() -> None:
    """Kill the calling scheduler thread (BaseException: see the class)."""
    fs = fault_spec("scheduler_crash")
    if fs is None:
        return
    fs.fired += 1
    raise SchedulerThreadDeath("injected dispatch-thread death")
