"""Where a solve's time goes: host spans, a profiler range under a
profiler, and one counter, all landing in ``EigenResult.timings``.

``span(name, into, key)`` always adds its host time (``time.perf_counter``
at entry and exit) to ``into[key]``, so a result's timings are filled with
tracing off.  Only while ``torch.profiler`` (or the autograd profiler)
records does it also open a range named ``name``, on the profiler's clock,
which is the device trace's: a trace then names each stretch of host work
between kernels by its innermost span.  Outside a profiler a span costs
about 2 µs, the check for a profiler a fraction of one; a range would add
about 15.  A span with no name keeps host time only.

``count(key, n)`` adds ``n`` to every record opened by ``counting``, on
this thread: ``eigsh_many`` opens one for each call, and counts there

* ``host_copy_bytes``: the bytes :func:`to_host` copies from a card;
* ``start_compares``: byte-wise comparisons of two distinct ``v0``s, which
  group a call's queries by start (only a call with two or more ``v0``s
  makes any);
* ``v0_digests``: host digests of a ``v0``, taken only where its key
  leaves the call (a checkpoint token, a reseed trail's ``"from"``).

The spans of one in-core solve of ``EigenSession.eigsh_many``, as
``trace name -> timings key: what it brackets``:

* ``repro_torch.query -> query_s``: the call, once the session's query
  lock is held;
* ``repro_torch.query.normalize -> normalize_s``: one query's checks and
  keys;
* ``repro_torch.query.plan -> plan_s``: the plan's lookup, or its build;
* ``repro_torch.sweep.lanczos -> lanczos_s``: the sweep, its sync and the
  health probe;
* ``repro_torch.ritz.jacobi -> jacobi_s``: the tridiagonal's eigenpairs;
* ``repro_torch.ritz.project -> project_s``: ``X = V^T W`` and its sync;
* ``repro_torch.query.finish -> finish_s``: the flags, the precision
  audit and the result.

Where a ``v0``'s content key leaves the call, ``repro_torch.query.v0_digest``
brackets its copy to the host and its hash: between the plan and the
sweep for a checkpointed sweep's token, after a failed sweep for a reseed
trail.  Its host time adds to the call's ``v0_digest_s``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, Optional

import torch

__all__ = ["HOST_COPY_BYTES", "START_COMPARES", "V0_DIGESTS", "count", "counting", "span",
           "to_host"]

HOST_COPY_BYTES = "host_copy_bytes"
START_COMPARES = "start_compares"
V0_DIGESTS = "v0_digests"

_open = threading.local()


@contextlib.contextmanager
def span(name: Optional[str], into: Optional[Dict[str, float]] = None,
         key: Optional[str] = None, args: tuple = ()) -> Iterator[None]:
    """Time the block on the host into ``into[key]`` (added to what is
    there); under a profiler also record it as the range ``name``, whose
    ``args`` a trace recorded with ``record_shapes=True`` shows as its
    inputs."""
    handle = None
    if name is not None and torch.autograd._profiler_enabled():
        handle = torch.autograd._record_function_with_args_enter(name, *args)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if handle is not None:
            torch.autograd._record_function_with_args_exit(handle)
        if into is not None:
            into[key] = into.get(key, 0.0) + dt


@contextlib.contextmanager
def counting(into: Dict[str, float]) -> Iterator[Dict[str, float]]:
    """While open, :func:`count` on this thread adds to ``into`` too."""
    records = _open.__dict__.setdefault("records", [])
    records.append(into)
    try:
        yield into
    finally:
        records.pop()


def count(key: str, n: float) -> None:
    """Add ``n`` to ``key`` of every record open on this thread."""
    for rec in getattr(_open, "records", ()):
        rec[key] = rec.get(key, 0.0) + n


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` detached on the host; a copy from a CUDA card counts its bytes
    as ``host_copy_bytes`` (a host tensor is returned as it is)."""
    if t.is_cuda:
        count(HOST_COPY_BYTES, float(t.nbytes))
    return t.detach().cpu()
