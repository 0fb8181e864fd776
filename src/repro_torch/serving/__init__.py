"""Eigensolver serving: async scheduler, persistent warm sessions, metrics,
and the mid-solve snapshot store behind ``checkpoint_dir=``.

    from repro_torch.serving import EigenScheduler, SchedulerConfig, SessionStore

    with EigenScheduler(store=SessionStore(root)) as sched:
        key = sched.add_matrix(csr, config=SolverConfig(device="cuda"))
        h = sched.submit(key, k=8, num_iters=32)   # future
        res = h.result()                           # per-query EigenResult
        print(sched.stats().summary())             # p50/p99, coalesce rate

The legacy LM decode engine moved to ``repro_torch.serving.lm``; importing
``Engine`` / ``ServeConfig`` from here still works with a
``DeprecationWarning``, as in the reference.
"""

import warnings

from .metrics import LatencyHistogram, ServerStats, ServingMetrics
from .scheduler import (
    DeadlineExceededError,
    EigenScheduler,
    QueryCancelledError,
    QueryHandle,
    QueueFullError,
    SchedulerConfig,
    SchedulerCrashedError,
    ServingError,
    SessionUnhealthyError,
    UnknownMatrixError,
)
from .store import SessionStore, SolveCheckpoint, default_checkpoint_root, default_store_root

__all__ = [
    "EigenScheduler",
    "SchedulerConfig",
    "QueryHandle",
    "SessionStore",
    "SolveCheckpoint",
    "default_store_root",
    "default_checkpoint_root",
    "ServingMetrics",
    "ServerStats",
    "LatencyHistogram",
    "ServingError",
    "QueueFullError",
    "DeadlineExceededError",
    "QueryCancelledError",
    "UnknownMatrixError",
    "SessionUnhealthyError",
    "SchedulerCrashedError",
]

_LEGACY = ("Engine", "ServeConfig")


def __getattr__(name: str):
    if name in _LEGACY:
        warnings.warn(
            f"repro_torch.serving.{name} is the legacy LM decode engine; import it from "
            "repro_torch.serving.lm (the eigensolver serving layer is "
            "repro_torch.serving.EigenScheduler)",
            DeprecationWarning,
            stacklevel=2,
        )
        from . import lm

        return getattr(lm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
