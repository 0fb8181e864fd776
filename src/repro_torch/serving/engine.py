"""Eigensolver serving surface: the scheduler, store and metrics
re-exported, as the reference's ``repro/serving/engine.py`` does.

The reference's module also reaches its legacy LM decode engine
(``Engine``, ``ServeConfig``); the port has none yet (ROADMAP queue A, "LM
and Hessian side"), so importing either raises ``ImportError``.
"""

from __future__ import annotations

from . import __getattr__  # noqa: F401  (Engine / ServeConfig raise ImportError)
from .metrics import LatencyHistogram, ServerStats, ServingMetrics
from .scheduler import (
    DeadlineExceededError,
    EigenScheduler,
    QueryCancelledError,
    QueryHandle,
    QueueFullError,
    SchedulerConfig,
    ServingError,
    UnknownMatrixError,
)
from .store import SessionStore, default_store_root

__all__ = [
    "EigenScheduler",
    "SchedulerConfig",
    "QueryHandle",
    "SessionStore",
    "default_store_root",
    "ServingMetrics",
    "ServerStats",
    "LatencyHistogram",
    "ServingError",
    "QueueFullError",
    "DeadlineExceededError",
    "QueryCancelledError",
    "UnknownMatrixError",
]
