"""Eigensolver serving surface: the scheduler, store and metrics
re-exported, as the reference's ``repro/serving/engine.py`` does.

Historically this module held the LM decode ``Engine``; that code lives in
``repro_torch.serving.lm``, and ``Engine`` / ``ServeConfig`` stay
importable from here through a ``DeprecationWarning`` shim.
"""

from __future__ import annotations

import warnings

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

_LEGACY = ("Engine", "ServeConfig")


def __getattr__(name: str):
    if name in _LEGACY:
        warnings.warn(
            f"repro_torch.serving.engine.{name} is the legacy LM decode engine; import it "
            "from repro_torch.serving.lm (the eigensolver serving layer is "
            "repro_torch.serving.EigenScheduler)",
            DeprecationWarning,
            stacklevel=2,
        )
        from . import lm

        return getattr(lm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
