"""The port's user-facing API: ``eigsh``, ``prepare``, ``EigenResult``."""

from ..core.lanczos import NumericalBreakdown
from .coerce import CoercedInput, coerce_input
from .dispatch import BACKENDS, select_backend
from .frontend import SolverConfig, eigsh, resolve_policy
from .result import EigenResult
from .session import EigenSession, prepare

__all__ = [
    "eigsh",
    "prepare",
    "EigenSession",
    "EigenResult",
    "SolverConfig",
    "NumericalBreakdown",
    "CoercedInput",
    "coerce_input",
    "BACKENDS",
    "select_backend",
    "resolve_policy",
]
