"""The port's user-facing API: ``eigsh``, ``prepare``, ``eigsh_many``,
``EigenResult`` and the session cache."""

from ..core.lanczos import NumericalBreakdown
from .coerce import CoercedInput, coerce_input, matrix_fingerprint
from .dispatch import BACKENDS, CHUNKED_NNZ_THRESHOLD, select_backend
from .frontend import SolverConfig, eigsh, is_auto_policy, resolve_policy
from .result import EigenResult
from .session import (
    EigenSession,
    EigQuery,
    config_fingerprint,
    eigsh_many,
    get_session,
    policy_key,
    prepare,
    session_cache_clear,
    session_cache_info,
)

__all__ = [
    "eigsh",
    "eigsh_many",
    "prepare",
    "EigenSession",
    "EigQuery",
    "EigenResult",
    "SolverConfig",
    "NumericalBreakdown",
    "CoercedInput",
    "coerce_input",
    "matrix_fingerprint",
    "config_fingerprint",
    "policy_key",
    "get_session",
    "session_cache_clear",
    "session_cache_info",
    "BACKENDS",
    "CHUNKED_NNZ_THRESHOLD",
    "select_backend",
    "resolve_policy",
    "is_auto_policy",
]
