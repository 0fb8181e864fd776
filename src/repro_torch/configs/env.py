"""Registry of the ``REPRO_*`` environment knobs the PyTorch port reads.

The same names and defaults as ``repro/configs/env.py``, so one environment
steers both packages; only the knobs this package reads are declared.  Every
read goes through the typed accessors below (stdlib only: this module sits
below everything else in the package).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterable, Optional

__all__ = [
    "EnvKnob",
    "KNOBS",
    "knob",
    "raw",
    "get_bool",
    "get_int",
    "get_float",
    "get_str",
    "is_falsey",
    "is_truthy",
]


@dataclasses.dataclass(frozen=True)
class EnvKnob:
    """One declared environment variable (``type`` is documentation-facing;
    the accessor the call site picks does the parsing)."""

    name: str
    type: str
    default: Any
    description: str


def _k(name: str, type: str, default: Any, description: str) -> EnvKnob:
    return EnvKnob(name=name, type=type, default=default, description=description)


_DECLARED: Iterable[EnvKnob] = (
    _k(
        "REPRO_SPMV_TUNE",
        "bool",
        False,
        "Enable the measured SpMV/iteration autotuner (off = heuristic tiles).",
    ),
    _k(
        "REPRO_SPMV_TUNE_CACHE",
        "path",
        ".cache/spmv_tune.json",
        "Path of the persistent autotune decision cache ('' disables persistence).",
    ),
    _k(
        "REPRO_SPMV_TUNE_BUDGET",
        "int",
        6,
        "Max number of tile candidates the autotuner measures per matrix.",
    ),
    _k(
        "REPRO_SPMV_TILES",
        "str",
        None,
        "Force SpMV tile config as 'RxW[@B]' (rows x width [@ bsr block]), bypassing heuristics.",
    ),
    _k(
        "REPRO_SPMV_ELL_OVERHEAD",
        "float",
        3.0,
        "Max ELL padded-cells / nnz overhead before falling back to COO/hybrid.",
    ),
    _k(
        "REPRO_SPMV_BSR_FILL",
        "float",
        0.35,
        "Min block fill fraction required to pick the BSR kernel.",
    ),
    _k(
        "REPRO_SPMV_HYBRID_Q",
        "float",
        0.995,
        "Row-length quantile that splits the ELL part from the COO tail in hybrid format.",
    ),
    _k(
        "REPRO_SPMV_HYBRID_TAIL",
        "float",
        0.05,
        "Max tail-nnz fraction for which hybrid is preferred over plain COO.",
    ),
    _k(
        "REPRO_ITER_UPDATE",
        "str",
        None,
        "Force the Lanczos update mode: 'fused', 'fused_spmv', 'unfused', or 'auto'.",
    ),
    _k(
        "REPRO_FUSED_LANCZOS",
        "bool",
        True,
        "Allow the fused Lanczos vector-update kernel (0/false/off disables).",
    ),
    _k(
        "REPRO_EIGSH_CHUNK_NNZ",
        "int",
        25_000_000,
        "nnz threshold above which eigsh routes to the out-of-core chunked engine.",
    ),
    _k(
        "REPRO_CHUNK_STAGING",
        "str",
        "f32",
        "Out-of-core chunk staging mode: 'f32' (plain), 'bf16'/'fp8' (packed), or 'auto'.",
    ),
    _k(
        "REPRO_EIGSH_SESSION_CACHE",
        "int",
        8,
        "Max entries in the process-wide warm EigenSession cache (0 disables).",
    ),
    _k(
        "REPRO_EIGSH_SESSION_CACHE_MB",
        "float",
        2048.0,
        "Total bytes budget (MB) for the warm EigenSession cache.",
    ),
    _k(
        "REPRO_CHUNK_CKPT_EVERY",
        "int",
        1,
        "Chunks between mid-step chunk-cursor checkpoints in the out-of-core host loop "
        "(0 = end-of-step saves only).",
    ),
    _k(
        "REPRO_DISKCSR_FP_BLOCKS",
        "int",
        16,
        "Strided 64KiB sample blocks per array in the DiskCSR content fingerprint.",
    ),
    _k(
        "REPRO_VALIDATE_INPUT",
        "bool",
        True,
        "Validate user matrices (finite values, symmetry probe) on ingestion.",
    ),
    _k(
        "REPRO_SERVING_STORE",
        "path",
        None,
        "Directory for the serving layer's persistent session store (unset = in-memory).",
    ),
    _k(
        "REPRO_SOLVE_CHECKPOINTS",
        "path",
        None,
        "Directory for mid-solve Lanczos checkpoints (unset = checkpointing off).",
    ),
    _k(
        "REPRO_FAULT",
        "str",
        None,
        "Fault-injection spec 'kind[@iter=N][,...]' armed for the next solve (CI robustness legs).",
    ),
    _k(
        "REPRO_PRECISION_MEASURE",
        "bool",
        False,
        "Attach the op counter's measured op counts (ops_by_dtype_measured) to result partitions.",
    ),
)

KNOBS: Dict[str, EnvKnob] = {k.name: k for k in _DECLARED}

_TRUE = frozenset({"1", "true", "on", "yes"})
_FALSE = frozenset({"0", "false", "off", "no"})


def knob(name: str) -> EnvKnob:
    """Return the declaration for ``name``; raise KeyError for undeclared knobs."""
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(
            f"{name} is not a declared REPRO_* knob of repro_torch; add it to "
            "repro_torch/configs/env.py"
        ) from None


def raw(name: str) -> Optional[str]:
    """The raw environment string for a declared knob, or None when unset."""
    knob(name)
    return os.environ.get(name)


def is_truthy(value: str) -> bool:
    return value.strip().lower() in _TRUE


def is_falsey(value: str) -> bool:
    return value.strip().lower() in _FALSE


def get_bool(name: str, default: Optional[bool] = None) -> bool:
    """1/true/on/yes -> True, 0/false/off/no -> False, else the default."""
    k = knob(name)
    fallback = k.default if default is None else default
    value = os.environ.get(name)
    if value is None:
        return bool(fallback)
    v = value.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    return bool(fallback)


def get_int(name: str, default: Optional[int] = None) -> int:
    """Parse an integer knob; an unparseable value raises ValueError."""
    k = knob(name)
    fallback = k.default if default is None else default
    value = os.environ.get(name)
    if value is None or not value.strip():
        return int(fallback)
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {value!r}") from None


def get_float(name: str, default: Optional[float] = None, *, lenient: bool = False) -> float:
    """Parse a float knob; ``lenient=True`` falls back to the default on junk."""
    k = knob(name)
    fallback = k.default if default is None else default
    value = os.environ.get(name)
    if value is None or not value.strip():
        return float(fallback)
    try:
        return float(value)
    except ValueError:
        if lenient:
            return float(fallback)
        raise ValueError(f"{name} must be a number, got {value!r}") from None


def get_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """The raw string for a knob, or its default (registry default if None)."""
    k = knob(name)
    fallback = k.default if default is None else default
    value = os.environ.get(name)
    return value if value is not None else fallback
