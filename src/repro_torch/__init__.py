"""repro_torch: the PyTorch/CUDA port of the mixed-precision Top-K sparse
eigensolver, beside the JAX reference package ``repro``.

The one-call entry point is :func:`repro_torch.eigsh`; it runs on the card
(``device="cuda"``, the default) through hand-written Hopper kernels, or on
the host with ``device="cpu"`` through their plain PyTorch versions.
"""

__version__ = "0.1.0"

from .api import (
    EigenResult,
    EigenSession,
    SolverConfig,
    eigsh,
    eigsh_many,
    prepare,
    session_cache_clear,
    session_cache_info,
)

__all__ = [
    "eigsh",
    "eigsh_many",
    "prepare",
    "EigenSession",
    "SolverConfig",
    "EigenResult",
    "session_cache_clear",
    "session_cache_info",
    "__version__",
]
