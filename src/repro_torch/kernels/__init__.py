"""The port's Hopper kernels (``csrc/``), their plain versions (``ref``),
the public wrappers (``ops``) and the SpMV engine (``engine``).  Importing
this package builds nothing: the CUDA library is built at first launch."""

from . import engine, ops, ref
from .engine import SpmvEngine, choose_format, make_engine

__all__ = [
    "engine",
    "ops",
    "ref",
    "SpmvEngine",
    "choose_format",
    "make_engine",
]
