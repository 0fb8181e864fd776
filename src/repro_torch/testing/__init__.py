"""Test-support utilities that ship with the package (not under tests/):
the deterministic fault-injection harness lives here because production
code hosts its injection points and CI arms it via ``REPRO_FAULT``."""

from . import faults
from .faults import FaultSpec, inject, parse_fault

__all__ = ["faults", "FaultSpec", "inject", "parse_fault"]
