"""Finding/rule infrastructure shared by every ``repro_torch.analysis`` pass.

The reference's table (``repro/analysis/findings.py``) with the same stable
IDs, so a ``# repro: ignore[RULE]`` comment means the same in both packages.
The P-, C- and E-rules keep their meaning; the K-rules check the port's CUDA
kernels on Hopper instead of Pallas grid mappings (no VMEM, no tiles):
launch shapes, index bounds and partial buffers, the compiled kernels'
resources, and deterministic cross-block reductions.

Findings carry ``file:line`` when they anchor to source and a synthetic
context (``<FDF/single/fused>``, ``<spmv_ell/float32/w8>``) when they anchor
to a measured run or a launch plan.  Stdlib only.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Optional

__all__ = [
    "RULES",
    "Finding",
    "Findings",
    "is_suppressed",
    "filter_suppressed",
    "format_findings",
]

# Stable rule IDs.  Never renumber: suppression comments reference them.
RULES: Dict[str, str] = {
    # Precision-flow verifier (aten ops counted under a TorchDispatchMode)
    "P001": "undeclared upcast: a conversion widens into a dtype the policy never declares",
    "P002": "double rounding: value cast down then back up through an undeclared dtype",
    "P003": "phase leak: arithmetic executes in a dtype foreign to the declared phase",
    "P004": "model divergence: phase_op_counts disagrees with the measured counts",
    # Hopper launch checker (the port's CUDA kernels)
    "K001": "launch shape: lanes that do not divide a warp, a block other than kThreads, "
            "or a grid past 2^31 - 1 blocks",
    "K002": "bounds: an index product overflows the type it is formed in, or a partial "
            "buffer is smaller than the grid that writes it",
    "K003": "resources: a kernel instantiation needs more than 227 KB of shared memory a "
            "block or cannot be resident (occupancy 0)",
    "K004": "nondeterministic reduction: a float atomic, or a cross-block scalar not "
            "reduced by one fixed-order pass over per-block partials",
    # Concurrency lints (AST-level)
    "C001": "field declared in _GUARDED_BY mutated outside a `with self.<lock>` block",
    "C002": "lock acquisition order violation between scheduler and session locks",
    # Config lints
    "E001": "raw os.environ/os.getenv read of a REPRO_* knob bypassing configs/env.py",
    "E002": "env-knob registry and README documentation out of sync",
}

_IGNORE_RE = re.compile(r"#\s*repro:\s*ignore\[([A-Z]\d{3}(?:\s*,\s*[A-Z]\d{3})*)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verified problem: a stable rule ID, a location, and the story."""

    rule: str
    message: str
    file: str = ""  # repo-relative path, or "" for run-anchored findings
    line: int = 0
    context: str = ""  # e.g. "FDF/single/fused" or a kernel/plan label

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown rule ID {self.rule!r}; known: {sorted(RULES)}")

    def location(self) -> str:
        if self.file:
            return f"{self.file}:{self.line}" if self.line else self.file
        return f"<{self.context}>" if self.context else "<run>"

    def __str__(self) -> str:
        ctx = f" [{self.context}]" if self.context and self.file else ""
        return f"{self.rule} {self.location()}{ctx}: {self.message}"


Findings = List[Finding]


def is_suppressed(source_line: str, rule: str) -> bool:
    """True when ``source_line`` carries ``# repro: ignore[...]`` naming ``rule``."""
    m = _IGNORE_RE.search(source_line)
    if not m:
        return False
    return rule in {r.strip() for r in m.group(1).split(",")}


def filter_suppressed(findings: Iterable[Finding], source_lines: Optional[List[str]]) -> Findings:
    """Drop findings whose anchoring source line suppresses their rule."""
    if source_lines is None:
        return list(findings)
    kept = []
    for f in findings:
        if f.line and 1 <= f.line <= len(source_lines):
            if is_suppressed(source_lines[f.line - 1], f.rule):
                continue
        kept.append(f)
    return kept


def format_findings(findings: Iterable[Finding]) -> str:
    fs = list(findings)
    if not fs:
        return "no findings"
    return "\n".join(str(f) for f in fs)
