"""repro_torch.analysis: the reference's ``repro.analysis`` for the port.

Four passes, the reference's rule IDs:

  * ``precision`` (P-rules): the declared phase map against the ops a run
    executes per dtype, counted under a ``TorchDispatchMode``
    (``op_count.py``; the kernels report their declared op contracts);
  * ``kernels`` (K-rules): the Hopper launch checker of the six CUDA kernels
    (launch shapes, index bounds and partial buffers, the compiled
    kernels' resources on the card, deterministic reductions);
  * ``concurrency`` (C-rules) and ``config`` (E-rules): the AST lints over
    ``src/repro_torch``.

Library: :func:`run_checks`; CLI: ``python -m repro_torch.analysis [--check
NAME]... [--strict] [--device cpu|cuda]``.  A source-anchored finding can be
suppressed with ``# repro: ignore[RULE]`` on its line, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from .findings import RULES, Finding, Findings, format_findings, is_suppressed

__all__ = [
    "RULES",
    "Finding",
    "Findings",
    "CHECKS",
    "format_findings",
    "is_suppressed",
    "resolve_device",
    "run_checks",
]

# Check names (each pass is imported lazily: the precision pass pulls in the
# whole solver stack, the AST passes need nothing).
CHECKS = ("precision", "kernels", "concurrency", "config")


def resolve_device(device: Optional[str] = None) -> str:
    """The device type the passes run on: ``device`` as given, the card for
    None.  Without a visible card the card raises (the session's error, which
    names ``device="cpu"``): the passes never fall back to the host."""
    from .._device import resolve_device as _resolve

    return _resolve(device).type


def run_checks(
    checks: Optional[Iterable[str]] = None,
    *,
    repo_root: str = ".",
    device: Optional[str] = None,
) -> Dict[str, Findings]:
    """Run the selected passes on ``device`` (see :func:`resolve_device`);
    returns {check name: findings}."""
    selected = list(checks) if checks is not None else list(CHECKS)
    unknown = [c for c in selected if c not in CHECKS]
    if unknown:
        raise ValueError(f"unknown checks {unknown}; available: {list(CHECKS)}")
    out: Dict[str, Findings] = {}
    for name in selected:
        if name == "precision":
            from . import precision_flow

            out[name] = precision_flow.run(device=resolve_device(device))
        elif name == "kernels":
            from . import kernel_check

            out[name] = kernel_check.run(resolve_device(device))
        elif name == "concurrency":
            from . import concurrency

            out[name] = concurrency.run(repo_root=repo_root)
        elif name == "config":
            from . import config_lint

            out[name] = config_lint.run(repo_root=repo_root)
    return out
