"""Config lints: every REPRO_* knob the port reads flows through one registry.

The reference's ``repro/analysis/config_lint.py`` for the port:

  * **E001** — AST pass over ``src/repro_torch`` and ``bench_torch``: any
    ``os.environ[...]``, ``os.environ.get(...)`` or ``os.getenv(...)``
    *read* of a ``REPRO_*`` name outside ``configs/env.py`` bypasses the
    registry.  Writes (``os.environ[...] = ...``, ``.setdefault``, ``.pop``,
    ``del``) are allowed: pinning a knob for a subprocess is how the
    registry itself is driven.

  * **E002** — the port's registry and the README's port section
    (:data:`PORT_SECTION`) agree both ways: every knob the port declares
    appears there, and every ``REPRO_*`` token there is a knob the port
    declares, or one of the reference's TPU-only knobs the section names to
    say the port does not read it (:data:`NOT_READ`).  The reference's own
    lint holds the whole README to the reference's registry.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable, List, Optional, Tuple

from .findings import Finding, Findings, filter_suppressed

__all__ = [
    "DEFAULT_TARGETS",
    "find_raw_env_reads",
    "check_file",
    "check_readme_sync",
    "port_section",
    "PORT_SECTION",
    "NOT_READ",
    "run",
]

DEFAULT_TARGETS = ("src/repro_torch", "bench_torch")
PORT_SECTION = "## PyTorch port"
# The reference's knobs the port section names only to say the port does
# not read them (both steer Pallas on the TPU).
NOT_READ = frozenset({"REPRO_ANALYSIS_VMEM_MB", "REPRO_PALLAS_LOWER_CHECK"})
_EXCLUDE_SUFFIXES = (os.path.join("configs", "env.py"),)
_REPRO_RE = re.compile(r"\bREPRO_[A-Z0-9_]+\b")


def _repro_name(node: ast.AST) -> Optional[str]:
    """The REPRO_* string constant a call/subscript argument carries."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        if node.value.startswith("REPRO_"):
            return node.value
    return None


def _is_os_environ(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Attribute)
        and node.attr == "environ"
        and isinstance(node.value, ast.Name)
        and node.value.id == "os"
    )


def find_raw_env_reads(source: str, path: str = "<string>") -> Findings:
    """E001 findings for one module's source text."""
    tree = ast.parse(source, filename=path)
    findings: List[Finding] = []

    def flag(name: str, lineno: int, how: str) -> None:
        findings.append(
            Finding(
                "E001",
                f"raw {how} read of {name} — route it through"
                f" repro_torch.configs.env (declared knobs only)",
                file=path,
                line=lineno,
            )
        )

    for node in ast.walk(tree):
        # os.getenv("REPRO_X")  /  os.environ.get("REPRO_X")
        if isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr == "getenv"
                and isinstance(func.value, ast.Name)
                and func.value.id == "os"
            ):
                name = _repro_name(node.args[0]) if node.args else None
                if name:
                    flag(name, node.lineno, "os.getenv")
            elif (
                isinstance(func, ast.Attribute)
                and func.attr == "get"
                and _is_os_environ(func.value)
            ):
                name = _repro_name(node.args[0]) if node.args else None
                if name:
                    flag(name, node.lineno, "os.environ.get")
        # os.environ["REPRO_X"] in Load context (stores/deletes are writes)
        elif isinstance(node, ast.Subscript):
            if _is_os_environ(node.value) and isinstance(node.ctx, ast.Load):
                name = _repro_name(node.slice)
                if name:
                    flag(name, node.lineno, "os.environ[]")
    return filter_suppressed(findings, source.splitlines())


def check_file(path: str, repo_root: str = ".") -> Findings:
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    rel = os.path.relpath(path, repo_root)
    return find_raw_env_reads(source, rel)


def port_section(readme_text: str) -> Optional[str]:
    """The README's port section: from the :data:`PORT_SECTION` heading to
    the next heading of its level, or None when there is none."""
    start = readme_text.find(PORT_SECTION)
    if start < 0:
        return None
    end = readme_text.find("\n## ", start + len(PORT_SECTION))
    return readme_text[start:] if end < 0 else readme_text[start:end]


def check_readme_sync(
    knob_names: Iterable[str], readme_text: str, readme_path: str = "README.md"
) -> Findings:
    """E002: registry <-> README text (the port section), both directions."""
    declared = set(knob_names)
    documented = set(_REPRO_RE.findall(readme_text)) - NOT_READ
    findings: List[Finding] = []
    for name in sorted(declared - documented):
        findings.append(
            Finding(
                "E002",
                f"knob {name} is declared in repro_torch/configs/env.py but"
                f" undocumented in {readme_path}'s port section",
                file=readme_path,
            )
        )
    for name in sorted(documented - declared):
        findings.append(
            Finding(
                "E002",
                f"{readme_path}'s port section documents {name}, which is not declared"
                f" in repro_torch/configs/env.py (deleted or misspelled knob)",
                file=readme_path,
            )
        )
    return findings


def _iter_py(target: str) -> List[str]:
    if os.path.isfile(target):
        return [target]
    out = []
    for dirpath, _, files in os.walk(target):
        out.extend(
            os.path.join(dirpath, f) for f in sorted(files) if f.endswith(".py")
        )
    return out


def run(
    targets: Tuple[str, ...] = DEFAULT_TARGETS, repo_root: str = "."
) -> Findings:
    findings: List[Finding] = []
    for target in targets:
        full = target if os.path.isabs(target) else os.path.join(repo_root, target)
        if not os.path.exists(full):
            continue
        for path in _iter_py(full):
            if any(path.endswith(suffix) for suffix in _EXCLUDE_SUFFIXES):
                continue
            findings.extend(check_file(path, repo_root))
    readme = os.path.join(repo_root, "README.md")
    if os.path.exists(readme):
        from ..configs.env import KNOBS

        with open(readme, encoding="utf-8") as fh:
            section = port_section(fh.read())
        if section is None:
            findings.append(Finding("E002", f"README.md has no '{PORT_SECTION}' section",
                                    file="README.md"))
        else:
            findings.extend(check_readme_sync(KNOBS, section))
    return findings
