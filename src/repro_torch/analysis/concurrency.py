"""Concurrency lints over the port's serving layer and session (AST: no
imports, no execution), the reference's ``repro/analysis/concurrency.py``
pointed at ``src/repro_torch``.

  * **C001** — a class that declares ``_GUARDED_BY = {"field": "_lock"}``
    promises every mutation of ``self.field`` happens inside a
    ``with self._lock:`` block.  The pass tracks the lexical lock stack
    through each method (nested functions inherit the locks held at their
    definition point — the scheduler's worker closures are defined and
    called under the same lock discipline) and flags writes, augmented
    assignments, subscript stores, and mutating container calls
    (``append``/``pop``/...) outside the declared lock.  Exempt:
    ``__init__`` (no concurrent access before construction completes),
    methods named ``*_locked``, and methods whose ``def`` line carries
    ``# repro: holds[LOCK]``.

  * **C002** — lock-acquisition order.  The deadlock-free order across the
    serving stack is scheduler ``_cv`` -> session ``_query_lock`` ->
    session ``_build_lock`` (:data:`LOCK_ORDER`).  Flagged: acquiring an
    earlier-ranked lock while lexically holding a later-ranked one, and —
    the cross-object case the ranks can't see — calling a session
    entrypoint (``eigsh``/``eigsh_many``/``warmup``/...) on a non-self
    object while holding ``_cv``: those entrypoints take ``_query_lock``
    internally, so the call inverts the order whenever a session thread
    simultaneously reaches back into the scheduler.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Tuple

from .findings import Finding, Findings, filter_suppressed

__all__ = [
    "LOCK_ORDER",
    "SESSION_ENTRYPOINTS",
    "MUTATING_METHODS",
    "check_source",
    "check_file",
    "run",
    "DEFAULT_TARGETS",
]

# Canonical acquisition order (lower rank acquired first).
LOCK_ORDER: Dict[str, int] = {"_cv": 0, "_query_lock": 1, "_build_lock": 2}

# Session methods that internally take _query_lock / _build_lock: calling
# them on another object while holding _cv inverts LOCK_ORDER.
SESSION_ENTRYPOINTS = frozenset(
    {"eigsh", "eigsh_many", "warmup", "import_plans", "export_state"}
)

# Container-method calls that mutate their receiver.
MUTATING_METHODS = frozenset(
    {
        "append", "appendleft", "extend", "insert", "pop", "popleft",
        "popitem", "remove", "clear", "update", "add", "discard",
        "setdefault", "move_to_end", "sort", "reverse",
    }
)

DEFAULT_TARGETS = ("src/repro_torch/serving", "src/repro_torch/api/session.py")

_HOLDS_RE = re.compile(r"#\s*repro:\s*holds\[(\w+)\]")


def _self_attr(node: ast.AST) -> Optional[str]:
    """'X' when node is exactly ``self.X``."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _mutated_self_field(target: ast.AST) -> Optional[str]:
    """The ``self.X`` field a store-target mutates, if any.

    Covers ``self.X = ...``, ``self.X[...] = ...``, ``self.X.attr = ...``
    (attribute of a guarded object counts as mutating the guarded object).
    """
    node = target
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        field = _self_attr(node)
        if field is not None:
            return field
        node = node.value
    return None


def _with_lock_names(node: ast.With) -> List[str]:
    """Locks this with-statement acquires via ``with self.<lock>:``."""
    names = []
    for item in node.items:
        field = _self_attr(item.context_expr)
        if field is not None:
            names.append(field)
    return names


class _MethodVisitor(ast.NodeVisitor):
    """Walks one method body tracking the lexical lock stack."""

    def __init__(
        self,
        guarded: Dict[str, str],
        path: str,
        exempt: bool,
        findings: List[Finding],
        held: Optional[List[str]] = None,
    ):
        self.guarded = guarded
        self.path = path
        self.exempt = exempt
        self.findings = findings
        self.held: List[str] = list(held or [])

    # -- lock tracking -----------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        locks = _with_lock_names(node)
        for lock in locks:
            rank = LOCK_ORDER.get(lock)
            if rank is not None:
                worst = max(
                    (LOCK_ORDER[h] for h in self.held if h in LOCK_ORDER),
                    default=-1,
                )
                if worst > rank:
                    holder = next(
                        h for h in self.held
                        if h in LOCK_ORDER and LOCK_ORDER[h] == worst
                    )
                    self.findings.append(
                        Finding(
                            "C002",
                            f"acquires {lock} while holding {holder}"
                            f" (canonical order: "
                            f"{' -> '.join(sorted(LOCK_ORDER, key=LOCK_ORDER.get))})",
                            file=self.path,
                            line=node.lineno,
                        )
                    )
        self.held.extend(locks)
        for child in node.body:
            self.visit(child)
        for _ in locks:
            self.held.pop()

    # -- mutations ---------------------------------------------------------

    def _check_mutation(self, field: str, lineno: int) -> None:
        if self.exempt:
            return
        lock = self.guarded.get(field)
        if lock is not None and lock not in self.held:
            self.findings.append(
                Finding(
                    "C001",
                    f"self.{field} is declared guarded by {lock} but is"
                    f" mutated without holding it",
                    file=self.path,
                    line=lineno,
                )
            )

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            field = _mutated_self_field(target)
            if field is not None:
                self._check_mutation(field, node.lineno)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        field = _mutated_self_field(node.target)
        if field is not None:
            self._check_mutation(field, node.lineno)
        self.visit(node.value)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            # self.X.append(...) — mutating call on a guarded container
            if func.attr in MUTATING_METHODS:
                field = _mutated_self_field(func.value)
                if field is not None:
                    self._check_mutation(field, node.lineno)
            # C002 cross-object: session entrypoint called under _cv on a
            # receiver that is not self (self-calls are rank-checked above).
            if (
                func.attr in SESSION_ENTRYPOINTS
                and "_cv" in self.held
                and not (isinstance(func.value, ast.Name) and func.value.id == "self")
            ):
                self.findings.append(
                    Finding(
                        "C002",
                        f".{func.attr}() called while holding _cv — session"
                        f" entrypoints take _query_lock internally, inverting"
                        f" the lock order",
                        file=self.path,
                        line=node.lineno,
                    )
                )
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # Nested closure: inherits the lock stack at its definition point.
        inner = _MethodVisitor(
            self.guarded, self.path, self.exempt, self.findings, held=self.held
        )
        for child in node.body:
            inner.visit(child)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]


def _guarded_by_map(cls: ast.ClassDef) -> Dict[str, str]:
    """The ``_GUARDED_BY`` dict literal of a class body, if declared."""
    for stmt in cls.body:
        if not isinstance(stmt, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == "_GUARDED_BY" for t in stmt.targets
        ):
            continue
        if isinstance(stmt.value, ast.Dict):
            out = {}
            for k, v in zip(stmt.value.keys, stmt.value.values):
                if isinstance(k, ast.Constant) and isinstance(v, ast.Constant):
                    out[str(k.value)] = str(v.value)
            return out
    return {}


def _method_exempt(fn: ast.FunctionDef, source_lines: List[str]) -> bool:
    if fn.name == "__init__" or fn.name.endswith("_locked"):
        return True
    if 1 <= fn.lineno <= len(source_lines):
        if _HOLDS_RE.search(source_lines[fn.lineno - 1]):
            return True
    return False


def check_source(source: str, path: str = "<string>") -> Findings:
    """Both lints over one module's source text."""
    tree = ast.parse(source, filename=path)
    lines = source.splitlines()
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        guarded = _guarded_by_map(node)
        for stmt in node.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            visitor = _MethodVisitor(
                guarded, path, _method_exempt(stmt, lines), findings
            )
            for child in stmt.body:
                visitor.visit(child)
    return filter_suppressed(findings, lines)


def check_file(path: str, repo_root: str = ".") -> Findings:
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    rel = os.path.relpath(path, repo_root)
    return check_source(source, rel)


def _iter_py(target: str) -> List[str]:
    if os.path.isfile(target):
        return [target]
    out = []
    for dirpath, _, files in os.walk(target):
        out.extend(
            os.path.join(dirpath, f) for f in sorted(files) if f.endswith(".py")
        )
    return out


def run(targets: Tuple[str, ...] = DEFAULT_TARGETS, repo_root: str = ".") -> Findings:
    findings: List[Finding] = []
    for target in targets:
        full = target if os.path.isabs(target) else os.path.join(repo_root, target)
        if not os.path.exists(full):
            continue
        for path in _iter_py(full):
            findings.extend(check_file(path, repo_root))
    return findings
