"""Nothing under eigbench/ imports JAX or the JAX package or its
harnesses, by top-level module name compared whole (``repro_torch``
begins with ``repro``), and the reference imports nothing of the program."""

import ast
import os

from eigbench.tests.tiny import REPO

HERE = os.path.join(REPO, "eigbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks", "bench_torch"}


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _modules(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {(os.path.relpath(p, REPO), name) for p in _modules()
             for name in _top_level_imports(p) if name in FORBIDDEN}
    assert not found
    # the comparison is by whole names: the port itself is allowed
    assert "repro_torch" in {n for p in _modules() for n in _top_level_imports(p)}


def test_the_reference_imports_nothing_of_the_program():
    for p in _modules("reference"):
        names = set(_top_level_imports(p))
        assert not names & (FORBIDDEN | {"repro_torch"}), p
