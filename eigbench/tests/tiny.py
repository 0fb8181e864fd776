"""A checkout-like root with tiny cells beside the real ones, for runs of
the whole harness on the CPU."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# A test process imports JAX and the JAX package for other test files, so
# whole runs in it look for none of them; test_forbidden_module_no_result
# checks the look itself.
FORBIDDEN = ()

# Large enough that the program's rounding in f32 storage averages out
# below the full-size cells' limits, as it does at full size.
TINY_CONFIGS = {
    "tiny_grid": {"generator": "grid2d", "grid_rows": 500, "grid_cols": 500, "rows": 250000},
    "tiny_wall": {"generator": "brick_wall", "lattice_cols": 500, "rows": 250000},
}
# Each tiny cell and the real cell whose traffic and limits it takes.
TINY_CELLS = {
    "tiny_grid.fdf.k8": ("tiny_grid", "hugetrace_00020.fdf.k8"),
    "tiny_wall.fdf.k8": ("tiny_wall", "hugetrace_00020.fdf.k8"),
    "tiny_grid.ddd.k8": ("tiny_grid", "hugetrace_00020.ddd.k8"),
}
# A generator that the benchmark does not have, added as a new file.
GRID2D = '''"""A grid of rows x cols nodes, each joined to its four neighbours."""

import torch

from eigbench.reference.graphs import csr_from_edges


def make(cfg, seed, device):
    R, C = int(cfg["grid_rows"]), int(cfg["grid_cols"])
    idx = torch.arange(R * C, device=device)
    right, down = idx % C < C - 1, idx < (R - 1) * C
    src = torch.cat([idx[right], idx[down]])
    dst = torch.cat([idx[right] + 1, idx[down] + C])
    return csr_from_edges(src, dst, R * C)


def nnz(cfg):
    R, C = int(cfg["grid_rows"]), int(cfg["grid_cols"])
    return 2 * (R * (C - 1) + (R - 1) * C)
'''


def _json(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(tmp) -> str:
    """A copy of ``BENCHMARK.json`` and the benchmark's files under
    ``tmp``, with the tiny cells and a generator added as new files and
    entries."""
    root = str(tmp)
    shutil.copytree(os.path.join(REPO, "eigbench"), os.path.join(root, "eigbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(root, "eigbench", "generators", "grid2d.py"), "w") as f:
        f.write(GRID2D)
    bench = _json(os.path.join(REPO, "BENCHMARK.json"))
    real = {w["name"]: w for w in bench["workloads"]}
    from eigbench import cells

    for name, cfg in TINY_CONFIGS.items():
        cfg = dict(cfg, name=name)
        cfg["nnz_generated"] = cells.generator(root, cfg["generator"]).nnz(cfg)
        path = f"eigbench/configs/{name}.json"
        _dump(cfg, os.path.join(root, path))
        bench["configs"].append({"name": name, "source": "test", "file": path, "reduced": [],
                                 "why": "test"})
    for name, (cfg, like) in TINY_CELLS.items():
        bench["workloads"].append({"name": name, "config": cfg, "traffic": real[like]["traffic"],
                                   "chips": 1, "why": "test"})
        shutil.copy(os.path.join(REPO, "eigbench", "limits", like + ".json"),
                    os.path.join(root, "eigbench", "limits", name + ".json"))
    _dump(bench, os.path.join(root, "BENCHMARK.json"))
    return root


def program(device):
    from eigbench.harness import Program

    return Program(REPO, device)
