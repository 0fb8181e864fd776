"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics.
Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own under ``eigbench/``, found by the
name that ``BENCHMARK.json`` gives it:

* a configuration: the ``file`` of its ``configs`` entry (JSON), whose
  ``generator`` names ``eigbench/generators/<generator>.py``;
* a traffic mix: ``eigbench/traffic/<traffic>.json``;
* a cell's limits for ``correct``: ``eigbench/limits/<cell>.json``;
* a metric: ``eigbench/metrics/<metric>.py``, whose ``read(ctx)``
  returns the value, or None where the run has nothing for it to read
  (the metric is then left out of the run's line).

So a cell, a configuration or a metric is added by adding files and
entries, with no file edited.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find(root: str, name: str) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    here = os.path.join(root, "eigbench")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(here, "limits", name + ".json")),
        end_to_end=bench["end_to_end"],
        per_layer=bench["per_layer"],
    )


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(root: str, name: str):
    return _module(os.path.join(root, "eigbench", "generators", name + ".py"),
                   f"eigbench_generator_{name}")


def metric_reader(root: str, name: str):
    return _module(os.path.join(root, "eigbench", "metrics", name + ".py"),
                   f"eigbench_metric_{name}")
