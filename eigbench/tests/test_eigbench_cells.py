"""The harness finds a cell's configuration, traffic, limits and metrics
by name, and a cell or a metric is added by new files and entries alone."""

import filecmp
import json
import os
import time

from eigbench import cells, harness
from eigbench.tests import tiny
from eigbench.tests.tiny import REPO


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_every_cell_finds_its_pieces():
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = cells.find(REPO, w["name"])
        assert cell.chips == 1
        assert cell.config["name"] == w["config"]
        assert cell.traffic["policy"] in ("FDF", "DDD")
        assert set(cell.limits) >= {"eig_gap", "vec_gap", "tri_gap", "controls"}
        assert {m["name"] for m in cell.end_to_end} == {
            "solve_ms", "solve_p95_ms", "peak_gib", "setup_s"}
        for m in cell.per_layer:
            assert callable(cells.metric_reader(REPO, m["name"]).read)
        assert callable(cells.generator(REPO, cell.config["generator"]).make)


def test_a_cell_and_a_metric_come_from_new_files_alone(tmp_path, capsys):
    root = tiny.make_root(tmp_path)
    # No file of the benchmark was edited: the copy's files equal the repo's.
    here = os.path.join(REPO, "eigbench")
    for d, _, files in os.walk(here):
        if "__pycache__" in d or os.sep + "tests" in d:
            continue
        for f in files:
            src = os.path.join(d, f)
            assert filecmp.cmp(src, os.path.join(root, os.path.relpath(src, REPO)),
                               shallow=False), src
    # A new per-layer metric: one reader file and one entry.  Its reader
    # finds something to read in the grid's cells alone, and the metric
    # is left out of the other cells' lines.
    with open(os.path.join(root, "eigbench", "metrics", "solves_traced.py"), "w") as f:
        f.write("def read(ctx):\n"
                "    if ctx['config']['generator'] == 'grid2d':\n"
                "        return ctx['traced_solves']\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["per_layer"].append({"name": "solves_traced", "unit": "solves", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "solve_ms", "workloads": ["tiny_grid.fdf.k8"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    cell = cells.find(root, "tiny_grid.fdf.k8")
    assert cell.config["generator"] == "grid2d"
    assert "solves_traced" in {m["name"] for m in cell.per_layer}
    lines = {}
    for name in ("tiny_grid.fdf.k8", "tiny_wall.fdf.k8"):
        rc = harness.run(root, name, 11, 0.3, True, t_start=time.perf_counter(),
                         device="cpu", program=tiny.program, forbidden=tiny.FORBIDDEN)
        assert rc == 0
        lines[name] = _last_json(capsys.readouterr().out)
    assert lines["tiny_grid.fdf.k8"]["metrics"]["solves_traced"]["value"] > 0
    assert lines["tiny_grid.fdf.k8"]["metrics"]["solves_traced"]["unit"] == "solves"
    assert "solves_traced" not in lines["tiny_wall.fdf.k8"]["metrics"]
