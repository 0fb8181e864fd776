"""Whole runs of tiny cells through the harness: on the CPU through the
plain kernels (the run's card check skipped), and on a card when there
is one."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from eigbench import harness
from eigbench.tests import tiny
from eigbench.tests.tiny import REPO


def _run(root, cell, seed, trace, capsys, device="cpu"):
    rc = harness.run(root, cell, seed, 0.3, trace, t_start=time.perf_counter(), device=device,
                     program=tiny.program, forbidden=tiny.FORBIDDEN)
    cap = capsys.readouterr()
    assert rc == 0
    return json.loads(cap.out.strip().splitlines()[-1]), cap.err.strip().splitlines()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_cpu_run_prints_a_well_formed_line(root, cell, capsys):
    line, err = _run(root, cell, 2**31 + 3, False, capsys)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    # On the CPU: host-clock metrics only, nothing under a device metric's name.
    assert set(line["metrics"]) == {"solve_ms", "solve_p95_ms", "setup_s"}
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": None}
    for name, c in line["checks"].items():
        assert f"check {name} {c['value']!r}" in "\n".join(err[-len(line["checks"]):])


def test_cpu_traced_run_reports_no_device_metric(root, capsys):
    line, _ = _run(root, "tiny_wall.fdf.k8", 17, True, capsys)
    assert set(line["metrics"]) == {"prepare_s", "lanczos_ms", "ritz_ms"}
    assert "busy_s" not in line["device"] and "breakdown" not in line
    assert line["correct"] is True


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: this test is of a machine without one")
    out = subprocess.run([sys.executable, os.path.join(REPO, "eigbench", "run.py"),
                          "--workload", "hugetrace_00020.fdf.k8", "--seed", "1", "--seconds", "1",
                          "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 3
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_forbidden_module_no_result(root, capsys):
    """A process that holds a forbidden module once the window has closed
    prints no result and exits 4 (``json`` stands in: every process holds
    it)."""
    rc = harness.run(root, "tiny_grid.fdf.k8", 5, 0.2, False, t_start=time.perf_counter(),
                     device="cpu", program=tiny.program, forbidden=("json",))
    cap = capsys.readouterr()
    assert rc == 4 and cap.out == ""
    assert "the process holds ['json']" in cap.err


def test_start_vectors_follow_the_seed():
    a = harness.start_vector(100, torch.float64, "cpu", 2**31 + 9, 4)
    assert torch.equal(a, harness.start_vector(100, torch.float64, "cpu", 2**31 + 9, 4))
    assert not torch.equal(a, harness.start_vector(100, torch.float64, "cpu", 2**31 + 9, 5))
    assert harness.sample_for(7, 10.0, [0.1], 6) == harness.sample_for(7, 10.0, [0.1], 6)
    assert len(set(harness.sample_for(7, 10.0, [0.1], 6))) == 6


@pytest.mark.gpu
def test_card_run_of_a_tiny_cell(root, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line, _ = _run(root, "tiny_grid.fdf.k8", 23, True, capsys, device="cuda")
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
