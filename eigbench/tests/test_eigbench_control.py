"""``correct`` has to come out false for the control and for each fault
a cell can have, with the rest of a run driven as it is: on tiny cells
on the CPU, the card check skipped.

* each control: the reference in one of the limits file's lower
  precisions put in the program's place;
* a step that returns its state unchanged: the sweep's last step repeats
  the one before it;
* an answer altered where it is produced: one eigenvalue, or a block of
  one Ritz vector, changed as the Ritz stage hands it out.

A cell has one solve at a time on one card, so "half of a batch" and
"the exchange between chips" are faults it cannot have.
"""

import json
import time

import pytest
import torch

from eigbench import harness
from eigbench.reference import lanczos
from eigbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


class ControlProgram:
    """The reference in one of the limits file's control precisions, in
    the program's place."""

    def __init__(self, prec):
        self.prec = prec

    def prepare(self, indptr, indices, data, traffic):
        self.a = lanczos.sparse_matrix(torch.from_numpy(indptr), torch.from_numpy(indices),
                                       torch.from_numpy(data).to(torch.float64), self.prec)

    def solve(self, v, traffic):
        got = lanczos.ritz_pairs(self.a, v, traffic["num_iters"], traffic["k"], self.prec)
        return got, {}, "control"

    def release(self):
        self.a = None


def _correct(root, cell, capsys, program=tiny.program, seed=31):
    rc = harness.run(root, cell, seed, 0.2, False, t_start=time.perf_counter(), device="cpu",
                     program=program, forbidden=tiny.FORBIDDEN)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(tiny.TINY_CELLS))
def test_the_control_fails(root, cell, capsys):
    from eigbench import cells

    for spec in cells.find(root, cell).limits["controls"]:
        prec = lanczos.Precision.parse(spec)
        line = _correct(root, cell, capsys, program=lambda device: ControlProgram(prec))
        assert line["correct"] is False, spec["name"]


def _last_step_repeats(real):
    def lanczos_tridiag(*args, **kwargs):
        res = real(*args, **kwargs)
        res.basis[-1] = res.basis[-2]
        res.alpha[-1] = res.alpha[-2]
        res.beta[-1] = res.beta[-2]
        return res
    return lanczos_tridiag


def _eigenvalue_altered(real):
    def ritz_extract(*args, **kwargs):
        evals, x, res = real(*args, **kwargs)
        evals = evals.clone()
        evals[0] = evals[0] * (1 + 1e-5)
        return evals, x, res
    return ritz_extract


def _vector_altered(real):
    def ritz_extract(*args, **kwargs):
        evals, x, res = real(*args, **kwargs)
        x = x.clone()
        x[: x.shape[0] // 50, 0] *= -1
        return evals, x, res
    return ritz_extract


@pytest.mark.parametrize("fault,target", [
    (_last_step_repeats, "lanczos_tridiag"),
    (_eigenvalue_altered, "ritz_extract"),
    (_vector_altered, "ritz_extract"),
], ids=["step-unchanged", "eigenvalue-altered", "vector-altered"])
@pytest.mark.parametrize("cell", ["tiny_grid.fdf.k8", "tiny_grid.ddd.k8"])
def test_each_fault_fails(root, cell, fault, target, monkeypatch, capsys):
    assert _correct(root, cell, capsys)["correct"] is True  # sound first
    from repro_torch.core import eigensolver

    monkeypatch.setattr(eigensolver, target, fault(getattr(eigensolver, target)))
    assert _correct(root, cell, capsys)["correct"] is False
