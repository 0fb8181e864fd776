"""The benchmark's graph generators at small sizes: rows exact, nnz as
counted, symmetric, the degrees their families promise, normalized values."""

import json
import os

import pytest
import torch

from eigbench import cells
from eigbench.tests.tiny import REPO

SMALL = [
    {"generator": "brick_wall", "lattice_cols": 37, "rows": 1800},
    {"generator": "brick_wall", "lattice_cols": 7, "rows": 50},
    {"generator": "brick_wall", "lattice_cols": 8, "rows": 64},
    {"generator": "brick_wall", "lattice_cols": 2, "rows": 9},
]


def _dense(g):
    rows = torch.repeat_interleave(torch.arange(g.n), g.indptr.diff())
    a = torch.zeros((g.n, g.n), dtype=torch.float64)
    a[rows, g.indices.long()] = g.data
    return a


@pytest.mark.parametrize("cfg", SMALL,
                         ids=lambda c: f"{c['generator']}-{c['lattice_cols']}-{c['rows']}")
def test_counts_and_symmetry(cfg):
    gen = cells.generator(REPO, cfg["generator"])
    g = gen.make(cfg, 2**31 + 5, "cpu")
    assert g.n == cfg["rows"]
    assert g.nnz == gen.nnz(cfg)
    assert int(g.indptr[-1]) == g.nnz
    a = _dense(g)
    assert torch.equal(a, a.T)
    assert torch.count_nonzero(torch.diagonal(a)) == 0
    # no repeated entry: the dense copy holds every stored value once
    assert torch.count_nonzero(a) == g.nnz
    deg = g.indptr.diff().to(torch.float64)
    rows = torch.repeat_interleave(torch.arange(g.n), g.indptr.diff())
    want = (deg[rows] * deg[g.indices.long()]).rsqrt()
    assert torch.allclose(g.data, want, rtol=0, atol=1e-15)


def test_degrees_of_each_family():
    """The mesh's rows: 3 inside, fewer only on the lattice's border."""
    wall = cells.generator(REPO, "brick_wall").make(SMALL[0], 3, "cpu")
    deg = wall.indptr.diff()
    C = SMALL[0]["lattice_cols"]
    idx = torch.arange(wall.n)
    interior = (idx % C > 0) & (idx % C < C - 1) & (idx >= C) & (idx < wall.n - 2 * C)
    assert bool((deg[interior] == 3).all())
    assert int(deg.max()) == 3 and int(deg.min()) >= 1


def test_the_lattice_is_the_same_for_every_seed():
    gen = cells.generator(REPO, "brick_wall")
    a, b = gen.make(SMALL[0], 1, "cpu"), gen.make(SMALL[0], 2**31 + 7, "cpu")
    assert torch.equal(a.indptr, b.indptr) and torch.equal(a.indices, b.indices)
    assert torch.equal(a.data, b.data)


@pytest.mark.parametrize("name", ["hugetrace_00020"])
def test_full_size_counts_match_the_source(name):
    """Counted, not generated: rows exact, nnz within 0.1% of the
    published matrix and equal to what the configuration states."""
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    entry = {c["name"]: c for c in bench["configs"]}[name]
    cfg = json.load(open(os.path.join(REPO, entry["file"])))
    assert cfg["source"] == entry["source"]
    assert cfg["rows"] == cfg["published"]["rows"]
    nnz = cells.generator(REPO, cfg["generator"]).nnz(cfg)
    assert nnz == cfg["nnz_generated"]
    assert abs(nnz - cfg["published"]["nnz"]) <= 1e-3 * cfg["published"]["nnz"]
