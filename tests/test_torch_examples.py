"""The port's four user examples (``examples/*_torch.py``) against the
reference's (``examples/*.py``), on the CPU.

* ``planted_partition`` builds the reference's graph bit for bit; ``kmeans``
  and ``accuracy`` agree on one embedding;
* the quickstart's and the spectral example's solves agree between the
  packages at the examples' sizes from one explicit NumPy ``v0``;
* ``train_lm_torch.py`` and ``hessian_spectrum_torch.py`` run as scripts
  with ``--device cpu`` (two subprocesses, started with the module so they
  overlap the tests above, each with its own timeout).
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import eigsh as jax_eigsh
from repro.sparse import generate as jax_generate

REPO_ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = REPO_ROOT / "examples"

# FDF (f64 Lanczos) in both packages: sum order only.  The spectral
# example's graph is not symmetric (a fault of the reference example), so
# its Lanczos amplifies the order of the sums.
EIG_TOL = {"quickstart": 1e-9, "spectral_graph": 1e-6}
# name -> (command line, timeout in seconds, a line its output must hold)
SCRIPTS = {
    "train_lm": (["train_lm_torch.py", "--device", "cpu", "--steps", "3", "--batch", "2",
                  "--seq", "16"], 300, "over 3 steps"),
    "hessian_spectrum": (["hessian_spectrum_torch.py", "--device", "cpu"], 600,
                         "policy FFF vs FDF"),
}


def load(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def scripts(tmp_path_factory):
    """Both script runs, started before the module's first test."""
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    ckpt = tmp_path_factory.mktemp("train_lm")
    procs = {}
    for name, (argv, _, _) in SCRIPTS.items():
        extra = ["--ckpt-dir", str(ckpt)] if name == "train_lm" else []
        procs[name] = subprocess.Popen([sys.executable, *argv, *extra], cwd=EXAMPLES, env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def spectral():
    return load("spectral_graph"), load("spectral_graph_torch")


def test_planted_partition_is_the_references(spectral):
    ref, port = spectral
    (rc, rl), (pc, pl) = ref.planted_partition(), port.planted_partition()
    np.testing.assert_array_equal(pl, rl)
    for f in ("indptr", "indices", "data"):
        a, b = getattr(pc, f), getattr(rc, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert pc.shape == rc.shape


def test_kmeans_and_accuracy_match_reference(spectral):
    ref, port = spectral
    rng = np.random.default_rng(4)
    truth = rng.integers(0, 4, 600)
    emb = np.eye(4)[truth] + 0.3 * rng.standard_normal((600, 4))
    pred = port.kmeans(emb, 4)
    np.testing.assert_array_equal(pred, ref.kmeans(emb, 4))
    assert port.accuracy(pred, truth, 4) == ref.accuracy(pred, truth, 4)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_quickstart_solve_matches_reference():
    qs = load("quickstart_torch")
    csr = qs.web_graph()
    v0 = np.random.default_rng(0).standard_normal(csr.n)
    got = qs.solve(csr, "cpu", v0=v0)
    # the reference quickstart's matrix and call (its main builds them inline)
    ref_csr = jax_generate("web", n=1 << 14, avg_deg=8.0, seed=0, values="normalized")
    want = jax_eigsh(ref_csr, k=8, policy="FDF", reorth="full", num_iters=32, v0=v0)
    err = _rel(got.eigenvalues.numpy(), np.asarray(want.eigenvalues))
    assert err <= EIG_TOL["quickstart"], err


def test_spectral_solve_and_accuracy_match_reference(spectral):
    ref, port = spectral
    csr, labels = port.planted_partition()
    rcsr, _ = ref.planted_partition()
    v0 = np.random.default_rng(1).standard_normal(csr.n)
    res, acc = port.cluster(csr, labels, "cpu", v0=v0)
    want = jax_eigsh(rcsr, k=4, policy="FDF", reorth="full", num_iters=24, v0=v0)
    err = _rel(res.eigenvalues.numpy(), np.asarray(want.eigenvalues))
    assert err <= EIG_TOL["spectral_graph"], err
    emb = np.asarray(want.eigenvectors, dtype=np.float64)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    assert abs(acc - ref.accuracy(ref.kmeans(emb, 4), labels, 4)) <= 1e-3


def test_quickstart_main_runs_on_the_host(capsys):
    res = load("quickstart_torch").main(["--device", "cpu"])
    assert res.k == 8 and res.eigenvalues.shape == (8,)
    out = capsys.readouterr().out
    assert "ARPACK agrees to" in out and "mean pairwise eigenvector angle" in out


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_example_script_exits_zero(scripts, name):
    _, timeout, marker = SCRIPTS[name]
    out, err = scripts[name].communicate(timeout=timeout)
    assert scripts[name].returncode == 0, out[-2000:] + err[-4000:]
    assert marker in out, out[-2000:]
