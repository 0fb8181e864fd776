"""The slice as a whole: ``repro_torch.eigsh(A, k, device="cpu")`` against
``repro.eigsh(A, k)`` with the same start vector, across the four SpMV
formats and three policies.

Tolerances on eigenvalues and residual bounds, relative to |lambda_max|:
FDF 1e-12 and FFF 1e-6 (the arithmetic is the same; only the order of the
sums differs, which f64 hides and f32 shows at a few ulps); BFF 1e-3 (an
ulp-level difference can flip a bf16 rounding of the stored basis, and
bf16's eps is 7.8e-3).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro
from repro.sparse import generate as jax_generate
from repro.sparse.formats import CSR as JaxCSR
import repro_torch
from repro_torch.api import EigenResult
from repro_torch.sparse import CSR

ROOT = Path(__file__).resolve().parents[1]
TOL = {"FDF": 1e-12, "FFF": 1e-6, "BFF": 1e-3}
K = 8


def _port_csr(c) -> CSR:
    return CSR(indptr=np.asarray(c.indptr), indices=np.asarray(c.indices),
               data=np.asarray(c.data), shape=c.shape)


def _block_csr() -> JaxCSR:
    """kron(small road network, dense symmetric 8 x 8): full 8 x 8 blocks."""
    road = jax_generate("road", 64, 2.1, seed=0, values="normalized")
    b = np.random.default_rng(0).random((8, 8))
    m = sp.kron(road.to_scipy(), sp.csr_matrix((b + b.T) / 2)).tocsr()
    m.sort_indices()
    return JaxCSR(indptr=m.indptr.astype(np.int64), indices=m.indices.astype(np.int32),
                  data=m.data.astype(np.float64), shape=m.shape)


MATRICES = {
    "web_csr": ("fixture", "hybrid"),
    "norm_csr": ("fixture", "hybrid"),
    "road": (lambda: jax_generate("road", 1024, 2.1, seed=3, values="normalized"), "ell"),
    "kron": (lambda: jax_generate("kron", 1024, 8.0, seed=2, values="normalized"), "coo"),
    "block": (_block_csr, "bsr"),
}


@pytest.mark.parametrize("policy", list(TOL))
@pytest.mark.parametrize("name", list(MATRICES))
def test_eigsh_matches_reference(name, policy, request):
    make, fmt = MATRICES[name]
    ref = request.getfixturevalue(name) if make == "fixture" else make()
    v0 = np.random.default_rng(1).standard_normal(ref.n)
    want = repro.eigsh(ref, k=K, v0=v0, policy=policy)
    got = repro_torch.eigsh(_port_csr(ref), k=K, v0=v0, policy=policy, device="cpu")
    assert got.spmv_format == want.spmv_format == fmt
    assert got.backend == want.backend == "single"
    assert got.policy == want.policy == policy
    assert got.eigenvalues.shape == (K,) and got.eigenvectors.shape == (ref.n, K)
    ev_want = np.asarray(want.eigenvalues, np.float64)
    scale = np.abs(ev_want).max()
    np.testing.assert_allclose(got.eigenvalues.double().numpy(), ev_want, rtol=0,
                               atol=TOL[policy] * scale)
    np.testing.assert_allclose(got.residuals, want.residuals, rtol=0, atol=TOL[policy] * scale)
    np.testing.assert_array_equal(got.converged, want.converged)
    assert got.tol == want.tol and got.iterations == want.iterations == K


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is usable here")
    csr = repro_torch.sparse.generate("road", 256, 2.1, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.eigsh(csr, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.prepare(csr)


def test_import_leaves_jax_and_repro_out():
    code = (
        "import sys, repro_torch, repro_torch.api.session, repro_torch.kernels.ops, "
        "repro_torch.kernels.build, repro_torch.sparse.generate, repro_torch.core.operators, "
        "repro_torch.sparse.diskcsr, repro_torch.kernels.mixed_dot\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'repro'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, check=True, cwd=str(ROOT))
    assert out.stdout.strip() == ""


def test_port_sources_import_neither_jax_nor_repro():
    """Static check of every port module, its scripts and chip_smoke.py."""
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
             + sorted((ROOT / "bench_torch").glob("*.py")) + [ROOT / "chip_smoke.py"])
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "ml_dtypes", "repro"), (
                    f"{path.relative_to(ROOT)} imports {name}"
                )


def test_input_forms_agree(norm_csr):
    v0 = np.random.default_rng(2).standard_normal(norm_csr.n)
    port = _port_csr(norm_csr)
    base = repro_torch.eigsh(port, k=4, v0=v0, device="cpu")
    via_scipy = repro_torch.eigsh(norm_csr.to_scipy(), k=4, v0=v0, device="cpu")
    assert torch.equal(base.eigenvalues, via_scipy.eigenvalues)
    dense = repro_torch.eigsh(norm_csr.toarray(), k=4, v0=v0, device="cpu")
    assert dense.spmv_format == "dense"
    np.testing.assert_allclose(dense.eigenvalues.numpy(), base.eigenvalues.numpy(), atol=1e-6)
    bad = norm_csr.toarray()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        repro_torch.eigsh(bad, k=4, device="cpu")


def test_prepared_session_reuses_its_layout():
    csr = repro_torch.sparse.generate("road", 1024, 2.1, seed=3)
    sess = repro_torch.prepare(csr, device="cpu")
    v0 = np.random.default_rng(0).standard_normal(csr.n)
    r1 = sess.eigsh(6, v0=v0)
    r2 = sess.eigsh(6, v0=v0)
    assert r1.session_reuse and r2.session_reuse  # prepare() built the plan
    assert r2.partition["spmv"]["conversions"] == 0 and r2.timings["prepare_s"] == 0.0
    assert torch.equal(r1.eigenvalues, r2.eigenvalues)
    r3 = sess.eigsh(6, v0=v0, policy="FFF")  # another compute dtype: a new plan
    assert not r3.session_reuse and r3.partition["spmv"]["conversions"] == 1
    evals, evecs = r3
    assert evals.dtype == torch.float32 and evecs.shape == (csr.n, 6)


def test_result_round_trips_through_json():
    csr = repro_torch.sparse.generate("web", 512, 6.0, seed=1)
    res = repro_torch.eigsh(csr, k=4, device="cpu", seed=3)
    back = EigenResult.from_dict(json.loads(json.dumps(res.to_dict())))
    assert torch.equal(back.eigenvalues, res.eigenvalues)
    assert torch.equal(back.eigenvectors, res.eigenvectors)
    np.testing.assert_array_equal(back.residuals, res.residuals)
    assert back.spmv_format == res.spmv_format and back.partition == json.loads(
        json.dumps(res.to_dict()["partition"]))
    assert "backend=single" in res.summary() and "spmv=hybrid" in res.summary()


@pytest.mark.parametrize("kwargs,match", [
    ({"backend": "distributed"}, "distributed"),
])
def test_unported_paths_raise_not_implemented(kwargs, match):
    csr = repro_torch.sparse.generate("road", 256, 2.1, seed=0)
    with pytest.raises(NotImplementedError, match=match):
        repro_torch.eigsh(csr, k=4, device="cpu", **kwargs)
