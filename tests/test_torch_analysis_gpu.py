"""repro_torch.analysis on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither ``jax`` nor the reference package, so it runs on a machine that has
only PyTorch: from the repository root,

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_analysis_gpu.py

The resource report of the built library (rule K003 and the occupancy part
of K002), the whole kernel check, the precision sweep with the CUDA kernels
in place of their plain versions, and a measured FDF solve: the counts carry
the model's dtypes, each kernel's recorded ops are its launches times its
contract, and the counter changes no bit of the result.
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.analysis import kernel_check, op_count, precision_flow
from repro_torch.analysis.findings import format_findings
from repro_torch.kernels import lanczos_update, spmv_ell
from repro_torch.sparse import generate


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_attrs_and_check(cuda):
    attrs = kernel_check.read_kernel_attrs()
    assert len(attrs) == 60  # every instantiation of the six sources
    assert all(a["registers"] > 0 and a["occupancy"] >= 1 for a in attrs)
    assert kernel_check.check_resources(attrs) == []
    fs = kernel_check.run("cuda")
    assert fs == [], format_findings(fs)


@pytest.mark.gpu
@pytest.mark.parametrize("rung", precision_flow.RUNGS)
def test_precision_sweep_on_the_card(cuda, rung):
    fs = precision_flow.run(rungs=[rung], device="cuda")
    assert fs == [], format_findings(fs)


@pytest.mark.gpu
def test_measured_fdf_solve(cuda, monkeypatch):
    a = generate("road", 1 << 14, 2.1, seed=1, values="normalized")
    v0 = np.random.default_rng(0).standard_normal(a.n)
    repro_torch.session_cache_clear()
    plain = repro_torch.eigsh(a, k=8, v0=v0, device="cuda")
    monkeypatch.setenv("REPRO_PRECISION_MEASURE", "1")
    launches0 = (spmv_ell.spmv_ell_kernel_call.launches,
                 lanczos_update.lanczos_update_kernel_call.launches)
    with op_count.OpCounter() as c:
        res = repro_torch.eigsh(a, k=8, v0=v0, device="cuda")
    torch.cuda.synchronize()
    launched = (spmv_ell.spmv_ell_kernel_call.launches - launches0[0],
                lanczos_update.lanczos_update_kernel_call.launches - launches0[1])
    prec = res.partition["spmv"]["precision"]
    assert set(prec["ops_by_dtype_measured"]) == set(prec["ops_by_dtype"]) == {"float64"}
    assert torch.equal(res.eigenvalues, plain.eigenvalues)
    assert torch.equal(res.eigenvectors, plain.eigenvectors)
    assert (c.kernels["spmv_ell"]["calls"], c.kernels["lanczos_update"]["calls"]) == launched
    # Each launch records its contract: 2 ops a padded ELL slot, 6 a vector element.
    from repro_torch.core.operators import make_operator
    from repro_torch.kernels.engine import make_engine

    eng = make_engine(a, accum_dtype=torch.float64, storage_dtype=torch.float32, device="cuda")
    slots = make_operator(a, dtype=torch.float32, engine=eng).mat.val.numel()
    assert c.kernels["spmv_ell"]["ops"] == {"float64": launched[0] * 2 * slots}
    assert c.kernels["lanczos_update"]["ops"] == {"float64": launched[1] * 6 * a.n}
