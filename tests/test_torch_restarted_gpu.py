"""The restarted backend and the session cache on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither ``jax`` nor the reference package, so it runs on a machine that has
only PyTorch: from the repository root,

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_restarted_gpu.py

A restarted solve on the card runs the same steps as on the host, in the
same order; only the kernels' sums and the card's BLAS round differently.
So under FDF (f64 arithmetic) the two give the same ``iterations`` and
``restarts`` and eigenvalues equal at rel 1e-9, on the ELL, hybrid and BSR
layouts.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro_torch
from repro_torch.api import EigQuery
from repro_torch.sparse import CSR, generate


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    return torch.device("cuda")


def _block() -> CSR:
    road = generate("road", 1 << 10, 2.1, seed=0, values="normalized")
    b = np.random.default_rng(0).random((8, 8))
    m = sp.kron(road.to_scipy(), sp.csr_matrix((b + b.T) / 2)).tocsr()
    m.sort_indices()
    return CSR(indptr=m.indptr.astype(np.int64), indices=m.indices.astype(np.int32),
               data=m.data.astype(np.float64), shape=m.shape)


MATRICES = {
    "ell": lambda: generate("road", 1 << 14, 2.1, seed=1, values="normalized"),
    "hybrid": lambda: generate("web", 1 << 14, 8.0, seed=2, values="normalized"),
    "bsr": _block,
}


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", list(MATRICES))
def test_restarted_card_matches_host(cuda, fmt):
    a = MATRICES[fmt]()
    kw = dict(k=8, tol=1e-8, max_restarts=12)
    repro_torch.session_cache_clear()
    gpu = repro_torch.eigsh(a, device="cuda", **kw)
    cpu = repro_torch.eigsh(a, device="cpu", **kw)
    assert gpu.backend == cpu.backend == "restarted"
    assert gpu.spmv_format == cpu.spmv_format == fmt
    assert (gpu.iterations, gpu.restarts) == (cpu.iterations, cpu.restarts)
    lg = np.sort(gpu.eigenvalues.double().cpu().numpy())
    lc = np.sort(cpu.eigenvalues.double().cpu().numpy())
    assert np.abs(lg - lc).max() <= 1e-9 * np.abs(lc).max()
    repro_torch.session_cache_clear()


@pytest.mark.gpu
def test_cache_clear_frees_device_memory(cuda):
    a = generate("road", 1 << 16, 2.1, seed=3)
    repro_torch.session_cache_clear()
    repro_torch.eigsh(generate("road", 1 << 10, 2.1, seed=4), 4, device="cuda")  # kernels built
    repro_torch.session_cache_clear()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    res = repro_torch.eigsh(a, 8, device="cuda")
    again = repro_torch.eigsh(a, 8, device="cuda", tol=1e-6, max_restarts=2)
    assert again.session_reuse and repro_torch.session_cache_info()["size"] == 1
    del res, again
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() > before  # the cached plan holds the layout
    repro_torch.session_cache_clear()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


@pytest.mark.gpu
def test_start_vectors_each_run_the_lone_sweep(cuda):
    """Queries that differ only in their start vector, on a COO matrix: each
    start is a sweep of its own through the fused update kernel (one launch
    a step), with the bits of a lone call from the same start."""
    from repro_torch.kernels.lanczos_update import lanczos_update_kernel_call as update

    a = generate("kron", 1 << 14, 8.0, seed=2, values="normalized")
    m = 24
    starts = [np.random.default_rng(s).standard_normal(a.shape[0]) for s in range(3)]
    sess = repro_torch.prepare(a, device="cuda", format="coo")
    update.launches = 0
    got = sess.eigsh_many([EigQuery(k=4, num_iters=m, v0=v) for v in starts])
    assert update.launches == m * len(starts)
    assert sess.stats["sweeps"] == len(starts)
    for g, v in zip(got, starts):
        assert g.spmv_format == "coo"
        alone = sess.eigsh(4, num_iters=m, v0=v)
        assert torch.equal(alone.eigenvalues, g.eigenvalues)
        assert np.array_equal(alone.residuals, g.residuals)
