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
    """Queries that differ only in their start vector, on a COO matrix: one
    multi-start sweep for all of them, its update one batched
    ``lanczos_update`` launch a step (m in all, no solo launch), each start
    within rel 1e-9 of a lone call from it (FDF: f64 sums in another
    order)."""
    from repro_torch.kernels.lanczos_update import lanczos_update_kernel_call as update
    from repro_torch.kernels.lanczos_update import lanczos_update_multi_kernel_call as multi

    a = generate("kron", 1 << 14, 8.0, seed=2, values="normalized")
    m = 24
    starts = [np.random.default_rng(s).standard_normal(a.shape[0]) for s in range(3)]
    sess = repro_torch.prepare(a, device="cuda", format="coo")
    update.launches = multi.launches = 0
    got = sess.eigsh_many([EigQuery(k=4, num_iters=m, v0=v) for v in starts])
    assert (multi.launches, update.launches) == (m, 0)
    assert sess.stats["sweeps"] == 1
    for g, v in zip(got, starts):
        assert g.spmv_format == "coo" and g.timings["amortized_over"] == len(starts)
        alone = sess.eigsh(4, num_iters=m, v0=v)
        lw = alone.eigenvalues.double().cpu().numpy()
        lg = g.eigenvalues.double().cpu().numpy()
        assert np.abs(lg - lw).max() <= 1e-9 * np.abs(lw).max()


@pytest.mark.gpu
@pytest.mark.parametrize("sdt,acc", [(torch.float32, torch.float32), (torch.float32, torch.float64),
                                     (torch.float64, torch.float64),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float16, torch.float32)])
@pytest.mark.parametrize("n", [1000, 1 << 20])
def test_batched_update_equals_solo_launches(cuda, sdt, acc, n):
    """Row s of a batched ``lanczos_update`` launch has the bits of a solo
    launch on row s (u and the norm), and both sit within sum-order
    rounding of the plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lanczos_update import (
        lanczos_update_kernel_call,
        lanczos_update_multi_kernel_call,
    )

    g = torch.Generator(device="cuda").manual_seed(n)
    b = 5
    w, v, vp = (torch.randn((b, n), generator=g, device="cuda").to(sdt) for _ in range(3))
    alpha = torch.randn((b,), generator=g, device="cuda", dtype=acc)
    beta = torch.randn((b,), generator=g, device="cuda", dtype=acc)
    u, nrm = lanczos_update_multi_kernel_call(w, v, vp, alpha, beta, accum_dtype=acc)
    for s in range(b):
        us, ns = lanczos_update_kernel_call(w[s], v[s], vp[s], alpha[s], beta[s], accum_dtype=acc)
        assert torch.equal(u[s], us) and torch.equal(nrm[s], ns), f"row {s}"
    pu, pn = ref.lanczos_update_multi_ref(w, v, vp, alpha, beta, acc)
    assert torch.equal(u, pu)
    rtol = 1e-12 if acc == torch.float64 else 1e-5
    assert float(((nrm - pn).abs() / pn.abs()).max()) <= rtol
