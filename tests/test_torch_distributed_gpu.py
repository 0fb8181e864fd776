"""The distributed backend on the card: a world of one over NCCL and two
ranks sharing one card over gloo, through the CUDA kernels.

Every test here needs a CUDA card and skips without one.  The file imports
neither ``jax`` nor the reference package, so it runs on a machine that has
only PyTorch: from the repository root,

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_distributed_gpu.py

Eigenvalues are held to rel 1e-9 of ``backend="single"`` with full
re-orthogonalization and the same start vector (FDF: only the order of the
sums differs); ranks to identical bits; the sharded chunk matvec to the
unsharded one's bits under the same staging.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro_torch
import torch_dist_ranks as R
from repro_torch.kernels import ref, spmv_bsr
from repro_torch.launch.ranks import run_ranks
from repro_torch.sparse import CSR, generate

K = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    repro_torch.session_cache_clear()
    yield torch.device("cuda")
    repro_torch.session_cache_clear()


def _block() -> CSR:
    small = generate("road", 1 << 12, 2.1, seed=1).to_scipy()
    d = np.random.default_rng(2).standard_normal((8, 8))
    m = sp.kron(small, sp.csr_matrix((d + d.T) / 2)).tocsr()
    m.sort_indices()
    return CSR(indptr=m.indptr.astype(np.int64), indices=m.indices.astype(np.int32),
               data=m.data.astype(np.float64), shape=m.shape)


def _rel(got, want) -> float:
    g, w = np.sort(got.double().cpu().numpy()), np.sort(want.double().cpu().numpy())
    return float(np.abs(g - w).max() / np.abs(w).max())


@pytest.mark.gpu
@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_distributed_runs_the_cuda_kernels(cuda, world, backend):
    road = generate("road", 1 << 16, 2.1, seed=1)
    block = _block()
    rng = np.random.default_rng(0)
    v_road, v_block = rng.standard_normal(road.n), rng.standard_normal(block.n)
    ranks = run_ranks(R.gpu_runs, world, backend=backend, device="cuda", timeout=600,
                      args=(road, block, v_road, v_block, K))
    for rank in ranks[1:]:
        for name in ("road", "block"):
            assert torch.equal(rank[name]["eigenvalues"], ranks[0][name]["eigenvalues"])
            assert torch.equal(rank[name]["eigenvectors"], ranks[0][name]["eigenvectors"])
    r0 = ranks[0]
    for name, csr, v, kernel in (("road", road, v_road, "spmv_ell"),
                                 ("block", block, v_block, "spmv_bsr")):
        got = r0[name]
        single = repro_torch.eigsh(csr, K, backend="single", reorth="full", v0=v, device="cuda")
        assert _rel(got["eigenvalues"], single.eigenvalues) <= 1e-9
        assert got["spmv_format"] == (kernel[5:],) * world
        # Each shard ran the CUDA kernels (their own counters), once a step.
        assert got["launches"][kernel] == K and got["launches"]["lanczos_update"] == K
        assert got["calls"]["all_gather"] == K and got["calls"]["reduce_scalar"] == 2 * K + 1
    for staging, kernel in (("f32", "spmv_ell"), ("bf16", "spmv_ell_packed")):
        got = r0["chunk_" + staging]
        assert torch.equal(got["sharded"], got["plain"])
        assert got["launches"][kernel] == got["chunks"]


@pytest.mark.gpu
def test_bsr_kernel_takes_a_row_shards_gathered_vector(cuda):
    """A BSR row shard's block columns index the all-gathered vector, which
    is longer than the shard's rows: the kernel takes it when told the
    column count (its wrapper used to refuse any ``x`` but ``nbr * BS``
    long), and refuses the shard-local length."""
    g = torch.Generator(device="cuda").manual_seed(0)
    nbr, slots, bs = 64, 3, 8
    val = torch.randn((nbr, slots, bs, bs), generator=g, device="cuda")
    bcol = torch.randint(0, 4 * nbr, (nbr, slots), generator=g, device="cuda").to(torch.int32)
    x = torch.randn(4 * nbr * bs, generator=g, device="cuda")
    y = spmv_bsr.spmv_bsr_kernel_call(val, bcol, x, accum_dtype=torch.float64, n_cols=x.shape[0])
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="whole 8-blocks"):
        spmv_bsr.spmv_bsr_kernel_call(val, bcol, x[: nbr * bs], accum_dtype=torch.float64,
                                      n_cols=x.shape[0])
    want = ref.spmv_bsr_ref(val, bcol, x, torch.float64)
    assert float((y - want).abs().max()) <= 1e-12 * float(want.abs().max())
