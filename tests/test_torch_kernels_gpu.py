"""The redesigned ``spmv_ell`` and ``mixed_dot`` kernels on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither ``jax`` nor the reference package, so it also runs on a machine that
has only PyTorch: from the repository root,

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_kernels_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports ``jax``).  The kernels are
held against their plain versions (``kernels.ref``) at rtol 1e-5 under f32
accumulation and 1e-12 under f64, relative to the largest |y| for SpMV and
to the sum of |a_i b_i| for the dot: the arithmetic is the same, only the
order of the sums differs.  Repeated calls, and the unpadded and padded
dot, must agree bit for bit.
"""

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.mixed_dot import mixed_dot_kernel_call
from repro_torch.kernels.spmv_ell import ell_launch_plan, spmv_ell_kernel_call

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# (storage, accum) pairs of the precision policies.
PAIRS = {
    "f32-f32": (torch.float32, torch.float32),
    "f32-f64": (torch.float32, torch.float64),
    "f64-f64": (torch.float64, torch.float64),
    "bf16-f32": (torch.bfloat16, torch.float32),
    "f16-f32": (torch.float16, torch.float32),
}
WIDTHS = [1, 3, 4, 8, 12, 16, 37, 64, 200]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    return torch.device("cuda")


def _ell(rows, width, n, dtype, dev, seed):
    """A random ELL layout with a zero-padded tail in every third row."""
    g = torch.Generator().manual_seed(seed)
    val = torch.randn(rows, width, generator=g, dtype=torch.float64)
    col = torch.randint(0, n, (rows, width), generator=g, dtype=torch.int32)
    short = torch.arange(rows) % 3 == 0
    val[short, width // 2 :] = 0.0
    col[short, width // 2 :] = 0
    x = torch.randn(n, generator=g, dtype=torch.float64)
    return val.to(dtype).to(dev), col.to(dev), x.to(dtype).to(dev)


def _close_ell(y, val, col, x, acc):
    want = ref.spmv_ell_ref(val, col, x, acc)
    assert y.dtype == acc and y.shape == want.shape
    err = float((y.double() - want.double()).abs().max())
    assert err <= RTOL[acc] * max(float(want.double().abs().max()), 1e-300)


@pytest.mark.gpu
@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("width", WIDTHS)
def test_spmv_ell_widths(cuda, pair, width):
    """Every path of the kernel (vector, wide, scalar) at 1,003 rows: a
    grid that does not divide them; two calls give the same bits."""
    S, A = PAIRS[pair]
    val, col, x = _ell(1003, width, 2000, S, cuda, seed=width)
    y = spmv_ell_kernel_call(val, col, x, accum_dtype=A)
    _close_ell(y, val, col, x, A)
    assert torch.equal(y, spmv_ell_kernel_call(val, col, x, accum_dtype=A))


@pytest.mark.gpu
@pytest.mark.parametrize("pair", list(PAIRS))
def test_spmv_ell_unaligned_base(cuda, pair):
    """A contiguous view whose base is one element past a 16-byte boundary
    takes the scalar path, and still matches."""
    S, A = PAIRS[pair]
    rows, width = 517, 8
    val, col, x = _ell(rows, width, 777, S, cuda, seed=5)
    vbuf = torch.empty(rows * width + 1, dtype=S, device=cuda)
    cbuf = torch.empty(rows * width + 1, dtype=torch.int32, device=cuda)
    vbuf[1:].copy_(val.reshape(-1))
    cbuf[1:].copy_(col.reshape(-1))
    val_u, col_u = vbuf[1:].view(rows, width), cbuf[1:].view(rows, width)
    assert val_u.is_contiguous() and val_u.data_ptr() % 16
    assert ell_launch_plan(width, val_u.element_size(), False)[1] == "scalar"
    y = spmv_ell_kernel_call(val_u, col_u, x, accum_dtype=A)
    _close_ell(y, val_u, col_u, x, A)


@pytest.mark.gpu
def test_spmv_ell_main_path_shape(cuda):
    """The main path's layout (rows of 8 f32 slots, f64 accumulation) at a
    size that spans many grid strides."""
    val, col, x = _ell(1 << 20, 8, 1 << 20, torch.float32, cuda, seed=11)
    assert ell_launch_plan(8, 4, True) == (2, "vector")
    y = spmv_ell_kernel_call(val, col, x, accum_dtype=torch.float64)
    _close_ell(y, val, col, x, torch.float64)
    assert torch.equal(y, spmv_ell_kernel_call(val, col, x, accum_dtype=torch.float64))


def _dot_operands(n, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    a, b = (torch.randn(n, generator=g, dtype=torch.float64) * 3.0 for _ in range(2))
    return a.to(dtype).to(dev), b.to(dtype).to(dev)


def _padded(t, block):
    return torch.nn.functional.pad(t, (0, (-t.shape[0]) % block))


# Tiles of 4096: 1, 2, 1,023 and 1,025, and 1,500 (eight rounds of the
# walk's 192 tile totals); each whole and ragged (1,000 short of whole).
DOT_TILES = [1, 2, 1023, 1025, 1500]


@pytest.mark.gpu
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("tiles", DOT_TILES)
@pytest.mark.parametrize("dt", ["f32", "bf16", "f64"])
def test_mixed_dot_tiles(cuda, dt, tiles, ragged):
    S = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}[dt]
    n = tiles * 4096 - (1000 if ragged else 0)
    a, b = _dot_operands(n, S, cuda, seed=tiles)
    terms = float((a.double() * b.double()).abs().sum())
    for A in (torch.float32, torch.float64):
        for comp in (False, True):
            got = mixed_dot_kernel_call(a, b, accum_dtype=A, compensated=comp)
            assert got.dtype == A and got.shape == (2,)
            block = min(4096, n)
            want = ref.mixed_dot_ref(_padded(a, block), _padded(b, block), A, block=block,
                                     compensated=comp)
            assert abs(float(got.double().sum() - want.double().sum())) <= RTOL[A] * terms
            # The same bits on a second call, and on operands padded to whole tiles.
            assert torch.equal(got, mixed_dot_kernel_call(a, b, accum_dtype=A, compensated=comp))
            padded = mixed_dot_kernel_call(_padded(a, block), _padded(b, block), block=block,
                                           accum_dtype=A, compensated=comp)
            assert torch.equal(got, padded)


@pytest.mark.gpu
@pytest.mark.parametrize("tiles", [1, 2, 191, 192, 193, 385, 1500])
@pytest.mark.parametrize("acc", ["f32", "f64"])
def test_mixed_dot_walk_is_the_reference_recurrence(cuda, acc, tiles):
    """One non-zero product per tile makes every tile total exact in any
    sum order, so the kernel's walk over the totals (running sum and
    Neumaier term, across rounds of shared memory) must give the plain
    version's recurrence bit for bit.  The totals span 1e-8 to 1e8, so the
    compensation term is far from zero."""
    A = {"f32": torch.float32, "f64": torch.float64}[acc]
    rng = torch.Generator().manual_seed(tiles)
    p = torch.randn(tiles, generator=rng, dtype=torch.float64) * 10.0 ** torch.randint(
        -8, 9, (tiles,), generator=rng).double()
    a = torch.zeros(tiles * 4096, dtype=A)
    b = torch.zeros(tiles * 4096, dtype=A)
    a[::4096] = 1.0
    b[::4096] = p.to(A)
    a, b = a.to(cuda), b.to(cuda)
    for comp in (False, True):
        got = mixed_dot_kernel_call(a, b, accum_dtype=A, compensated=comp)
        want = ref.mixed_dot_ref(a, b, A, compensated=comp)
        assert torch.equal(got.cpu(), want.cpu()), (got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("acc", ["f32", "f64"])
def test_mixed_dot_nan_tiles_finish(cuda, acc):
    """A tile total whose bits are all ones (a NaN with a full payload, which
    the kernel also uses to mark a total not yet written) is published as
    the canonical NaN: the call finishes and the dot is NaN."""
    A = {"f32": torch.float32, "f64": torch.float64}[acc]
    ones = torch.tensor([-1], dtype=torch.int32 if A == torch.float32 else torch.int64).view(A)
    a = torch.ones(3 * 4096 + 5, dtype=A)
    b = torch.zeros_like(a)
    b[4096 + 7] = ones[0]
    assert torch.isnan(b).any()
    a, b = a.to(cuda), b.to(cuda)
    for comp in (False, True):
        got = mixed_dot_kernel_call(a, b, accum_dtype=A, compensated=comp)
        assert torch.isnan(got.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16", "f64"])
def test_mixed_dot_unaligned_operands(cuda, dt):
    """Operands one element past a 16-byte boundary take scalar loads in the
    same element order as the vector loads: the same bits as an aligned copy."""
    S = {"f32": torch.float32, "bf16": torch.bfloat16, "f64": torch.float64}[dt]
    n = 5 * 4096 + 77
    a, b = _dot_operands(n + 1, S, cuda, seed=9)
    a_u, b_u = a[1:], b[1:]
    assert a_u.data_ptr() % 16
    for comp in (False, True):
        got = mixed_dot_kernel_call(a_u, b_u, accum_dtype=torch.float64, compensated=comp)
        want = mixed_dot_kernel_call(a_u.clone(), b_u.clone(), accum_dtype=torch.float64,
                                     compensated=comp)
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_mixed_dot_entry_point_matches_host(cuda):
    """``ops.mixed_dot`` on the card (no padding) and on the host (padded
    plain version) at phase 8's ragged Gram length, f64 accumulation."""
    n = 14_077_504 // 16
    a, b = _dot_operands(n, torch.float32, cuda, seed=3)
    terms = float((a.double() * b.double()).abs().sum())
    for comp in (False, True):
        got = ops.mixed_dot(a, b, torch.float64, comp)
        want = ops.mixed_dot(a.cpu(), b.cpu(), torch.float64, comp)
        assert abs(float(got) - float(want)) <= 1e-12 * terms
