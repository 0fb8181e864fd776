"""The redesigned ``spmv_ell``, ``mixed_dot``, ``spmv_ell_packed`` and
``spmv_ell_alpha`` kernels on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither ``jax`` nor the reference package, so it also runs on a machine that
has only PyTorch: from the repository root,

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_kernels_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports ``jax``).  The kernels are
held against their plain versions (``kernels.ref``) at rtol 1e-5 under f32
accumulation and 1e-12 under f64, relative to the largest |y| for SpMV and
to the sum of |a_i b_i| for the dot and for alpha: the arithmetic is the
same, only the order of the sums differs.  Repeated calls, the unpadded and
padded dot, and ``spmv_ell_alpha``'s ``w`` and ``spmv_ell``'s ``y`` (one row
code) must agree bit for bit.
"""

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.lanczos_fused import spmv_ell_alpha_kernel_call
from repro_torch.kernels.mixed_dot import mixed_dot_kernel_call
from repro_torch.kernels.spmv_ell import ell_launch_plan, spmv_ell_kernel_call
from repro_torch.kernels.spmv_ell_packed import packed_launch_plan, spmv_ell_packed_kernel_call

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


# ------------------------------------------------------------ spmv_ell_packed

VALUE_DTYPES = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}
# Columns: 20,000 keep every delta in int16; 100,000 need int32.
DELTAS = {"int16": (torch.int16, 20_000), "int32": (torch.int32, 100_000)}
# Width -> the kernel's path: 8 slots a lane, a warp past 32 vectors.
PACKED_WIDTHS = {8: "vector", 16: "vector", 24: "vector", 40: "vector", 264: "wide",
                 37: "scalar"}


def _packed(rows, width, mode, idx, dev, seed):
    """A packed chunk as the staging builds one: sorted columns per row, the
    ragged tail of each row padded with value 0 at column 0 (its first delta
    returns the column to 0), a positive f32 scale per row, ``base`` the
    row's first column and ``dcol`` the deltas from it."""
    idt, n = DELTAS[idx]
    g = torch.Generator().manual_seed(seed)
    col = torch.randint(0, n, (rows, width), generator=g).sort(dim=1).values
    val = torch.randn(rows, width, generator=g) * 4.0
    pad = torch.arange(width) >= torch.randint(1, width + 1, (rows, 1), generator=g)
    col[pad], val[pad] = 0, 0.0
    scale = torch.rand(rows, 1, generator=g) + 0.5
    base = col[:, :1].to(torch.int32)
    dcol = torch.diff(col, dim=1, prepend=col[:, :1]).to(idt)
    x = torch.randn(n, generator=g, dtype=torch.float64)
    return [t.contiguous().to(dev) for t in (val.to(VALUE_DTYPES[mode]), scale, base, dcol)], x


@pytest.mark.gpu
@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("width", list(PACKED_WIDTHS))
@pytest.mark.parametrize("idx", list(DELTAS))
@pytest.mark.parametrize("mode", list(VALUE_DTYPES))
def test_spmv_ell_packed_widths(cuda, mode, idx, width, pair):
    """Every path of the kernel at 1,003 rows (a grid that does not divide
    them): the vector path at 1, 2, 4 and 8 lanes a row, the wide path and
    the scalar path; two calls give the same bits."""
    S, A = PAIRS[pair]
    packed, x64 = _packed(1003, width, mode, idx, cuda, seed=width)
    x = x64.to(S).to(cuda)
    assert packed_launch_plan(width, packed[3].element_size(), True)[1] == PACKED_WIDTHS[width]
    y = spmv_ell_packed_kernel_call(*packed, x, accum_dtype=A)
    want = ref.spmv_ell_packed_ref(*packed, x, A)
    assert y.dtype == A and y.shape == want.shape
    err = float((y.double() - want.double()).abs().max())
    assert err <= RTOL[A] * max(float(want.double().abs().max()), 1e-300)
    assert torch.equal(y, spmv_ell_packed_kernel_call(*packed, x, accum_dtype=A))


@pytest.mark.gpu
@pytest.mark.parametrize("idx", list(DELTAS))
@pytest.mark.parametrize("mode", list(VALUE_DTYPES))
def test_spmv_ell_packed_unaligned_base(cuda, mode, idx):
    """Values and deltas one element past a 16-byte boundary take the scalar
    path, and still match."""
    rows, width = 517, 8
    packed, x64 = _packed(rows, width, mode, idx, cuda, seed=5)
    shifted = []
    for t in (packed[0], packed[3]):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        buf[1:].copy_(t.reshape(-1))
        shifted.append(buf[1:].view(rows, width))
    val_u, dcol_u = shifted
    assert val_u.data_ptr() % 16 and dcol_u.data_ptr() % 16
    assert packed_launch_plan(width, dcol_u.element_size(), False)[1] == "scalar"
    x = x64.to(torch.float32).to(cuda)
    args = (val_u, packed[1], packed[2], dcol_u, x)
    y = spmv_ell_packed_kernel_call(*args, accum_dtype=torch.float64)
    want = ref.spmv_ell_packed_ref(*args, torch.float64)
    assert float((y - want).abs().max()) <= 1e-12 * float(want.abs().max())


# ------------------------------------------------------------- spmv_ell_alpha

# Path -> a width that takes it for every storage dtype (16-byte vectors of
# 2 to 8 slots).
ALPHA_WIDTHS = {"vector": 8, "wide": 520, "scalar": 37}


def _alpha_close(alpha, val, col, x, v, acc):
    w_ref, alpha_ref = ref.spmv_ell_alpha_ref(val, col, x, v, acc)
    terms = float((v.double() * w_ref[: v.shape[0]].double()).abs().sum())
    assert alpha.dtype == acc and alpha.dim() == 0
    assert abs(float(alpha) - float(alpha_ref)) <= RTOL[acc] * terms


@pytest.mark.gpu
@pytest.mark.parametrize("path", list(ALPHA_WIDTHS))
@pytest.mark.parametrize("pair", list(PAIRS))
def test_spmv_ell_alpha_w_is_spmv_ell(cuda, pair, path):
    """``w`` is ``spmv_ell``'s ``y`` bit for bit on every path (one row
    code); alpha matches the plain version and has the same bits on five
    calls."""
    S, A = PAIRS[pair]
    width = ALPHA_WIDTHS[path]
    val, col, x = _ell(1003, width, 2000, S, cuda, seed=width)
    assert ell_launch_plan(width, val.element_size(), True)[1] == path
    v = torch.randn(1003, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    v = v.to(A).to(cuda)
    w, alpha = spmv_ell_alpha_kernel_call(val, col, x, v, accum_dtype=A)
    assert torch.equal(w, spmv_ell_kernel_call(val, col, x, accum_dtype=A))
    _alpha_close(alpha, val, col, x, v, A)
    for _ in range(4):
        w2, alpha2 = spmv_ell_alpha_kernel_call(val, col, x, v, accum_dtype=A)
        assert torch.equal(w2, w) and torch.equal(alpha2, alpha)


@pytest.mark.gpu
def test_spmv_ell_alpha_main_path_shape(cuda):
    """The main path's layout (rows of 8 f32 slots, v and w in f64) at a size
    that spans many grid strides: w equals spmv_ell's y, and alpha has the
    same bits on five calls."""
    val, col, x = _ell(1 << 20, 8, 1 << 20, torch.float32, cuda, seed=11)
    v = torch.randn(1 << 20, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    v = v.to(cuda)
    w, alpha = spmv_ell_alpha_kernel_call(val, col, x, v, accum_dtype=torch.float64)
    assert torch.equal(w, spmv_ell_kernel_call(val, col, x, accum_dtype=torch.float64))
    _alpha_close(alpha, val, col, x, v, torch.float64)
    for _ in range(4):
        assert torch.equal(spmv_ell_alpha_kernel_call(val, col, x, v, accum_dtype=torch.float64)[1],
                           alpha)


@pytest.mark.gpu
@pytest.mark.parametrize("path", list(ALPHA_WIDTHS))
@pytest.mark.parametrize("pair", list(PAIRS))
def test_spmv_ell_alpha_ignores_padding_rows(cuda, pair, path):
    """With ``len(v) < rows`` the rows past ``len(v)`` are written to ``w`` but
    add nothing to alpha, and ``v`` is not read past its end: ``v`` is a view
    whose storage goes on with 1e30s."""
    S, A = PAIRS[pair]
    rows, nv = 1003, 1003 - 11
    val, col, x = _ell(rows, ALPHA_WIDTHS[path], 2000, S, cuda, seed=3)
    v_full = torch.randn(rows, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    v_full[nv:] = 1e30
    v = v_full.to(A).to(cuda)[:nv]
    w, alpha = spmv_ell_alpha_kernel_call(val, col, x, v, accum_dtype=A)
    assert w.shape == (rows,)
    assert torch.equal(w, spmv_ell_kernel_call(val, col, x, accum_dtype=A))
    _alpha_close(alpha, val, col, x, v, A)
