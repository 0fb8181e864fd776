"""The port's six kernels against the reference's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the reference
kernels run in Pallas interpret mode, as ``tests/test_kernels.py`` runs
them.  Both get the same data: the layouts are the reference's own
containers, carried over with ``repro_torch.sparse.formats.from_reference``.

Tolerances: f64 accumulation rtol 1e-12; f32 accumulation rtol 1e-5 — the
arithmetic is the same, only the order of the sums differs.  The ``gpu``
tests hold each CUDA kernel against its plain version on the card, with the
same tolerances.  ``mixed_dot``'s tolerance is relative to the sum of the
|a_i b_i| (the scale of its rounding errors), since the sum itself can
cancel.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lanczos_fused import spmv_ell_alpha_kernel_call as jax_spmv_ell_alpha
from repro.kernels import ops as jax_ops
from repro.kernels.lanczos_update import lanczos_update_kernel_call as jax_lanczos_update
from repro.kernels.spmv_ell_packed import pack_ell_chunk as jax_pack_ell_chunk
from repro.kernels.spmv_ell_packed import spmv_ell_packed_kernel_call as jax_spmv_ell_packed
from repro.kernels.spmv_bsr import spmv_bsr_kernel_call as jax_spmv_bsr
from repro.kernels.spmv_ell import spmv_ell_kernel_call as jax_spmv_ell
from repro.sparse import generate, to_device_bsr, to_device_ell
from repro_torch.kernels import build, lanczos_fused, ops, ref
from repro_torch.kernels import spmv_ell as spmv_ell_module
from repro_torch.kernels.lanczos_fused import spmv_ell_alpha_kernel_call
from repro_torch.kernels.lanczos_update import lanczos_update_kernel_call
from repro_torch.kernels.mixed_dot import mixed_dot_kernel_call
from repro_torch.kernels.spmv_bsr import spmv_bsr_kernel_call
from repro_torch.kernels.spmv_ell import (
    ell_group,
    ell_launch_plan,
    ell_max_blocks,
    lane_plan,
    spmv_ell_kernel_call,
)
from repro_torch.kernels.spmv_ell_packed import (
    pack_ell_chunk,
    packed_launch_plan,
    spmv_ell_packed_kernel_call,
)
from repro_torch.sparse.formats import from_reference

# (storage, accum) pairs, as (jax dtype, torch dtype) each.
PAIRS = {
    "f32-f32": ((jnp.float32, torch.float32), (jnp.float32, torch.float32)),
    "f32-f64": ((jnp.float32, torch.float32), (jnp.float64, torch.float64)),
    "bf16-f32": ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)),
    "f64-f64": ((jnp.float64, torch.float64), (jnp.float64, torch.float64)),
}
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _arrays(container) -> dict:
    return {f.name: np.asarray(getattr(container, f.name)) for f in dataclasses.fields(container)}


def _t(a_jax) -> torch.Tensor:
    """A reference array as a CPU tensor (bf16 / fp8 bits carried over exactly)."""
    a = np.asarray(a_jax)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _close(got: torch.Tensor, want, acc) -> None:
    want = np.asarray(want, dtype=np.float64)
    got = got.double().numpy()
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=RTOL[acc], atol=RTOL[acc] * scale)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    return torch.device("cuda")


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("n", [1001, 2048])
def test_spmv_ell_matches_reference(pair, n):
    (jdt, tdt), (jacc, tacc) = PAIRS[pair]
    csr = generate("urand", n, 6.0, seed=n, values="uniform")
    ell = to_device_ell(csr, dtype=jdt)
    x_np = np.random.default_rng(0).standard_normal(n)
    x_j = jnp.asarray(x_np, dtype=jdt)
    rows = ell.val.shape[0]  # one row tile: a short interpret-mode grid
    want = jax_spmv_ell(ell.val, ell.col, x_j, block_r=rows, accum_dtype=jacc, interpret=True)[:n]
    mat = from_reference(_arrays(ell), device="cpu")
    got = ops.spmv_ell(mat, _t(x_j), accum_dtype=tacc)
    assert got.dtype == tacc and got.shape == (n,)
    _close(got, want, tacc)


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("n", [1001, 2048])
def test_spmv_ell_alpha_matches_reference(pair, n):
    (jdt, tdt), (jacc, tacc) = PAIRS[pair]
    csr = generate("web", n, 6.0, seed=n + 1, values="uniform")
    ell = to_device_ell(csr, dtype=jdt)
    rows = ell.val.shape[0]
    rng = np.random.default_rng(1)
    x_j = jnp.asarray(rng.standard_normal(n), dtype=jdt)
    v_np = np.zeros(rows)
    v_np[:n] = rng.standard_normal(n)
    v_j = jnp.asarray(v_np, dtype=jacc)
    w_want, a_want = jax_spmv_ell_alpha(
        ell.val, ell.col, x_j, v_j, block_r=rows, accum_dtype=jacc, interpret=True
    )
    mat = from_reference(_arrays(ell), device="cpu")
    w, alpha = ops.spmv_ell_alpha(mat, _t(x_j), _t(v_j)[:n], accum_dtype=tacc)
    _close(w, w_want[:n], tacc)
    terms = float(np.sum(np.abs(v_np[:n]) * np.abs(np.asarray(w_want[:n], np.float64))))
    assert abs(float(alpha) - float(a_want[0])) <= RTOL[tacc] * terms


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("n", [999, 4096])
def test_lanczos_update_matches_reference(pair, n):
    (jdt, tdt), (jacc, tacc) = PAIRS[pair]
    rng = np.random.default_rng(n)
    w, v, vp = (jnp.asarray(rng.standard_normal(n), dtype=jdt) for _ in range(3))
    alpha, beta = jnp.asarray(0.37, jacc), jnp.asarray(1.21, jacc)
    u_want, nrm_want = jax_lanczos_update(
        w, v, vp, alpha, beta, block=n, accum_dtype=jacc, interpret=True
    )
    u, nrm = ops.lanczos_update(
        _t(w), _t(v), _t(vp), _t(alpha), _t(beta), accum_dtype=tacc
    )
    assert u.dtype == tdt and u.shape == (n,)
    # u is rounded to the storage dtype: allow one rounding of it.
    u_tol = max(RTOL[tacc], float(torch.finfo(tdt).eps))
    np.testing.assert_allclose(
        u.double().numpy(), np.asarray(u_want, np.float64), rtol=u_tol, atol=u_tol
    )
    assert abs(float(nrm) - float(nrm_want[0])) <= RTOL[tacc] * float(nrm_want[0])


BSR_PAIRS = {**PAIRS, "f16-f32": ((jnp.float16, torch.float16), (jnp.float32, torch.float32))}


@pytest.mark.parametrize("pair", list(BSR_PAIRS))
@pytest.mark.parametrize("bs", [4, 8, 16])
def test_spmv_bsr_matches_reference(pair, bs):
    (jdt, tdt), (jacc, tacc) = BSR_PAIRS[pair]
    csr = generate("road", 529, 3.0, seed=bs, values="uniform")  # 529 rows: odd
    bsr = to_device_bsr(csr, block_size=bs, dtype=jdt)
    nbr = bsr.val.shape[0]
    x_np = np.zeros(nbr * bs)
    x_np[: csr.n] = np.random.default_rng(7).standard_normal(csr.n)
    x_j = jnp.asarray(x_np, dtype=jdt)
    want = jax_spmv_bsr(bsr.val, bsr.bcol, x_j, accum_dtype=jacc, interpret=True)[: csr.n]
    mat = from_reference(_arrays(bsr), device="cpu")
    got = ops.spmv_bsr(mat, _t(x_j)[: csr.n], accum_dtype=tacc)
    assert got.shape == (csr.n,)
    _close(got, want, tacc)


def test_kernel_calls_refuse_host_tensors():
    """A kernel call never runs a plain path: host tensors are refused."""
    val = torch.zeros(8, 8)
    col = torch.zeros(8, 8, dtype=torch.int32)
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        spmv_ell_kernel_call(val, col, x, accum_dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        spmv_ell_alpha_kernel_call(val, col, x, x, accum_dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        lanczos_update_kernel_call(x, x, x, 0.5, 0.5, accum_dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        spmv_bsr_kernel_call(torch.zeros(1, 1, 8, 8), torch.zeros(1, 1, dtype=torch.int32), x,
                             accum_dtype=torch.float32)
    packed = pack_ell_chunk(val.numpy(), col.numpy(), "bf16")
    with pytest.raises(ValueError, match="CUDA"):
        spmv_ell_packed_kernel_call(*packed, x, accum_dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        mixed_dot_kernel_call(x, x, block=8, accum_dtype=torch.float32)
    with pytest.raises(ValueError, match="no kernel path"):
        ops.ell_matvec(val.to("meta"), col.to("meta"), x.to("meta"), torch.float32)


def test_build_is_keyed_and_lazy():
    """Importing the kernel modules builds nothing; the build key covers
    every CUDA source and header, and the dtype codes match the C side."""
    assert build._LIB is None
    assert build._source_key() == build._source_key()
    names = {p.name for p in build.CSRC.glob("*.cu*")}
    assert set(build.SOURCES) <= names and "common.cuh" in names
    assert [build.dtype_code(d) for d in (torch.float32, torch.float64, torch.float16,
                                          torch.bfloat16, torch.float8_e4m3fn)] == [0, 1, 2, 3, 4]
    assert [build.index_code(d) for d in (torch.int16, torch.int32)] == [5, 6]
    with pytest.raises(TypeError):
        build.dtype_code(torch.int32)
    assert [ell_group(w) for w in (1, 3, 8, 9, 32, 200)] == [1, 4, 8, 16, 32, 32]


def _packed_chunk(rows: int, width: int, n_cols: int, seed: int):
    """A host ELL chunk as the staging builds one: sorted columns per row,
    f32 values of mixed magnitude, and zero padding (val 0, col 0) at the
    end of every row shorter than the width."""
    rng = np.random.default_rng(seed)
    col = np.zeros((rows, width), np.int32)
    val = np.zeros((rows, width), np.float32)
    for r in range(rows):
        k = int(rng.integers(1, width + 1))
        col[r, :k] = np.sort(rng.choice(n_cols, size=k, replace=False))
        val[r, :k] = rng.standard_normal(k) * 10.0 ** rng.integers(-3, 3)
    return val, col


# (mode, columns): 2,000 columns keep every delta in int16; 100,000 make
# the padding's return-to-0 delta overflow it, so dcol stays int32.
PACK_CASES = [("bf16", 2000), ("fp8", 2000), ("bf16", 100_000), ("fp8", 100_000)]


@pytest.mark.parametrize("mode,n_cols", PACK_CASES)
def test_pack_ell_chunk_bytes_equal_reference(mode, n_cols):
    val, col = _packed_chunk(64, 12, n_cols, seed=n_cols)
    want = jax_pack_ell_chunk(val, col, mode)
    got = pack_ell_chunk(val, col, mode)
    assert got[3].dtype == (torch.int16 if n_cols < (1 << 15) else torch.int32)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert g.contiguous().view(torch.uint8).numpy().tobytes() == w.tobytes()


@pytest.mark.parametrize("mode,n_cols", PACK_CASES)
@pytest.mark.parametrize("pair", ["f32-f32", "f32-f64", "bf16-f32", "f64-f64"])
def test_spmv_ell_packed_matches_reference(mode, n_cols, pair):
    (jdt, tdt), (jacc, tacc) = PAIRS[pair]
    val, col = _packed_chunk(64, 12, n_cols, seed=7)
    packed = jax_pack_ell_chunk(val, col, mode)
    x_j = jnp.asarray(np.random.default_rng(3).standard_normal(n_cols), dtype=jdt)
    want = jax_spmv_ell_packed(*packed, x_j, accum_dtype=jacc, interpret=True)
    got = ops.packed_ell_matvec(*(_t(a) for a in packed), _t(x_j), tacc)
    assert got.dtype == tacc and got.shape == (64,)
    # rtol 1e-6 under f32 accumulation (sum order), 1e-12 under f64.
    rtol = 1e-6 if tacc == torch.float32 else 1e-12
    scale = float(np.abs(np.asarray(want, np.float64)).max())
    np.testing.assert_allclose(got.double().numpy(), np.asarray(want, np.float64), rtol=rtol,
                               atol=rtol * scale)


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16", "f64"])
@pytest.mark.parametrize("n", [4096 * 3, 10_000])
def test_mixed_dot_matches_reference(compensated, dt, n):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
                "f64": (jnp.float64, torch.float64)}[dt]
    jacc, tacc = (jnp.float64, torch.float64) if dt == "f64" else (jnp.float32, torch.float32)
    rng = np.random.default_rng(n)
    a_j, b_j = (jnp.asarray(rng.standard_normal(n) * 3.0, dtype=jdt) for _ in range(2))
    want = float(jax_ops.mixed_dot(a_j, b_j, accum_dtype=jacc, compensated=compensated,
                                   interpret=True))
    got = ops.mixed_dot(_t(a_j), _t(b_j), accum_dtype=tacc, compensated=compensated)
    assert got.dtype == tacc and got.dim() == 0
    terms = float(np.sum(np.abs(np.asarray(a_j, np.float64) * np.asarray(b_j, np.float64))))
    # Per-tile sums in another order: 1e-6 (f32 accum) / 1e-12 (f64) of sum |a_i b_i|.
    assert abs(float(got) - want) <= (1e-6 if tacc == torch.float32 else 1e-12) * terms


def test_mixed_dot_compensation_matches_reference_exactly():
    """Tile totals 1e8 then six 1s: an f32 running sum drops every 1 (the
    ulp at 1e8 is 8); the compensation term keeps all six, and sum + comp
    rounds to 1e8 + 8, in both packages."""
    a = np.ones(7 * 4096, np.float32)
    b = np.zeros(7 * 4096, np.float32)
    b[0] = 1e8
    b[4096::4096] = 1.0
    for compensated, want in ((False, 1e8), (True, 1e8 + 8)):
        ref_out = float(jax_ops.mixed_dot(jnp.asarray(a), jnp.asarray(b), compensated=compensated,
                                          interpret=True))
        got = ops.mixed_dot(torch.from_numpy(a), torch.from_numpy(b), compensated=compensated)
        assert ref_out == float(got) == want
    pair = ref.mixed_dot_ref(torch.from_numpy(a), torch.from_numpy(b), torch.float32,
                             compensated=True)
    assert pair.tolist() == [1e8, 6.0]


# (width, element size, base aligned, rows, SMs) -> (lanes per row, path,
# slots a split segment): a lane reads one 16-byte vector of 16 /
# element-size slots.  The first cases at 1M rows (a card's worth of wide
# rows) keep the wide path; the split cases follow.
WIDE_ROWS = 1 << 20
LAUNCH_PLANS = [
    ((8, 4, True, WIDE_ROWS, 132), (2, "vector", 0)),     # the main path: f32 rows of 8, a lane pair a row
    ((8, 2, True, WIDE_ROWS, 132), (1, "vector", 0)),     # bf16 / f16: one lane a row
    ((8, 8, True, WIDE_ROWS, 132), (4, "vector", 0)),     # f64
    ((12, 4, True, WIDE_ROWS, 132), (4, "vector", 0)),    # 3 vectors: rounded up to 4 lanes, one idle
    ((64, 4, True, WIDE_ROWS, 132), (16, "vector", 0)),
    ((128, 4, True, WIDE_ROWS, 132), (32, "vector", 0)),  # 32 vectors: the last width with a lane each
    ((200, 4, True, WIDE_ROWS, 132), (32, "wide", 0)),    # 50 vectors: a warp walks the row
    ((1024, 8, True, WIDE_ROWS, 132), (32, "wide", 0)),
    ((37, 4, True, WIDE_ROWS, 132), (32, "scalar", 0)),   # not a whole number of vectors
    ((12, 2, True, WIDE_ROWS, 132), (16, "scalar", 0)),
    ((1, 4, True, WIDE_ROWS, 132), (1, "scalar", 0)),
    ((3, 8, True, WIDE_ROWS, 132), (4, "scalar", 0)),
    ((8, 4, False, WIDE_ROWS, 132), (8, "scalar", 0)),    # a base that is not 16-byte aligned
    ((200, 4, False, WIDE_ROWS, 132), (32, "scalar", 0)),
    # Wide rows too few to fill 132 SMs (under 4 a SM) and longer than one
    # step of the wide path (128 vectors) split, in segments of 32 lanes x
    # 1-4 vectors: the largest that leaves 8 warps a SM.
    ((1_047_672, 4, True, 1, 132), (32, "split", 512)),   # a hub row
    ((1_047_672, 4, True, 8, 132), (32, "split", 512)),   # the hub chunk
    ((1_047_672, 4, True, 251, 132), (32, "split", 512)),
    ((25_232, 4, True, 1, 132), (32, "split", 128)),      # 198 segments of 1 vector a lane
    ((25_232, 4, True, 8, 132), (32, "split", 128)),
    ((25_232, 4, True, 251, 132), (32, "split", 512)),    # the degree-ordered kron's top chunk
    ((25_232, 2, True, 251, 132), (32, "split", 1024)),   # bf16: 8 slots a vector
    ((25_232, 4, True, 527, 132), (32, "split", 512)),
    ((25_232, 4, True, 528, 132), (32, "wide", 0)),       # 4 rows a SM: the wide path again
    ((516, 4, True, 1, 132), (32, "split", 128)),         # 129 vectors: two segments
    ((512, 4, True, 1, 132), (32, "wide", 0)),            # 128 vectors: one wide step
    ((200, 4, True, 5_656, 132), (32, "wide", 0)),        # the kron's 5th chunk: many short rows
    ((264, 4, True, 8_192, 132), (32, "wide", 0)),
    ((128, 4, True, 1, 132), (32, "vector", 0)),          # 32 vectors: still the vector path
    ((1_047_672, 4, False, 8, 132), (32, "scalar", 0)),   # unaligned: scalar, whatever the rows
]


@pytest.mark.parametrize("args,plan", LAUNCH_PLANS, ids=[str(a) for a, _ in LAUNCH_PLANS])
def test_spmv_ell_launch_plan(args, plan):
    assert ell_launch_plan(*args) == plan


# (width, delta bytes, bases aligned, rows, SMs) -> (lanes per row, path,
# slots a split segment): a lane of spmv_ell_packed reads 8 slots as
# vectors, whatever the delta size.
PACKED_PLANS = [
    ((8, 2, True, WIDE_ROWS, 132), (1, "vector", 0)),     # a chunk of a road network: one lane a row
    ((8, 4, True, WIDE_ROWS, 132), (1, "vector", 0)),
    ((16, 4, True, WIDE_ROWS, 132), (2, "vector", 0)),
    ((24, 2, True, WIDE_ROWS, 132), (4, "vector", 0)),    # 3 vectors: rounded up to 4 lanes, one idle
    ((40, 4, True, WIDE_ROWS, 132), (8, "vector", 0)),
    ((256, 2, True, WIDE_ROWS, 132), (32, "vector", 0)),  # 32 vectors: the last width with a lane each
    ((264, 4, True, WIDE_ROWS, 132), (32, "wide", 0)),    # 33 vectors: a warp walks the row
    ((1_047_672, 4, True, WIDE_ROWS, 132), (32, "wide", 0)),
    ((37, 2, True, WIDE_ROWS, 132), (32, "scalar", 0)),   # not a whole number of vectors
    ((12, 4, True, WIDE_ROWS, 132), (16, "scalar", 0)),
    ((4, 2, True, WIDE_ROWS, 132), (4, "scalar", 0)),
    ((8, 4, False, WIDE_ROWS, 132), (8, "scalar", 0)),    # a base that is not 16-byte aligned
    ((264, 2, False, WIDE_ROWS, 132), (32, "scalar", 0)),
    # Few wide rows split: the hub chunk, the degree-ordered kron's top chunk.
    ((1_047_672, 4, True, 1, 132), (32, "split", 768)),   # a hub row: 3 vectors a lane
    ((1_047_672, 4, True, 8, 132), (32, "split", 1024)),  # the hub chunk
    ((1_047_672, 2, True, 251, 132), (32, "split", 1024)),
    ((25_232, 4, True, 1, 132), (32, "split", 256)),
    ((25_232, 2, True, 8, 132), (32, "split", 256)),
    ((25_232, 4, True, 251, 132), (32, "split", 1024)),   # the degree-ordered kron's top chunk
    ((1_032, 4, True, 8, 132), (32, "split", 256)),       # 129 vectors: the wide/split edge
    ((1_024, 4, True, 8, 132), (32, "wide", 0)),          # 128 vectors: one wide step
    ((560, 4, True, 2_638, 132), (32, "wide", 0)),        # the kron's 4th chunk
    ((25_232, 4, True, 528, 132), (32, "wide", 0)),       # 4 rows a SM
    ((264, 2, True, 1, 132), (32, "wide", 0)),            # 33 vectors: one wide step
    ((200, 4, True, 8, 132), (32, "vector", 0)),          # 25 vectors: the vector path at any rows
]


@pytest.mark.parametrize("args,plan", PACKED_PLANS, ids=[str(a) for a, _ in PACKED_PLANS])
def test_spmv_ell_packed_launch_plan(args, plan):
    assert packed_launch_plan(*args) == plan


@pytest.mark.parametrize("delta_size", [1, 8])
def test_spmv_ell_packed_launch_plan_refuses_other_deltas(delta_size):
    with pytest.raises(ValueError, match="deltas"):
        packed_launch_plan(8, delta_size, True, WIDE_ROWS, 132)


# (rows, width, storage, SMs): the main path's f32 rows of 8 on a small
# card, a grid that covers the rows at once, the wide and the scalar path.
ALPHA_GRIDS = [
    (1 << 16, 8, torch.float32, 8),
    (1 << 16, 8, torch.float64, 132),
    (1000, 8, torch.float32, 132),
    (64, 200, torch.float32, 2),
    (4096, 37, torch.float32, 4),
]


@pytest.mark.parametrize("rows,width,dt,sms", ALPHA_GRIDS)
def test_spmv_ell_alpha_partials_sized_from_grid(rows, width, dt, sms, monkeypatch):
    """The alpha wrapper allocates one partial per block of the kernel's
    grid (at most SMs x the 8 blocks of 256 threads a Hopper SM holds),
    not one per 256 lanes of rows, and passes that count and spmv_ell's
    launch plan to the kernel."""
    seen = {}

    class FakeLib:
        def repro_spmv_ell_alpha(self, *args):
            seen["args"] = args
            return 0

    monkeypatch.setattr(build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(build, "load", FakeLib)
    monkeypatch.setattr(build, "stream_of", lambda t: None)
    monkeypatch.setattr(build, "ptr", lambda t: t)  # the kernel sees the tensors
    monkeypatch.setattr(lanczos_fused, "sm_count", lambda dev: sms)
    val = torch.zeros(rows, width, dtype=dt)
    col = torch.zeros(rows, width, dtype=torch.int32)
    spmv_ell_alpha_kernel_call(val, col, torch.zeros(rows, dtype=dt),
                               torch.zeros(rows - 3, dtype=torch.float64),
                               accum_dtype=torch.float64)
    args = seen["args"]
    assert args[:3] == (build.dtype_code(dt), build.dtype_code(dt),
                        build.dtype_code(torch.float64))  # storage, x, accum
    lanes, path = lane_plan(width, 16 // val.element_size(), True)  # alpha never splits
    assert args[13:17] == (width, lanes, spmv_ell_module.ELL_PATHS[path], sms)
    partials, n_partials = args[9], args[10]
    assert partials.dtype == torch.float64 and partials.numel() == n_partials
    assert n_partials == ell_max_blocks(rows, lanes, path, sms) <= sms * 8
    step = 256 // (32 if path == "wide" else lanes) * (4 if path == "vector" else 1)
    assert n_partials == min(-(-rows // step), sms * 8)
    old_blocks = -(-rows * ell_group(width) // 256)  # the lane-group design's grid
    if rows >= 1 << 16:
        assert n_partials * 8 <= old_blocks


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 4095, 4097, 3 * 4096 + 17])
def test_mixed_dot_ragged_matches_reference(compensated, dt, n):
    """Lengths that are not whole tiles (n = 1 and 4095 are one short tile;
    4097 and 3 * 4096 + 17 end in a ragged one) against the reference's
    wrapper, which zero-pads them."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    rng = np.random.default_rng(n + 1)
    a_j, b_j = (jnp.asarray(rng.standard_normal(n) * 3.0, dtype=jdt) for _ in range(2))
    want = float(jax_ops.mixed_dot(a_j, b_j, compensated=compensated, interpret=True))
    got = ops.mixed_dot(_t(a_j), _t(b_j), compensated=compensated)
    assert got.dtype == torch.float32 and got.dim() == 0
    terms = float(np.sum(np.abs(np.asarray(a_j, np.float64) * np.asarray(b_j, np.float64))))
    # Per-tile sums in another order: 1e-6 of sum |a_i b_i| (f32 accumulation).
    assert abs(float(got) - want) <= 1e-6 * terms


@pytest.mark.parametrize("n", [1, 4097, 14_077])
def test_mixed_dot_on_the_card_passes_operands_unpadded(n, monkeypatch):
    """On a CUDA tensor ``ops.mixed_dot`` hands the kernel the operands as
    they are (no padding copy; the kernel masks the ragged tile), with the
    reference's tile size."""
    seen = []

    def kernel(a, b, *, block, accum_dtype, compensated):
        seen.append((a, b, block))
        return torch.zeros(2, dtype=accum_dtype)

    def no_pad(*args, **kw):
        raise AssertionError("operands padded on the kernel path")

    monkeypatch.setattr(ops, "on_cpu", lambda t: False)
    monkeypatch.setattr(ops, "mixed_dot_kernel_call", kernel)
    monkeypatch.setattr(torch.nn.functional, "pad", no_pad)
    a, b = torch.ones(n), torch.ones(n)
    ops.mixed_dot(a, b, torch.float64, True)
    assert len(seen) == 1
    got_a, got_b, block = seen[0]
    assert got_a is a and got_b is b and block == min(4096, n)


# ------------------------------------------------------------ on the card


@pytest.mark.gpu
@pytest.mark.parametrize("pair", list(PAIRS))
def test_cuda_kernels_match_plain_versions(pair, cuda):
    (_, tdt), (_, tacc) = PAIRS[pair]
    g = torch.Generator().manual_seed(0)
    rows, width, n = 1003, 13, 1003
    val = torch.randn(rows, width, generator=g).to(tdt).to(cuda)
    col = torch.randint(0, n, (rows, width), generator=g, dtype=torch.int32).to(cuda)
    x = torch.randn(n, generator=g).to(tdt).to(cuda)
    _close(spmv_ell_kernel_call(val, col, x, accum_dtype=tacc).cpu(),
           ref.spmv_ell_ref(val, col, x, tacc).cpu().numpy(), tacc)
    v = torch.randn(n - 5, generator=g).to(tacc).to(cuda)
    w, alpha = spmv_ell_alpha_kernel_call(val, col, x, v, accum_dtype=tacc)
    w_ref, alpha_ref = ref.spmv_ell_alpha_ref(val, col, x, v, tacc)
    _close(w.cpu(), w_ref.cpu().numpy(), tacc)
    terms = float((v.abs() * w_ref[: n - 5].abs()).sum())
    assert abs(float(alpha) - float(alpha_ref)) <= RTOL[tacc] * terms
    ww, vv, vp = (torch.randn(5001, generator=g).to(tdt).to(cuda) for _ in range(3))
    a = torch.tensor(0.37, dtype=tacc, device=cuda)
    b = torch.tensor(1.21, dtype=tacc, device=cuda)
    u, nrm = lanczos_update_kernel_call(ww, vv, vp, a, b, accum_dtype=tacc)
    u_ref, nrm_ref = ref.lanczos_update_ref(ww, vv, vp, a, b, tacc)
    assert torch.equal(u, u_ref)  # same operation order, products rounded
    assert abs(float(nrm) - float(nrm_ref)) <= RTOL[tacc] * float(nrm_ref)
    for bs in (4, 8, 16):
        bv = torch.randn(37, 5, bs, bs, generator=g).to(tdt).to(cuda)
        bc = torch.randint(0, 37, (37, 5), generator=g, dtype=torch.int32).to(cuda)
        bx = torch.randn(37 * bs, generator=g).to(tdt).to(cuda)
        _close(spmv_bsr_kernel_call(bv, bc, bx, accum_dtype=tacc).cpu(),
               ref.spmv_bsr_ref(bv, bc, bx, tacc).cpu().numpy(), tacc)


@pytest.mark.gpu
@pytest.mark.parametrize("pair", list(PAIRS) + ["f16-f32"])
def test_cuda_packed_and_mixed_dot_match_plain_versions(pair, cuda):
    tdt, tacc = {"f16-f32": (torch.float16, torch.float32)}.get(pair, None) or (
        PAIRS[pair][0][1], PAIRS[pair][1][1])
    for mode, n_cols in PACK_CASES:
        val, col = _packed_chunk(1000, 37, n_cols, seed=1)  # width 37: two tiles of 32 lanes
        packed = [t.to(cuda) for t in pack_ell_chunk(val, col, mode)]
        x = torch.randn(n_cols, generator=torch.Generator().manual_seed(2)).to(tdt).to(cuda)
        _close(spmv_ell_packed_kernel_call(*packed, x, accum_dtype=tacc).cpu(),
               ref.spmv_ell_packed_ref(*packed, x, tacc).cpu().numpy(), tacc)
    g = torch.Generator().manual_seed(3)
    a, b = (torch.randn(4096 * 5 + 17, generator=g).to(tdt).to(cuda) for _ in range(2))
    terms = float((a.double() * b.double()).abs().sum())
    for acc in (torch.float32, torch.float64):
        for comp in (False, True):
            got = ops.mixed_dot(a, b, accum_dtype=acc, compensated=comp)
            want = ops.mixed_dot(a.cpu(), b.cpu(), accum_dtype=acc, compensated=comp)
            assert abs(float(got) - float(want)) <= RTOL[acc] * terms
