"""The port's host sparse layer against the reference: generators, layouts,
and the format decision."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.kernels.engine as jeng
import repro.sparse.formats as jfmt
from repro.sparse import generate as jax_generate
from repro_torch.kernels import engine as teng
from repro_torch.sparse import formats as tfmt
from repro_torch.sparse import generate as torch_generate

DTYPES = {
    "f32": (jnp.float32, torch.float32),
    "f64": (jnp.float64, torch.float64),
    "bf16": (jnp.bfloat16, torch.bfloat16),
}


def _np(a) -> np.ndarray:
    """Array of either package as NumPy; bf16 as its raw bits (int16)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _port_csr(c) -> tfmt.CSR:
    return tfmt.CSR(indptr=np.asarray(c.indptr), indices=np.asarray(c.indices),
                    data=np.asarray(c.data), shape=c.shape)


def _csr_pair(m):
    """One scipy matrix as a (reference CSR, port CSR) pair."""
    m = ((m + m.T) / 2).tocsr()
    m.sort_indices()
    arrays = dict(indptr=m.indptr.astype(np.int64), indices=m.indices.astype(np.int32),
                  data=m.data.astype(np.float64), shape=m.shape)
    return jfmt.CSR(**arrays), tfmt.CSR(**arrays)


def _assert_padded_equal(port, ref, rows, width):
    """Equal on the stored region [:rows, :width]; zero everywhere else."""
    port, ref = _np(port), _np(ref)
    np.testing.assert_array_equal(port[:rows, :width], ref[:rows, :width])
    assert not port[rows:].any() and not port[:, width:].any()
    assert not ref[rows:].any() and not ref[:, width:].any()


# The selector matrices of tests/test_engine.py.
def block_diagonal(n_blocks=32, bs=8, seed=0):
    rng = np.random.default_rng(seed)
    return sp.block_diag([rng.random((bs, bs)) + 0.1 for _ in range(n_blocks)], format="csr")


def banded(n=512, bandwidth=2, seed=0):
    rng = np.random.default_rng(seed)
    diags = [rng.random(n - abs(o)) + 0.1 for o in range(-bandwidth, bandwidth + 1)]
    return sp.diags(diags, range(-bandwidth, bandwidth + 1), format="csr")


def powerlaw(n=1024, deg=6.0, seed=0):
    return jax_generate("web", n, deg, seed=seed, values="uniform").to_scipy()


def hub_dense(n=400, hubs=40, seed=0):
    rng = np.random.default_rng(seed)
    a = sp.lil_matrix((n, n))
    a[:hubs, :] = rng.random((hubs, n)) + 0.1
    return a.tocsr()


SELECTOR_MATRICES = {
    "blockdiag": (lambda: block_diagonal(), "bsr"),
    "banded1": (lambda: banded(bandwidth=1), "ell"),
    "banded3": (lambda: banded(bandwidth=3, seed=1), "ell"),
    "powerlaw": (lambda: powerlaw(), "hybrid"),
    "hubdense": (lambda: hub_dense(), "coo"),
}


@pytest.mark.parametrize("kind,n,deg", [("web", 2048, 8.0), ("road", 1024, 2.1),
                                        ("urand", 1500, 4.0), ("kron", 1024, 8.0)])
@pytest.mark.parametrize("values", ["normalized", "unit"])
def test_generate_is_byte_equal(kind, n, deg, values):
    a = jax_generate(kind, n, deg, seed=3, values=values)
    b = torch_generate(kind, n, deg, seed=3, values=values)
    assert a.shape == b.shape
    for f in ("indptr", "indices", "data"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_ell_layout_matches_reference(dt):
    jdt, tdt = DTYPES[dt]
    ref = jax_generate("road", 1000, 2.1, seed=1)
    ell_j = jfmt.to_device_ell(ref, dtype=jdt)
    ell_t = tfmt.to_device_ell(_port_csr(ref), dtype=tdt)
    width = int(ref.row_nnz().max())
    # 8-slot width padding, not the TPU's 128 lanes; rows padded to 8.
    assert ell_t.val.shape == (-(-ref.n // 8) * 8, 8) and ell_t.val.dtype == tdt
    assert ell_j.val.shape[1] == 128
    _assert_padded_equal(ell_t.val, ell_j.val, ref.n, width)
    _assert_padded_equal(ell_t.col, ell_j.col, ref.n, width)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_hybrid_layout_matches_reference(dt):
    jdt, tdt = DTYPES[dt]
    ref = jax_generate("web", 2048, 8.0, seed=7, values="normalized")
    hyb_j = jfmt.to_device_hybrid(ref, dtype=jdt, row_tile=512)
    hyb_t = tfmt.to_device_hybrid(_port_csr(ref), dtype=tdt)
    assert hyb_t.width == hyb_j.width
    _assert_padded_equal(hyb_t.ell_val, hyb_j.ell_val, ref.n, hyb_t.width)
    _assert_padded_equal(hyb_t.ell_col, hyb_j.ell_col, ref.n, hyb_t.width)
    for f in ("tail_row", "tail_col", "tail_val"):
        np.testing.assert_array_equal(_np(getattr(hyb_t, f)), _np(getattr(hyb_j, f)))
    offsets = hyb_t.tail_offsets.numpy()
    tail_row = np.asarray(hyb_j.tail_row)
    assert offsets[-1] == np.count_nonzero(np.asarray(hyb_j.tail_val, np.float64))
    np.testing.assert_array_equal(np.diff(offsets), np.bincount(tail_row[: offsets[-1]],
                                                                minlength=ref.n))


@pytest.mark.parametrize("bs", [4, 8, 16])
def test_bsr_and_coo_layouts_match_reference(bs):
    ref = jax_generate("road", 529, 3.0, seed=bs, values="uniform")
    port = _port_csr(ref)
    bsr_j, bsr_t = jfmt.to_device_bsr(ref, block_size=bs), tfmt.to_device_bsr(port, block_size=bs)
    np.testing.assert_array_equal(bsr_t.val.numpy(), np.asarray(bsr_j.val))
    np.testing.assert_array_equal(bsr_t.bcol.numpy(), np.asarray(bsr_j.bcol))
    coo_j, coo_t = jfmt.to_device_coo(ref), tfmt.to_device_coo(port)
    for f in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(coo_t, f).numpy(), np.asarray(getattr(coo_j, f)))
    np.testing.assert_array_equal(coo_t.offsets.numpy(), ref.indptr)


@pytest.mark.parametrize("fmt", ["ell", "hybrid", "bsr", "coo"])
def test_from_reference_rebuilds_the_port_layout(fmt):
    ref = jax_generate("web", 1024, 6.0, seed=2, values="normalized")
    port = _port_csr(ref)
    conv = {
        "ell": (lambda: jfmt.to_device_ell(ref, slot_tile=8), lambda: tfmt.to_device_ell(port)),
        "hybrid": (lambda: jfmt.to_device_hybrid(ref), lambda: tfmt.to_device_hybrid(port)),
        "bsr": (lambda: jfmt.to_device_bsr(ref), lambda: tfmt.to_device_bsr(port)),
        "coo": (lambda: jfmt.to_device_coo(ref), lambda: tfmt.to_device_coo(port)),
    }[fmt]
    jc, own = conv[0](), conv[1]()
    arrays = {f.name: (np.asarray(getattr(jc, f.name)) if f.name not in ("n_rows", "n_cols")
                       else getattr(jc, f.name)) for f in dataclasses.fields(jc)}
    got = tfmt.from_reference(arrays)
    assert type(got) is type(own)
    for f in dataclasses.fields(own):
        a, b = getattr(got, f.name), getattr(own, f.name)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(ref.n))
    eng = teng.SpmvEngine(format=fmt, accum_dtype=torch.float64, device="cpu")
    want = ref.to_scipy() @ x.numpy()
    np.testing.assert_allclose(eng.spmv(got, x.to(torch.float32)).numpy(), want, rtol=1e-6,
                               atol=1e-6)


def test_conversion_count_ticks_per_layout():
    port = torch_generate("road", 256, 2.1, seed=0)
    c0 = tfmt.conversion_count()
    tfmt.to_device_ell(port)
    tfmt.to_device_coo(port)
    tfmt.to_device_bsr(port)
    tfmt.to_device_hybrid(port)
    assert tfmt.conversion_count() - c0 == 4


@pytest.mark.parametrize("name", list(SELECTOR_MATRICES))
def test_matrix_stats_and_choose_format_match_reference(name):
    make, expected = SELECTOR_MATRICES[name]
    ref, port = _csr_pair(make())
    sj, st = jeng.matrix_stats(ref), teng.matrix_stats(port)
    assert dataclasses.asdict(sj) == dataclasses.asdict(st)
    allowed = ("coo", "ell", "hybrid") if name == "hubdense" else jeng.FORMATS
    assert jeng.choose_format(sj, allowed) == teng.choose_format(st, allowed) == expected


@pytest.mark.parametrize("env", [{}, {"REPRO_SPMV_ELL_OVERHEAD": "1e9"},
                                 {"REPRO_SPMV_BSR_FILL": "1e9"},
                                 {"REPRO_SPMV_HYBRID_Q": "0.5", "REPRO_SPMV_HYBRID_TAIL": "0.01"}])
def test_selection_knobs_steer_both_packages_alike(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for make, _ in SELECTOR_MATRICES.values():
        ref, port = _csr_pair(make())
        assert jeng.choose_format(jeng.matrix_stats(ref)) == teng.choose_format(
            teng.matrix_stats(port))


def test_make_engine_validates_and_plans():
    _, port = _csr_pair(banded(128))
    with pytest.raises(ValueError, match="unknown SpMV format"):
        teng.make_engine(port, "ellpack", device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        teng.make_engine(port, "bsr", allowed=("coo", "ell"), device="cpu")
    cpu = teng.make_engine(port, device="cpu")
    assert cpu.format == "ell" and cpu.iteration_plan.update == "unfused"
    assert teng.table_update_mode("cuda") == "fused"
    assert cpu.describe()["device"] == "cpu"
