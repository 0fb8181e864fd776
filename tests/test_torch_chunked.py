"""The out-of-core chunked backend of the port against the reference's, on
the CPU (modelled on ``tests/test_oocore.py``: a 384-node web graph cut into
chunks of 512 nnz).

Tolerances, each stated where it is used:

* ``ChunkedOperator.matvec``: rtol 1e-12 of max |y|.  Both packages stage
  the same values (packed chunks byte-equal) and accumulate in f64; only
  the order of the row sums differs (the reference pads widths to 128
  lanes, the port to 8).
* ``eigsh`` eigenvalues and residual bounds, relative to |lambda_max|:
  FDF 2.5e-7 and FFF 1e-5 (the eigenvalues are emitted in f32, and a
  different sum order can move them by an f32 rounding; over 20 f32
  Lanczos steps a few more), BFF 1e-3 (bf16 basis, eps 7.8e-3).
* Packed staging against f32 staging, as in the reference's tests: bf16
  8e-3, fp8 8e-2 on a matvec.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.api import dispatch as jax_dispatch
from repro.api import session_cache_clear
from repro.core.operators import ChunkedOperator as JaxChunked
from repro.core.operators import chunk_row_bounds as jax_chunk_row_bounds
from repro.kernels import make_engine as jax_make_engine
from repro.sparse import generate
from repro.sparse import save_diskcsr as jax_save
from repro_torch.api import dispatch
from repro_torch.core.operators import ChunkedOperator, chunk_row_bounds, chunk_rows_pad
from repro_torch.kernels.engine import make_engine
from repro_torch.sparse import CSR, open_diskcsr, save_diskcsr

K = 4
ITERS = 20
CHUNK_NNZ = 512
MV_RTOL = 1e-12
EIG_TOL = {"FDF": 2.5e-7, "FFF": 1e-5, "BFF": 1e-3}


@pytest.fixture(autouse=True)
def _no_reference_cache():
    session_cache_clear()
    yield
    session_cache_clear()


@functools.lru_cache(maxsize=None)
def _web():
    return generate("web", 384, 6.0, seed=7, values="normalized")


def _port_csr(c) -> CSR:
    return CSR(indptr=np.asarray(c.indptr), indices=np.asarray(c.indices),
               data=np.asarray(c.data), shape=c.shape)


def _x(n: int) -> np.ndarray:
    return np.random.default_rng(5).standard_normal(n).astype(np.float32)


def _port_op(fmt: str, staging="f32", stage_depth=1, **kw) -> ChunkedOperator:
    csr = kw.pop("csr", None) or _port_csr(_web())
    eng = make_engine(csr, "ell", device="cpu") if fmt == "ell" else None
    return ChunkedOperator(csr, chunk_nnz=CHUNK_NNZ, engine=eng, staging=staging,
                           stage_depth=stage_depth, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _reference_matvec(fmt: str, staging: str):
    """The reference operator's product (stage_depth does not change it)."""
    web = _web()
    eng = jax_make_engine(csr=web, format="ell", interpret=True) if fmt == "ell" else None
    op = JaxChunked(web, chunk_nnz=CHUNK_NNZ, engine=eng, staging=staging)
    y = np.asarray(op.matvec(jnp.asarray(_x(web.n)), accum_dtype=jnp.float64))
    st = op.staging_stats()
    return y, op.num_chunks, op.staging_mode, st["transfers"], st["conversions"], st["max_resident"]


@pytest.mark.parametrize("chunk_nnz", [1, 100, 512, 2048, 1 << 20])
def test_chunk_row_bounds_equal_reference(chunk_nnz):
    for csr in (_web(), generate("road", 1000, 2.1, seed=1)):
        want = jax_chunk_row_bounds(csr.indptr, csr.n, chunk_nnz)
        assert chunk_row_bounds(np.asarray(csr.indptr), csr.n, chunk_nnz) == want


def test_chunk_rows_pad_rounds_to_eight():
    assert [chunk_rows_pad(r) for r in (1, 7, 8, 9, 262_144)] == [8, 8, 8, 16, 262_144]


@pytest.mark.parametrize("stage_depth", [0, 1, 2])
@pytest.mark.parametrize("staging", ["f32", "bf16", "fp8"])
@pytest.mark.parametrize("fmt", ["ell", "coo"])
def test_matvec_matches_reference(fmt, staging, stage_depth):
    y_ref, chunks, mode, transfers, conversions, resident = _reference_matvec(fmt, staging)
    op = _port_op(fmt, staging, stage_depth)
    y = op.matvec(torch.from_numpy(_x(op.n)), accum_dtype=torch.float64)
    assert y.dtype == torch.float64 and y.shape == (op.n,)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=MV_RTOL * np.abs(y_ref).max())
    st = op.staging_stats()
    assert op.staging_mode == mode == (staging if fmt == "ell" else "f32")
    assert (op.num_chunks, st["transfers"], st["conversions"]) == (chunks, transfers, conversions)
    assert chunks >= 3 and st["transfers"] == chunks
    assert st["max_resident"] <= stage_depth + 1 and resident <= 2
    if fmt == "ell" and staging != "f32":
        assert st["compression_ratio"] > 1.5
    else:
        assert st["compression_ratio"] == pytest.approx(1.0)


@pytest.mark.parametrize("mode,rtol", [("f32", 1e-6), ("bf16", 8e-3), ("fp8", 8e-2)])
def test_staging_modes_accuracy(mode, rtol):
    """As the reference's test of the same name: the streamed product
    against scipy in f64."""
    op = _port_op("ell", mode)
    x = np.ones(op.n)
    y = op.matvec(torch.ones(op.n), accum_dtype=torch.float64).numpy()
    want = _web().to_scipy() @ x
    np.testing.assert_allclose(y, want, rtol=rtol, atol=rtol * np.abs(want).max())
    assert op.staging_stats()["max_resident"] <= 2


def test_matvec_resume_bit_identical():
    op = _port_op("ell", "fp8")
    x = torch.from_numpy(_x(op.n))
    partials = {}
    ref = op.matvec(x, accum_dtype=torch.float64,
                    on_chunk=lambda c, y: partials.__setitem__(c, y))
    assert sorted(partials) == list(range(op.num_chunks))
    resumed = op.matvec(x, accum_dtype=torch.float64, start_chunk=2, partial_y=partials[1])
    assert torch.equal(ref, resumed)
    op.set_resume(1, partials[0])
    assert torch.equal(ref, op.matvec(x, accum_dtype=torch.float64))
    assert op._resume is None  # armed once, consumed once
    assert torch.equal(ref, op.matvec(x, accum_dtype=torch.float64))
    seen = []
    op.set_step_hook(lambda c, y: seen.append(c))
    op.matvec(x, accum_dtype=torch.float64)
    assert seen == list(range(op.num_chunks))
    assert op.staging_stats()["max_resident"] <= 2


def test_coo_resume_bit_identical():
    op = _port_op("coo", stage_depth=0)
    x = torch.from_numpy(_x(op.n))
    partials = {}
    ref = op.matvec(x, accum_dtype=torch.float64,
                    on_chunk=lambda c, y: partials.__setitem__(c, y))
    resumed = op.matvec(x, accum_dtype=torch.float64, start_chunk=3, partial_y=partials[2])
    assert torch.equal(ref, resumed)
    assert op.staging_stats()["max_resident"] <= 1


def test_own_data_pins_then_frees_source():
    csr = _port_csr(_web())
    lazy = _port_op("ell", "bf16", csr=csr)
    op = _port_op("ell", "bf16", csr=csr, own_data=True)
    assert op._csr is None and op._row_nnz is None
    assert op._pinned is not None and len(op._pinned) == op.num_chunks
    assert op.staging["conversions"] == op.num_chunks  # the pin is the conversion
    x = torch.from_numpy(_x(op.n))
    want = lazy.matvec(x, accum_dtype=torch.float64)
    assert torch.equal(op.matvec(x, accum_dtype=torch.float64), want)
    assert torch.equal(op.matvec(x, accum_dtype=torch.float64), want)
    assert op.staging["conversions"] == op.num_chunks
    assert op.staging_stats()["max_resident"] <= 2


def test_conversions_tick_once_per_chunk_lifetime():
    op = _port_op("ell")
    x = torch.from_numpy(_x(op.n))
    op.matvec(x, accum_dtype=torch.float64)
    assert op.staging["conversions"] == op.num_chunks
    op.matvec(x, accum_dtype=torch.float64)
    assert op.staging["conversions"] == op.num_chunks
    assert op.staging["transfers"] == 2 * op.num_chunks
    assert op.staging_stats()["max_resident"] <= 2


def test_staging_auto_follows_storage_dtype_and_demotes_on_coo():
    csr = _port_csr(_web())
    eng = make_engine(csr, "ell", device="cpu")
    kw = dict(chunk_nnz=CHUNK_NNZ, engine=eng, staging="auto", device="cpu")
    assert ChunkedOperator(csr, **kw).staging_mode == "f32"
    assert ChunkedOperator(csr, dtype=torch.bfloat16, **kw).staging_mode == "bf16"
    assert ChunkedOperator(csr, dtype=torch.float16, **kw).staging_mode == "bf16"
    coo = ChunkedOperator(csr, chunk_nnz=CHUNK_NNZ, staging="bf16", device="cpu")
    assert coo.spmv_format == "coo" and coo.staging_mode == "f32"
    with pytest.raises(ValueError, match="staging mode"):
        ChunkedOperator(csr, staging="int4", device="cpu")
    with pytest.raises(ValueError, match="COO or ELL"):
        ChunkedOperator(csr, engine=make_engine(csr, "hybrid", device="cpu"), device="cpu")


# ------------------------------------------------------------------ eigsh


@functools.lru_cache(maxsize=None)
def _reference_eigsh(policy: str, staging: str):
    r = repro.eigsh(_web(), K, v0=_v0(), policy=policy, num_iters=ITERS, backend="chunked",
                    format="ell", chunk_nnz=CHUNK_NNZ, staging=staging)
    return np.asarray(r.eigenvalues, np.float64), np.asarray(r.residuals), r.partition


def _v0() -> np.ndarray:
    return np.random.default_rng(1).standard_normal(_web().n)


@functools.lru_cache(maxsize=None)
def _disk_paths(root: str):
    """The web graph saved by each package, as diskcsr directories."""
    port = save_diskcsr(f"{root}/port", _port_csr(_web()))
    ref = jax_save(f"{root}/ref", _web())
    return port, ref


@pytest.fixture(scope="module")
def disk_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("chunked"))


@pytest.mark.parametrize("source", ["csr", "diskcsr", "path", "reference_path"])
@pytest.mark.parametrize("policy,staging", [
    ("FFF", "f32"), ("FDF", "f32"), ("BFF", "f32"), ("FDF", "bf16"), ("FFF", "fp8"),
    ("BFF", "auto"),
])
def test_eigsh_chunked_matches_reference(policy, staging, source, disk_root):
    ev_ref, res_ref, part_ref = _reference_eigsh(policy, staging)
    port_path, ref_path = _disk_paths(disk_root)
    A = {"csr": _port_csr(_web()), "diskcsr": open_diskcsr(port_path), "path": port_path,
         "reference_path": ref_path}[source]
    got = repro_torch.eigsh(A, K, v0=_v0(), policy=policy, num_iters=ITERS, backend="chunked",
                            format="ell", chunk_nnz=CHUNK_NNZ, staging=staging, device="cpu")
    assert got.backend == "chunked" and got.spmv_format == "ell" and got.policy == policy
    scale = np.abs(ev_ref).max()
    np.testing.assert_allclose(got.eigenvalues.double().numpy(), ev_ref, rtol=0,
                               atol=EIG_TOL[policy] * scale)
    np.testing.assert_allclose(got.residuals, res_ref, rtol=0, atol=EIG_TOL[policy] * scale)
    part = got.partition
    assert sorted(part) == sorted(part_ref)
    assert sorted(part["spmv"]["staging"]) == sorted(part_ref["spmv"]["staging"])
    assert part["disk_backed"] == (source != "csr")
    for key in ("num_chunks", "stage_depth"):
        assert part[key] == part_ref[key]
    st, st_ref = part["spmv"]["staging"], part_ref["spmv"]["staging"]
    for key in ("mode", "transfers", "conversions"):
        assert st[key] == st_ref[key]
    assert st["transfers"] == part["num_chunks"] * ITERS
    assert st["max_resident"] <= part["stage_depth"] + 1


def test_session_on_a_mapping_never_materializes(disk_root, monkeypatch):
    port_path, _ = _disk_paths(disk_root)
    disk = open_diskcsr(port_path)

    def refuse(*_a, **_k):
        raise AssertionError("the chunked session materialized the mapping")

    monkeypatch.setattr(type(disk), "to_csr", refuse)
    sess = repro_torch.prepare(disk, backend="chunked", chunk_nnz=CHUNK_NNZ, num_iters=ITERS,
                               device="cpu")
    r1, r2 = sess.eigsh(K, v0=_v0()), sess.eigsh(K, v0=_v0())
    assert sess.csr is disk and r2.session_reuse
    assert torch.equal(r1.eigenvalues, r2.eigenvalues)
    # Per-call staging costs, not the operator's running totals.
    assert r1.partition["staging"]["transfers"] == r2.partition["staging"]["transfers"]
    assert r2.partition["staging"]["max_resident"] <= 2


def test_staging_env_pin_overrides_config(monkeypatch):
    kw = dict(policy="FFF", num_iters=ITERS, backend="chunked", format="ell",
              chunk_nnz=CHUNK_NNZ, device="cpu")
    monkeypatch.setenv("REPRO_CHUNK_STAGING", "bf16")
    sess = repro_torch.prepare(_port_csr(_web()), **kw)
    assert sess.eigsh(K).partition["spmv"]["staging"]["mode"] == "bf16"
    monkeypatch.delenv("REPRO_CHUNK_STAGING")
    unpinned = sess.eigsh(K)  # the pin is part of the plan: a new one is built
    assert unpinned.partition["spmv"]["staging"]["mode"] == "f32"
    assert not unpinned.session_reuse


# ---------------------------------------------------------------- dispatch


def test_dispatch_picks_chunked_over_the_nnz_threshold(monkeypatch):
    web = _web()
    for mod in (dispatch, jax_dispatch):
        monkeypatch.setattr(mod, "CHUNKED_NNZ_THRESHOLD", web.nnz)
        assert mod.select_backend("auto", has_matrix=True, nnz=web.nnz) == "chunked"
        assert mod.select_backend("auto", has_matrix=True, nnz=web.nnz - 1) == "single"
    got = repro_torch.eigsh(_port_csr(web), K, v0=_v0(), num_iters=ITERS, device="cpu")
    want = repro.eigsh(web, K, v0=_v0(), num_iters=ITERS)
    assert got.backend == want.backend == "chunked"
    assert got.partition["num_chunks"] == want.partition["num_chunks"] == 1  # 1 << 20 nnz a chunk


def test_dispatch_disk_pressure_picks_chunked(monkeypatch, disk_root):
    big = 1 << 30
    for mod in (dispatch, jax_dispatch):
        assert mod.select_backend("auto", has_matrix=True, nnz=1000, disk_bytes=big,
                                  free_bytes=big) == "chunked"
        assert mod.select_backend("auto", has_matrix=True, nnz=1000, tol=1e-8, disk_bytes=big,
                                  free_bytes=big) == "chunked"
        assert mod.select_backend("auto", has_matrix=True, nnz=1000, disk_bytes=1 << 10,
                                  free_bytes=big) == "single"
        monkeypatch.setattr(mod, "host_available_bytes", lambda: 1 << 10)
    port_path, ref_path = _disk_paths(disk_root)
    got = repro_torch.eigsh(port_path, K, v0=_v0(), num_iters=ITERS, device="cpu")
    want = repro.eigsh(ref_path, K, v0=_v0(), num_iters=ITERS)
    assert got.backend == want.backend == "chunked"
    assert got.partition["disk_backed"] and want.partition["disk_backed"]


# -------------------------------------------------- the documented divergence


def test_auto_format_charges_the_ports_padding():
    """A road network (max row 6-7) pads to 8 slots a row here and to 128
    lanes in the reference: the port's chunked "auto" picks ELL where the
    reference picks COO.  Rows of ~120-230 nnz pad alike in both (to 232 vs
    256 slots): both pick ELL."""
    kw = dict(num_iters=8, backend="chunked", chunk_nnz=4096)
    road = generate("road", 4096, 2.1, seed=0, values="normalized")
    got = repro_torch.eigsh(_port_csr(road), K, device="cpu", **kw)
    want = repro.eigsh(road, K, **kw)
    assert (got.spmv_format, want.spmv_format) == ("ell", "coo")
    dense_rows = generate("urand", 512, 120.0, seed=1, values="normalized")
    got = repro_torch.eigsh(_port_csr(dense_rows), K, device="cpu", **kw)
    want = repro.eigsh(dense_rows, K, **kw)
    assert got.spmv_format == want.spmv_format == "ell"
    web = _web()
    got = repro_torch.eigsh(_port_csr(web), K, device="cpu", **dict(kw, chunk_nnz=CHUNK_NNZ))
    want = repro.eigsh(web, K, **dict(kw, chunk_nnz=CHUNK_NNZ))
    assert got.spmv_format == want.spmv_format == "coo"  # the hub row breaks both bounds
