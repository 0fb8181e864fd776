"""The distributed backend of the port against the reference's, on the CPU.

The port runs SPMD over ``torch.distributed``: one module-scoped fixture
spawns G = 2 and G = 4 gloo ranks once each (``repro_torch.launch.ranks``,
a file init under ``tmp_path``, every wait bounded by ``RANK_TIMEOUT``) and
runs every scenario of ``tests/torch_dist_ranks.py`` in them, while a
subprocess runs the reference on 8 forced host devices (the way
``tests/test_distributed.py`` does).  G = 1 runs in-process, with no
process group, against the reference's ``solve_sharded`` on one device.

Tolerances, each stated where it is used:

* layouts and splits: byte-equal (they carry no floating-point work);
* FDF Ritz values (the eigenvalues of the f64 tridiagonal) against the
  reference or across G: rel 1e-9 of |lambda|max (only the order of the
  sums differs); the f32 output eigenvalues: rel 2.5e-7 (one f32 rounding
  of values that may differ in the last f64 bits); residual bounds: 1e-9
  of |lambda|max;
* across the ranks of one run: identical bits;
* the sharded chunk matvec against the unsharded one: identical bits under
  the same staging, and within the reference tests' bounds across staging
  modes (f32 1e-6, bf16 8e-3 of max |y|).
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro
import repro_torch
import torch_dist_ranks as R
from repro.core.distributed import prepare_sharded as ref_prepare_sharded
from repro.core.distributed import solve_sharded as ref_solve_sharded
from repro.core.partition import nnz_balanced_splits as ref_splits
from repro.core.partition import partition_matrix as ref_partition
from repro.core.precision import FDF as REF_FDF
from repro.kernels.engine import shard_stats as ref_shard_stats
from repro.sparse import CSR as RefCSR
from repro.sparse import generate
from repro.sparse import formats as ref_formats
from repro.testing import faults as ref_faults
from repro_torch.core.distributed import DISTRIBUTED_FORMATS, ShardComm, prepare_sharded
from repro_torch.core.partition import nnz_balanced_splits, partition_matrix
from repro_torch.core.precision import FDF
from repro_torch.kernels.engine import shard_stats
from repro_torch.launch.ranks import run_ranks
from repro_torch.sparse import CSR
from repro_torch.sparse import formats

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
RANK_TIMEOUT = 240.0
RITZ_RTOL = 1e-9
OUT_RTOL = 2.5e-7
NAMES = ("road", "web", "block")

pytestmark = pytest.mark.filterwarnings("ignore:SpMV auto-selection is restricted")


def _block_csr() -> RefCSR:
    """kron(a random symmetric circulant tridiagonal, a dense symmetric
    8 x 8): every row holds 24 entries, so the nnz-balanced cuts fall on
    whole 8-row blocks and the shards stay block-dense (BSR)."""
    n = 256
    rng = np.random.default_rng(11)
    a, b = rng.standard_normal(n), rng.standard_normal(n)
    t = sp.diags([a], [0], shape=(n, n)) + sp.diags([b[:-1], b[:-1]], [1, -1], shape=(n, n))
    t = t.tolil()
    t[0, n - 1] = t[n - 1, 0] = b[-1]
    d = rng.standard_normal((8, 8))
    m = sp.kron(t.tocsr(), sp.csr_matrix((d + d.T) / 2)).tocsr()
    m.sort_indices()
    return RefCSR(indptr=m.indptr.astype(np.int64), indices=m.indices.astype(np.int32),
                  data=m.data.astype(np.float64), shape=m.shape)


def _ref_mats() -> dict:
    return {"road": generate("road", 2048, 2.1, seed=3),
            "web": generate("web", 2048, 6.0, seed=3),
            "block": _block_csr()}


def _port(c) -> CSR:
    return CSR(indptr=np.asarray(c.indptr), indices=np.asarray(c.indices),
               data=np.asarray(c.data), shape=tuple(c.shape))


REF_MATS = _ref_mats()
MATS = {k: _port(v) for k, v in REF_MATS.items()}
FAULT_WEB = generate("web", 384, 6.0, seed=7, values="normalized")  # tests/test_faults.py's
CHUNK_WEB = generate("web", 384, 6.0, seed=7, values="normalized")  # tests/test_oocore.py's

_REF_SCRIPT = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
from jax.sharding import Mesh
from repro.core.distributed import solve_sharded
from repro.core.precision import FDF
from repro.sparse import CSR

data = np.load(sys.argv[1])
devs = np.array(jax.devices())
out = {"num_devices": len(devs)}
for name in %(names)r:
    c = CSR(indptr=data[name + "_indptr"], indices=data[name + "_indices"],
            data=data[name + "_data"], shape=(len(data[name + "_indptr"]) - 1,) * 2)
    for g in %(worlds)r:
        r = solve_sharded(c, %(k)d, Mesh(devs[:g], ("data",)), policy=FDF, reorth="full",
                          num_iters=%(iters)d, seed=%(seed)d)
        out[f"{name}_g{g}"] = {
            "alpha": np.asarray(r.tridiag.alpha, np.float64).tolist(),
            "beta": np.asarray(r.tridiag.beta, np.float64).tolist(),
            "eigenvalues": np.asarray(r.eigenvalues, np.float64).tolist(),
            "residuals": np.asarray(r.residuals).tolist(),
            "spmv_format": list(r.spmv_format),
            "splits": r.partition["splits"],
        }
print("JSON:" + json.dumps(out))
""" % {"names": NAMES, "worlds": WORLDS, "k": R.K, "iters": R.ITERS, "seed": R.SEED}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"ref": the reference's 8-device run, G: [rank results]}``: the
    reference subprocess runs while the port's ranks do."""
    tmp = tmp_path_factory.mktemp("dist")
    npz = tmp / "mats.npz"
    np.savez(npz, **{f"{k}_{f}": getattr(c, f) for k, c in REF_MATS.items()
                     for f in ("indptr", "indices", "data")})
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, str(npz)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        out = {g: run_ranks(R.everything, g, args=(MATS, _port(FAULT_WEB), _port(CHUNK_WEB)),
                            backend="gloo", device="cpu", timeout=RANK_TIMEOUT,
                            tmp_dir=str(tmp)) for g in WORLDS}
        stdout, stderr = proc.communicate(timeout=RANK_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"reference run failed:\n{stderr[-4000:]}"
    line = [ln for ln in stdout.splitlines() if ln.startswith("JSON:")][-1]
    out["ref"] = json.loads(line[len("JSON:"):])
    return out


@pytest.fixture(autouse=True)
def _fresh_caches():
    repro_torch.session_cache_clear()
    repro.api.session_cache_clear()
    yield
    repro_torch.session_cache_clear()
    repro.api.session_cache_clear()


def _ritz(alpha, beta, k=R.K) -> np.ndarray:
    """The k Ritz values of largest |lambda| of a tridiagonal, in f64."""
    a = np.asarray(alpha, np.float64).reshape(-1)
    b = np.asarray(beta, np.float64).reshape(-1)
    ev = np.linalg.eigvalsh(np.diag(a) + np.diag(b, 1) + np.diag(b, -1))
    return ev[np.argsort(-np.abs(ev))][:k]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _as_np(t) -> np.ndarray:
    return t.double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)


# Per-rank by design: host timings and staging counters (a rank stages only
# its share of each chunk).
_PER_RANK = ("partition", "bytes_staged")


def _same_bits(a, b, path=""):
    """Assert two nested results are identical, tensors bit for bit (keys in
    ``_PER_RANK`` aside)."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), f"{path} differs"
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for key in a:
            if key in _PER_RANK:
                continue
            _same_bits(a[key], b[key], f"{path}/{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_bits(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


# --------------------------------------------------------- layouts, in-process


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", NAMES)
def test_splits_and_col_map_byte_equal(name, g):
    c = REF_MATS[name]
    want = ref_splits(np.asarray(c.indptr), g)
    got = nnz_balanced_splits(MATS[name].indptr, g)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    n_pad = int((got[1:] - got[:-1]).max())
    want_map = ref_formats.padded_col_map(want, n_pad, c.n)
    got_map = formats.padded_col_map(got, n_pad, c.n)
    assert got_map.dtype == want_map.dtype
    np.testing.assert_array_equal(got_map, want_map)


@pytest.mark.parametrize("g", [1, 3, 4])
@pytest.mark.parametrize("name", NAMES)
def test_shard_layouts_match_reference(name, g):
    """With the reference's padding multiples passed to both, the port's
    converters build the reference's arrays, element for element."""
    c, pc = REF_MATS[name], MATS[name]
    splits = nnz_balanced_splits(pc.indptr, g)
    n_pad = -(-int((splits[1:] - splits[:-1]).max()) // 8) * 8
    import jax.numpy as jnp

    rv, rc, rs = ref_formats.shard_to_ell(c, splits, n_pad, dtype=jnp.float64, row_tile=8,
                                          slot_tile=8)
    pv, pc_, ps = formats.shard_to_ell(pc, splits, n_pad, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pc_.numpy(), np.asarray(rc))
    assert ps == rs
    # One shard only (what an SPMD rank converts) is that shard's slice.
    one, _, _ = formats.shard_to_ell(pc, splits, n_pad, dtype=torch.float64, shards=(g - 1,), device="cpu")
    assert torch.equal(one[0], pv[g - 1])

    rb, rbc, rbs = ref_formats.shard_to_blocked_ell(c, splits, n_pad, block_size=8,
                                                    dtype=jnp.float64)
    pb, pbc, pbs = formats.shard_to_blocked_ell(pc, splits, n_pad, block_size=8,
                                                dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(pb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(pbc.numpy(), np.asarray(rbc))
    assert pbs == rbs

    rh, rhs = ref_formats.shard_to_hybrid(c, splits, n_pad, dtype=jnp.float64, row_tile=8)
    ph, phs = formats.shard_to_hybrid(pc, splits, n_pad, dtype=torch.float64, device="cpu")
    for got, want in zip(ph, rh):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert phs == rhs


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_partition_and_stats_match_reference(name, g):
    c, pc = REF_MATS[name], MATS[name]
    import jax.numpy as jnp

    rpm = ref_partition(c, g, dtype=jnp.float64, row_align=8)
    pm = partition_matrix(pc, g, dtype=torch.float64, row_align=8, device="cpu")
    assert (pm.n_pad, pm.num_shards, pm.n) == (rpm.n_pad, rpm.num_shards, rpm.n)
    for i in range(g):
        k = pm.nnz[i]
        np.testing.assert_array_equal(pm.row[i, :k].numpy(), np.asarray(rpm.row)[i, :k])
        np.testing.assert_array_equal(pm.col[i, :k].numpy(), np.asarray(rpm.col)[i, :k])
        np.testing.assert_array_equal(pm.val[i, :k].numpy(), np.asarray(rpm.val)[i, :k])
        assert not np.asarray(rpm.val)[i, k:].any()
    x = torch.arange(c.n, dtype=torch.float64)
    assert torch.equal(pm.unpad_vector(pm.pad_vector(x)), x)
    np.testing.assert_array_equal(pm.pad_vector(x).numpy(),
                                  np.asarray(rpm.pad_vector(np.arange(c.n, dtype=np.float64))))
    splits = nnz_balanced_splits(pc.indptr, g)
    got = [dataclasses.asdict(st) for st in shard_stats(pc, splits)]
    assert got == [dataclasses.asdict(st) for st in ref_shard_stats(c, splits)]


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_format_auto_matches_reference(name, g):
    want = ref_prepare_sharded(REF_MATS[name], g, REF_FDF, "auto").engine.format
    got = prepare_sharded(MATS[name], g, FDF, "auto", device="cpu")
    assert got.engine.format == want
    assert got.pm.shards == tuple(range(g)) and len(got.mats) == g


def test_bsr_operand_check_takes_a_gathered_vector():
    """A BSR row shard multiplies the all-gathered vector, longer than its
    rows: the kernel wrapper's check takes it when told the column count,
    and refuses any other length, a shorter one above all (the kernel would
    read past its end)."""
    from repro_torch.kernels.spmv_bsr import check_bsr_operands

    val = torch.zeros((4, 2, 8, 8))
    bcol = torch.zeros((4, 2), dtype=torch.int32)
    check_bsr_operands(val, bcol, torch.zeros(4 * 8 * 3), n_cols=4 * 8 * 3)
    check_bsr_operands(val, bcol, torch.zeros(4 * 8))  # square: nbr * BS
    for bad in (4 * 8 * 3 + 1, 4 * 8 * 3 - 8, 4 * 8):
        with pytest.raises(ValueError, match="whole 8-blocks"):
            check_bsr_operands(val, bcol, torch.zeros(bad), n_cols=4 * 8 * 3)
    with pytest.raises(ValueError, match="whole 8-blocks"):
        check_bsr_operands(val, bcol, torch.zeros(4 * 8 * 3))  # no n_cols: square
    with pytest.raises(ValueError, match="whole 8-blocks"):
        check_bsr_operands(val, bcol, torch.zeros(4 * 8, dtype=torch.float64))


def test_bsr_shard_spmv_refuses_a_local_vector():
    """``SpmvEngine.spmv`` on a BSR row shard checks ``x`` against the
    shard's ``n_cols`` (the gathered length) on the CPU too: the shard-local
    ``n_pad`` vector raises, the gathered one gives the plain product."""
    from repro_torch.core.distributed import prepare_sharded
    from repro_torch.kernels import ref

    prep = prepare_sharded(MATS["block"], 2, FDF, "bsr", shards=(1,), device="cpu")
    mat, eng = prep.mats[0], prep.engine
    assert mat.n_cols == 2 * prep.pm.n_pad
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(mat.n_cols)).float()
    got = eng.spmv(mat, x, accum_dtype=torch.float64)
    want = ref.spmv_bsr_ref(mat.val, mat.bcol, x, torch.float64)[: mat.n_rows]
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="whole 8-blocks"):
        eng.spmv(mat, x[: prep.pm.n_pad], accum_dtype=torch.float64)


# ------------------------------------------------------------- G = 1, in-process


@pytest.mark.parametrize("name", NAMES)
def test_world_of_one_matches_reference(name):
    """No process group: a world of one, against the reference's
    ``solve_sharded`` on one device (``tests/test_engine.py``'s call)."""
    from jax.sharding import Mesh
    import jax

    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    ref = ref_solve_sharded(REF_MATS[name], R.K, mesh, policy=REF_FDF, reorth="full",
                            num_iters=R.ITERS, seed=R.SEED)
    ShardComm.reset_calls()
    res = repro_torch.eigsh(MATS[name], R.K, backend="distributed", num_iters=R.ITERS,
                            seed=R.SEED, device="cpu")
    assert res.backend == "distributed" and res.num_devices == 1
    assert res.spmv_format == tuple(ref.spmv_format)
    lam = np.abs(np.asarray(ref.eigenvalues_f64)).max()
    assert _rel(_ritz(res.tridiag.alpha, res.tridiag.beta),
                _ritz(ref.tridiag.alpha, ref.tridiag.beta)) <= RITZ_RTOL
    assert _rel(_as_np(res.eigenvalues), np.asarray(ref.eigenvalues)) <= OUT_RTOL
    assert np.abs(res.residuals - ref.residuals).max() <= RITZ_RTOL * lam
    # Eigenvectors up to sign, in the output dtype.
    x, xr = _as_np(res.eigenvectors), np.asarray(ref.eigenvectors, np.float64)
    sign = np.sign(np.sum(x * xr, axis=0))
    assert np.abs(x * sign - xr).max() <= 1e-5
    assert res.partition["splits"] == ref.partition["splits"]
    assert set(ref.partition) == set(res.partition)
    assert ShardComm.calls["all_gather"] == R.ITERS


def test_distributed_backend_runs_at_world_of_one():
    """``backend="distributed"`` runs on the CPU with no process group and
    reports itself (the reference's partition keys, a per-shard format)."""
    csr = repro_torch.sparse.generate("road", 256, 2.1, seed=0)
    res = repro_torch.eigsh(csr, k=4, backend="distributed", device="cpu")
    ref = repro.eigsh(generate("road", 256, 2.1, seed=0), k=4, backend="distributed")
    assert res.backend == "distributed" == ref.backend
    assert res.partition.keys() == ref.partition.keys()
    assert res.partition["num_shards"] == 1 and res.spmv_format == ("ell",)
    assert torch.isfinite(res.eigenvalues).all() and res.eigenvectors.shape == (csr.n, 4)
    assert repro_torch.eigsh(csr, k=4, device="cpu").backend == "single"  # world of one


def test_topk_eigs_sharded_is_a_deprecated_shim():
    from repro_torch.core.distributed import topk_eigs_sharded

    with pytest.warns(DeprecationWarning, match="topk_eigs_sharded is deprecated"):
        old = topk_eigs_sharded(MATS["road"], R.K, num_iters=R.ITERS, seed=R.SEED, device="cpu")
    res = repro_torch.eigsh(MATS["road"], R.K, backend="distributed", num_iters=R.ITERS,
                            seed=R.SEED, device="cpu")
    assert torch.equal(old.eigenvalues, res.eigenvalues)
    assert torch.equal(old.eigenvectors, res.eigenvectors)


def test_distributed_session_reuses_its_shards():
    csr = MATS["road"]
    sess = repro_torch.prepare(csr, backend="distributed", device="cpu")
    r1 = sess.eigsh(R.K, num_iters=R.ITERS)
    r2 = sess.eigsh(R.K, num_iters=R.ITERS)
    assert r2.session_reuse and r2.partition["spmv"]["conversions"] == 0
    assert torch.equal(r1.eigenvalues, r2.eigenvalues)
    many = sess.eigsh_many([{"k": 2, "num_iters": R.ITERS}, {"k": 4, "num_iters": R.ITERS}])
    assert torch.equal(many[1].eigenvalues, r1.eigenvalues)
    assert torch.equal(many[0].eigenvalues, r1.eigenvalues[:2])
    assert sess.export_state()["plans"] == []  # a shard plan is bound to its group


# ------------------------------------------------------------------ faults, G = 1

_FAULT_CASES = {
    "spmv_nan": ("spmv_nan@iter=3", "raise"),
    "beta_collapse": ("beta_collapse@iter=2", "raise"),
    "auto_nan": ("spmv_nan@iter=3", "auto"),
    "auto_beta": ("beta_collapse@iter=2", "auto"),
}


def _ref_fault(case: str) -> dict:
    spec, recovery = _FAULT_CASES[case]
    try:
        with ref_faults.inject(spec):
            res = repro.eigsh(FAULT_WEB, R.K, backend="distributed", policy="FFF",
                              num_iters=R.FAULT_ITERS, recovery=recovery)
    except repro.api.NumericalBreakdown as exc:
        return {"kind": exc.kind, "iteration": exc.iteration, "policy": exc.policy}
    return {"trail": res.recovery_trail, "eigenvalues": np.asarray(res.eigenvalues)}


def _check_fault(got: dict, want: dict) -> None:
    if "kind" in want:
        assert (got["kind"], got["iteration"], got["policy"]) == (
            want["kind"], want["iteration"], want["policy"])
        return
    steps = [(t["action"], t.get("from"), t.get("to"), t.get("kind")) for t in got["trail"]]
    ref_steps = [(t["action"], t.get("from"), t.get("to"), t.get("kind")) for t in want["trail"]]
    assert steps == ref_steps
    assert torch.isfinite(got["eigenvalues"]).all()


@functools.lru_cache(maxsize=None)
def _port_faults_world_of_one() -> dict:
    return R.fault_runs(0, 1, _port(FAULT_WEB))


@pytest.mark.parametrize("case", list(_FAULT_CASES))
def test_faults_world_of_one_match_reference(case):
    _check_fault(_port_faults_world_of_one()[case], _ref_fault(case))


# ----------------------------------------------------------- G = 2, 4: spawned


@pytest.mark.parametrize("g", WORLDS)
def test_ranks_return_identical_bits(runs, g):
    ranks = runs[g]
    assert len(ranks) == g
    for r in range(1, g):
        _same_bits(ranks[r], ranks[0], f"rank{r}")


@pytest.mark.parametrize("g", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_matches_reference(runs, g, name):
    got = runs[g][0]["solves"][name]
    want = runs["ref"][f"{name}_g{g}"]
    assert runs["ref"]["num_devices"] == 8
    assert got["backend"] == "distributed" and got["num_devices"] == g
    assert list(got["spmv_format"]) == want["spmv_format"]
    assert got["partition"]["splits"] == want["splits"]
    lam = np.abs(want["eigenvalues"]).max()
    assert _rel(_ritz(got["alpha"], got["beta"]), _ritz(want["alpha"], want["beta"])) <= RITZ_RTOL
    assert _rel(_as_np(got["eigenvalues"]), want["eigenvalues"]) <= OUT_RTOL
    assert np.abs(got["residuals"] - np.asarray(want["residuals"])).max() <= RITZ_RTOL * lam


@pytest.mark.parametrize("name", NAMES)
def test_shard_count_invariance(runs, name):
    """G = 1 (in-process), 2 and 4 agree to reduction-order tolerance."""
    one = repro_torch.eigsh(MATS[name], R.K, backend="distributed", num_iters=R.ITERS,
                            seed=R.SEED, device="cpu")
    base = _ritz(one.tridiag.alpha, one.tridiag.beta)
    for g in WORLDS:
        got = runs[g][0]["solves"][name]
        assert _rel(_ritz(got["alpha"], got["beta"]), base) <= RITZ_RTOL


@pytest.mark.parametrize("g", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_distributed_spmv_is_kernel_backed(runs, g, name):
    """Every shard runs a kernel format, and the kernel wrappers (routed as
    on the card, into counting plain versions) launched once a step."""
    got = runs[g][0]["solves"][name]
    fmt = got["spmv_format"][0]
    assert len(got["spmv_format"]) == g and fmt in DISTRIBUTED_FORMATS
    assert got["partition"]["spmv"]["format"] == fmt
    kernel = "spmv_bsr" if fmt == "bsr" else "spmv_ell"
    assert got["launches"][kernel] == R.ITERS


@pytest.mark.parametrize("reorth", R.REORTHS)
@pytest.mark.parametrize("mode", R.UPDATE_MODES)
@pytest.mark.parametrize("g", WORLDS)
def test_collective_budget(runs, g, mode, reorth):
    """Per step: one all-gather and two scalar reductions, plus one vector
    reduction per reorth pass; before the loop one reduction (the start
    vector's norm), after it one gather of X.  The kernels each mode
    launches, once a step."""
    m = 12
    got = runs[g][0]["solves"]["budget"][mode, reorth]
    passes = 0 if reorth == "none" else 1
    assert got["calls"] == {"all_gather": m, "reduce_scalar": 2 * m + 1,
                            "reduce_vector": passes * m, "gather_x": 1, "broadcast": 1}
    want = {"unfused": {"spmv_ell": m, "lanczos_update": 0, "spmv_ell_alpha": 0},
            "fused": {"spmv_ell": m, "lanczos_update": m, "spmv_ell_alpha": 0},
            "fused_spmv": {"spmv_ell": 0, "lanczos_update": m, "spmv_ell_alpha": m}}[mode]
    assert {k: got["launches"][k] for k in want} == want
    base = runs[g][0]["solves"]["budget"]["unfused", reorth]["eigenvalues"]
    assert _rel(_as_np(got["eigenvalues"]), _as_np(base)) <= OUT_RTOL


@pytest.mark.parametrize("g", WORLDS)
def test_auto_picks_distributed_and_mesh_matches_default_group(runs, g):
    solves = runs[g][0]["solves"]
    assert solves["auto_backend"] == "distributed"
    _same_bits(solves["road_mesh"]["eigenvalues"], solves["road"]["eigenvalues"])
    _same_bits(solves["road_mesh"]["eigenvectors"], solves["road"]["eigenvectors"])


@pytest.mark.parametrize("case", list(_FAULT_CASES))
@pytest.mark.parametrize("g", WORLDS)
def test_faults_on_every_rank(runs, g, case):
    """The reference's typed breakdowns and recovery trails, on every rank
    (the probe reads reduced scalars only)."""
    want = _ref_fault(case)
    for rank in runs[g]:
        _check_fault(rank["faults"][case], want)


@pytest.mark.parametrize("staging", ["f32", "bf16"])
@pytest.mark.parametrize("g", WORLDS)
def test_sharded_chunk_matvec(runs, g, staging):
    got = runs[g][0]["chunked"][staging]
    y, plain = got["sharded"], got["plain"]
    assert torch.equal(y, plain)  # same staging: the unsharded products, bit for bit
    f32 = runs[g][0]["chunked"]["f32"]["plain"]
    tol = {"f32": 1e-6, "bf16": 8e-3}[staging]
    assert float((y - f32).abs().max() / f32.abs().max()) <= tol
    kernel = "spmv_ell" if staging == "f32" else "spmv_ell_packed"
    assert got["launches"][kernel] == got["chunks"]
    assert got["calls"]["all_gather"] == 1  # one per matvec, not one per chunk
    staged = sum(rank["chunked"][staging]["bytes_staged"] for rank in runs[g])
    assert staged >= got["plain_bytes_staged"]  # every rank stages only its share
    assert got["bytes_staged"] < got["plain_bytes_staged"]


@pytest.mark.parametrize("g", WORLDS)
def test_sharded_chunked_eigsh_equals_unsharded(runs, g):
    got = runs[g][0]["chunked"]
    assert got["eigsh_sharded"]["backend"] == "chunked"
    assert got["eigsh_sharded"]["spmv_format"] == got["eigsh_plain"]["spmv_format"] == "ell"
    _same_bits(got["eigsh_sharded"]["eigenvalues"], got["eigsh_plain"]["eigenvalues"])
    _same_bits(got["eigsh_sharded"]["eigenvectors"], got["eigsh_plain"]["eigenvectors"])
