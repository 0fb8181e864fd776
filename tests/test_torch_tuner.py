"""The measured autotuner of the port (``kernels/engine.py``) against the
reference's: plan resolution, the persisted cache, provenance in the
session's results and the probe accounting of a tuned session.

The port's candidate space is its own (padding multiples of the Hopper
layouts, the device type in the key), so the tests compare what the two
tuners decide structurally: the sources, the probe counts, the modes and
block edges measured, the cache contract.  Timings on the CPU rank the
plain versions and decide nothing about the card.  Eigenvalues of tuned
solves are compared at rel 1e-5 of |lambda|max (FFF) and 1e-12 (FDF), with
the same explicit start vector in both packages.
"""

import json

import numpy as np
import pytest
import torch

import repro
import repro.kernels.engine as jeng
from repro.sparse import generate as jax_generate
import repro_torch
import repro_torch.kernels.engine as eng
from repro_torch.kernels.engine import (
    ITER_UPDATE_MODES,
    IterationPlan,
    TileConfig,
    grid_fingerprint,
    resolve_iteration_plan,
    table_update_mode,
    tuned_tiles,
)
from repro_torch.sparse import CSR

ITERS = 16
EIG_TOL = {"FDF": 1e-12, "FFF": 1e-5}


def _port_csr(c) -> CSR:
    return CSR(indptr=np.asarray(c.indptr), indices=np.asarray(c.indices),
               data=np.asarray(c.data), shape=c.shape)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Both packages' tuners and session caches fresh; no pins."""
    for name in ("REPRO_ITER_UPDATE", "REPRO_FUSED_LANCZOS", "REPRO_SPMV_TILES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(eng, "_TUNER", None)
    monkeypatch.setattr(jeng, "_TUNER", None)
    repro_torch.session_cache_clear()
    repro.api.session_cache_clear()
    yield
    repro_torch.session_cache_clear()
    repro.api.session_cache_clear()


@pytest.fixture
def tuning(monkeypatch, tmp_path):
    """Probes on, a small budget, a fresh cache file each (the tests that
    share one file say so)."""
    monkeypatch.setenv("REPRO_SPMV_TUNE", "1")
    monkeypatch.setenv("REPRO_SPMV_TUNE_BUDGET", "3")
    monkeypatch.setenv("REPRO_SPMV_TUNE_CACHE", str(tmp_path / "tune.json"))
    return tmp_path / "tune.json"


def _fresh(monkeypatch):
    monkeypatch.setattr(eng, "_TUNER", None)
    monkeypatch.setattr(jeng, "_TUNER", None)


def _use_cache(monkeypatch, path):
    monkeypatch.setenv("REPRO_SPMV_TUNE_CACHE", str(path))
    _fresh(monkeypatch)


def test_table_fallback_when_probes_disabled(monkeypatch):
    """Probes off: the static table decides in both packages, the CPU like
    the reference's interpret mode and the card like compiled Mosaic."""
    monkeypatch.setenv("REPRO_SPMV_TUNE", "0")
    port = {dev: resolve_iteration_plan(1024, 32, device=dev) for dev in ("cpu", "cuda")}
    ref = {interp: jeng.resolve_iteration_plan(1024, 32, interpret=interp)
           for interp in (True, False)}
    assert {p.source for p in port.values()} == {p.source for p in ref.values()} == {"table"}
    assert port["cpu"].update == ref[True].update == table_update_mode("cpu") == "unfused"
    assert port["cuda"].update == ref[False].update == table_update_mode("cuda") == "fused"
    assert tuned_tiles(1024, 32, device="cpu") == (TileConfig(), "table")
    assert eng.tuner_probe_count() == jeng.tuner_probe_count() == 0


@pytest.mark.parametrize("pin", ["iter_update", "tiles", "bad_iter_update"])
def test_env_pin_overrides_everything(tuning, monkeypatch, pin):
    """A pin wins over the tuner in both packages and never probes; a bad
    value raises the same error."""
    if pin == "tiles":
        monkeypatch.setenv("REPRO_SPMV_TILES", "16,16,4")
        tiles, src = tuned_tiles(512, 64, device="cpu")
        jtiles, jsrc = jeng.tuned_tiles(512, 64, interpret=True)
        assert src == jsrc == "override"
        assert tiles == TileConfig(block_r=16, block_w=16, block_size=4)
        assert (jtiles.block_r, jtiles.block_w, jtiles.block_size) == (16, 16, 4)
        assert eng.tuner_probe_count() == jeng.tuner_probe_count() == 0
        # The update mode is still measured, on the pinned layout only.
        csr = _port_csr(jax_generate("road", 512, 3.0, seed=2, values="normalized"))
        e = eng.make_engine(csr, "ell", device="cpu")
        assert e.tiles == tiles and e.tiles_from == "override"
        assert e.iteration_plan.source == "tuned" and e.iteration_plan.tiles == tiles
        assert eng.tuner_probe_count() == 1
        return
    elif pin == "iter_update":
        monkeypatch.setenv("REPRO_ITER_UPDATE", "fused_spmv")
        plan = resolve_iteration_plan(512, 64, device="cpu")
        jplan = jeng.resolve_iteration_plan(512, 64, interpret=True)
        assert plan.update == jplan.update == "fused_spmv"
        assert plan.source == jplan.source == "override"
    else:
        monkeypatch.setenv("REPRO_ITER_UPDATE", "sideways")
        with pytest.raises(ValueError, match="REPRO_ITER_UPDATE"):
            resolve_iteration_plan(512, 64, device="cpu")
        with pytest.raises(ValueError, match="REPRO_ITER_UPDATE"):
            jeng.resolve_iteration_plan(512, 64, interpret=True)
    assert eng.tuner_probe_count() == jeng.tuner_probe_count() == 0


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_measured_plan_roundtrips_through_cache(tuning, monkeypatch, tmp_path, fmt):
    """One probe pass measures the reference's candidate rules (every mode
    for ELL, fused_spmv only there; the three BSR block edges), persists an
    ``iter|`` entry stamped with the grid, and a fresh tuner serves the same
    plan without probing: in both packages."""
    plan = resolve_iteration_plan(512, 64, format=fmt, device="cpu")
    probes = eng.tuner_probe_count()
    _use_cache(monkeypatch, tmp_path / "ref.json")
    jplan = jeng.resolve_iteration_plan(512, 64, format=fmt, tiles=jeng.TileConfig(),
                                        interpret=True)
    assert plan.source == jplan.source == "tuned"
    assert probes == jeng.tuner_probe_count() == 1

    def measured(path):
        recs = json.loads(path.read_text())["entries"]
        (rec,) = [r for k, r in recs.items() if k.startswith("iter|")]
        return rec, {name.split("|")[0] if fmt == "ell" else name.split("|")[1]
                     for name in rec["candidates_us"]}

    rec, names = measured(tuning)
    jrec, jnames = measured(tmp_path / "ref.json")
    assert names == jnames == (set(ITER_UPDATE_MODES) if fmt == "ell" else {"bs4", "bs8", "bs16"})
    assert rec["kind"] == jrec["kind"] == "iteration"
    assert rec["update"] == plan.update and rec["grid"] == grid_fingerprint()
    assert rec["package"] == "repro_torch"
    if fmt == "bsr":
        assert plan.update in ("unfused", "fused")
        assert plan.tiles.block_size in eng._ITER_BSR_BLOCKS
    _use_cache(monkeypatch, tuning)
    again = resolve_iteration_plan(512, 64, format=fmt, device="cpu")
    assert again == plan and again.tiles.block_size == plan.tiles.block_size
    assert eng.get_tuner().measure_count == 0


def _seed_cache(cache, key, update="fused", grid=None):
    rec = {"kind": "iteration", "update": update, "block_r": 16, "block_w": 16,
           "block_size": 8, "grid": grid if grid is not None else grid_fingerprint(),
           "package": "repro_torch", "best_us": 1.0, "candidates_us": {"seeded": 1.0}}
    cache.write_text(json.dumps({"version": 2, "entries": {key: rec}}))


def test_frozen_cache_is_deterministic(tuning, monkeypatch):
    """A seeded entry is served as it is, again and again, with no probe."""
    key = "iter|" + eng._tune_key("ell", torch.float32, 512, 64, "cpu", torch.float32)
    _seed_cache(tuning, key, update="fused")
    want = IterationPlan(update="fused", tiles=TileConfig(block_r=16, block_w=16),
                         source="tuned")
    for _ in range(3):
        _fresh(monkeypatch)
        assert resolve_iteration_plan(512, 64, format="ell", device="cpu") == want
        assert eng.get_tuner().measure_count == 0


def test_stale_grid_fingerprint_invalidates(tuning, monkeypatch):
    """An entry of the port stamped by another candidate space re-measures
    and is re-stamped, never served."""
    key = "iter|" + eng._tune_key("ell", torch.float32, 512, 64, "cpu", torch.float32)
    _seed_cache(tuning, key, update="fused", grid="0" * 16)
    _fresh(monkeypatch)
    plan = resolve_iteration_plan(512, 64, format="ell", device="cpu")
    assert plan.source == "tuned"
    assert eng.get_tuner().measure_count == 1
    assert json.loads(tuning.read_text())["entries"][key]["grid"] == grid_fingerprint()


def test_foreign_entry_survives_the_ports_write(tuning, monkeypatch):
    """A cache file shared through ``REPRO_SPMV_TUNE_CACHE``: the port keeps
    the reference's entries when it writes; the reference, as it stands,
    drops the port's (queue C), and the port then re-measures."""
    jplan = jeng.resolve_iteration_plan(512, 64, format="ell", interpret=True)
    ref_keys = set(json.loads(tuning.read_text())["entries"])
    plan = resolve_iteration_plan(512, 64, format="ell", device="cpu")
    entries = json.loads(tuning.read_text())["entries"]
    assert ref_keys < set(entries)  # the reference's entries kept
    port_keys = {k for k, r in entries.items() if r.get("package") == "repro_torch"}
    assert port_keys and not port_keys & ref_keys
    _fresh(monkeypatch)
    assert jeng.resolve_iteration_plan(512, 64, format="ell", interpret=True) == jplan
    assert jeng.get_tuner().measure_count == 0  # the reference still reads its entry
    assert resolve_iteration_plan(512, 64, format="ell", device="cpu") == plan
    assert eng.get_tuner().measure_count == 0
    # The reference's next write keeps only its own entries.
    jeng.resolve_iteration_plan(512, 64, format="bsr", tiles=jeng.TileConfig(), interpret=True)
    assert not port_keys & set(json.loads(tuning.read_text())["entries"])
    _fresh(monkeypatch)
    resolve_iteration_plan(512, 64, format="ell", device="cpu")
    assert eng.get_tuner().measure_count == 1


def test_engine_surfaces_plan_provenance(monkeypatch):
    monkeypatch.setenv("REPRO_SPMV_TUNE", "0")
    csr = jax_generate("web", 256, 4.0, seed=2, values="normalized")
    e = eng.make_engine(_port_csr(csr), "ell", device="cpu")
    je = jeng.make_engine(csr, "ell")
    for engine in (e, je):
        desc = engine.describe()
        assert desc["iteration_plan"]["update"] == engine.iteration_plan.update
        assert desc["iteration_plan"]["source"] == "table"
        assert desc["tiles_from"] == "table"


def test_probe_rows_exceed_the_l2_on_the_card():
    """The card's probe is sized from the problem's row bucket up to a cap
    whose f32 ELL (8 slots, values and columns) exceeds the H100's 50 MB
    L2; the CPU's stays small."""
    assert eng._probe_rows(1 << 23, "cuda") == eng._PROBE_ROWS_CAP["cuda"] == 1 << 22
    assert eng._probe_rows(3000, "cuda") == 4096
    assert eng._PROBE_ROWS_CAP["cuda"] * 8 * (4 + 4) > 50 * 2**20
    assert eng._probe_rows(1 << 20, "cpu") == 1 << 12
    tiles = eng._candidate_tiles(TileConfig())
    assert tiles[0] == TileConfig() and len(tiles) <= 6
    assert all(t.block_w % 8 == 0 and t.block_r % 8 == 0 for t in tiles)


@pytest.mark.parametrize("policy", ["FFF", "FDF"])
def test_tuned_session_probes_once(tuning, monkeypatch, tmp_path, policy):
    """The first call of a tuned session pays the probes and reports them,
    a repeat call reports none and runs none (``tests/test_session.py``'s
    counterpart).  Under FFF both packages probe the tiles and the
    iteration (2); under FDF the reference pins "unfused" for its f64
    accumulation and probes the tiles only (1), while the port, whose
    kernels run f64, probes both (2): the queue C difference."""
    csr = jax_generate("web", 512, 6.0, seed=3, values="normalized")
    v0 = np.random.default_rng(0).standard_normal(csr.n)
    kw = dict(policy=policy, format="ell", num_iters=ITERS, v0=v0, reorth="full")
    r1 = repro_torch.eigsh(_port_csr(csr), 4, device="cpu", **kw)
    r2 = repro_torch.eigsh(_port_csr(csr), 4, device="cpu", **kw)
    probes = eng.tuner_probe_count()
    _use_cache(monkeypatch, tmp_path / "ref.json")
    monkeypatch.setenv("REPRO_SPMV_TUNE", "1")
    j1 = repro.eigsh(csr, 4, **kw)
    j2 = repro.eigsh(csr, 4, **kw)
    spmv, jspmv = r1.partition["spmv"], j1.partition["spmv"]
    assert spmv["tiles_from"] == "tuned" and spmv["iteration_plan"]["source"] == "tuned"
    assert spmv["tuner_probes"] == 2 == probes  # the repeat call probed nothing
    assert jspmv["tuner_probes"] == (2 if policy == "FFF" else 1)
    assert jspmv["iteration_plan"]["source"] == ("tuned" if policy == "FFF" else "table")
    assert r2.session_reuse and j2.session_reuse
    assert r2.partition["spmv"]["tuner_probes"] == j2.partition["spmv"]["tuner_probes"] == 0
    lam, jlam = np.sort(r1.eigenvalues.double().numpy()), np.sort(np.asarray(j1.eigenvalues))
    np.testing.assert_allclose(lam, jlam, rtol=0, atol=EIG_TOL[policy] * np.abs(jlam).max())
    assert torch.equal(r1.eigenvalues, r2.eigenvalues)
