"""SpMV execution layer of the port: format selection, launch config and
the measured autotuner.

The format decision is the reference's (``repro/kernels/engine.py``), ported
verbatim so the same matrix picks the same layout: ELL while the padded
slots stay within ``REPRO_SPMV_ELL_OVERHEAD`` x nnz, BSR when the touched
BS x BS blocks are dense enough, hybrid (quantile-capped ELL plus a COO hub
tail) when only the hub rows break the ELL bound, COO otherwise.

What is not carried over is the TPU's tiling: the 128-lane width padding,
the (8, 128) tile table and the sublane minimums.  :class:`TileConfig` here
is a Hopper layout configuration: the row and slot padding multiples of the
ELL layouts (8 and 8 by default) and the BSR block edge.

Tiles come from the default :class:`TileConfig` (``select_tiles``), or from
the **measured autotuner** (:func:`tuned_tiles`) when ``REPRO_SPMV_TUNE=1``:
a small grid of padding multiples around the default is timed on probe
SpMVs on the solve's own device, memoized in-process and persisted to a
JSON cache (``REPRO_SPMV_TUNE_CACHE``, by default
``build/repro_torch_cache/spmv_tune.json`` of the checkout).
``REPRO_SPMV_TILES`` pins the tiles outright.  On top of that the tuner
resolves a **whole-iteration plan** (:class:`IterationPlan`): the Lanczos
update mode (``unfused`` / ``fused`` / ``fused_spmv``) with the tiles and
the BSR block edge, timed on the port's own Lanczos step.  With tuning off
a static table keyed on the device decides (see :func:`table_update_mode`),
or the ``REPRO_ITER_UPDATE`` pin.  Provenance ("table" | "tuned" |
"override") lands in ``partition["spmv"]``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import env as envcfg
from ..core.precision import dtype_name
from . import ops as kops

__all__ = [
    "FORMATS",
    "ITER_UPDATE_MODES",
    "TileConfig",
    "IterationPlan",
    "TileTuner",
    "SpmvStats",
    "SpmvEngine",
    "DEFAULT_TUNE_CACHE",
    "grid_fingerprint",
    "matrix_stats",
    "shard_stats",
    "choose_format",
    "hybrid_width_cap",
    "select_tiles",
    "tune_enabled",
    "tuned_tiles",
    "resolve_iteration_plan",
    "table_update_mode",
    "get_tuner",
    "tuner_probe_count",
    "make_engine",
]

FORMATS = ("coo", "ell", "bsr", "hybrid")

# Selection thresholds: the reference's defaults (env-overridable by the
# same knobs).
ELL_MAX_OVERHEAD = 3.0
BSR_FILL_FACTOR = 4.0
DEFAULT_BLOCK_SIZE = 8
HYBRID_QUANTILE = 0.95
HYBRID_MAX_TAIL = 0.6


def _env_float(name: str, default: float) -> float:
    return envcfg.get_float(name, default, lenient=True)


def ell_overhead_bound() -> float:
    return _env_float("REPRO_SPMV_ELL_OVERHEAD", ELL_MAX_OVERHEAD)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Hopper launch configuration of the SpMV kernels.

    ``block_r`` / ``block_w``: the ELL layouts pad their rows / width to a
    multiple of these (8 slots, not the TPU's 128 lanes); ``block_size``:
    the BSR block edge.  Every kernel launches 256-thread blocks (the
    constant ``kThreads`` of ``csrc/common.cuh``).
    """

    block_r: int = 8
    block_w: int = 8
    block_size: int = DEFAULT_BLOCK_SIZE


# How the Lanczos three-term update runs, in increasing fusion order:
#   unfused    — plain tensor expressions
#   fused      — the lanczos_update kernel (update + norm in one pass)
#   fused_spmv — spmv_ell_alpha + lanczos_update (ELL only)
ITER_UPDATE_MODES = ("unfused", "fused", "fused_spmv")


# BSR block edges the iteration probe re-converts through (the kernel's
# edges; the block size changes the layout, so picking it is a measurement).
_ITER_BSR_BLOCKS = (4, 8, 16)


@dataclasses.dataclass(frozen=True)
class IterationPlan:
    """Whole-iteration decision: update mode + tiles (with the BSR block
    edge), with provenance: "table" (the static default for the device),
    "tuned" (won a measured whole-iteration probe) or "override" (the
    ``REPRO_ITER_UPDATE`` pin)."""

    update: str = "unfused"
    tiles: TileConfig = TileConfig()
    source: str = "table"

    def __post_init__(self):
        if self.update not in ITER_UPDATE_MODES:
            raise ValueError(f"unknown update mode {self.update!r}; expected {ITER_UPDATE_MODES}")

    def as_dict(self) -> dict:
        return {
            "update": self.update,
            "block_r": self.tiles.block_r,
            "block_w": self.tiles.block_w,
            "block_size": self.tiles.block_size,
            "source": self.source,
        }


def table_update_mode(device) -> str:
    """Static update-mode table.  On the card the fused kernel saves a pass
    over the vectors; on the CPU the plain expressions run, which is the
    reference's choice off the TPU (interpret mode), so CPU runs of the two
    packages compare like with like.  For FDF the two modes give the same
    numbers anyway: ``u`` is formed in f64 either way."""
    return "unfused" if torch.device(device).type == "cpu" else "fused"


def select_tiles(block_size: int = DEFAULT_BLOCK_SIZE) -> TileConfig:
    """The prior tiles: the default :class:`TileConfig`, or the pin
    ``REPRO_SPMV_TILES="block_r,block_w[,block_size]"`` (the ELL layouts'
    row and slot padding multiples and the BSR block edge)."""
    env = envcfg.get_str("REPRO_SPMV_TILES")
    if env:
        try:
            parts = [int(p) for p in env.split(",")]
        except ValueError:
            parts = []
        if len(parts) not in (2, 3) or min(parts) < 1:
            raise ValueError(
                f"REPRO_SPMV_TILES={env!r}: expected 'block_r,block_w[,block_size]' "
                "(positive integers)"
            )
        bs = parts[2] if len(parts) == 3 else block_size
        return TileConfig(block_r=parts[0], block_w=parts[1], block_size=bs)
    return TileConfig(block_size=block_size)


# ------------------------------ tile autotuner -------------------------------

# The port's own cache file, beside the kernels' build and the serving store
# (src/repro_torch/kernels/engine.py -> the repository root).
DEFAULT_TUNE_CACHE = str(
    Path(__file__).resolve().parents[3] / "build" / "repro_torch_cache" / "spmv_tune.json"
)
# Formats whose layout takes the tile knobs (BSR's is its block edge, which
# the iteration probe decides).
_TUNABLE_FORMATS = ("ell", "hybrid")
# The candidate grid: multiples of the prior's row and slot padding.  Every
# multiple of 8 slots is a whole number of 16-byte vectors for f64, f32 and
# the 16-bit types, so each candidate runs the kernel's vector path.
_ROW_MULTS = (1, 2, 4)
_SLOT_MULTS = (1, 2)
# Probe rows: the problem's own row bucket, at most this many.  On the card
# 1 << 22 rows of 8 f32 slots and their columns are 268 MB, five times the
# H100's 50 MB L2, so the ranking times the HBM-bound matvec that a large
# solve pays (the reference's 1 << 16 rows, 4 MB, would sit in L2 and time
# launch overhead); on the CPU the plain versions run at 1 << 12 rows.
_PROBE_ROWS_CAP = {"cuda": 1 << 22, "cpu": 1 << 12}
# Probe columns lie within this many rows of their own row: the locality of
# a mesh or road network (a uniform random gather would time L2 misses on x).
_PROBE_BAND = 2048
# Bump when the cache entry layout itself changes (fields, key format).
_GRID_SCHEMA = 1
_PACKAGE = "repro_torch"


def grid_fingerprint() -> str:
    """Hash of the port's candidate space (prior, grids, update modes, BSR
    edges, probe shape).  Stamped into every persisted entry and checked on
    load: a change to the space drops the port's stale entries (they
    re-measure on next use) instead of serving unmeasured tiles."""
    payload = repr((_PACKAGE, _GRID_SCHEMA, TileConfig(), _ROW_MULTS, _SLOT_MULTS,
                    ITER_UPDATE_MODES, _ITER_BSR_BLOCKS, sorted(_PROBE_ROWS_CAP.items()),
                    _PROBE_BAND))
    return hashlib.blake2b(payload.encode(), digest_size=8).hexdigest()


def tune_enabled() -> bool:
    """Measured tuning is opt-in (``REPRO_SPMV_TUNE=1``)."""
    return envcfg.get_bool("REPRO_SPMV_TUNE")


class TileTuner:
    """Measured tile cache: in-process memo + persistent JSON.

    One entry per (format, dtypes, shape bucket, device type) key: the
    fastest :class:`TileConfig` of the measured grid and the raw timings of
    every candidate.  Whole-iteration plans live in the same file as
    ``kind: "iteration"`` entries under an ``iter|`` key.  The port's
    entries carry ``"package": "repro_torch"`` and the current
    :func:`grid_fingerprint`; its entries with another stamp are dropped on
    load.  Entries it does not own (the reference's, whose keys name the
    ``mosaic`` / ``interp`` modes) are kept as they are and written back,
    so a cache file shared through ``REPRO_SPMV_TUNE_CACHE`` keeps both
    packages' decisions (the reference's writer does not return the
    favour).  A missing or corrupt file is an empty cache.
    """

    def __init__(self, cache_path: Optional[str] = None):
        self.cache_path = cache_path or DEFAULT_TUNE_CACHE
        self._mem: Dict[str, TileConfig] = {}
        self._plans: Dict[str, IterationPlan] = {}
        self._meta: Dict[str, dict] = {}  # the port's live entries
        self._foreign: Dict[str, dict] = {}  # entries of another package
        self._loaded = False
        self.measure_count = 0  # tune passes actually run

    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        fp = grid_fingerprint()
        try:
            with open(self.cache_path) as f:
                entries = json.load(f).get("entries", {})
        except (OSError, ValueError, AttributeError):
            return  # absent or corrupt cache = cold start
        for key, rec in entries.items():
            if not isinstance(rec, dict):
                continue
            if rec.get("package") != _PACKAGE:
                self._foreign[key] = rec
                continue
            if rec.get("grid") != fp:
                continue  # stale candidate space: drop, re-measure on use
            try:
                tiles = TileConfig(block_r=int(rec["block_r"]), block_w=int(rec["block_w"]),
                                   block_size=int(rec.get("block_size", DEFAULT_BLOCK_SIZE)))
                if rec.get("kind") == "iteration":
                    self._plans[key] = IterationPlan(update=str(rec["update"]), tiles=tiles,
                                                     source="tuned")
                else:
                    self._mem[key] = tiles
            except (KeyError, TypeError, ValueError):
                continue
            self._meta[key] = rec

    def lookup(self, key: str) -> Optional[TileConfig]:
        self._load()
        return self._mem.get(key)

    def lookup_plan(self, key: str) -> Optional[IterationPlan]:
        self._load()
        return self._plans.get(key)

    def _dump(self) -> None:
        if not self.cache_path:
            return
        try:
            os.makedirs(os.path.dirname(os.path.abspath(self.cache_path)), exist_ok=True)
            tmp = f"{self.cache_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump({"version": 2, "entries": {**self._foreign, **self._meta}}, f,
                          indent=1, sort_keys=True)
            os.replace(tmp, self.cache_path)
        except OSError:
            pass  # read-only cache dir: keep the in-process memo only

    def _record(self, key: str, tiles: TileConfig, timings: Dict[str, float], **extra) -> None:
        self._meta[key] = {
            **extra,
            "package": _PACKAGE,
            "block_r": tiles.block_r,
            "block_w": tiles.block_w,
            "block_size": tiles.block_size,
            "grid": grid_fingerprint(),
            "best_us": min(timings.values()) if timings else None,
            "candidates_us": timings,
        }
        self._foreign.pop(key, None)
        self._dump()

    def record(self, key: str, tiles: TileConfig, timings: Dict[str, float]) -> None:
        self._load()
        self._mem[key] = tiles
        self._record(key, tiles, timings)

    def record_plan(self, key: str, plan: IterationPlan, timings: Dict[str, float]) -> None:
        self._load()
        plan = dataclasses.replace(plan, source="tuned")
        self._plans[key] = plan
        self._record(key, plan.tiles, timings, kind="iteration", update=plan.update)


_TUNER: Optional[TileTuner] = None
# One tune pass at a time: a scheduler's dispatch thread may build a plan
# while another thread adds a matrix, and two probes on one card would
# time each other (and race on the memo and the file).
_TUNE_LOCK = threading.RLock()


def get_tuner() -> TileTuner:
    """Process-wide tuner bound to the current ``REPRO_SPMV_TUNE_CACHE``."""
    global _TUNER
    path = envcfg.raw("REPRO_SPMV_TUNE_CACHE") or DEFAULT_TUNE_CACHE
    if _TUNER is None or _TUNER.cache_path != path:
        _TUNER = TileTuner(path)
    return _TUNER


def tuner_probe_count() -> int:
    """Measured tune passes run by this process so far (0 when tuning is
    off).  The session layer checks plan reuse against it: a cache-hit
    solve adds no probes."""
    return _TUNER.measure_count if _TUNER is not None else 0


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _mode(device) -> str:
    return "cpu" if torch.device(device).type == "cpu" else "cuda"


def _tune_key(fmt: str, dtype, n_rows: int, width: int, device, accum_dtype=None) -> str:
    """Shape-bucketed cache key: tiles depend on the size class, not the
    exact shape, so nearby problems share one measurement.  The mode is the
    device type ("cuda" / "cpu", where the reference has "mosaic" /
    "interp"); the iteration plans also key on the accumulator."""
    acc = f"|a{dtype_name(accum_dtype)}" if accum_dtype is not None else ""
    return (f"{fmt}|{dtype_name(dtype)}{acc}|r{_next_pow2(n_rows)}|w{_next_pow2(width)}|"
            f"{_mode(device)}")


def _candidate_tiles(prior: TileConfig) -> Tuple[TileConfig, ...]:
    """The grid of padding multiples around the prior (the prior first, so a
    tie keeps it), cut to ``REPRO_SPMV_TUNE_BUDGET`` candidates."""
    budget = envcfg.get_int("REPRO_SPMV_TUNE_BUDGET")
    out = []
    for r in _ROW_MULTS:
        for w in _SLOT_MULTS:
            cfg = dataclasses.replace(prior, block_r=prior.block_r * r, block_w=prior.block_w * w)
            if cfg not in out:
                out.append(cfg)
    return tuple(out[: max(1, budget)])


def _pad(x: int, mult: int) -> int:
    return -(-max(1, int(x)) // mult) * mult


def _probe_rows(n_rows: int, device, least: int = 8) -> int:
    return min(max(_next_pow2(n_rows), least), max(_PROBE_ROWS_CAP[_mode(device)], least))


def _probe_ell(rows: int, width: int, n_cols: int, dtype, device,
               gen) -> Tuple[torch.Tensor, torch.Tensor]:
    """A synthetic (rows, width) ELL on ``device`` over ``n_cols`` columns:
    normal values, columns within :data:`_PROBE_BAND` of their own row."""
    val = torch.randn((rows, width), generator=gen, device=device).to(dtype)
    off = torch.randint(-_PROBE_BAND, _PROBE_BAND + 1, (rows, width), generator=gen,
                        device=device)
    col = (torch.arange(rows, device=device)[:, None] + off).remainder(n_cols).to(torch.int32)
    return val, col


def _generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def _time_us(fn: Callable, device, reps: int = 5, inner: int = 4) -> float:
    """Median time of one ``fn()`` in us after a warm-up call outside the
    timed reps: CUDA events around ``inner`` calls on the card, the host
    clock around one call on the CPU (where the plain versions run)."""
    fn()
    ts = []
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(max(1, reps)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e3 / inner)
    else:
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(ts))


def _measure_ell_tiles(n_rows: int, width: int, dtype, accum_dtype,
                       candidates: Sequence[TileConfig], device) -> Dict[str, float]:
    """Median time (us) of a probe ELL SpMV per candidate, keyed
    ``"{block_r}x{block_w}"``.

    Each candidate is timed on the layout it would build: the probe's rows
    (the problem's pow2 row bucket, capped at :data:`_PROBE_ROWS_CAP`)
    padded to ``block_r``, the problem's width padded to ``block_w``.
    Candidates that build the same layout are one measurement (the first
    keeps the name); a ``block_r`` above the probe's rows is skipped (its
    padding would inflate the real rows, a cost the probe cannot see).
    """
    from . import ops as kops

    rows = _probe_rows(n_rows, device, min(c.block_r for c in candidates))
    gen = _generator(device)
    x = torch.randn(rows, generator=gen, device=device).to(dtype)
    layouts: Dict[Tuple[int, int], str] = {}
    for cfg in candidates:
        if rows % cfg.block_r:
            continue
        shape = (rows, _pad(width, cfg.block_w))
        layouts.setdefault(shape, f"{cfg.block_r}x{cfg.block_w}")
    timings: Dict[str, float] = {}
    for (r, w), name in layouts.items():
        val, col = _probe_ell(r, w, rows, dtype, device, gen)
        timings[name] = _time_us(lambda: kops.ell_matvec(val, col, x, accum_dtype), device)
        del val, col
    return timings


def tuned_tiles(
    n_rows: int,
    width: int,
    dtype=torch.float32,
    format: str = "ell",
    block_size: int = DEFAULT_BLOCK_SIZE,
    device="cuda",
    accum_dtype=None,
) -> Tuple[TileConfig, str]:
    """Resolve the tiles with provenance: "table" | "tuned" | "override".

    The ``REPRO_SPMV_TILES`` pin wins outright ("override"); otherwise the
    default :class:`TileConfig` is the prior, and with ``REPRO_SPMV_TUNE=1``
    and an ELL or hybrid layout a measured pass over the grid around it
    refines it ("tuned"), cached under ``REPRO_SPMV_TUNE_CACHE`` so each
    (shape bucket, dtype, format, device type) is measured once per cache.
    ``width`` is the raw row width the layout pads (the longest row, or the
    hybrid cap); ``accum_dtype`` (default: ``dtype``) is the SpMV's.
    """
    prior = select_tiles(block_size)
    if envcfg.get_str("REPRO_SPMV_TILES"):
        return prior, "override"
    if not tune_enabled() or format not in _TUNABLE_FORMATS or n_rows <= 0 or width <= 0:
        return prior, "table"
    with _TUNE_LOCK:
        tuner = get_tuner()
        key = _tune_key(format, dtype, n_rows, width, device)
        hit = tuner.lookup(key)
        if hit is not None:
            return dataclasses.replace(hit, block_size=block_size), "tuned"
        timings = _measure_ell_tiles(n_rows, width, dtype, accum_dtype or dtype,
                                     _candidate_tiles(prior), device)
        tuner.measure_count += 1
        if not timings:  # no candidate fits the probe: keep the prior
            return prior, "table"
        br, bw = (int(p) for p in min(timings, key=timings.get).split("x"))
        best = TileConfig(block_r=br, block_w=bw, block_size=block_size)
        tuner.record(key, best, timings)
        return best, "tuned"


# --------------------------- whole-iteration tuner ---------------------------


def _iter_candidates(fmt: str, tiles: TileConfig,
                     tile_variants: bool) -> Tuple[Tuple[str, TileConfig], ...]:
    """(update mode, tiles) candidates of the whole-iteration probe, by the
    reference's rules: ELL probes every mode (``fused_spmv`` is ELL's only)
    and one taller tile variant; BSR probes the block edges; COO and hybrid
    choose only the update (their SpMV is the same under every mode)."""
    if fmt == "bsr":
        return tuple((mode, dataclasses.replace(tiles, block_size=bs))
                     for mode in ("unfused", "fused") for bs in _ITER_BSR_BLOCKS)
    if fmt == "ell":
        tile_opts = [tiles]
        if tile_variants:
            taller = dataclasses.replace(tiles, block_r=tiles.block_r * 2)
            if taller not in tile_opts:
                tile_opts.append(taller)
        return tuple((mode, t) for mode in ITER_UPDATE_MODES for t in tile_opts)
    return tuple((mode, tiles) for mode in ("unfused", "fused"))


def _measure_iteration(
    n_rows: int,
    width: int,
    dtype,
    accum_dtype,
    fmt: str,
    candidates: Sequence[Tuple[str, TileConfig]],
    device,
) -> Tuple[Dict[str, float], Dict[str, Tuple[str, TileConfig]]]:
    """Median time (us) of one synthetic Lanczos step per candidate.

    The step is the port's own (``core/lanczos.py``): the SpMV in the
    accumulator, alpha, the three-term update and ``||u||^2``, through the
    same ``kernels.ops`` entry points: ``spmv_ell_alpha`` + ``lanczos_update``
    under ``fused_spmv``, SpMV + dot + ``lanczos_update`` under ``fused``,
    SpMV + plain expressions under ``unfused``.  The vectors are carried in
    the accumulator dtype (FDF's f64), the matrix in the storage dtype.
    Shapes are bucketed and capped as in :func:`_measure_ell_tiles`;
    candidates that build the same probe are one measurement.
    """
    from ..sparse.formats import DeviceELL
    from . import ops as kops

    cdt = accum_dtype
    rows = _probe_rows(n_rows, device, 16)
    gen = _generator(device)
    x = torch.randn(rows, generator=gen, device=device).to(cdt)
    xs = x.to(dtype)
    xp = torch.randn(rows, generator=gen, device=device).to(cdt)
    beta = torch.tensor(0.25, dtype=cdt, device=device)
    ell: Dict[Tuple[int, int], DeviceELL] = {}
    bsr: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    w_synth = (torch.randn(rows, generator=gen, device=device).to(cdt)
               if fmt not in ("ell", "bsr") else None)

    def update(w, mode):
        a = torch.sum(x * w)
        if mode == "unfused":
            u = w - a * x - beta * xp
            return u, torch.sum(u * u)
        return kops.lanczos_update(w, x, xp, a, beta, accum_dtype=cdt)

    timings: Dict[str, float] = {}
    by_name: Dict[str, Tuple[str, TileConfig]] = {}
    for mode, tiles in candidates:
        if fmt == "ell":
            shape = (_pad(rows, tiles.block_r), _pad(width, tiles.block_w))
            if shape not in ell:
                ell[shape] = DeviceELL(*_probe_ell(*shape, rows, dtype, device, gen), rows, rows)
            mat = ell[shape]
            if mode == "fused_spmv":
                def step(mat=mat):
                    w, a = kops.spmv_ell_alpha(mat, xs, x, accum_dtype=cdt)
                    return kops.lanczos_update(w.to(cdt), x, xp, a.to(cdt), beta, accum_dtype=cdt)
            else:
                def step(mat=mat, mode=mode):
                    return update(kops.spmv_ell(mat, xs, accum_dtype=cdt).to(cdt), mode)
            name = f"{mode}|{shape[0]}x{shape[1]}"
        elif fmt == "bsr":
            bs = tiles.block_size
            if rows % bs:
                continue
            if bs not in bsr:
                nbr = rows // bs
                slots = max(1, min(8, max(width, 8) // bs))
                val = torch.randn((nbr, slots, bs, bs), generator=gen, device=device).to(dtype)
                off = torch.randint(-_PROBE_BAND // bs, _PROBE_BAND // bs + 1, (nbr, slots),
                                    generator=gen, device=device)
                bcol = (torch.arange(nbr, device=device)[:, None] + off).remainder(nbr)
                bsr[bs] = (val, bcol.to(torch.int32))

            def step(pair=bsr[bs], mode=mode):
                w = kops.bsr_matvec(*pair, xs, cdt)[:rows]
                return update(w.to(cdt), mode)
            name = f"{mode}|bs{bs}"
        else:
            def step(mode=mode):
                return update(w_synth, mode)
            name = f"{mode}|update"
        if name in by_name:
            continue  # a tile variant that builds the same probe
        by_name[name] = (mode, tiles)
        timings[name] = _time_us(step, device)
    return timings, by_name


def resolve_iteration_plan(
    n_rows: int,
    width: int,
    dtype=torch.float32,
    format: str = "ell",
    tiles: TileConfig = TileConfig(),
    device="cuda",
    tile_variants: bool = True,
    accum_dtype=None,
) -> IterationPlan:
    """Resolve the whole-iteration plan with provenance.

    A ``REPRO_ITER_UPDATE`` pin wins ("override"); with
    ``REPRO_SPMV_TUNE=1`` a measured probe over :func:`_iter_candidates`
    decides and persists ("tuned"); otherwise the static table for the
    device decides ("table").  ``tiles`` is the resolved SpMV tile choice;
    the probe may refine it (the taller ELL variant, the BSR block edge)
    and :func:`make_engine` adopts the winner's tiles.  Unlike the
    reference, which pins ``"unfused"`` under f64 accumulation (its f64
    path runs no kernel), the port probes every accumulator: its kernels
    run f64, and FDF is the default policy.
    """
    env = (envcfg.get_str("REPRO_ITER_UPDATE") or "").strip().lower()
    if env and env != "auto":
        if env not in ITER_UPDATE_MODES:
            raise ValueError(f"REPRO_ITER_UPDATE={env!r}: expected one of {ITER_UPDATE_MODES}")
        return IterationPlan(update=env, tiles=tiles, source="override")
    table = IterationPlan(update=table_update_mode(device), tiles=tiles, source="table")
    if not tune_enabled() or n_rows <= 0 or width <= 0:
        return table
    acc = accum_dtype or dtype
    with _TUNE_LOCK:
        tuner = get_tuner()
        key = "iter|" + _tune_key(format, dtype, n_rows, width, device, acc)
        hit = tuner.lookup_plan(key)
        if hit is not None:
            return hit
        candidates = _iter_candidates(format, tiles, tile_variants)
        candidates = candidates[: max(2, envcfg.get_int("REPRO_SPMV_TUNE_BUDGET") * 2)]
        timings, by_name = _measure_iteration(n_rows, width, dtype, acc, format, candidates,
                                              device)
        tuner.measure_count += 1
        if not timings:  # no candidate fits the probe
            return table
        mode, best_tiles = by_name[min(timings, key=timings.get)]
        plan = IterationPlan(update=mode, tiles=best_tiles, source="tuned")
        tuner.record_plan(key, plan, timings)
        return plan


@dataclasses.dataclass(frozen=True)
class SpmvStats:
    """Cheap per-matrix layout statistics driving selection."""

    n_rows: int
    nnz: int
    max_row_nnz: int
    mean_row_nnz: float
    ell_overhead: float  # padded ELL slots / nnz (1.0 = no padding)
    block_size: int
    n_blocks: int  # touched BS x BS blocks
    block_fill: float  # nnz / (n_blocks * BS^2)
    hyb_width: int = 0
    hyb_tail_nnz: int = 0
    hyb_overhead: float = 0.0
    hyb_tail_frac: float = 0.0


def hybrid_quantile() -> float:
    return _env_float("REPRO_SPMV_HYBRID_Q", HYBRID_QUANTILE)


def hybrid_width_cap(row_nnz: np.ndarray, quantile: Optional[float] = None) -> int:
    """The hybrid split's ELL width: the given quantile of the row lengths."""
    if not row_nnz.size or not int(row_nnz.max()):
        return 0
    q = hybrid_quantile() if quantile is None else quantile
    cap = int(np.ceil(np.quantile(row_nnz, min(max(q, 0.0), 1.0))))
    return max(1, min(cap, int(row_nnz.max())))


def _stats_from_triplets(
    row_nnz: np.ndarray,
    rows: Optional[np.ndarray],
    cols: Optional[np.ndarray],
    n_rows: int,
    block_size: int,
    width: Optional[int] = None,
    hyb_width: Optional[int] = None,
) -> SpmvStats:
    """``rows`` / ``cols`` None skip the block census.  ``width`` charges
    the ELL overhead at a wider row (a shard pays the global longest row)
    and ``hyb_width`` pins the hybrid cap (shards share the global one)."""
    nnz = int(row_nnz.sum())
    max_row = int(row_nnz.max()) if row_nnz.size else 0
    mean_row = nnz / max(1, n_rows)
    overhead = (max(max_row, width or 0) * n_rows) / max(1, nnz)
    bs = block_size
    if nnz and rows is not None:
        nbc = -(-int(cols.max() + 1) // bs)
        keys = (rows // bs).astype(np.int64) * nbc + cols // bs
        n_blocks = int(np.unique(keys).size)
    else:
        n_blocks = 0
    # No census (skipped or empty matrix) reads as "no block structure".
    fill = nnz / (n_blocks * bs * bs) if n_blocks else 0.0
    cap = hybrid_width_cap(row_nnz) if hyb_width is None else int(hyb_width)
    tail = int(np.maximum(row_nnz - cap, 0).sum()) if (nnz and cap) else 0
    return SpmvStats(
        n_rows=n_rows,
        nnz=nnz,
        max_row_nnz=max_row,
        mean_row_nnz=mean_row,
        ell_overhead=overhead,
        block_size=bs,
        n_blocks=n_blocks,
        block_fill=fill,
        hyb_width=cap,
        hyb_tail_nnz=tail,
        hyb_overhead=(cap * n_rows + tail) / max(1, nnz),
        hyb_tail_frac=tail / max(1, nnz),
    )


def matrix_stats(csr, block_size: int = DEFAULT_BLOCK_SIZE, with_blocks: bool = True) -> SpmvStats:
    """O(nnz) layout statistics of a host CSR (the block census, a sort, is
    skipped with ``with_blocks=False``)."""
    row_nnz = csr.row_nnz()
    if with_blocks:
        rows = np.repeat(np.arange(csr.n, dtype=np.int64), row_nnz)
        return _stats_from_triplets(row_nnz, rows, csr.indices, csr.n, block_size)
    return _stats_from_triplets(row_nnz, None, None, csr.n, block_size)


def shard_stats(
    csr,
    splits: np.ndarray,
    block_size: int = DEFAULT_BLOCK_SIZE,
    with_blocks: bool = True,
) -> Tuple[SpmvStats, ...]:
    """Per-shard statistics of a row-partitioned CSR (``splits`` from
    ``core.partition.nnz_balanced_splits``), by the reference's rule: every
    shard is charged at the uniform shape the distributed layouts build
    (the largest shard's row count, the global longest row, the global
    hybrid cap), and block density is counted in the padded-global columns
    of the distributed BSR layout, so the selector judges the layout it
    would build."""
    out = []
    row_nnz = csr.row_nnz()
    global_width = int(row_nnz.max()) if row_nnz.size else 0
    global_cap = hybrid_width_cap(row_nnz)
    max_rows = int((splits[1:] - splits[:-1]).max()) if len(splits) > 1 else csr.n
    max_rows = max(1, max_rows)
    cols_pg = None
    if with_blocks:
        n_pad_bsr = -(-max_rows // block_size) * block_size
        owner = np.searchsorted(splits, csr.indices, side="right") - 1
        cols_pg = owner * n_pad_bsr + (csr.indices - splits[owner])
    for s in range(len(splits) - 1):
        r0, r1 = int(splits[s]), int(splits[s + 1])
        lo, hi = int(csr.indptr[r0]), int(csr.indptr[r1])
        local_nnz = row_nnz[r0:r1]
        if with_blocks:
            rows = np.repeat(np.arange(r1 - r0, dtype=np.int64), local_nnz)
            cols = cols_pg[lo:hi]
        else:
            rows = cols = None
        out.append(_stats_from_triplets(local_nnz, rows, cols, max_rows, block_size,
                                        width=global_width, hyb_width=global_cap))
    return tuple(out)


def choose_format(
    stats,
    allowed: Sequence[str] = FORMATS,
    *,
    ell_max_overhead: Optional[float] = None,
    bsr_fill_factor: Optional[float] = None,
) -> str:
    """Pick a SpMV format from layout statistics (the reference's rules;
    with several shards' stats the worst shard decides)."""
    if isinstance(stats, SpmvStats):
        stats = (stats,)
    ell_max = ell_max_overhead if ell_max_overhead is not None else ell_overhead_bound()
    bsr_factor = (
        bsr_fill_factor
        if bsr_fill_factor is not None
        else _env_float("REPRO_SPMV_BSR_FILL", BSR_FILL_FACTOR)
    )
    tail_max = _env_float("REPRO_SPMV_HYBRID_TAIL", HYBRID_MAX_TAIL)
    bsr_ok = "bsr" in allowed and all(s.block_fill >= bsr_factor / s.block_size for s in stats)
    if bsr_ok:
        return "bsr"
    ell_ok = "ell" in allowed and all(s.ell_overhead <= ell_max for s in stats)
    if ell_ok:
        return "ell"
    tail_frac = sum(s.hyb_tail_nnz for s in stats) / max(1, sum(s.nnz for s in stats))
    hyb_ok = (
        "hybrid" in allowed
        and tail_frac <= tail_max
        and all(s.hyb_overhead <= ell_max for s in stats)
    )
    if hyb_ok:
        return "hybrid"
    if "coo" in allowed:
        return "coo"
    for fmt in ("hybrid", "ell"):
        if fmt not in allowed:
            continue
        worst = max((s.hyb_overhead if fmt == "hybrid" else s.ell_overhead) for s in stats)
        warnings.warn(
            f"SpMV auto-selection is restricted to kernel formats here and "
            f"fell back to {fmt.upper()} despite a {worst:.0f}x padding "
            f"overhead (bound: {ell_max:.1f}x); for hub-dominated matrices "
            f"consider format='coo' or a larger REPRO_SPMV_ELL_OVERHEAD",
            stacklevel=2,
        )
        return fmt
    raise ValueError(f"no admissible SpMV format among {tuple(allowed)}")


@dataclasses.dataclass(frozen=True)
class SpmvEngine:
    """One SpMV execution configuration: format + accum dtype + launch
    config, on one device.  The kernel wrappers (``ops``) choose the plain
    version or the CUDA kernel from the tensors' device."""

    format: str = "ell"
    accum_dtype: Any = torch.float32
    tiles: TileConfig = TileConfig()
    device: str = "cuda"
    requested: str = "auto"
    stats: Optional[Tuple[SpmvStats, ...]] = None
    tiles_from: str = "table"
    iteration_plan: Optional[IterationPlan] = None

    def __post_init__(self):
        if self.format not in FORMATS:
            raise ValueError(f"unknown SpMV format {self.format!r}; expected {FORMATS}")

    def ell_matvec(self, val, col, x) -> torch.Tensor:
        """y = ELL(val, col) @ x -> (rows_pad,) in the accum dtype."""
        return kops.ell_matvec(val, col, x, self.accum_dtype)

    def packed_ell_matvec(self, val, scale, base, dcol, x) -> torch.Tensor:
        """y = dequant(val, scale) @ x over delta-encoded columns (a packed
        out-of-core chunk; see ``kernels/spmv_ell_packed.py``) -> (rows_pad,)
        in the accum dtype."""
        return kops.packed_ell_matvec(val, scale, base, dcol, x, self.accum_dtype)

    def bsr_matvec(self, val, bcol, x, n_cols=None) -> torch.Tensor:
        """y = BSR(val, bcol) @ x -> (nbr * BS,) in the accum dtype; ``x``
        holds ``n_cols`` columns (default ``nbr * BS``)."""
        return kops.bsr_matvec(val, bcol, x, self.accum_dtype, n_cols)

    def hybrid_matvec(self, mat, x) -> torch.Tensor:
        """Hub-split SpMV on a ``DeviceHybrid``: the ELL kernel over the
        capped part plus a deterministic segmented sum over the row-ordered
        tail.  Returns (n_rows,) in the accum dtype."""
        from ..sparse.formats import segment_sum

        acc = self.accum_dtype
        y = self.ell_matvec(mat.ell_val, mat.ell_col, x)[: mat.n_rows]
        t = mat.tail_nnz
        prod = mat.tail_val[:t].to(acc) * x.index_select(0, mat.tail_col[:t]).to(acc)
        return y + segment_sum(prod, mat.tail_offsets)

    def spmv(self, mat, x, accum_dtype=None) -> torch.Tensor:
        """SpMV on a device container (DeviceCOO/ELL/BSR/Hybrid)."""
        from ..sparse.formats import DeviceBSR, DeviceCOO, DeviceELL, DeviceHybrid

        acc = accum_dtype or self.accum_dtype
        if isinstance(mat, DeviceCOO):
            return mat.matvec(x, accum_dtype=acc)
        eng = self if acc == self.accum_dtype else dataclasses.replace(self, accum_dtype=acc)
        if isinstance(mat, DeviceELL):
            return eng.ell_matvec(mat.val, mat.col, x)[: mat.n_rows]
        if isinstance(mat, DeviceBSR):
            return eng.bsr_matvec(mat.val, mat.bcol, x, mat.n_cols)[: mat.n_rows]
        if isinstance(mat, DeviceHybrid):
            return eng.hybrid_matvec(mat, x)
        raise TypeError(f"SpmvEngine.spmv: unsupported container {type(mat).__name__}")

    def describe(self) -> dict:
        """Loggable summary (what ``EigenResult.partition["spmv"]`` records)."""
        return {
            "format": self.format,
            "requested": self.requested,
            "accum_dtype": dtype_name(self.accum_dtype),
            "block_r": self.tiles.block_r,
            "block_w": self.tiles.block_w,
            "block_size": self.tiles.block_size,
            "device": self.device,
            "tiles_from": self.tiles_from,
            "iteration_plan": (
                self.iteration_plan.as_dict() if self.iteration_plan is not None else None
            ),
        }


def make_engine(
    csr=None,
    format: str = "auto",
    *,
    stats=None,
    accum_dtype: Any = torch.float32,
    allowed: Sequence[str] = FORMATS,
    block_size: int = DEFAULT_BLOCK_SIZE,
    device="cuda",
    tiles: Optional[TileConfig] = None,
    storage_dtype: Any = None,
    ell_max_overhead: Optional[float] = None,
    bsr_fill_factor: Optional[float] = None,
) -> SpmvEngine:
    """Build a :class:`SpmvEngine` for a matrix (or precomputed stats).

    ``format="auto"`` runs :func:`choose_format`; an explicit format is
    validated against ``allowed`` and used as it is.  Tiles come from
    :func:`tuned_tiles` unless ``tiles`` pins them, then the iteration plan
    from :func:`resolve_iteration_plan`; a tuned plan's tiles (the BSR block
    edge included) are adopted unless the tiles were pinned.  With
    ``REPRO_SPMV_TUNE=1`` both probe on ``device`` in ``storage_dtype``
    (default: ``accum_dtype``).
    """
    requested = format
    if stats is None:
        if csr is None:
            raise ValueError("make_engine needs a csr or precomputed stats")
        with_blocks = format == "auto" and "bsr" in allowed
        stats = (matrix_stats(csr, block_size=block_size, with_blocks=with_blocks),)
    elif isinstance(stats, SpmvStats):
        stats = (stats,)
    else:
        stats = tuple(stats)

    if format == "auto":
        fmt = choose_format(
            stats, allowed, ell_max_overhead=ell_max_overhead, bsr_fill_factor=bsr_fill_factor
        )
    else:
        if format not in FORMATS:
            raise ValueError(f"unknown SpMV format {format!r}; expected {FORMATS} or 'auto'")
        if format not in allowed:
            raise ValueError(
                f"format={format!r} is not supported by this backend (allowed: {tuple(allowed)})"
            )
        fmt = format
    device = str(torch.device(device))
    sdt = storage_dtype or accum_dtype
    n_rows = max(s.n_rows for s in stats)
    # The raw width the layout pads: the hybrid cap, else the longest row.
    if fmt == "hybrid":
        width = max(1, max(s.hyb_width for s in stats))
    else:
        width = max(1, max(s.max_row_nnz for s in stats))
    explicit_tiles = tiles is not None
    if explicit_tiles:
        tiles_from = "override"
    else:
        tiles, tiles_from = tuned_tiles(n_rows, width, sdt, fmt, block_size, device, accum_dtype)
    pinned = explicit_tiles or tiles_from == "override"
    plan = resolve_iteration_plan(
        n_rows, width, sdt, fmt, tiles, device,
        # A pinned layout is a commitment the probe must not second-guess.
        tile_variants=not pinned, accum_dtype=accum_dtype,
    )
    if plan.source == "tuned" and not pinned:
        tiles, tiles_from = plan.tiles, "tuned"
    return SpmvEngine(
        format=fmt,
        accum_dtype=accum_dtype,
        tiles=tiles,
        device=device,
        requested=requested,
        stats=stats,
        tiles_from=tiles_from,
        iteration_plan=plan,
    )
