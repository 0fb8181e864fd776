"""SpMV execution layer of the port: format selection and launch config.

The format decision is the reference's (``repro/kernels/engine.py``), ported
verbatim so the same matrix picks the same layout: ELL while the padded
slots stay within ``REPRO_SPMV_ELL_OVERHEAD`` x nnz, BSR when the touched
BS x BS blocks are dense enough, hybrid (quantile-capped ELL plus a COO hub
tail) when only the hub rows break the ELL bound, COO otherwise.

What is not carried over is the TPU's tiling: the 128-lane width padding,
the (8, 128) tile table and the sublane minimums.  :class:`TileConfig` here
is a Hopper launch configuration (row and width padding of 8), fixed for
now; the measured autotuner is later work.

The Lanczos update mode comes from a static table keyed on the device (see
:func:`table_update_mode`), or from the ``REPRO_ITER_UPDATE`` pin.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional, Sequence, Tuple

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
    "SpmvStats",
    "SpmvEngine",
    "matrix_stats",
    "choose_format",
    "hybrid_width_cap",
    "resolve_iteration_plan",
    "table_update_mode",
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


@dataclasses.dataclass(frozen=True)
class IterationPlan:
    """Whole-iteration decision: update mode + tiles, with provenance
    ("table" or "override"; no measured plans yet)."""

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


def resolve_iteration_plan(tiles: TileConfig = TileConfig(), device="cuda") -> IterationPlan:
    """``REPRO_ITER_UPDATE`` pins the mode ("override"); otherwise the
    static table decides ("table")."""
    env = (envcfg.get_str("REPRO_ITER_UPDATE") or "").strip().lower()
    if env and env != "auto":
        if env not in ITER_UPDATE_MODES:
            raise ValueError(f"REPRO_ITER_UPDATE={env!r}: expected one of {ITER_UPDATE_MODES}")
        return IterationPlan(update=env, tiles=tiles, source="override")
    return IterationPlan(update=table_update_mode(device), tiles=tiles, source="table")


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
) -> SpmvStats:
    nnz = int(row_nnz.sum())
    max_row = int(row_nnz.max()) if row_nnz.size else 0
    mean_row = nnz / max(1, n_rows)
    overhead = (max_row * n_rows) / max(1, nnz)
    bs = block_size
    if nnz and rows is not None:
        nbc = -(-int(cols.max() + 1) // bs)
        keys = (rows // bs).astype(np.int64) * nbc + cols // bs
        n_blocks = int(np.unique(keys).size)
    else:
        n_blocks = 0
    # No census (skipped or empty matrix) reads as "no block structure".
    fill = nnz / (n_blocks * bs * bs) if n_blocks else 0.0
    cap = hybrid_width_cap(row_nnz)
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

    def bsr_matvec(self, val, bcol, x) -> torch.Tensor:
        """y = BSR(val, bcol) @ x -> (nbr * BS,) in the accum dtype."""
        return kops.bsr_matvec(val, bcol, x, self.accum_dtype)

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
            return eng.bsr_matvec(mat.val, mat.bcol, x)[: mat.n_rows]
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
    ell_max_overhead: Optional[float] = None,
    bsr_fill_factor: Optional[float] = None,
) -> SpmvEngine:
    """Build a :class:`SpmvEngine` for a matrix (or precomputed stats).

    ``format="auto"`` runs :func:`choose_format`; an explicit format is
    validated against ``allowed`` and used as it is.
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
    tiles_from = "override" if tiles is not None else "table"
    tiles = tiles or TileConfig(block_size=block_size)
    device = str(torch.device(device))
    return SpmvEngine(
        format=fmt,
        accum_dtype=accum_dtype,
        tiles=tiles,
        device=device,
        requested=requested,
        stats=stats,
        tiles_from=tiles_from,
        iteration_plan=resolve_iteration_plan(tiles, device),
    )
