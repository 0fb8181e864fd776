"""Hopper launch checker: every launch the port's six CUDA kernels can be given.

It replaces the reference's Pallas grid-mapping checks, whose VMEM and tile
rules mean nothing on the card.  The rules keep their IDs:

  * **K001, launch shape.**  For every ELL width, storage dtype, alignment
    and row count that the engine, the tuner and the shard converters can
    emit, ``lane_plan`` / ``ell_launch_plan`` / ``packed_launch_plan`` give
    a power-of-two group of lanes that divides a warp and a plan the C side
    accepts (``ell_row.cuh:ell_plan_ok``); every block is ``kThreads`` (256,
    ``common.cuh``); every grid stays within ``2^31 - 1`` blocks.  The
    Python mirrors of the sources' launch constants must match them.
  * **K002, bounds.**  Every index product a kernel forms fits the type it
    is formed in, for the largest layouts the port builds (:data:`LAYOUTS`:
    road 14.08M in core and in chunks, the ``G * n_pad`` shard vectors, BSR
    ``n_cols``); each declared expression must still be in its source.  The
    partial buffers cover their kernel's grid: ``ell_max_blocks`` against
    ``ell_grid`` at the most blocks an SM holds, and on the card against
    each instantiation's real occupancy, and ``repro_update_blocks``
    against its mirror.
  * **K003, resources** (on the card only: it needs the built library).
    ``repro_kernel_attrs`` (``csrc/attrs.cu``) reads each template
    instantiation's registers, static shared memory, local bytes and
    occupancy at ``kThreads``.  A finding is shared memory over 227 KB a
    block, an occupancy of 0, or a block limit under ``kThreads``.  Spills
    (local bytes) are reported, not flagged.
  * **K004, deterministic reductions.**  No float or double atomic anywhere
    in ``csrc/`` (integer tickets, such as ``mixed_dot``'s, are allowed),
    and every kernel with a cross-block scalar writes per-block partials
    that one fixed-order pass reduces (:data:`CROSS_BLOCK`, the counterpart
    of the reference's ``PARALLEL_DIMS``).

On the CPU everything but the attribute and occupancy reads runs.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from .findings import Finding, Findings

__all__ = [
    "CSRC",
    "CROSS_BLOCK",
    "Layout",
    "LAYOUTS",
    "INDEX_EXPRS",
    "ell_grid",
    "check_launch_constants",
    "check_lane_plans",
    "check_index_bounds",
    "check_partials",
    "check_atomics",
    "check_cross_block",
    "read_kernel_attrs",
    "check_resources",
    "format_attrs",
    "run",
]

CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"

WARP = 32
MAX_GRID_X = 2**31 - 1
_TYPE_MAX = {"int": 2**31 - 1, "long long": 2**63 - 1, "grid": MAX_GRID_X}
SMEM_PER_BLOCK = 232_448  # 227 KB: the most shared memory a Hopper block may use
H100_SMS = 132

# Kernels whose result crosses blocks, and how the port keeps its sum in a
# fixed order: (source, the per-block partial write, the one fixed-order
# pass over the partials).  The other kernels are row-parallel.
CROSS_BLOCK = {
    "lanczos_update": ("lanczos_update.cu", "partials[blockIdx.x] = acc",
                       "launch_reduce_partials"),
    "spmv_ell_alpha": ("lanczos_fused.cu", "partials[blockIdx.x] = total",
                       "launch_reduce_partials"),
    "mixed_dot": ("mixed_dot.cu", "publish(partials + tile, acc)", "walk_tiles"),
}
_FIXED_ORDER_PASS = ("common.cuh", "reduce_partials_kernel")

_ATOMIC_RE = re.compile(r"\b(atomic(?:Add|Sub|Exch|Max|Min|CAS|Inc|Dec|And|Or|Xor)\w*)\s*\(")
_INT_TYPES = ("unsigned", "int", "long", "short", "uint", "size_t", "char")


@dataclasses.dataclass(frozen=True)
class Layout:
    """One operand layout a kernel is launched on."""

    name: str
    kernels: tuple
    rows: int = 0  # padded rows of an ELL / packed operand, or n of a vector kernel
    width: int = 0  # ELL slots a row
    n_cols: int = 0  # entries of the gathered vector x
    nbr: int = 0  # BSR block rows
    slots: int = 0  # BSR block slots a block row
    bs: int = 8  # BSR block edge
    block: int = 4096  # mixed_dot tile


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


_CENTRAL = 14_077_504  # road_central's rows (generate("road", 14_081_816, 2.4))
_SHARD4 = _pad(-(-_CENTRAL // 4), 8)
_ELL_KERNELS = ("spmv_ell", "spmv_ell_alpha")
# The largest layouts the port builds (chip_smoke.py's matrices).
LAYOUTS = (
    Layout("road 4.19M, in core", _ELL_KERNELS + ("lanczos_update",),
           rows=1 << 22, width=8, n_cols=1 << 22),
    Layout("road 14.08M, in core", _ELL_KERNELS + ("lanczos_update", "mixed_dot"),
           rows=_CENTRAL, width=8, n_cols=_CENTRAL),
    Layout("road 14.08M, one chunk", ("spmv_ell", "spmv_ell_packed"),
           rows=261_816, width=8, n_cols=_CENTRAL),
    Layout("web 1M, the hub chunk", ("spmv_ell", "spmv_ell_packed"),
           rows=8, width=_pad(1_047_670, 8), n_cols=1 << 20),
    Layout("road 14.08M, a G = 4 row shard", _ELL_KERNELS + ("lanczos_update",),
           rows=_SHARD4, width=8, n_cols=4 * _SHARD4),
    Layout("kron 0.5M BSR", ("spmv_bsr",), nbr=1 << 16, slots=8, bs=8, n_cols=1 << 19),
    Layout("kron 0.5M BSR, a G = 2 row shard", ("spmv_bsr",),
           nbr=1 << 15, slots=8, bs=8, n_cols=1 << 19),
    Layout("road 14.08M BSR 16", ("spmv_bsr",), nbr=_pad(_CENTRAL, 16) // 16, slots=8, bs=16,
           n_cols=_pad(_CENTRAL, 16)),
)


# Every index product the kernels form, with the type it is formed in:
# (kernel, source, the expression as written there, type, its largest value
# on a layout).  The expression must stay in the source: a kernel edited
# past this table is a finding until the table follows.
def _ell_cols(L: Layout) -> int:
    return L.n_cols - 1


INDEX_EXPRS = (
    ("spmv_ell", "ell_row.cuh",
     "const long long off = r * width + static_cast<long long>(lane) * V;", "long long",
     lambda L: L.rows * L.width),
    ("spmv_ell", "ell_row.cuh", "const S* vr = val + r * width;", "long long",
     lambda L: L.rows * L.width),
    ("spmv_ell", "ell_row.cuh", "xs[j][s] = gather(x, c[j][s]);", "int", _ell_cols),
    ("spmv_ell", "spmv_ell.cu", "long long rows, int width", "int", lambda L: L.width),
    ("spmv_ell_alpha", "lanczos_fused.cu", "long long rows, int width", "int", lambda L: L.width),
    ("spmv_ell_packed", "spmv_ell_packed.cu",
     "const long long off = r * width + static_cast<long long>(lane) * kSlots;", "long long",
     lambda L: L.rows * L.width),
    ("spmv_ell_packed", "spmv_ell_packed.cu", "const V* vr = val + row * width;", "long long",
     lambda L: L.rows * L.width),
    ("spmv_ell_packed", "spmv_ell_packed.cu", "int carry = live ? base[row] : 0;", "int",
     _ell_cols),
    ("spmv_bsr", "spmv_bsr.cu",
     "const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;",
     "long long", lambda L: _pad(L.nbr * L.bs, 256)),
    ("spmv_bsr", "spmv_bsr.cu", "const S* blk = val + (slot * BS + r) * BS;", "long long",
     lambda L: L.nbr * L.slots * L.bs * L.bs),
    ("spmv_bsr", "spmv_bsr.cu", "const S* xs = x + static_cast<long long>(bcol[slot]) * BS;",
     "long long", lambda L: L.n_cols),
    ("spmv_bsr", "spmv_bsr.cu", "const int* __restrict__ bcol", "int",
     lambda L: -(-L.n_cols // L.bs) - 1),
    ("spmv_bsr", "spmv_bsr.cu", "spmv_bsr_kernel<S, A, BS><<<static_cast<unsigned>(blocks)",
     "grid", lambda L: -(-L.nbr * L.bs // 256)),
    ("lanczos_update", "lanczos_update.cu", "i += stride", "long long",
     lambda L: L.rows + 1024 * 256),
    ("mixed_dot", "mixed_dot.cu", "const long long lo = tile * block;", "long long",
     lambda L: L.rows),
    ("mixed_dot", "mixed_dot.cu", "if (tiles >= INT_MAX)", "int",
     lambda L: -(-L.rows // L.block)),
    ("mixed_dot", "mixed_dot.cu", "mixed_dot_kernel<S, A><<<static_cast<unsigned>(tiles + 1)",
     "grid", lambda L: -(-L.rows // L.block) + 1),
)


def _source(name: str, sources: Optional[Dict[str, str]] = None) -> str:
    if sources is not None and name in sources:
        return sources[name]
    return (CSRC / name).read_text(encoding="utf-8")


def _rel(name: str) -> str:
    return f"src/repro_torch/kernels/csrc/{name}"


def _line_of(text: str, needle: str) -> int:
    i = text.find(needle)
    return text.count("\n", 0, i) + 1 if i >= 0 else 0


def ell_grid(rows: int, lanes: int, path: str, sms: int, per_sm: int,
             rows_in_flight: Optional[int] = None) -> int:
    """Blocks of one launch of the ELL row code: the mirror of
    ``csrc/ell_row.cuh:ell_grid``."""
    from ..kernels.spmv_ell import ROWS_IN_FLIGHT, THREADS

    rif = ROWS_IN_FLIGHT if rows_in_flight is None else rows_in_flight
    step = THREADS // WARP if path == "wide" else THREADS // lanes
    per_block = step * rif if path == "vector" else step
    return min(-(-rows // per_block), sms * per_sm)


def _plan_ok(width: int, vec: int, aligned: bool, lanes: int, path: str) -> bool:
    """The mirror of ``csrc/ell_row.cuh:ell_plan_ok``."""
    if lanes < 1 or lanes > WARP or lanes & (lanes - 1):
        return False
    if path == "scalar":
        return True
    if path not in ("vector", "wide") or width % vec or not aligned:
        return False
    return lanes == WARP if path == "wide" else lanes * vec >= width


# ----------------------------------------------------------------- K001


def check_launch_constants(sources: Optional[Dict[str, str]] = None) -> Findings:
    """K001: the sources' launch constants against their Python mirrors."""
    from ..kernels.spmv_ell import ROWS_IN_FLIGHT, THREADS
    from ..kernels.spmv_ell_packed import PACKED_SLOTS

    wants = (
        ("common.cuh", "kThreads", THREADS, "kernels/spmv_ell.py THREADS"),
        ("ell_row.cuh", "kRows", ROWS_IN_FLIGHT, "kernels/spmv_ell.py ROWS_IN_FLIGHT"),
        ("spmv_ell_packed.cu", "kSlots", PACKED_SLOTS, "kernels/spmv_ell_packed.py PACKED_SLOTS"),
    )
    out: List[Finding] = []
    for src, name, mirror, where in wants:
        text = _source(src, sources)
        m = re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", text)
        if m is None or int(m.group(1)) != mirror:
            got = m.group(1) if m else "missing"
            out.append(Finding("K001", f"{name} = {got} in the source but {mirror} in {where}",
                               file=_rel(src), line=_line_of(text, name)))
            continue
        if name == "kThreads" and (mirror % WARP or not 0 < mirror <= 1024):
            out.append(Finding("K001", f"kThreads = {mirror} is not whole warps within "
                                       "1024 threads", file=_rel(src), line=_line_of(text, name)))
    return out


# Every ELL width the engine, the tuner and the shard converters can emit:
# each width to 256 slots (padding multiples of 8 and the tuner's variants
# included), then the wide rows of hybrid bulks and hub chunks.
ELL_WIDTHS = tuple(range(1, 257)) + (264, 512, 1000, 1024, 4096, 1 << 16, 1_047_672, 1 << 20)
ROW_COUNTS = (0, 1, 7, 8, 9, 255, 256, 257, 4096, 261_816, 1 << 22, _SHARD4, _CENTRAL)


def check_lane_plans(plan: Optional[Callable] = None, *, widths: Sequence[int] = ELL_WIDTHS,
                     rows: Sequence[int] = ROW_COUNTS, sms: int = H100_SMS) -> Findings:
    """K001 over every (width, element size, alignment): the plan's lanes
    divide a warp, the C side accepts the plan, and the grid of every row
    count stays within ``2^31 - 1`` blocks.  ``plan`` defaults to the
    kernels' own (``ell_launch_plan`` for 2-, 4- and 8-byte values, then
    ``packed_launch_plan`` for 2- and 4-byte deltas)."""
    from ..kernels.spmv_ell import MAX_BLOCKS_PER_SM, ell_launch_plan
    from ..kernels.spmv_ell_packed import PACKED_SLOTS, packed_launch_plan

    if plan is not None:
        cases = [("custom", plan, s, 16 // s) for s in (2, 4, 8)]
    else:
        cases = [("spmv_ell", ell_launch_plan, s, 16 // s) for s in (2, 4, 8)]
        cases += [("spmv_ell_packed", packed_launch_plan, d, PACKED_SLOTS) for d in (2, 4)]
    out: List[Finding] = []
    for kernel, fn, size, vec in cases:
        bad = 0
        for width in widths:
            for aligned in (True, False):
                lanes, path = fn(width, size, aligned)
                ctx = f"{kernel}/{size}B/w{width}/{'aligned' if aligned else 'unaligned'}"
                problem = None
                if not (1 <= lanes <= WARP and lanes & (lanes - 1) == 0):
                    problem = f"{lanes} lanes a row do not divide a warp"
                elif not _plan_ok(width, vec, aligned, lanes, path):
                    problem = f"plan ({lanes} lanes, {path}) is refused by ell_plan_ok"
                else:
                    grid = max(ell_grid(r, lanes, path, sms, MAX_BLOCKS_PER_SM) for r in rows)
                    if grid > MAX_GRID_X:
                        problem = f"grid of {grid} blocks exceeds 2^31 - 1"
                if problem is not None:
                    bad += 1
                    if bad <= 3:  # a systematic fault needs three examples, not thousands
                        out.append(Finding("K001", problem, context=ctx))
    return out


# ----------------------------------------------------------------- K002


def check_index_bounds(layouts: Iterable[Layout] = LAYOUTS, exprs=INDEX_EXPRS,
                       sources: Optional[Dict[str, str]] = None) -> Findings:
    """K002: every declared index product on every layout of its kernel
    fits the type it is formed in, and is still in its source."""
    out: List[Finding] = []
    layouts = list(layouts)
    for kernel, src, text, ctype, value in exprs:
        source = _source(src, sources)
        if text not in source:
            out.append(Finding("K002", f"declared index expression `{text}` of {kernel} is no "
                                       f"longer in {src}: re-check its bound",
                               file=_rel(src), context=kernel))
            continue
        for L in layouts:
            if kernel not in L.kernels:
                continue
            v = value(L)
            if v > _TYPE_MAX[ctype]:
                out.append(Finding(
                    "K002", f"`{text}` reaches {v:,} on {L.name}, past the {ctype} maximum "
                            f"{_TYPE_MAX[ctype]:,}",
                    file=_rel(src), line=_line_of(source, text), context=kernel))
    return out


def check_partials(*, rows: Sequence[int] = ROW_COUNTS, widths: Sequence[int] = ELL_WIDTHS,
                   per_sm: Optional[Dict[str, int]] = None, update_blocks=None,
                   sms: int = H100_SMS, sources: Optional[Dict[str, str]] = None) -> Findings:
    """K002: the partial buffers cover the grids that write them.

    ``spmv_ell_alpha`` allocates ``ell_max_blocks`` partials; its grid is
    ``ell_grid`` at the kernel's occupancy, at most ``MAX_BLOCKS_PER_SM`` a
    SM (``per_sm``, on the card: each instantiation's measured occupancy).
    ``lanczos_update`` allocates ``repro_update_blocks(n)`` (``update_blocks``,
    on the card: the library's own function) and launches ``update_blocks(n)``
    blocks, at most ``kMaxUpdateBlocks``."""
    from ..kernels.spmv_ell import MAX_BLOCKS_PER_SM, ell_launch_plan, ell_max_blocks

    out: List[Finding] = []
    occ = dict(per_sm or {})
    for inst, n in occ.items():
        if n > MAX_BLOCKS_PER_SM:
            out.append(Finding("K002", f"{inst} holds {n} blocks an SM, past the "
                                       f"{MAX_BLOCKS_PER_SM} its partials are sized for",
                               context="spmv_ell_alpha"))
    most = max([MAX_BLOCKS_PER_SM, *occ.values()])
    for size in (2, 4, 8):
        for width in widths:
            lanes, path = ell_launch_plan(width, size, True)
            for r in rows:
                grid = ell_grid(r, lanes, path, sms, most)
                have = max(1, ell_max_blocks(r, lanes, path, sms))
                if grid > have:
                    out.append(Finding(
                        "K002", f"{grid} blocks write {have} partials",
                        context=f"spmv_ell_alpha/{size}B/w{width}/rows{r}"))
                    return out
    text = _source("lanczos_update.cu", sources)
    m = re.search(r"constexpr\s+long\s+long\s+kMaxUpdateBlocks\s*=\s*(\d+)\s*;", text)
    cap = int(m.group(1)) if m else 0

    def mirror(n: int) -> int:
        b = -(-n // 256)
        return min(max(b, 1), cap)

    for n in (1, 255, 256, 257, 1 << 16, 1 << 18, 1 << 22, _CENTRAL):
        want = mirror(n)
        got = update_blocks(n) if update_blocks is not None else want
        if got != want or want > cap or cap < 1:
            out.append(Finding("K002", f"lanczos_update at n = {n:,}: {got} partials for a grid "
                                       f"of {want} blocks (kMaxUpdateBlocks {cap})",
                               file=_rel("lanczos_update.cu"),
                               line=_line_of(text, "kMaxUpdateBlocks")))
    return out


# ----------------------------------------------------------------- K004


def check_atomics(text: str, path: str) -> Findings:
    """K004: atomics whose target is not an integer."""
    out: List[Finding] = []
    for m in _ATOMIC_RE.finditer(text):
        args = text[m.end():].split(",", 1)[0].strip()
        target = re.sub(r"^[&(\s]+|[\s)]+$", "", args).split("[")[0].split("+")[0].strip()
        ident = re.sub(r"\W", "", target)
        decl = re.search(
            rf"([\w:<>\s]+?)\s*\*?\s*(?:__restrict__\s+)?\b{re.escape(ident)}\b\s*[,);=\[]",
            text) if ident else None
        dtype = decl.group(1).split()[-1] if decl else ""
        if not any(dtype.startswith(t) for t in _INT_TYPES):
            out.append(Finding("K004", f"{m.group(1)} on `{target}` ({dtype or 'undeclared'}):"
                                       " a float atomic sums in a different order every run",
                               file=path, line=text.count("\n", 0, m.start()) + 1))
    return out


def check_cross_block(sources: Optional[Dict[str, str]] = None,
                      contracts: Optional[Dict[str, tuple]] = None) -> Findings:
    """K004: each cross-block scalar is written as per-block partials and
    reduced by one fixed-order pass (``common.cuh:reduce_partials_kernel``,
    or ``mixed_dot``'s in-order walk)."""
    out: List[Finding] = []
    common = _source(_FIXED_ORDER_PASS[0], sources)
    if f"__global__ void __launch_bounds__(kThreads) {_FIXED_ORDER_PASS[1]}" not in common:
        out.append(Finding("K004", "the fixed-order pass over per-block partials is gone",
                           file=_rel(_FIXED_ORDER_PASS[0])))
    for kernel, (src, write, reduce) in (contracts or CROSS_BLOCK).items():
        text = _source(src, sources)
        for marker, what in ((write, "per-block partial write"), (reduce, "fixed-order pass")):
            if marker not in text:
                out.append(Finding("K004", f"{kernel}'s {what} (`{marker}`) is missing: its "
                                           "cross-block scalar has no fixed summation order",
                                   file=_rel(src), context=kernel))
    return out


# ----------------------------------------------------------------- K003


def read_kernel_attrs() -> List[dict]:
    """Every kernel instantiation's resources from the built library (the
    card): name, registers, static shared bytes, local bytes, max threads a
    block, blocks of ``kThreads`` an SM holds, constant bytes."""
    import ctypes

    from ..kernels import build

    lib = build.load()
    out = []
    for i in range(lib.repro_kernel_count()):
        name = ctypes.c_char_p()
        vals = (ctypes.c_longlong * 6)()
        build.check(lib.repro_kernel_attrs(i, ctypes.byref(name), vals), "repro_kernel_attrs")
        out.append({"name": name.value.decode(), "registers": vals[0], "shared_bytes": vals[1],
                    "local_bytes": vals[2], "max_threads": vals[3], "occupancy": vals[4],
                    "const_bytes": vals[5]})
    return out


def check_resources(attrs: Iterable[dict]) -> Findings:
    """K003 over a list of :func:`read_kernel_attrs` records."""
    from ..kernels.spmv_ell import THREADS

    out: List[Finding] = []
    for a in attrs:
        problems = []
        if a["shared_bytes"] > SMEM_PER_BLOCK:
            problems.append(f"{a['shared_bytes']:,} B of shared memory a block, past "
                            f"{SMEM_PER_BLOCK:,}")
        if a["occupancy"] < 1:
            problems.append(f"no block of {THREADS} threads fits an SM")
        if a["max_threads"] < THREADS:
            problems.append(f"at most {a['max_threads']} threads a block, under {THREADS}")
        for p in problems:
            out.append(Finding("K003", p, context=a["name"]))
    return out


def format_attrs(attrs: Iterable[dict]) -> str:
    return "\n".join(
        f"[kernels] attrs {a['name']}: registers {a['registers']}, shared {a['shared_bytes']} B, "
        f"local {a['local_bytes']} B, occupancy {a['occupancy']} blocks/SM"
        for a in attrs)


# ------------------------------------------------------------------ run


def run(device="cpu") -> Findings:
    """The sweep: K001, K002 and K004 everywhere; on ``device="cuda"`` also
    K003 and the occupancy and ``repro_update_blocks`` parts of K002 from the
    built library."""
    import torch

    findings: List[Finding] = []
    findings += check_launch_constants()
    findings += check_lane_plans()
    findings += check_index_bounds()
    per_sm, update_blocks = None, None
    if torch.device(device).type == "cuda":
        from ..kernels import build

        attrs = read_kernel_attrs()
        findings += check_resources(attrs)
        per_sm = {a["name"]: a["occupancy"] for a in attrs
                  if a["name"].startswith("spmv_ell_alpha_kernel")}
        update_blocks = build.load().repro_update_blocks
    findings += check_partials(per_sm=per_sm, update_blocks=update_blocks)
    for path in sorted(CSRC.glob("*.cu*")):
        findings += check_atomics(path.read_text(encoding="utf-8"), _rel(path.name))
    findings += check_cross_block()
    return findings
