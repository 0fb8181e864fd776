#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check exits non-zero
before the last line:

1. device: the card's name and power limit, the torch and CUDA versions;
   build the six CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. every kernel against its plain PyTorch version on the card, at the
   main path's shapes, for the (storage, accum) pairs the policies use
   (``spmv_ell_packed`` on a real chunk of phase 8's matrix, in bf16 and
   fp8 with int32 deltas, and on a one-chunk road network whose deltas fit
   int16; ``mixed_dot`` at n = 4,194,304, which fits in L2, and at phase
   8's n = 14,077,504, which does not); for every kernel and library call
   its series time (``ms``: CUDA events over back-to-back calls) and its
   device time per call (``device_ms``: the card's own kernel, memset and
   copy time under ``torch.profiler``), the plain version's time and the
   bound; ``spmv_ell`` also on one 261,816-row chunk of phase 8;
   ``spmv_ell_alpha``'s ``w`` equals ``spmv_ell``'s ``y`` bit for bit at the
   main path's shape for every pair, and alpha has the same bits on five
   calls; ``spmv_ell_packed`` also on the chunk that holds phase 4's widest
   row (its hub: the kernel's wide path);
3. the main path: ``repro_torch.eigsh`` on a 4.19M-row road network
   (``generate("road", 1 << 22, 2.1)``, the size of the paper's italy_osm)
   with the defaults (FDF): ELL format, ``spmv_ell`` and ``lanczos_update``
   launched k times each; eigenvalues against the same solve on the host
   with the same start vector; true residuals against the reported bounds;
   the Lanczos loop of every phase runs with no device->host sync;
4. hybrid: a 1M-row power-law web graph under FFF;
5. ``REPRO_ITER_UPDATE=fused_spmv`` on phase 3's matrix (``spmv_ell_alpha``);
6. BSR: ``kron(road 1 << 16, dense symmetric 8 x 8)``, 0.5M rows, block fill 1;
7. warm wall times of each phase's solve (run last);
8. chunked: ``generate("road", 14_081_816, 2.4)`` (the row count of the
   paper's road_central, 56.6M nnz, above the 25M-nnz chunked threshold),
   written with ``save_diskcsr`` into a temporary directory (deleted at the
   end); ``repro_torch.eigsh(path, k=8)`` with the defaults runs the
   chunked backend, ELL, f32 staging, ``spmv_ell`` launched
   ``num_chunks * k`` times; eigenvalues against ``backend="single"`` on
   the in-RAM CSR, true residuals against the bounds, residency within
   ``stage_depth + 1``; ``kernels.ops.mixed_dot`` (compensated, f64) forms
   the Gram matrix of the eigenvectors; the staging counters and a split
   of one warm solve (``torch.profiler``);
9. packed staging on the same matrix: ``staging="bf16"`` and ``"fp8"``
   under FDF and ``policy="BFF", staging="auto"`` launch
   ``spmv_ell_packed`` ``num_chunks * k`` times and stay within the
   reference tests' bounds of f32 staging; fp8 on
   ``generate("road", 1 << 20, 2.1)`` (``chunk_nnz = 1 << 18``) matches the
   same chunked solve on the host at rel 1e-9;
10. the restarted backend and the session's query layer, full width: (a)
   ``repro_torch.eigsh(road 4.19M, k=8, tol=1e-6)`` (FDF) runs
   ``backend="restarted"`` on ELL, ``spmv_ell`` launched ``iterations``
   times and ``lanczos_update`` never; true residuals against the bounds
   (phase 3's gap rule) and, for converged pairs, against ``tol``; (b) the
   same call at ``generate("road", 1 << 20, 2.1)`` on the card and on the
   host: equal ``iterations`` and ``restarts``, eigenvalues at rel 1e-9;
   (c) ``policy="auto", tol=1e-4`` on phase 4's web graph: the trail of
   rungs, the accepted rung's verified residuals within ``tol``, every
   earlier rung rejected, plans reused; (d) a second
   ``repro_torch.eigsh(road, k=8, v0=...)`` is served by the session cache
   (``session_reuse``, ``prepare_s`` 0, the same bits), cold and cached
   wall times; (e) ``prepare(road).eigsh_many([k=4 FDF, k=8 FDF, k=8
   FFF])``: two sweeps, the k=8 FDF answer equal to a lone call at rel
   1e-9, the k=4 answer the first four of that sweep;
11. solve robustness, full width, snapshots in a temporary directory
   (deleted at the end): (a) ``eigsh(road, k=8, tol=1e-6, v0,
   max_restarts=8)`` plain, with ``checkpoint_dir=`` (same bits), killed by
   ``solve_crash@cycle=4`` and resumed after a cache clear: the plain run's
   bits, steps and restarts, ``spmv_ell`` once per remaining step,
   ``lanczos_update`` never; (b) phase 8's call with
   ``REPRO_CHUNK_CKPT_EVERY=32`` killed by ``chunk_io_error@chunk=40`` (an
   ``OSError``) and resumed from its chunk cursor: phase 8's bits; snapshot
   bytes and seconds per save, and the reckoned cost of the default
   ``REPRO_CHUNK_CKPT_EVERY=1``; (c) ``recovery="auto"`` on road under FFF:
   ``spmv_nan@iter=3`` escalates to FCF (a plain FCF call's bits),
   ``beta_collapse@iter=2`` reseeds, ``kernel_error`` unfuses (``spmv_ell``
   k times, ``lanczos_update`` never), ``oom`` falls back to the chunked
   backend; ``recovery="raise"`` raises the typed breakdown; (d)
   ``jacobi="jax"`` on phase 3's call (rel 1e-12 of the host Jacobi) and the
   two placements' ``jacobi_s``; (e) ``topk_eigs`` on ``make_operator(road,
   "ell")`` (a DeprecationWarning, rel 1e-12 of ``eigsh(format="ell")``),
   ``make_operator(block, "bsr_kernel")`` and ``kernels.ops.spmv_ell_packed``
   with f64 accumulation on phase 2's bf16 chunk;
12. the measured autotuner and the serving layer, full width, with
   ``REPRO_SPMV_TUNE=1`` and the tune cache and session store in a
   temporary directory (deleted at the end): (a) ``prepare(road)`` (FDF)
   probes once, prints every candidate's us and the chosen tiles and plan, a
   second ``prepare`` adds no probe, the tuned solve launches what its plan
   says and is within rel 1e-9 of phase 3's; the same on the BSR matrix
   (its block edge) against phase 6; (b) an ``EigenScheduler`` with road
   and web resident serves 3 threads x 6 queries (k in 2..8, one ``v0`` per
   matrix): each result equals ``eigsh_many`` of the same query (rel 1e-9),
   launches match the sweeps under each plan, and the ``ServerStats``
   (coalesce rate, e2e and queue p50/p99, queries/s) print; (c)
   ``close(persist=True)`` and a second scheduler on the same store: 0
   conversions, 0 probes, the same bits; entry bytes, save and load
   seconds; (d) ``scheduler_crash``: the watchdog fails the stranded
   requests with ``SchedulerCrashedError`` and ``start()`` serves again;
   (e) ``python -m repro_torch.launch.serve --smoke`` exits 0;
13. the distributed backend on the card, its ranks spawned by
   ``repro_torch.launch.ranks.run_ranks`` (each with a timeout; a failed
   rank fails the phase), the matrices handed over as ``.npy`` files.
   First, in this process, every kernel of the path against its plain
   version on the operands a rank gives it: the first and last row shards
   of (a)-(b)'s matrices (ELL, the hybrid bulk, BSR, times a gathered
   ``(G * n_pad,)`` vector; ``lanczos_update`` at ``n_pad``) and each
   rank's share of a chunk of phase 8's matrix, plain and packed bf16.
   (a) a world of one over NCCL, ``eigsh(road 4.19M, k=8,
   backend="distributed")`` (ELL, FDF) within rel 1e-9 of
   ``backend="single", reorth="full"`` with the same ``v0``, ``spmv_ell``
   and ``lanczos_update`` launched k times, and k ``spmv_ell_alpha`` under
   ``REPRO_ITER_UPDATE=fused_spmv``; the collective counter (k all-gathers,
   2k + 1 scalar and k vector reductions); (b) G = 2 and G = 4 ranks over
   gloo on cuda:0: road at both (within rel 1e-9 of (a), its f64 Ritz
   values too), the BSR matrix at G = 2 and the web graph (hybrid) at
   G = 4 (each within rel 1e-9 of ``backend="single"``); every rank's
   eigenvalues, tridiagonal and eigenvector digest identical; the shards'
   nnz balance; a warm query's wall, its Lanczos time on the host clock
   and its collectives' time by CUDA events; (c) at G = 2, ``eigsh(phase 8's directory,
   backend="chunked", mesh=...)``: f32 staging within rel 1e-9 of phase 8,
   bf16 within 8e-3, each rank launching its shares of every chunk and one
   all-gather a matvec; (d) at G = 2, ``spmv_nan@iter=3`` under FFF with
   ``recovery="auto"``: every rank escalates FFF -> FCF, finite results;
14. the analysis on the card (``repro_torch.analysis``): (a) on phase 3's
   road network, k = 8, ``eigsh`` with ``REPRO_PRECISION_MEASURE=1`` under
   BFF, FFF, FCF, FDF and DDD and each update plan the rung resolves
   (``unfused``, ``fused``, ``fused_spmv``; FCF only ``unfused``): no P001-
   P004 finding (the whole solve, and each phase of the same rung and plan
   at the reference's size), the measured counts beside the model's, the
   conversions a Lanczos step by (src, dst), each kernel's recorded ops
   equal to its launches times its per-launch contract, eigenvalues and
   eigenvectors with the bits of an uncounted solve; (b) the same under FDF
   for the BSR matrix and a restarted ``tol=1e-6`` solve of
   ``generate("road", 1 << 20, 2.1)``; (c) ``python -m repro_torch.analysis
   --check kernels --strict --device cuda`` in a subprocess: no finding,
   and each instantiation's registers, shared and local bytes and
   occupancy, which join the ``kernels`` line; (d) its own seconds.

``repro_torch.eigsh`` keeps a cache of prepared sessions, so every call a
phase reports as cold (``solve``) clears it first; phase 7 prints its
state once.

Then one JSON line of kernel records (``launches`` from the main path's
phases, ``launches_distributed`` from phase 13's, ``launches_analysis`` from
phase 14's, and the resources of each kernel's main-path instantiation), and
as the last line
``{"ok": true, "device": {...}}``.  Exits 2 without printing a result when
no CUDA device is visible.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import scipy.sparse as sp
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
K = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# Peak rates without tensor cores, NVIDIA H100 SXM data sheet (dense).
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}  # by accum dtype
# (storage, accum) pairs the seven precision policies use.
PAIRS = (
    (torch.float32, torch.float32),
    (torch.float32, torch.float64),
    (torch.float64, torch.float64),
    (torch.bfloat16, torch.float32),
    (torch.float16, torch.float32),
)
MAIN_PAIR = (torch.float32, torch.float64)  # FDF: f32 storage, f64 accumulation


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def dname(dt) -> str:
    return str(dt).replace("torch.", "")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def time_ms(fn, launches: int = 20, rounds: int = 5) -> float:
    """Time of one ``fn()`` in ms: CUDA events around ``launches`` calls in a
    row, over the count; the median of ``rounds`` such runs, after a warm-up.
    Calls queue back to back, so a wrapper's host work hides behind the
    device's unless it takes longer."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


# Device-side records of the profiler itself, not of the program.
_PROFILER_RECORDS = ("Activity Buffer Request",)


def device_ms(fn, calls: int = 20, tag: str = "", parts: dict = None) -> float:
    """Device time of one ``fn()`` in ms, from ``torch.profiler``: for each
    kind of device activity (kernel, memset, copy) that ``calls`` calls put
    on the card, the median duration times the number of them per call,
    summed (after a warm-up).  Unlike :func:`time_ms`, the wrapper's host
    work and the gaps between launches do not count; the median keeps one
    slow launch (the first under a new profiler session) out.  With ``tag``,
    prints each kind's count and min / median / max in us; ``parts``, if
    given, receives each kind's device us per call.  A profile with
    no device records is taken again, twice at most; then it fails."""
    fn()
    torch.cuda.synchronize()
    by_name: dict = {}
    for attempt in range(3):  # a profile now and then comes back without device records
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in device_events(prof):
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if by_name:
            break
        print(f"[kernels]   {tag or 'device_ms'}: profile {attempt + 1} recorded no device time")
    # Launches of each kind per call: the profiler drops a record now and
    # then (15 of 20 seen), so round the count rather than divide by it.
    per_call = {name: float(np.median(d)) * max(1, round(len(d) / calls))
                for name, d in by_name.items()}
    total_us = sum(per_call.values())
    check(total_us > 0, "torch.profiler recorded no device time in three profiles")
    if parts is not None:
        parts.update(per_call)
    for name, d in by_name.items() if tag else ():
        print(f"[kernels]   {tag} device: {len(d)}/{calls} x {name[:90]}: min {min(d):.2f} "
              f"median {float(np.median(d)):.2f} max {max(d):.2f} us")
    return total_us / 1e3


def device_events(prof):
    """The profile's device activities (kernels, memsets, copies), each once.
    ``key_averages()`` would count an ATen operator's kernels twice: once
    as the kernel and once in the operator's self device time."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in _PROFILER_RECORDS]


def to_port_csr(m):
    from repro_torch.sparse import CSR

    m = m.tocsr()
    m.sort_indices()
    return CSR(
        indptr=m.indptr.astype(np.int64),
        indices=m.indices.astype(np.int32),
        data=m.data.astype(np.float64),
        shape=m.shape,
    )


# ------------------------------------------------------------------ kernels


def kernel_modules():
    from repro_torch.kernels import (
        lanczos_fused,
        lanczos_update,
        mixed_dot,
        spmv_bsr,
        spmv_ell,
        spmv_ell_packed,
    )

    return {
        "spmv_ell": spmv_ell.spmv_ell_kernel_call,
        "lanczos_update": lanczos_update.lanczos_update_kernel_call,
        "spmv_ell_alpha": lanczos_fused.spmv_ell_alpha_kernel_call,
        "spmv_bsr": spmv_bsr.spmv_bsr_kernel_call,
        "spmv_ell_packed": spmv_ell_packed.spmv_ell_packed_kernel_call,
        "mixed_dot": mixed_dot.mixed_dot_kernel_call,
    }


KERNEL_META = {
    "spmv_ell": ("src/repro_torch/kernels/csrc/spmv_ell.cu", "src/repro/kernels/spmv_ell.py:54"),
    "lanczos_update": (
        "src/repro_torch/kernels/csrc/lanczos_update.cu",
        "src/repro/kernels/lanczos_update.py:50",
    ),
    "spmv_ell_alpha": (
        "src/repro_torch/kernels/csrc/lanczos_fused.cu",
        "src/repro/kernels/lanczos_fused.py:81",
    ),
    "spmv_bsr": ("src/repro_torch/kernels/csrc/spmv_bsr.cu", "src/repro/kernels/spmv_bsr.py:51"),
    "spmv_ell_packed": (
        "src/repro_torch/kernels/csrc/spmv_ell_packed.cu",
        "src/repro/kernels/spmv_ell_packed.py:104",
    ),
    "mixed_dot": ("src/repro_torch/kernels/csrc/mixed_dot.cu", "src/repro/kernels/mixed_dot.py:51"),
}
KERNEL_ORDER = tuple(KERNEL_META)


def reset_launches():
    for fn in kernel_modules().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_modules().items()}


def close(got: torch.Tensor, want: torch.Tensor, rtol: float, scale=None) -> float:
    """Max abs error; checks it against ``rtol * scale`` (``scale`` defaults
    to max |want|: the kernels and plain versions sum in different orders)."""
    err = float((got.double() - want.double()).abs().max())
    s = float(want.double().abs().max()) if scale is None else float(scale)
    check(err <= rtol * max(s, 1e-300), f"error {err:.3e} > {rtol:.0e} * {s:.3e}")
    return err


def bound(bytes_moved: int, flops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(road, block_csr) -> dict:
    """Phase 2: every kernel vs its plain version at the main path's shapes."""
    from repro_torch.kernels import ref
    from repro_torch.sparse import to_device_bsr, to_device_ell

    fns = kernel_modules()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    ell = to_device_ell(road, dtype=torch.float64, device=dev)  # layout of the main path
    rows, width = ell.val.shape
    x64 = torch.randn(road.n, generator=g, dtype=torch.float64, device=dev)
    v64 = torch.randn(road.n, generator=g, dtype=torch.float64, device=dev)
    print(f"[kernels] ELL layout {rows} x {width} (road, n={road.n:,}, nnz={road.nnz:,})")
    for name in ("spmv_ell", "spmv_ell_alpha"):
        rec = None
        for S, A in PAIRS:
            val, x, v = ell.val.to(S), x64.to(S), v64.to(A)
            if name == "spmv_ell":
                run = lambda: fns[name](val, ell.col, x, accum_dtype=A)  # noqa: E731
                plain = lambda: ref.spmv_ell_ref(val, ell.col, x, A)  # noqa: E731
                y, yr = run(), plain()
                err = close(y, yr, RTOL[A])
            else:
                run = lambda: fns[name](val, ell.col, x, v, accum_dtype=A)  # noqa: E731
                plain = lambda: ref.spmv_ell_alpha_ref(val, ell.col, x, v, A)  # noqa: E731
                (w, al), (wr, alr) = run(), plain()
                err = close(w, wr, RTOL[A])
                terms = float((v.double().abs() * wr[: road.n].double().abs()).sum())
                err = max(err, close(al.reshape(1), alr.reshape(1), RTOL[A], scale=terms))
                # One row code: w is spmv_ell's y bit for bit; alpha's sums run
                # in an order fixed by the grid, so five calls give its bits.
                check(torch.equal(w, fns["spmv_ell"](val, ell.col, x, accum_dtype=A)),
                      f"spmv_ell_alpha ({dname(S)}, {dname(A)}): w differs from spmv_ell's y")
                check(all(torch.equal(run()[1], al) for _ in range(4)),
                      f"spmv_ell_alpha ({dname(S)}, {dname(A)}): alpha differs between calls")
            print(f"[kernels] {name} ({dname(S)}, {dname(A)}): max_abs_err {err:.3e} ok"
                  + ("; w == spmv_ell's y; alpha bits equal on 5 calls"
                     if name == "spmv_ell_alpha" else ""))
            if (S, A) == MAIN_PAIR:
                moved = nbytes(val, ell.col, x) + rows * A.itemsize
                if name == "spmv_ell_alpha":
                    moved += nbytes(v) + A.itemsize
                flops = 2.0 * road.nnz + (2.0 * road.n if name == "spmv_ell_alpha" else 0.0)
                t_b, by = bound(moved, flops, A)
                lib = None
                if name == "spmv_ell":
                    csr_t = torch.sparse_csr_tensor(
                        torch.as_tensor(road.indptr.astype(np.int32), device=dev),
                        torch.as_tensor(road.indices.astype(np.int32), device=dev),
                        torch.as_tensor(road.data, dtype=S, device=dev),
                        size=road.shape,
                    )
                    lib = lambda: csr_t @ x  # noqa: E731
                rec = timed(run, plain, lib, err, t_b, by)
        out[name] = rec

    # lanczos_update at the main path's vector length; FDF carries f64 vectors.
    n = road.n
    w64, vv64, vp64 = (torch.randn(n, generator=g, dtype=torch.float64, device=dev) for _ in range(3))
    rec = None
    for S, A in PAIRS:
        w, v, vp = w64.to(S), vv64.to(S), vp64.to(S)
        a = torch.tensor(0.37, dtype=A, device=dev)
        b = torch.tensor(1.21, dtype=A, device=dev)
        run = lambda: fns["lanczos_update"](w, v, vp, a, b, accum_dtype=A)  # noqa: E731
        plain = lambda: ref.lanczos_update_ref(w, v, vp, a, b, A)  # noqa: E731
        (u, nr), (ur, nrr) = run(), plain()
        # u is rounded to S: allow one rounding of S on top of the accum order.
        u_tol = max(RTOL[A], float(torch.finfo(S).eps))
        err = close(u, ur, u_tol)
        close(nr.reshape(1), nrr.reshape(1), RTOL[A])
        print(f"[kernels] lanczos_update ({dname(S)}, {dname(A)}): max_abs_err {err:.3e} ok")
        if (S, A) == (torch.float64, torch.float64):
            t_b, by = bound(nbytes(w, v, vp, u) + 4 * A.itemsize, 6.0 * n, A)
            rec = timed(run, plain, None, err, t_b, by)
    out["lanczos_update"] = rec

    bsr = to_device_bsr(block_csr, block_size=8, dtype=torch.float64, device=dev)
    nbr, slots, bs, _ = bsr.val.shape
    print(f"[kernels] BSR layout {nbr} x {slots} x {bs} x {bs} (n={block_csr.n:,}, nnz={block_csr.nnz:,})")
    xb64 = torch.randn(nbr * bs, generator=g, dtype=torch.float64, device=dev)
    rec = None
    for S, A in PAIRS:
        val, x = bsr.val.to(S), xb64.to(S)
        run = lambda: fns["spmv_bsr"](val, bsr.bcol, x, accum_dtype=A)  # noqa: E731
        plain = lambda: ref.spmv_bsr_ref(val, bsr.bcol, x, A)  # noqa: E731
        err = close(run(), plain(), RTOL[A])
        print(f"[kernels] spmv_bsr ({dname(S)}, {dname(A)}): max_abs_err {err:.3e} ok")
        if (S, A) == MAIN_PAIR:
            t_b, by = bound(nbytes(val, bsr.bcol, x) + nbr * bs * A.itemsize, 2.0 * val.numel(), A)
            rec = timed(run, plain, library_bsr(block_csr, S, x), err, t_b, by)
    out["spmv_bsr"] = rec
    return out


def timed(run, plain, lib, err, t_b, by) -> dict:
    """A kernel's record: series and device times of the kernel (and the
    device us per call of each of its launches and memsets) and of its
    library yardstick ``lib`` (None where no single call computes the same
    function), the plain version's series time, and the bound."""
    parts: dict = {}
    return {
        "max_abs_err": err,
        "ms": time_ms(run),
        "device_ms": device_ms(run, tag="kernel", parts=parts),
        "device_parts_us": parts,
        "plain_ms": time_ms(plain),
        "bound_ms": t_b,
        "bound_by": by,
        "library_ms": None if lib is None else time_ms(lib),
        "library_device_ms": None if lib is None else device_ms(lib, tag="library"),
    }


def library_bsr(block_csr, dtype, x):
    """One PyTorch call for the BSR product (a yardstick, never used by the
    port): ``torch.sparse_bsr_tensor`` times the vector; None when this
    build of PyTorch has no BSR matrix-vector product for ``dtype``."""
    dev = x.device
    m = block_csr.to_scipy().tobsr(blocksize=(8, 8))
    bsr_t = torch.sparse_bsr_tensor(
        torch.as_tensor(m.indptr.astype(np.int64), device=dev),
        torch.as_tensor(m.indices.astype(np.int64), device=dev),
        torch.as_tensor(m.data, dtype=dtype, device=dev),
        size=m.shape,
    )
    try:
        torch.mv(bsr_t, x)
    except (RuntimeError, NotImplementedError) as exc:
        print(f"[kernels] spmv_bsr library yardstick unavailable: {type(exc).__name__}: {exc}")
        return None
    return lambda: torch.mv(bsr_t, x)


def ell_chunk(csr, r0: int, r1: int):
    """Rows ``[r0, r1)`` of a host CSR as the chunked operator stages them:
    an ELL chunk with rows and width padded to 8, values rounded to f32."""
    from repro_torch.sparse import CSR, to_device_ell

    lo, hi = int(csr.indptr[r0]), int(csr.indptr[r1])
    sub = CSR(indptr=csr.indptr[r0 : r1 + 1] - lo, indices=csr.indices[lo:hi],
              data=csr.data[lo:hi], shape=(r1 - r0, r1 - r0))
    ell = to_device_ell(sub, dtype=torch.float32, device="cpu")
    return ell.val.numpy(), ell.col.numpy()


def phase_kernels_chunked(big, small, web) -> dict:
    """Phase 2, the chunked path's kernels: ``spmv_ell_packed`` on a real
    chunk of phase 8's matrix (int32 deltas), on a one-chunk road network
    whose deltas fit int16 and on the rows of phase 4's hub, for both value
    dtypes and every (storage, accum) pair; ``mixed_dot`` at
    n = 4,194,304."""
    from repro_torch.core.operators import chunk_row_bounds
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_ell_packed import pack_ell_chunk

    fns = kernel_modules()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    out = {}
    r0, r1 = chunk_row_bounds(big.indptr, big.n, 1 << 20)[0]
    chunks = {"int32": (ell_chunk(big, r0, r1), big.n), "int16": (ell_chunk(small, 0, small.n), small.n)}
    rec = None
    for want_idx, ((val, col), n_x) in chunks.items():
        x64 = torch.randn(n_x, generator=g, dtype=torch.float64, device=dev)
        for mode in ("bf16", "fp8"):
            packed = [t.to(dev) for t in pack_ell_chunk(val, col, mode)]
            idx = str(packed[3].dtype).replace("torch.", "")
            check(idx == want_idx, f"packed chunk deltas are {idx}, expected {want_idx}")
            rows, width = packed[0].shape
            for S, A in PAIRS:
                x = x64.to(S)
                run = lambda: fns["spmv_ell_packed"](*packed, x, accum_dtype=A)  # noqa: E731
                plain = lambda: ref.spmv_ell_packed_ref(*packed, x, A)  # noqa: E731
                err = close(run(), plain(), RTOL[A])
                print(f"[kernels] spmv_ell_packed {rows} x {width} ({mode}, {idx}, {dname(S)}, "
                      f"{dname(A)}): max_abs_err {err:.3e} ok")
                if (mode, idx, S, A) == ("bf16", "int32", *MAIN_PAIR):
                    nnz = int(np.count_nonzero(val))
                    touched = int(np.unique(col[val != 0]).size)
                    moved = nbytes(*packed) + touched * S.itemsize + rows * A.itemsize
                    t_b, by = bound(moved, 3.0 * nnz, A)
                    rec = timed(run, plain, None, err, t_b, by)
    out["spmv_ell_packed"] = rec
    packed_hub_check(web, g)
    out["spmv_ell_chunk"] = chunk_ell_record(big, (r0, r1), chunks["int32"][0], g)

    n = 1 << 22
    a64, b64 = (torch.randn(n, generator=g, dtype=torch.float64, device=dev) for _ in range(2))
    rec = None
    for S in (torch.float32, torch.bfloat16, torch.float16, torch.float64):
        a, b = a64.to(S), b64.to(S)
        terms = float((a.double() * b.double()).abs().sum())
        for A in (torch.float32, torch.float64):
            for comp in (False, True):
                run = lambda: fns["mixed_dot"](a, b, accum_dtype=A, compensated=comp)  # noqa: E731
                plain = lambda: ref.mixed_dot_ref(a, b, A, compensated=comp)  # noqa: E731
                got, want = run(), plain()
                err = float((got.double().sum() - want.double().sum()).abs())
                check(err <= RTOL[A] * terms, f"mixed_dot {S}/{A}: error {err:.3e} vs {terms:.3e}")
                # The 0-d entry point returns the same sum.
                check(float(ops.mixed_dot(a, b, A, comp)) == float(got.sum()), "ops.mixed_dot")
                print(f"[kernels] mixed_dot n={n:,} ({dname(S)}, {dname(A)}, compensated={comp}): "
                      f"abs err {err:.3e} (sum |a b| {terms:.3e}) ok")
                if (S, A, comp) == (torch.float32, torch.float32, False):
                    t_b, by = bound(nbytes(a, b) + 2 * A.itemsize, 2.0 * n, A)
                    rec = timed(run, plain, lambda: torch.dot(a, b), err, t_b, by)
                    rec["shape"] = f"L2-resident: n={n:,}, f32, acc f32"
    del a64, b64, a, b
    rec["out_of_l2"] = mixed_dot_out_of_l2(big.n, g)
    out["mixed_dot"] = rec
    return out


def packed_hub_check(web, g) -> None:
    """``spmv_ell_packed`` on a packed chunk that holds the web graph's widest
    row (its hub): rows ``[hub, hub + 8)``, the width the hub's nnz padded
    to 8, which takes the kernel's wide path; bf16 and fp8, every pair,
    against the plain version.  The hub's row sums a million products that
    cancel, so the error of the sum order is held to ``RTOL`` of the largest
    row sum of |products|, not of |y|."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.spmv_ell_packed import pack_ell_chunk, packed_launch_plan

    fn = kernel_modules()["spmv_ell_packed"]
    dev = torch.device("cuda")
    hub = int(web.row_nnz().argmax())
    val, col = ell_chunk(web, hub, min(hub + 8, web.n))
    x64 = torch.randn(web.n, generator=g, dtype=torch.float64, device=dev)
    for mode in ("bf16", "fp8"):
        packed = [t.to(dev) for t in pack_ell_chunk(val, col, mode)]
        rows, width = packed[0].shape
        aligned = (packed[0].data_ptr() | packed[3].data_ptr()) % 16 == 0
        path = packed_launch_plan(width, packed[3].element_size(), aligned)[1]
        check(path == "wide", f"hub chunk {rows} x {width} planned {path}, expected wide")
        idx = dname(packed[3].dtype)
        for S, A in PAIRS:
            x = x64.to(S)
            terms = ref.spmv_ell_packed_ref(packed[0].double().abs(), *packed[1:],
                                            x.double().abs(), torch.float64)
            want = ref.spmv_ell_packed_ref(*packed, x, A)
            err = close(fn(*packed, x, accum_dtype=A), want, RTOL[A], scale=float(terms.max()))
            print(f"[kernels] spmv_ell_packed hub rows {hub:,}+{rows} x {width:,} ({mode}, {idx}, "
                  f"{dname(S)}, {dname(A)}, {path} path): max_abs_err {err:.3e} (sum |products| "
                  f"{float(terms.max()):.3e}) ok")


def chunk_ell_record(big, rows_range, chunk, g) -> dict:
    """``spmv_ell`` (val f32, acc f64) on one chunk of phase 8's matrix (rows
    ``rows_range``), the chunked path's launch shape: device time per launch
    and its bound, beside cuSPARSE's CSR product of the same rows (f32, a
    yardstick as on the main path)."""
    from repro_torch.kernels import ref

    fn = kernel_modules()["spmv_ell"]
    dev = torch.device("cuda")
    val, col = (torch.as_tensor(t, device=dev) for t in chunk)
    x = torch.randn(big.n, generator=g, dtype=torch.float32, device=dev)
    rows, width = val.shape
    run = lambda: fn(val, col, x, accum_dtype=torch.float64)  # noqa: E731
    err = close(run(), ref.spmv_ell_ref(val, col, x, torch.float64), RTOL[torch.float64])
    touched = int(torch.unique(col[val != 0]).numel())
    t_b, by = bound(nbytes(val, col) + touched * x.element_size() + rows * 8, 2.0 * int((val != 0).sum()),
                    torch.float64)
    r0, r1 = rows_range
    lo, hi = int(big.indptr[r0]), int(big.indptr[r1])
    csr_t = torch.sparse_csr_tensor(
        torch.as_tensor((big.indptr[r0 : r1 + 1] - lo).astype(np.int32), device=dev),
        torch.as_tensor(big.indices[lo:hi].astype(np.int32), device=dev),
        torch.as_tensor(big.data[lo:hi], dtype=torch.float32, device=dev),
        size=(r1 - r0, big.n),
    )
    lib = lambda: csr_t @ x  # noqa: E731
    close(lib(), run()[: r1 - r0], RTOL[torch.float32])
    plain = lambda: ref.spmv_ell_ref(val, col, x, torch.float64)  # noqa: E731
    rec = {"rows": rows, "width": width, "max_abs_err": err, "ms": time_ms(run),
           "device_ms": device_ms(run, tag="chunk"), "plain_ms": time_ms(plain), "bound_ms": t_b,
           "bound_by": by, "library_ms": time_ms(lib),
           "library_device_ms": device_ms(lib, tag="chunk library")}
    print(f"[kernels] spmv_ell on one chunk {rows} x {width} (f32, f64): max_abs_err {err:.3e}; "
          f"device {rec['device_ms']:.4f} ms, series {rec['ms']:.4f} ms, bound {t_b:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms; "
          f"cuSPARSE CSR f32 on its {r1 - r0:,} rows: device {rec['library_device_ms']:.4f} ms, "
          f"series {rec['library_ms']:.4f} ms")
    return rec


def mixed_dot_out_of_l2(n: int, g) -> dict:
    """``mixed_dot`` at phase 8's Gram shape (n = 14,077,504 rows, f32
    eigenvectors, f64 accumulation; 113 MB of operands, more than the 50 MB
    L2), uncompensated and compensated: the kernel on operands of whole
    4096-element tiles (n rounded up, the tail zero), and ``ops.mixed_dot``
    on the first n elements, as phase 8 calls it.  Series and device times
    per call, against ``torch.dot`` of the same dtype (the uncompensated
    function)."""
    from repro_torch.kernels import ops, ref

    fn = kernel_modules()["mixed_dot"]
    dev = torch.device("cuda")
    n_pad = n + (-n) % 4096
    a, b = (torch.randn(n_pad, generator=g, dtype=torch.float32, device=dev) for _ in range(2))
    a[n:], b[n:] = 0.0, 0.0
    an, bn = a[:n], b[:n]
    terms = float((an.double() * bn.double()).abs().sum())
    rec = {"n": n, "kernel_n": n_pad, "dtype": "float32", "accum": "float64"}
    for comp in (False, True):
        run = lambda: fn(a, b, accum_dtype=torch.float64, compensated=comp)  # noqa: E731
        entry = lambda: ops.mixed_dot(an, bn, torch.float64, comp)  # noqa: E731
        want = ref.mixed_dot_ref(a, b, torch.float64, compensated=comp)
        got = run()
        err = float((got.sum() - want.sum()).abs())
        check(err <= RTOL[torch.float64] * terms, f"mixed_dot out of L2: error {err:.3e} vs {terms:.3e}")
        check(float(entry()) == float(got.sum()), "mixed_dot out of L2: ops.mixed_dot != padded kernel")
        plain = lambda: ref.mixed_dot_ref(a, b, torch.float64, compensated=comp)  # noqa: E731
        rec["compensated" if comp else "uncompensated"] = {
            "max_abs_err": err, "ms": time_ms(run), "device_ms": device_ms(run, tag="kernel"),
            "entry_ms": time_ms(entry), "entry_device_ms": device_ms(entry, tag="ops.mixed_dot"),
            "plain_ms": time_ms(plain)}
    t_b, by = bound(nbytes(an, bn) + 16, 2.0 * n, torch.float64)
    rec.update(bound_ms=t_b, bound_by=by, library_ms=time_ms(lambda: torch.dot(an, bn)),
               library_device_ms=device_ms(lambda: torch.dot(an, bn), tag="torch.dot"))
    u, c = rec["uncompensated"], rec["compensated"]
    print(f"[kernels] mixed_dot n={n:,} (float32, float64), out of L2: kernel device "
          f"{u['device_ms']:.4f} ms (compensated {c['device_ms']:.4f}); ops.mixed_dot device "
          f"{u['entry_device_ms']:.4f} ms (compensated {c['entry_device_ms']:.4f}); torch.dot "
          f"{rec['library_device_ms']:.4f} ms; bound {t_b:.4f} ms; plain {u['plain_ms']:.4f} ms "
          f"(compensated {c['plain_ms']:.4f})")
    return rec


# ---------------------------------------------------------------- eigensolves


def solve(A, dev, v0, **kw):
    """One cold ``repro_torch.eigsh`` call (the session cache cleared first,
    so it prepares anew), its wall time and its kernel launches."""
    import repro_torch

    repro_torch.session_cache_clear()
    reset_launches()
    t0 = time.perf_counter()
    res = repro_torch.eigsh(A, k=K, v0=v0, device=dev, **kw)
    if dev == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, read_launches()


def check_eigs(tag, gpu, cpu, rtol):
    """Max difference of two solves' eigenvalues, relative to |lambda|max.
    Compared as sorted values: the road networks' +-lambda pairs differ in
    magnitude by ~1e-5, so a perturbation of that size (fp8 staging) may
    list the two members of a pair in either order."""
    eg = np.sort(gpu.eigenvalues.double().cpu().numpy())
    ec = np.sort(cpu.eigenvalues.double().cpu().numpy())
    check(eg.shape == (K,) and np.isfinite(eg).all(), f"{tag}: bad eigenvalues {eg}")
    check(tuple(gpu.eigenvectors.shape) == (gpu.n, K), f"{tag}: eigenvectors {gpu.eigenvectors.shape}")
    err = float(np.abs(eg - ec).max() / np.abs(ec).max())
    check(err <= rtol, f"{tag}: eigenvalues differ from the other solve by {err:.3e} > {rtol:.0e}")
    return err


def eig_rel_err(tag, got, want, rtol):
    """Max difference of two sorted eigenvalue tensors, relative to
    |lambda|max (the legacy ``EigResult`` has no ``n``)."""
    g = np.sort(got.double().cpu().numpy())
    w = np.sort(want.double().cpu().numpy())
    check(g.shape == (K,) and np.isfinite(g).all(), f"{tag}: bad eigenvalues {g}")
    err = float(np.abs(g - w).max() / np.abs(w).max())
    check(err <= rtol, f"{tag}: eigenvalues differ by {err:.3e} > {rtol:.0e}")
    return err


def check_residuals(tag, res, A):
    """True residuals ||A x - lambda x|| (scipy, f64) against the Ritz bounds."""
    X = res.eigenvectors.double().cpu().numpy()
    lam = res.eigenvalues.double().cpu().numpy()
    true = np.linalg.norm(A.to_scipy() @ X - X * lam, axis=0)
    gap = np.abs(true - res.residuals)
    ok = gap <= 1e-4 * np.abs(lam).max() + 1e-3 * res.residuals
    check(bool(ok.all()), f"{tag}: true residuals {true} vs bounds {res.residuals}")
    return float(gap.max())


def phase_main(road, v0, smi):
    res, wall, launches = solve(road, "cuda", v0)
    print(f"[main] eigsh(road n={road.n:,} nnz={road.nnz:,}, k={K}) policy={res.policy} "
          f"format={res.spmv_format} backend={res.backend} plan="
          f"{res.partition['spmv']['iteration_plan']['effective']} launches={launches} "
          f"wall {wall:.3f} s (cold, conversion included) on {smi}")
    check(res.spmv_format == "ell", f"main path picked {res.spmv_format}, expected ell")
    check(res.backend == "single", f"backend {res.backend}")
    check(launches["spmv_ell"] == K and launches["lanczos_update"] == K,
          f"main path launches {launches}, expected {K} spmv_ell and {K} lanczos_update")
    cpu, cwall, _ = solve(road, "cpu", v0)
    err = check_eigs("main", res, cpu, 1e-9)
    gap = check_residuals("main", res, road)
    print(f"[main] eigenvalues {np.round(res.eigenvalues.cpu().numpy(), 6).tolist()}")
    print(f"[main] vs host solve: max rel err {err:.3e} (<= 1e-9); residual bound gap {gap:.3e}; "
          f"host solve {cwall:.2f} s")
    return res, launches


def check_loop_never_syncs(tag, A, policy_name):
    """Run the Lanczos loop with CUDA sync debugging set to "error": any
    device->host read inside the loop raises."""
    from repro_torch.core.lanczos import lanczos_tridiag, ops_for_operator
    from repro_torch.core.operators import make_operator
    from repro_torch.core.precision import POLICIES
    from repro_torch.kernels.engine import make_engine

    pol = POLICIES[policy_name]
    eng = make_engine(A, accum_dtype=pol.phase_dtype("spmv"), device="cuda")
    op = make_operator(A, dtype=pol.storage, engine=eng)
    ops = ops_for_operator(op, pol, device="cuda")
    v1 = torch.randn(A.n, dtype=pol.compute, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lanczos_tridiag(op.bound_matvec(pol), v1, K, pol, ops=ops)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[{tag}] Lanczos loop ({eng.format}, {policy_name}, "
          f"{eng.iteration_plan.update}): no device->host sync in {K} steps")


def staging_line(res) -> str:
    st = res.partition["spmv"]["staging"]
    return (f"mode {st['mode']}, transfers {st['transfers']}, bytes_staged {st['bytes_staged']:,}, "
            f"bytes_plain {st['bytes_plain']:,}, stage_s {st['stage_s']:.3f}, effective "
            f"{st['effective_bandwidth_gbps']:.3f} GB/s, compression {st['compression_ratio']:.4f}, "
            f"max_resident {st['max_resident']}")


def check_chunked(tag, res, launches, kernel, mode):
    part = res.partition
    st = part["spmv"]["staging"]
    check(res.backend == "chunked", f"{tag}: backend {res.backend}, expected chunked")
    check(res.spmv_format == "ell", f"{tag}: format {res.spmv_format}, expected ell")
    check(st["mode"] == mode, f"{tag}: staging mode {st['mode']}, expected {mode}")
    want = part["num_chunks"] * K
    other = "spmv_ell" if kernel == "spmv_ell_packed" else "spmv_ell_packed"
    check(launches[kernel] == want and launches[other] == 0 and launches["lanczos_update"] == K,
          f"{tag}: launches {launches}, expected {want} {kernel} and {K} lanczos_update")
    check(st["max_resident"] <= part["stage_depth"] + 1,
          f"{tag}: {st['max_resident']} chunks resident > stage_depth + 1")
    check(st["transfers"] == want, f"{tag}: {st['transfers']} transfers, expected {want}")


def compression_range(csr, chunk_nnz: int, storage_bytes: int, value_bytes: int):
    """The compression ratio packed staging must show on this matrix: every
    chunk's deltas in int32 (low end) or all in int16 (high end)."""
    from repro_torch.core.operators import chunk_row_bounds, chunk_rows_pad

    row_nnz = csr.row_nnz()
    plain = lo = hi = 0
    for r0, r1 in chunk_row_bounds(csr.indptr, csr.n, chunk_nnz):
        rows, width = chunk_rows_pad(r1 - r0), -(-max(1, int(row_nnz[r0:r1].max())) // 8) * 8
        plain += rows * width * (storage_bytes + 4)
        lo += rows * width * (value_bytes + 4) + 8 * rows
        hi += rows * width * (value_bytes + 2) + 8 * rows
    return plain / lo, plain / hi


def device_split(sess, v0) -> dict:
    """One profiled warm solve of a chunked session: device milliseconds of
    host->device copies, of the SpMV kernels and of everything else on the
    card, with the solve's wall time and its host staging seconds."""
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        res = sess.eigsh(K, v0=v0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = {"h2d_ms": 0.0, "spmv_ms": 0.0, "other_ms": 0.0}
    for e in device_events(prof):
        t = e.time_range.elapsed_us() / 1e3
        if "HtoD" in e.name:
            split["h2d_ms"] += t
        elif "spmv_ell" in e.name:
            split["spmv_ms"] += t
        else:
            split["other_ms"] += t
    split["wall_ms"] = wall * 1e3
    split["stage_ms"] = res.partition["staging"]["stage_s"] * 1e3
    return split


def phase_chunked(road, v0, path, smi) -> tuple:
    """Phase 8: the default call on a diskcsr path above the chunk threshold."""
    import repro_torch
    from repro_torch.kernels import ops

    res, wall, launches = solve(path, "cuda", v0)
    part = res.partition
    print(f"[chunked] eigsh(diskcsr road n={road.n:,} nnz={road.nnz:,}, k={K}) backend={res.backend} "
          f"format={res.spmv_format} chunks={part['num_chunks']} stage_depth={part['stage_depth']} "
          f"disk_backed={part['disk_backed']} launches={launches} wall {wall:.3f} s (cold) on {smi}")
    check(part["disk_backed"], "chunked: the diskcsr input is not disk-backed")
    check_chunked("chunked", res, launches, "spmv_ell", "f32")
    print(f"[chunked] staging: {staging_line(res)}")
    single, swall, sl = solve(road, "cuda", v0, backend="single")
    check(single.backend == "single" and sl["spmv_ell"] == K, f"single backend launches {sl}")
    err = check_eigs("chunked", res, single, 1e-9)
    gap = check_residuals("chunked", res, road)
    print(f"[chunked] eigenvalues {np.round(res.eigenvalues.cpu().numpy(), 6).tolist()}")
    print(f"[chunked] vs backend='single' (in-RAM CSR, {swall:.2f} s cold): max rel err {err:.3e} "
          f"(<= 1e-9); residual bound gap {gap:.3e}")

    # The Gram matrix of the eigenvectors through mixed_dot's entry point.
    xt = res.eigenvectors.T.contiguous()
    reset_launches()
    gram = torch.stack([torch.stack([ops.mixed_dot(xt[i], xt[j], torch.float64, True)
                                     for j in range(K)]) for i in range(K)])
    dot_launches = read_launches()["mixed_dot"]
    want = xt.double() @ xt.double().T
    terms = xt.double().abs() @ xt.double().abs().T
    check(bool(((gram - want).abs() <= 1e-12 * terms).all()), "mixed_dot Gram matrix")
    check(dot_launches == K * K, f"mixed_dot launches {dot_launches}, expected {K * K}")
    ortho = float((gram - torch.eye(K, dtype=torch.float64, device=gram.device)).abs().max())
    print(f"[chunked] eigenvector Gram matrix by ops.mixed_dot (f64, compensated): "
          f"launches {dot_launches}, max |X^T X - I| {ortho:.3e}; matches an f64 matmul ok")

    sess = repro_torch.prepare(path, device="cuda")
    sess.eigsh(K, v0=v0)  # warm-up: windows allocated, pinned
    split = device_split(sess, v0)
    print(f"[chunked] warm solve split (profiled): wall {split['wall_ms']:.1f} ms; host staging "
          f"(chunk build + copy launch) {split['stage_ms']:.1f} ms; on the card: H2D copies "
          f"{split['h2d_ms']:.2f} ms, spmv_ell {split['spmv_ms']:.2f} ms, other "
          f"{split['other_ms']:.2f} ms; rest of the wall {split['wall_ms'] - split['stage_ms']:.1f} "
          f"ms; on {smi}")
    return res, launches, dot_launches


def phase_packed(road, v0, path, f32_res, smi) -> dict:
    """Phase 9: packed staging on the same matrix, and fp8 exactness on a
    smaller one against the host."""
    from repro_torch.sparse import generate

    out = {}
    for tag, kw, value_bytes, storage_bytes, tol in (
        ("bf16 FDF", {"staging": "bf16"}, 2, 4, 8e-3),
        ("fp8 FDF", {"staging": "fp8"}, 1, 4, 8e-2),
        ("auto BFF", {"policy": "BFF", "staging": "auto"}, 2, 2, 8e-3),
    ):
        res, wall, launches = solve(path, "cuda", v0, **kw)
        mode = kw["staging"] if kw["staging"] != "auto" else "bf16"
        check_chunked(tag, res, launches, "spmv_ell_packed", mode)
        ratio = res.partition["spmv"]["staging"]["compression_ratio"]
        lo, hi = compression_range(road, 1 << 20, storage_bytes, value_bytes)
        check(lo - 1e-9 <= ratio <= hi + 1e-9, f"{tag}: compression {ratio} outside [{lo}, {hi}]")
        err = check_eigs(tag, res, f32_res, tol)
        print(f"[packed] {tag}: launches={launches} wall {wall:.3f} s; {staging_line(res)} "
              f"(expected in [{lo:.4f}, {hi:.4f}]); vs f32 staging: max rel err {err:.3e} "
              f"(<= {tol:.0e}) on {smi}")
        out[tag] = launches

    small = generate("road", 1 << 20, 2.1, seed=0)
    v_small = np.random.default_rng(3).standard_normal(small.n)
    kw = {"backend": "chunked", "staging": "fp8", "chunk_nnz": 1 << 18}
    gpu, _, gl = solve(small, "cuda", v_small, **kw)
    check_chunked("fp8 small", gpu, gl, "spmv_ell_packed", "fp8")
    cpu, cwall, _ = solve(small, "cpu", v_small, **kw)
    err = check_eigs("fp8 small", gpu, cpu, 1e-9)
    print(f"[packed] fp8 on road n={small.n:,} (chunk_nnz 1 << 18, {gpu.partition['num_chunks']} "
          f"chunks): card vs host chunked solve max rel err {err:.3e} (<= 1e-9); host {cwall:.2f} s")
    return out


def check_restarted_residuals(tag, res, A, tol):
    """True residuals ||A x - lambda x|| (scipy, f64) of a restarted solve:
    every pair against its bound with phase 3's gap rule, and every pair
    flagged converged against ``tol * |lambda|``, with room for the
    eigenvectors' rounding to the output dtype (4 eps |lambda|max)."""
    X = res.eigenvectors.double().cpu().numpy()
    lam = res.eigenvalues.double().cpu().numpy()
    true = np.linalg.norm(A.to_scipy() @ X - X * lam, axis=0)
    scale = np.abs(lam).max()
    gap = np.abs(true - res.residuals)
    check(bool((gap <= 1e-4 * scale + 1e-3 * res.residuals).all()),
          f"{tag}: true residuals {true} vs bounds {res.residuals}")
    eps = float(torch.finfo(res.eigenvectors.dtype).eps)
    conv = np.asarray(res.converged)
    ok = true[conv] <= tol * np.abs(lam[conv]) + 4 * eps * scale
    check(bool(ok.all()), f"{tag}: converged pairs' true residuals {true[conv]} exceed tol {tol}")
    return true / np.maximum(np.abs(lam), 1e-300)


def phase_restarted(road, web, v_road, smi) -> None:
    """Phase 10: ``tol=`` (the restarted backend) at full width, its parity
    with the host, ``policy="auto"``, the session cache and ``eigsh_many``."""
    import repro_torch
    from repro_torch.core.precision import POLICIES
    from repro_torch.sparse import generate

    tol = 1e-6
    # (a) full-width restarted solve
    res, wall, launches = solve(road, "cuda", None, tol=tol)
    print(f"[restarted] eigsh(road n={road.n:,}, k={K}, tol={tol:g}) policy={res.policy} "
          f"backend={res.backend} format={res.spmv_format} iterations={res.iterations} "
          f"restarts={res.restarts} converged={res.converged.astype(int).tolist()} "
          f"launches={launches} wall {wall:.3f} s (cold) on {smi}")
    check(res.backend == "restarted", f"tol= ran backend {res.backend}, expected restarted")
    check(res.spmv_format == "ell", f"restarted road picked {res.spmv_format}, expected ell")
    check(launches["spmv_ell"] == res.iterations and launches["lanczos_update"] == 0,
          f"restarted launches {launches}, expected {res.iterations} spmv_ell and no lanczos_update")
    rel = check_restarted_residuals("restarted", res, road, tol)
    exhausted = not res.all_converged
    e2 = {"float_kind": lambda x: f"{x:.2e}"}
    print(f"[restarted] eigenvalues {np.round(res.eigenvalues.cpu().numpy(), 6).tolist()}; bounds "
          f"{np.array2string(res.residuals, formatter=e2)}; true relative residuals "
          f"{np.array2string(rel, formatter=e2)}; "
          + (f"max_restarts exhausted: {int(res.converged.sum())} of {K} pairs converged, the "
             "checks cover the bounds it reports" if exhausted else "all pairs converged")
          + f"; solve {res.timings['solve_s']:.3f} s, prepare {res.timings['prepare_s']:.3f} s")

    # (b) the same call on the card and on the host
    mid = generate("road", 1 << 20, 2.1, seed=0)
    gpu, gwall, gl = solve(mid, "cuda", None, tol=tol)
    cpu, cwall, _ = solve(mid, "cpu", None, tol=tol)
    check((gpu.iterations, gpu.restarts) == (cpu.iterations, cpu.restarts),
          f"restarted card {gpu.iterations}/{gpu.restarts} vs host {cpu.iterations}/{cpu.restarts}")
    check(gl["spmv_ell"] == gpu.iterations, f"restarted road 1M launches {gl}")
    err = check_eigs("restarted 1M", gpu, cpu, 1e-9)
    print(f"[restarted] road n={mid.n:,}, tol={tol:g}: card and host both {gpu.iterations} steps, "
          f"{gpu.restarts} restarts; eigenvalues max rel err {err:.3e} (<= 1e-9); card {gwall:.2f} s, "
          f"host {cwall:.2f} s")

    # (c) policy="auto"
    repro_torch.session_cache_clear()
    t0 = time.perf_counter()
    auto = repro_torch.eigsh(web, K, policy="auto", tol=1e-4, device="cuda")
    torch.cuda.synchronize()
    awall = time.perf_counter() - t0
    trail = auto.policy_escalations
    for a in trail:
        print(f"[auto]   rung {a['policy']}: max residual {a['max_residual']:.3e} "
              f"({a['residual_kind']}), tol {a['tol']:g}, accepted {a['converged']}")
    check(trail[-1]["converged"] and trail[-1]["residual_kind"] == "verified"
          and trail[-1]["max_residual"] <= 1e-4, f"auto: accepted rung {trail[-1]}")
    check(not any(a["converged"] for a in trail[:-1]), f"auto: an earlier rung passed: {trail}")
    check(auto.policy == trail[-1]["policy"], f"auto: result policy {auto.policy}")

    def plan(name):
        p = POLICIES[name]
        return (p.storage, p.phase_dtype("spmv"))

    seen = {plan(a["policy"]) for a in trail[:-1]}
    conv = auto.partition["spmv"]["conversions"]
    check((conv == 0) == (plan(auto.policy) in seen),
          f"auto: accepted rung {auto.policy} reports {conv} conversions")
    again = repro_torch.eigsh(web, K, policy="auto", tol=1e-4, device="cuda")
    check(again.session_reuse and again.partition["spmv"]["conversions"] == 0
          and [a["policy"] for a in again.policy_escalations] == [a["policy"] for a in trail],
          "auto: the repeat call rebuilt a plan or took other rungs")
    print(f"[auto] eigsh(web n={web.n:,}, k={K}, policy='auto', tol=1e-4): rungs "
          f"{[a['policy'] for a in trail]} -> {auto.policy} ({auto.iterations} steps, "
          f"{auto.restarts} restarts), conversions {conv}; wall {awall:.3f} s (cold); repeat "
          f"call reuses every plan, on {smi}")

    # (d) the session cache: a repeat call on the same matrix is warm
    first, cold_wall, _ = solve(road, "cuda", v_road)
    t0 = time.perf_counter()
    second = repro_torch.eigsh(road, k=K, v0=v_road, device="cuda")
    torch.cuda.synchronize()
    cached_wall = time.perf_counter() - t0
    check(second.session_reuse and second.timings["prepare_s"] == 0.0,
          f"cache: repeat call session_reuse={second.session_reuse}, timings {second.timings}")
    check(torch.equal(first.eigenvalues, second.eigenvalues), "cache: repeat call changed the bits")
    print(f"[cache] eigsh(road, k={K}, v0): cold {cold_wall:.3f} s (prepare "
          f"{first.timings['prepare_s']:.3f} s), cached {cached_wall:.3f} s (prepare 0, same bits); "
          f"{repro_torch.session_cache_info()} on {smi}")

    # (e) eigsh_many: queries grouped into shared sweeps
    sess = repro_torch.prepare(road, device="cuda")
    sweeps0 = sess.stats["sweeps"]
    reset_launches()
    many = sess.eigsh_many([{"k": 4, "v0": v_road}, {"k": K, "v0": v_road},
                            {"k": K, "policy": "FFF", "v0": v_road}])
    torch.cuda.synchronize()
    ml = read_launches()
    check(sess.stats["sweeps"] == sweeps0 + 2, f"eigsh_many: {sess.stats['sweeps'] - sweeps0} sweeps")
    err = check_eigs("eigsh_many k=8 FDF", many[1], first, 1e-9)
    check(torch.equal(many[0].eigenvalues, many[1].eigenvalues[:4]),
          "eigsh_many: the k=4 answer is not the first four of the shared sweep")
    print(f"[many] eigsh_many([k=4 FDF, k=8 FDF, k=8 FFF]): 2 sweeps, launches {ml}; k=8 FDF vs a "
          f"lone eigsh max rel err {err:.3e} (<= 1e-9), bits equal "
          f"{torch.equal(many[1].eigenvalues, first.eigenvalues)}; k=4 = first four of the sweep")


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def timed_saves():
    """Wrap ``SolveCheckpoint.save`` so every snapshot's seconds (the
    device->host copy and the npz write) land in the returned list; the
    returned function restores it."""
    from repro_torch.serving.store import SolveCheckpoint

    seconds, orig = [], SolveCheckpoint.save

    def save(self, token, state):
        t0 = time.perf_counter()
        out = orig(self, token, state)
        seconds.append(time.perf_counter() - t0)
        return out

    SolveCheckpoint.save = save

    def restore():
        SolveCheckpoint.save = orig

    return seconds, restore


def sync(dev) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def phase_robustness(road, central, block, path, v_road, v_central, v_block, main_res,
                     chunk_res, bsr_res, smi, dev="cuda", max_restarts=8, chunk_every=32,
                     chunk_fault=40) -> None:
    """Phase 11: solve robustness at full width: (a) a restarted solve
    killed at cycle 4 and resumed from its snapshot, (b) a chunked solve
    killed mid-step by a chunk I/O fault and resumed from its chunk cursor,
    (c) ``recovery="auto"`` under four faults, (d) ``jacobi="jax"``, (e) the
    legacy entry points."""
    import warnings

    import repro_torch
    from repro_torch.api import NumericalBreakdown
    from repro_torch.core import make_operator, topk_eigs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_ell_packed import pack_ell_chunk
    from repro_torch.serving import SolveCheckpoint
    from repro_torch.testing import faults

    def eigsh(A, v0, **kw):
        res = repro_torch.eigsh(A, k=K, v0=v0, device=dev, **kw)
        sync(dev)
        return res

    def same_bits(a, b):
        return torch.equal(a.eigenvalues, b.eigenvalues) and torch.equal(a.eigenvectors, b.eigenvectors)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    save_s, restore = timed_saves()
    try:
        # (a) restarted: uninterrupted, checkpointed, killed at cycle 4, resumed
        kw = {"tol": 1e-6, "max_restarts": max_restarts}
        solve(road, dev, v_road, **kw)  # cold: builds the plan
        t0 = time.perf_counter()
        plain = eigsh(road, v_road, **kw)
        plain_wall = time.perf_counter() - t0
        full_dir = os.path.join(tmp, "restarted_full")
        t0 = time.perf_counter()
        ck = eigsh(road, v_road, checkpoint_dir=full_dir, **kw)
        ck_wall = time.perf_counter() - t0
        full_saves = list(save_s)
        check(same_bits(ck, plain) and not SolveCheckpoint(full_dir).entries(),
              "restarted: the checkpointed run differs from the plain one or left a snapshot")
        check(len(full_saves) == plain.restarts, f"restarted: {len(full_saves)} saves, "
              f"expected one per restart ({plain.restarts})")
        crash_dir = os.path.join(tmp, "restarted_crash")
        with faults.inject("solve_crash@cycle=4"):
            try:
                eigsh(road, v_road, checkpoint_dir=crash_dir, **kw)
                raise CheckFailed("restarted: solve_crash@cycle=4 did not raise")
            except faults.InjectedCrash:
                pass
        entries = SolveCheckpoint(crash_dir).entries()
        check(len(entries) == 1, f"restarted: {len(entries)} snapshots after the crash")
        snap_bytes = dir_bytes(crash_dir)
        repro_torch.session_cache_clear()
        reset_launches()
        resumed = eigsh(road, v_road, checkpoint_dir=crash_dir, **kw)
        rl = read_launches()
        m = max(2 * K, K + 8)
        remaining = plain.iterations - m - 3 * (m - K)  # cycles 0-3 were saved
        check(same_bits(resumed, plain), "restarted: the resumed run's bits differ")
        check((resumed.iterations, resumed.restarts) == (plain.iterations, plain.restarts),
              f"restarted: resumed {resumed.iterations}/{resumed.restarts} vs plain "
              f"{plain.iterations}/{plain.restarts}")
        check(not SolveCheckpoint(crash_dir).entries(), "restarted: the snapshot survived the resume")
        check(rl["spmv_ell"] == remaining and rl["lanczos_update"] == 0,
              f"restarted resume launches {rl}, expected {remaining} spmv_ell, no lanczos_update")
        print(f"[robust] (a) restarted road n={road.n:,}, k={K}, tol=1e-6, max_restarts="
              f"{max_restarts}: {plain.iterations} steps, {plain.restarts} restarts; killed at cycle "
              f"4, resumed: same bits, same steps, snapshot cleared; resume launches {rl} "
              f"({remaining} remaining steps); snapshot {snap_bytes:,} bytes, save median "
              f"{np.median(full_saves):.4f} s (min {min(full_saves):.4f}, max {max(full_saves):.4f}, "
              f"{len(full_saves)} saves); warm wall plain {plain_wall:.3f} s, checkpointed "
              f"{ck_wall:.3f} s on {smi}")

        # (b) chunked: a chunk I/O fault mid-step, resumed from the chunk cursor
        # The fault stops the staging of chunk `chunk_fault`, after chunk
        # `chunk_fault - 1` was summed: the last cursor saved is below it.
        saved = chunk_fault // chunk_every * chunk_every - 1
        os.environ["REPRO_CHUNK_CKPT_EVERY"] = str(chunk_every)
        try:
            n0 = len(save_s)
            chunk_dir = os.path.join(tmp, "chunked")
            with faults.inject(f"chunk_io_error@chunk={chunk_fault}"):
                try:
                    eigsh(path, v_central, checkpoint_dir=chunk_dir)
                    raise CheckFailed(f"chunked: chunk_io_error@chunk={chunk_fault} did not raise")
                except faults.InjectedChunkIOError as exc:
                    check(isinstance(exc, OSError), "chunked: the chunk fault is not an OSError")
            store = SolveCheckpoint(chunk_dir)
            entries = store.entries()
            check(len(entries) == 1, f"chunked: {len(entries)} snapshots after the fault")
            snap = store.load(entries[0])
            check((snap["i"], snap["chunk"]) == (0, saved),
                  f"chunked: snapshot at step {snap['i']} chunk {snap.get('chunk')}, "
                  f"expected 0 / {saved}")
            c_bytes = dir_bytes(chunk_dir)
            del snap
            repro_torch.session_cache_clear()
            reset_launches()
            t0 = time.perf_counter()
            c_res = eigsh(path, v_central, checkpoint_dir=chunk_dir)
            c_wall = time.perf_counter() - t0
            cl = read_launches()
        finally:
            os.environ.pop("REPRO_CHUNK_CKPT_EVERY", None)
        chunk_saves = save_s[n0:]
        n_chunks = c_res.partition["num_chunks"]
        check(same_bits(c_res, chunk_res), "chunked: the resumed run's bits differ from phase 8's")
        check(not store.entries(), "chunked: the snapshot survived the resume")
        # Step 0 resumes after the saved chunk; steps 1..k-1 run whole.
        want = (n_chunks - saved - 1) + (K - 1) * n_chunks
        check(cl["spmv_ell"] == want, f"chunked resume launches {cl}, expected {want} spmv_ell")
        every1 = K * (n_chunks - 1)  # REPRO_CHUNK_CKPT_EVERY=1: a save after every chunk but the last
        print(f"[robust] (b) chunked diskcsr road n={central.n:,}, {n_chunks} chunks, "
              f"REPRO_CHUNK_CKPT_EVERY={chunk_every}, chunk_io_error@chunk={chunk_fault} (an "
              f"OSError): snapshot at step 0 chunk {saved}, {c_bytes:,} bytes; resumed: phase 8's "
              f"bits, launches {cl}; "
              f"{len(chunk_saves)} saves, median {np.median(chunk_saves):.4f} s (min "
              f"{min(chunk_saves):.4f}, max {max(chunk_saves):.4f}); resumed solve wall {c_wall:.3f} s "
              f"on {smi}")
        print(f"[robust] (b) reckoned, not run: REPRO_CHUNK_CKPT_EVERY=1 (the default) would save "
              f"{every1} snapshots in this k={K} solve, {every1 * c_bytes:,} bytes, about "
              f"{every1 * float(np.median(chunk_saves)):.1f} s at this median")
    finally:
        restore()
        shutil.rmtree(tmp, ignore_errors=True)

    # (c) recovery="auto" on road 4.19M under FFF, v0 = v_road
    fff = eigsh(road, v_road, policy="FFF")
    fcf = eigsh(road, v_road, policy="FCF")

    def trail(res):
        return [(t["action"], t.get("from"), t.get("to")) for t in res.recovery_trail or []]

    with faults.inject("spmv_nan@iter=3"):
        r_nan = eigsh(road, v_road, policy="FFF", recovery="auto")
    check(trail(r_nan) == [("escalate_policy", "FFF", "FCF")], f"spmv_nan trail {trail(r_nan)}")
    check(bool(torch.isfinite(r_nan.eigenvalues).all()) and same_bits(r_nan, fcf),
          "spmv_nan: the escalated result is not a plain FCF call's bits")
    with faults.inject("beta_collapse@iter=2"):
        r_beta = eigsh(road, v_road, policy="FFF", recovery="auto")
    check([t[0] for t in trail(r_beta)] == ["reseed"] and bool(torch.isfinite(r_beta.eigenvalues).all()),
          f"beta_collapse trail {trail(r_beta)}")
    reset_launches()
    with faults.inject("kernel_error"):
        r_kern = eigsh(road, v_road, policy="FFF", recovery="auto")
    kl = read_launches()
    lam = float(fff.eigenvalues.double().abs().max())
    kerr = float((r_kern.eigenvalues.double() - fff.eigenvalues.double()).abs().max()) / lam
    check(trail(r_kern) == [("unfuse", "fused", "unfused")], f"kernel_error trail {trail(r_kern)}")
    check(kl["spmv_ell"] == K and kl["lanczos_update"] == 0, f"unfused attempt launches {kl}")
    check(kerr <= 1e-5, f"unfused eigenvalues differ from the fused call by {kerr:.3e}")
    reset_launches()
    with faults.inject("oom"):
        r_oom = eigsh(road, v_road, policy="FFF", recovery="auto")
    ol = read_launches()
    check(trail(r_oom) == [("fallback_chunked", "single", "chunked")] and r_oom.backend == "chunked",
          f"oom trail {trail(r_oom)}, backend {r_oom.backend}")
    check(ol["spmv_ell"] == r_oom.partition["num_chunks"] * K, f"chunked fallback launches {ol}")
    with faults.inject("spmv_nan@iter=3"):
        try:
            eigsh(road, v_road, policy="FFF", recovery="raise")
            raise CheckFailed("spmv_nan under recovery='raise' did not raise")
        except NumericalBreakdown as exc:
            check((exc.kind, exc.iteration) == ("nonfinite", 3), f"breakdown {exc}")
    print(f"[robust] (c) recovery='auto', road FFF: spmv_nan@iter=3 -> {trail(r_nan)} (= plain FCF "
          f"bits); beta_collapse@iter=2 -> {trail(r_beta)}; kernel_error -> {trail(r_kern)}, "
          f"launches {kl}, vs fused rel {kerr:.3e}; oom -> {trail(r_oom)}, "
          f"{r_oom.partition['num_chunks']} chunks, launches {ol}; recovery='raise' -> "
          "NumericalBreakdown(nonfinite, 3)")

    # (d) jacobi="jax" on phase 3's call
    reset_launches()
    r_jax = eigsh(road, v_road, jacobi="jax")
    jl = read_launches()
    check(jl["spmv_ell"] == K and jl["lanczos_update"] == K, f"jacobi='jax' launches {jl}")
    jerr = check_eigs("jacobi jax", r_jax, main_res, 1e-12)
    gap = check_residuals("jacobi jax", r_jax, road)
    sess = repro_torch.prepare(road, device=dev)
    times = {}
    for placement in ("host", "jax"):
        sess.eigsh(K, v0=v_road, jacobi=placement)  # warm-up
        times[placement] = [sess.eigsh(K, v0=v_road, jacobi=placement).timings["jacobi_s"]
                            for _ in range(5)]
    print(f"[robust] (d) jacobi='jax' on road FDF: vs host Jacobi max rel err {jerr:.3e} (<= 1e-12), "
          f"residual bound gap {gap:.3e}, launches {jl}; timings['jacobi_s'] median of 5 warm calls: "
          f"host {np.median(times['host']) * 1e3:.3f} ms, device "
          f"{np.median(times['jax']) * 1e3:.3f} ms (all: host "
          f"{[round(t * 1e3, 3) for t in times['host']]}, device "
          f"{[round(t * 1e3, 3) for t in times['jax']]}) on {smi}")

    # (e) the legacy entry points
    single = eigsh(road, v_road, backend="single", format="ell")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        reset_launches()
        legacy = topk_eigs(make_operator(road, "ell", device=dev), K, v1=v_road)
        sync(dev)
        ll = read_launches()
    check(any(issubclass(w.category, DeprecationWarning) for w in caught),
          "topk_eigs raised no DeprecationWarning")
    check(tuple(legacy.eigenvectors.shape) == (road.n, K), f"topk_eigs: {legacy.eigenvectors.shape}")
    lerr = eig_rel_err("topk_eigs", legacy.eigenvalues, single.eigenvalues, 1e-12)
    check(ll["spmv_ell"] == K, f"topk_eigs(make_operator(road, 'ell')) launches {ll}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        reset_launches()
        legacy_bsr = topk_eigs(make_operator(block, "bsr_kernel", device=dev), K, v1=v_block)
        sync(dev)
        bl = read_launches()
    check(bl["spmv_bsr"] == K, f"make_operator(block, 'bsr_kernel') launches {bl}")
    berr = eig_rel_err("bsr_kernel", legacy_bsr.eigenvalues, bsr_res.eigenvalues, 1e-9)
    from repro_torch.core.operators import chunk_row_bounds

    r0, r1 = chunk_row_bounds(central.indptr, central.n, 1 << 20)[0]
    val, col = ell_chunk(central, r0, r1)
    packed = [t.to(dev) for t in pack_ell_chunk(val, col, "bf16")]
    x = torch.randn(central.n, dtype=torch.float32, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    reset_launches()
    got = ops.spmv_ell_packed(*packed, x, r1 - r0, accum_dtype=torch.float64)
    sync(dev)
    pl = read_launches()["spmv_ell_packed"]
    want = ref.spmv_ell_packed_ref(*packed, x, torch.float64)[: r1 - r0]
    perr = close(got, want, 1e-12)
    check(pl == 1 and got.shape == (r1 - r0,), f"ops.spmv_ell_packed launches {pl}, shape {got.shape}")
    print(f"[robust] (e) topk_eigs(make_operator(road, 'ell')) warns DeprecationWarning, vs "
          f"eigsh(format='ell') max rel err {lerr:.3e} (<= 1e-12), launches {ll}; "
          f"make_operator(block, 'bsr_kernel'): launches {bl}, vs phase 6 max rel err {berr:.3e}; "
          f"ops.spmv_ell_packed on phase 2's bf16 chunk ({r1 - r0:,} rows), f64: max_abs_err "
          f"{perr:.3e} (<= 1e-12 of max |y|), 1 launch")


def phase_serving(road, web, block, v_road, v_web, v_block, main_res, bsr_res, smi,
                  dev="cuda", launcher=True) -> None:
    """Phase 12: the measured autotuner and the serving layer at full width,
    with ``REPRO_SPMV_TUNE=1``, no ``REPRO_ITER_UPDATE`` pin, the tune cache
    and the session store in a temporary directory (deleted at the end):
    (a) tuned ``prepare`` on road (FDF) and on the BSR kron matrix, (b) an
    ``EigenScheduler`` over road and web under a threaded query stream, (c)
    its warm restart from the store, (d) the watchdog under
    ``scheduler_crash``, (e) ``python -m repro_torch.launch.serve --smoke``
    as a subprocess."""
    import threading

    import repro_torch
    from repro_torch.api import SolverConfig
    from repro_torch.kernels.engine import tuner_probe_count
    from repro_torch.serving import (EigenScheduler, SchedulerConfig, SchedulerCrashedError,
                                     SessionStore)
    from repro_torch.sparse.formats import conversion_count
    from repro_torch.testing import faults

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    cache = os.path.join(tmp, "spmv_tune.json")
    saved = {name: os.environ.get(name) for name in
             ("REPRO_SPMV_TUNE", "REPRO_SPMV_TUNE_CACHE", "REPRO_ITER_UPDATE")}
    os.environ.update(REPRO_SPMV_TUNE="1", REPRO_SPMV_TUNE_CACHE=cache)
    os.environ.pop("REPRO_ITER_UPDATE", None)
    per_plan = {"fused_spmv": {"spmv_ell_alpha": K, "lanczos_update": K, "spmv_ell": 0},
                "fused": {"spmv_ell": K, "lanczos_update": K, "spmv_ell_alpha": 0},
                "unfused": {"spmv_ell": K, "lanczos_update": 0, "spmv_ell_alpha": 0}}
    try:
        # (a) tuned prepare: probes once, a second prepare adds none, the
        # tuned solve launches what its plan says
        for tag, A, v, want_res, spmv_kernel in (("road", road, v_road, main_res, "spmv_ell"),
                                                 ("bsr", block, v_block, bsr_res, "spmv_bsr")):
            p0 = tuner_probe_count()
            known = set(json.load(open(cache))["entries"]) if os.path.exists(cache) else set()
            t0 = time.perf_counter()
            sess = repro_torch.prepare(A, device=dev)
            cold_s = time.perf_counter() - t0
            probes = tuner_probe_count() - p0
            check(probes == sess.prepare_tuner_probes and probes >= 1,
                  f"tuned {tag}: {probes} probes, session reports {sess.prepare_tuner_probes}")
            p1 = tuner_probe_count()
            sess2 = repro_torch.prepare(A, device=dev)
            check(tuner_probe_count() == p1 and sess2.prepare_tuner_probes == 0,
                  f"tuned {tag}: a second prepare ran {tuner_probe_count() - p1} probes")
            reset_launches()
            res = sess.eigsh(K, v0=v)
            sync(dev)
            launches = read_launches()
            spmv = res.partition["spmv"]
            plan = spmv["iteration_plan"]
            want = dict(per_plan[plan["effective"]])
            if tag == "bsr":
                want = {"spmv_bsr": K, "lanczos_update": want["lanczos_update"]}
            else:
                want[spmv_kernel] = want.pop("spmv_ell")
            got = {name: launches[name] for name in want}
            check(got == want, f"tuned {tag}: launches {launches}, plan {plan['effective']} "
                  f"wants {want}")
            with open(cache) as f:
                entries = json.load(f)["entries"]
            for key, rec in sorted(entries.items()):
                if key not in known:
                    cands = ", ".join(f"{name} {us:.1f}" for name, us in rec["candidates_us"].items())
                    print(f"[serve] (a) {tag} probe {key}: {cands} us -> "
                          f"{rec.get('update', '')} {rec['block_r']}x{rec['block_w']} "
                          f"bs{rec['block_size']}")
            print(f"[serve] (a) tuned {tag}: format {res.spmv_format}, tiles {spmv['block_r']}x"
                  f"{spmv['block_w']} bs{spmv['block_size']} ({spmv['tiles_from']}), plan "
                  f"{plan['update']} ({plan['source']}, effective {plan['effective']}); "
                  f"{probes} probes, prepare {cold_s:.3f} s cold (probes included), second "
                  f"prepare 0 probes; launches {got} on {smi}")
            err = check_eigs(f"tuned {tag}", res, want_res, 1e-9)
            print(f"[serve] (a) tuned {tag} vs phase {'3' if tag == 'road' else '6'}: max rel err "
                  f"{err:.3e} (<= 1e-9)")
            del sess, sess2

        # (b) the scheduler: road (ELL) and web (hybrid) resident, 3 threads x
        # 6 queries, one group key per matrix (one v0, num_iters = K)
        store = SessionStore(os.path.join(tmp, "store"))
        scfg = SchedulerConfig(admission_window_s=0.02, max_group=16, watchdog_interval_s=0.1)
        solver = SolverConfig(device=dev)
        mats = {"road": (road, v_road), "web": (web, v_web)}
        sched = EigenScheduler(scfg, store=store)
        add_s = {}
        for name, (A, _) in mats.items():
            t0 = time.perf_counter()
            sched.add_matrix(A, name=name, config=solver)
            add_s[name] = time.perf_counter() - t0
        sweeps0 = {name: sched.session(name).stats["sweeps"] for name in mats}
        results, errors = {}, []

        def submitter(tid):
            try:
                hs = []
                for i in range(6):
                    name = ("road", "web")[(tid + i) % 2]
                    k = (2, 4, 6, 8)[(tid * 6 + i) % 4]
                    hs.append((name, k, sched.submit(name, k=k, num_iters=K, v0=mats[name][1])))
                results[tid] = [(name, k, h.result(timeout=300.0)) for name, k, h in hs]
            except Exception as exc:  # reported below
                errors.append(exc)

        reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=submitter, args=(t,)) for t in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600.0)
        wall = time.perf_counter() - t0
        launches = read_launches()
        check(not errors and not any(t.is_alive() for t in threads) and len(results) == 3,
              f"scheduler stream: errors {errors[:1]}, results {len(results)}")
        stats = sched.stats()
        sweeps = {name: sched.session(name).stats["sweeps"] - sweeps0[name] for name in mats}
        plans = {name: r.partition["spmv"]["iteration_plan"]["effective"]
                 for per in results.values() for name, _, r in per}
        want = {kern: sum(sweeps[name] * per_plan[plans[name]][kern] for name in mats)
                for kern in ("spmv_ell", "spmv_ell_alpha", "lanczos_update")}
        got = {kern: launches[kern] for kern in want}
        check(got == want, f"scheduler launches {got}, sweeps {sweeps} under plans {plans} "
              f"want {want}")
        worst = 0.0
        for per_thread in results.values():
            for name, k, r in per_thread:
                (alone,) = sched.session(name).eigsh_many([{"k": k, "num_iters": K,
                                                            "v0": mats[name][1]}])
                check(r.k == k, f"scheduler: asked k={k}, got {r.k}")
                lam, want_lam = r.eigenvalues.double().cpu(), alone.eigenvalues.double().cpu()
                worst = max(worst, float((lam - want_lam).abs().max() / want_lam.abs().max()))
        check(worst <= 1e-9, f"scheduler: results differ from eigsh_many by {worst:.3e}")
        # Host cost of admitting one query: group_key validates it and
        # digests its v0 (the dispatch's eigsh_many digests it again).
        key_ms = {}
        for name, (_, v) in mats.items():
            t0 = time.perf_counter()
            sched.session(name).group_key({"k": 2, "num_iters": K, "v0": v})
            key_ms[name] = (time.perf_counter() - t0) * 1e3
        e2e, q = stats.latency["e2e"], stats.latency["queue"]
        print(f"[serve] (b) {stats.summary()}")
        print(f"[serve] (b) 3 threads x 6 queries (k in 2..8, num_iters {K}, FDF) on road "
              f"n={road.n:,} ({plans['road']}) and web n={web.n:,} ({plans['web']}): completed "
              f"{stats.completed}, sweeps {sweeps}, coalesce rate {stats.coalesce_rate:.3f}, e2e "
              f"p50 {e2e['p50_s'] * 1e3:.2f} ms p99 {e2e['p99_s'] * 1e3:.2f} ms, queue p50 "
              f"{q['p50_s'] * 1e3:.2f} ms p99 {q['p99_s'] * 1e3:.2f} ms, "
              f"{stats.completed / wall:.2f} queries/s ({wall:.3f} s wall); launches {got} "
              f"({launches['spmv_ell'] / max(1, sum(sweeps.values())):.2f} spmv_ell a sweep); "
              f"vs eigsh_many max rel err {worst:.3e} (<= 1e-9); group_key with v0 "
              + ", ".join(f"{n} {ms:.1f} ms" for n, ms in key_ms.items()) + "; cold add_matrix "
              + ", ".join(f"{n} {s:.3f} s" for n, s in add_s.items()) + f" on {smi}")
        before = {name: next(r for per in results.values() for n, k, r in per
                             if n == name and k == K) for name in mats}

        # (c) warm restart from the store
        t0 = time.perf_counter()
        sched.close(persist=True)
        save_s = time.perf_counter() - t0
        entry_bytes = {e: dir_bytes(os.path.join(store.root, e)) for e in store.entries()}
        conv0, probes0 = conversion_count(), tuner_probe_count()
        sched2 = EigenScheduler(scfg, store=store)
        load_s = {}
        for name, (A, _) in mats.items():
            t0 = time.perf_counter()
            sched2.add_matrix(A, name=name, config=solver)
            load_s[name] = time.perf_counter() - t0
        first = {name: sched2.submit(name, k=K, num_iters=K, v0=mats[name][1]).result(timeout=300.0)
                 for name in mats}
        dconv, dprobes = conversion_count() - conv0, tuner_probe_count() - probes0
        st2 = sched2.stats()
        check(dconv == 0 and dprobes == 0 and st2.warm_starts == 2,
              f"warm restart: {dconv} conversions, {dprobes} probes, {st2.warm_starts} warm starts")
        for name in mats:
            check(first[name].session_reuse and torch.equal(first[name].eigenvalues,
                                                            before[name].eigenvalues),
                  f"warm restart {name}: reuse {first[name].session_reuse}, bits differ")
        print(f"[serve] (c) close(persist=True) {save_s:.3f} s; entries "
              + ", ".join(f"{b:,} bytes" for b in entry_bytes.values())
              + "; warm add_matrix " + ", ".join(f"{n} {s:.3f} s" for n, s in load_s.items())
              + f"; 0 conversions, 0 probes, first results session_reuse and the same bits "
              f"as before the restart on {smi}")

        # (d) the watchdog fails every stranded request, start() serves again.
        # Seeded starts: a submit with a v0 digests it (tens of ms at 4.19M
        # rows), and the three must queue inside one admission window.
        t0 = time.perf_counter()
        with faults.inject("scheduler_crash"):
            hs = [sched2.submit("road", k=2, num_iters=K) for _ in range(3)]
            excs = [h.exception(timeout=30.0) for h in hs]
        crash_s = time.perf_counter() - t0
        check(all(isinstance(e, SchedulerCrashedError) for e in excs) and crash_s < 10.0,
              f"watchdog: {[type(e).__name__ for e in excs]} after {crash_s:.2f} s")
        sched2.start()
        again = sched2.submit("road", k=2, num_iters=K).result(timeout=300.0)
        check(again.k == 2, "watchdog: the restarted scheduler did not serve")
        print(f"[serve] (d) scheduler_crash: {len(excs)} stranded requests failed with "
              f"SchedulerCrashedError in {crash_s:.3f} s (watchdog every "
              f"{scfg.watchdog_interval_s} s; {sched2.stats().watchdog_trips} trip); start() "
              "serves again")
        sched2.close(persist=False)

        # (e) the launcher, as a user runs it
        if launcher:
            env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
                                  "--device", dev], capture_output=True, text=True, env=env,
                                 cwd=ROOT, timeout=300)
            lines = (out.stdout + out.stderr).strip().splitlines()
            check(out.returncode == 0, f"launch.serve --smoke exited {out.returncode}: "
                  + " | ".join(lines[-5:]))
            print(f"[serve] (e) python -m repro_torch.launch.serve --smoke: exit 0 in "
                  f"{time.perf_counter() - t0:.1f} s; "
                  + " | ".join(ln for ln in lines if ln.startswith(("throughput", "restart"))))
    finally:
        faults.reset()
        for name, val in saved.items():
            if val is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = val
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------- phase 13: distributed

DIST_TIMEOUT = 600.0  # seconds for one spawn of ranks, start-up included


def _digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.blake2b(t.contiguous().cpu().numpy().tobytes(), digest_size=16).hexdigest()


def _dist_load(job, name):
    from repro_torch.sparse import CSR

    arrs = [np.load(os.path.join(job["dir"], f"{name}_{f}.npy"))
            for f in ("indptr", "indices", "data")]
    return CSR(indptr=arrs[0], indices=arrs[1], data=arrs[2], shape=(len(arrs[0]) - 1,) * 2)


def _warm_query(A, v, **kw):
    """``(wall seconds, result)`` of one query on the session that an
    ``eigsh(A, device="cuda", **kw)`` call just cached: no digest of the
    matrix, no conversion."""
    from repro_torch.api import SolverConfig, get_session

    sess, hit = get_session(A, SolverConfig(device="cuda", **kw))
    check(hit, "the warm query found no cached session")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sess.eigsh(K, v0=v)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res


def _dist_solve(A, v, warm: bool = True, **kw) -> dict:
    """One cold ``eigsh`` (session cache cleared) with its launches and
    collective calls, and, with ``warm``, a query on its cached session (its
    wall time and timings)."""
    import repro_torch
    from repro_torch.core.distributed import ShardComm

    repro_torch.session_cache_clear()
    reset_launches()
    ShardComm.reset_calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = repro_torch.eigsh(A, k=K, v0=v, device="cuda", **kw)
    torch.cuda.synchronize()
    out = {
        "cold_s": time.perf_counter() - t0, "launches": read_launches(),
        "calls": dict(ShardComm.calls), "backend": res.backend, "spmv_format": res.spmv_format,
        "partition": res.partition, "eigenvalues": res.eigenvalues.cpu(),
        "alpha": res.tridiag.alpha.cpu(), "beta": res.tridiag.beta.cpu(),
        "x_digest": _digest(res.eigenvectors), "x_shape": tuple(res.eigenvectors.shape),
        "x_finite": bool(torch.isfinite(res.eigenvectors).all()),
        "recovery_trail": res.recovery_trail, "timings": res.timings,
    }
    if warm:
        wall, again = _warm_query(A, v, **kw)
        out.update(warm_s=wall, timings=again.timings,
                   warm_ok=again.session_reuse and torch.equal(again.eigenvalues, res.eigenvalues))
    return out


def dist_rank(rank: int, world: int, job: dict) -> dict:
    """Phase 13's work on one rank (spawned by ``repro_torch.launch.ranks``):
    each of ``job["runs"]`` is (tag, kind, matrix, keywords)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.testing import faults

    out = {}
    for tag, kind, name, kw in job["runs"]:
        kw = dict(kw)
        env = kw.pop("env", {})
        os.environ.update(env)
        try:
            v = np.load(os.path.join(job["dir"], f"{name}_v.npy"))
            if kind == "chunked":
                mesh = DeviceMesh("cuda", list(range(world)), mesh_dim_names=("data",))
                out[tag] = _dist_solve(job["path"], v, warm=False, backend="chunked", mesh=mesh,
                                       **kw)
            elif kind == "fault":
                with faults.inject(kw.pop("fault")):
                    out[tag] = _dist_solve(_dist_load(job, name), v, warm=False,
                                           backend="distributed", **kw)
            else:
                out[tag] = _dist_solve(_dist_load(job, name), v, backend="distributed", **kw)
        finally:
            for key in env:
                os.environ.pop(key, None)
    return out


def _rel_err(tag, got: torch.Tensor, want: torch.Tensor, rtol: float) -> float:
    """Max difference of two sorted eigenvalue sets, relative to |lambda|max."""
    g = np.sort(got.double().cpu().numpy())
    w = np.sort(want.double().cpu().numpy())
    check(g.shape == (K,) and np.isfinite(g).all(), f"{tag}: bad eigenvalues {g}")
    err = float(np.abs(g - w).max() / np.abs(w).max())
    check(err <= rtol, f"{tag}: eigenvalues differ by {err:.3e} > {rtol:.0e}")
    return err


def _ritz64(r) -> torch.Tensor:
    """The K Ritz values of a result's f64 tridiagonal."""
    a, b = r["alpha"].double().numpy(), r["beta"].double().numpy()
    ev = np.linalg.eigvalsh(np.diag(a) + np.diag(b, 1) + np.diag(b, -1))
    return torch.from_numpy(ev[np.argsort(-np.abs(ev))][:K].copy())


def _rank0(tag, ranks, n) -> dict:
    """Rank 0's result of ``tag`` after checking that every rank has its bits
    (eigenvalues, the tridiagonal, the eigenvectors' digest)."""
    r0 = ranks[0][tag]
    for r, rk in enumerate(ranks[1:], 1):
        got = rk[tag]
        check(torch.equal(got["eigenvalues"], r0["eigenvalues"])
              and torch.equal(got["alpha"], r0["alpha"]) and torch.equal(got["beta"], r0["beta"])
              and got["x_digest"] == r0["x_digest"], f"{tag}: rank {r} differs from rank 0")
    check(r0["x_finite"] and r0["x_shape"] == (n, K), f"{tag}: eigenvectors {r0['x_shape']}")
    check(r0.get("warm_ok", True), f"{tag}: the warm repeat was not a reuse with the same bits")
    return r0


def _balance(part, A) -> str:
    s = np.asarray(part["splits"])
    nnz = np.diff(A.indptr[s])
    return (f"shard nnz {nnz.tolist()} (max/mean {nnz.max() / nnz.mean():.4f}), rows "
            f"{np.diff(s).tolist()}, n_pad {part['n_pad']:,}")


def _time_line(r, smi) -> str:
    """A solve's times: the warm repeat's wall; its Lanczos loop on the host
    clock and, where the distributed backend times them, its collectives
    by CUDA events around each call (two clocks: the difference is no
    measured compute time); the Jacobi and projection; the cold call's
    wall."""
    t = r["timings"]
    lz = t["lanczos_s"]
    warm = f"warm solve {r['warm_s'] * 1e3:.1f} ms: " if "warm_s" in r else ""
    split = ""
    if "collective_s" in t:
        split = f" (collectives, CUDA events around each call: {t['collective_s'] * 1e3:.1f} ms)"
    return (f"{warm}lanczos {lz * 1e3:.1f} ms host{split}; jacobi {t['jacobi_s'] * 1e3:.1f} ms; "
            f"project {t['project_s'] * 1e3:.1f} ms; cold call {r['cold_s']:.2f} s; on {smi}")


def ell_share(csr, a: int, b: int, rows: int, width: int):
    """Rows ``[a, b)`` of a host CSR laid out as the sharded chunk path
    stages a rank's share: ``(rows, width)`` ELL, zeros past each row's
    entries, values rounded to f32."""
    ip = csr.indptr
    lo, hi = int(ip[a]), int(ip[b])
    starts = np.arange(b - a, dtype=np.int64) * width - (ip[a:b] - lo)
    flat = np.repeat(starts, np.diff(ip[a : b + 1])) + np.arange(hi - lo)
    val = np.zeros(rows * width, dtype=np.float32)
    col = np.zeros(rows * width, dtype=np.int32)
    val[flat], col[flat] = csr.data[lo:hi], csr.indices[lo:hi]
    return val.reshape(rows, width), col.reshape(rows, width)


def phase_shard_kernels(data) -> None:
    """Phase 13, before the ranks: each kernel of the distributed path
    against its plain version on the operands a rank gives it.  The first
    and last shards of each run of (a)-(b), converted by
    ``prepare_sharded(..., shards=...)`` as a rank converts its own, times
    a random all-gathered ``(G * n_pad,)`` vector: road's ELL shards at
    G = 2 and 4 (``spmv_ell``; ``spmv_ell_alpha`` with an ``(n_pad,)`` v;
    ``lanczos_update`` at ``n_pad``), the ELL bulk of web's hybrid shards
    at G = 4, kron's BSR shards at G = 2.  Then each rank's share of the
    first chunk of phase 8's matrix at G = 2 (rows padded to 8 G, the
    chunk's width), plain f32 and packed bf16, times the replicated
    ``(n,)`` vector.  FDF's dtypes, phase 2's ``RTOL``."""
    from repro_torch.core.distributed import prepare_sharded
    from repro_torch.core.operators import chunk_row_bounds, chunk_rows_pad
    from repro_torch.core.precision import FDF
    from repro_torch.kernels import ref
    from repro_torch.kernels.engine import TileConfig
    from repro_torch.kernels.spmv_ell_packed import pack_ell_chunk

    fns = kernel_modules()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    S, A = MAIN_PAIR
    errs, shapes = {}, {}

    def note(name, err, shape):
        errs[name] = max(errs.get(name, 0.0), err)
        shapes.setdefault(name, []).append(shape)

    for name, world, fmt, want in (("road", 2, "auto", "ell"), ("road", 4, "auto", "ell"),
                                   ("web", 4, "auto", "hybrid"), ("block", 2, "bsr", "bsr")):
        prep = prepare_sharded(data[name], world, FDF, fmt, shards=(0, world - 1), device="cuda")
        check(prep.engine.format == want, f"{name} G={world}: format {prep.engine.format}")
        n_pad = prep.pm.n_pad
        for shard, mat in zip(prep.pm.shards, prep.mats):
            x = torch.randn(world * n_pad, generator=g, dtype=torch.float64, device=dev).to(S)
            tag = f"{name} G={world} shard {shard}"
            if want == "bsr":
                check(mat.n_cols == x.shape[0], f"{tag}: n_cols {mat.n_cols}")
                y = fns["spmv_bsr"](mat.val, mat.bcol, x, accum_dtype=A, n_cols=mat.n_cols)
                note("spmv_bsr", close(y, ref.spmv_bsr_ref(mat.val, mat.bcol, x, A), RTOL[A]),
                     f"{tag} {tuple(mat.val.shape)}")
                continue
            val, col = (mat.val, mat.col) if want == "ell" else (mat.ell_val, mat.ell_col)
            note("spmv_ell", close(fns["spmv_ell"](val, col, x, accum_dtype=A),
                                   ref.spmv_ell_ref(val, col, x, A), RTOL[A]),
                 f"{tag} {tuple(val.shape)}")
            if want != "ell":
                continue
            v = torch.randn(mat.n_rows, generator=g, dtype=A, device=dev)
            (w, al), (wr, alr) = (fns["spmv_ell_alpha"](val, col, x, v, accum_dtype=A),
                                  ref.spmv_ell_alpha_ref(val, col, x, v, A))
            terms = float((v.double().abs() * wr[: mat.n_rows].double().abs()).sum())
            err = max(close(w, wr, RTOL[A]),
                      close(al.reshape(1), alr.reshape(1), RTOL[A], scale=terms))
            note("spmv_ell_alpha", err, f"{tag} {tuple(val.shape)}")
            w, vv, vp = (torch.randn(n_pad, generator=g, dtype=A, device=dev) for _ in range(3))
            a, b = (torch.tensor(c, dtype=A, device=dev) for c in (0.37, 1.21))
            (u, nr), (ur, nrr) = (fns["lanczos_update"](w, vv, vp, a, b, accum_dtype=A),
                                  ref.lanczos_update_ref(w, vv, vp, a, b, A))
            err = max(close(u, ur, RTOL[A]), close(nr.reshape(1), nrr.reshape(1), RTOL[A]))
            note("lanczos_update", err, f"{tag} ({n_pad},)")
        del prep
    big, tiles, world = data["central"], TileConfig(), 2
    r0, r1 = chunk_row_bounds(big.indptr, big.n, 1 << 20)[0]
    width = -(-int(big.row_nnz()[r0:r1].max()) // tiles.block_w) * tiles.block_w
    share = chunk_rows_pad(r1 - r0, tiles.block_r * world) // world
    x = torch.randn(big.n, generator=g, dtype=torch.float64, device=dev).to(S)
    for rank in range(world):
        a = min(r1, r0 + rank * share)
        val, col = ell_share(big, a, min(r1, a + share), share, width)
        tag = f"central chunk 0 G={world} rank {rank} ({share} x {width})"
        vt, ct = torch.from_numpy(val).to(dev), torch.from_numpy(col).to(dev)
        note("spmv_ell", close(fns["spmv_ell"](vt, ct, x, accum_dtype=A),
                               ref.spmv_ell_ref(vt, ct, x, A), RTOL[A]), f"{tag} f32")
        packed = [t.to(dev) for t in pack_ell_chunk(val, col, "bf16")]
        note("spmv_ell_packed", close(fns["spmv_ell_packed"](*packed, x, accum_dtype=A),
                                      ref.spmv_ell_packed_ref(*packed, x, A), RTOL[A]),
             f"{tag} bf16")
    for name in KERNEL_ORDER:
        if name in errs:
            dt = dname(A) if name == "lanczos_update" else f"{dname(S)} storage, {dname(A)}"
            print(f"[dist] shard shapes, {name} ({dt}) vs its plain "
                  f"version: max_abs_err {errs[name]:.3e} (<= {RTOL[A]:.0e} of max |y|) ok on "
                  f"{'; '.join(shapes[name])}")
    check(set(errs) == set(KERNEL_ORDER) - {"mixed_dot"}, f"shard checks ran {sorted(errs)}")


def phase_distributed(data, path, chunk_res, smi) -> dict:
    """Phase 13: the distributed backend on one card (see the module doc).
    Returns the launches of one ``eigsh(k=8)`` on the distributed path, per
    kernel."""
    import repro_torch
    from repro_torch.launch.ranks import run_ranks

    mats = {"road": data["road"], "web": data["web"], "block": data["block"]}
    v = data["v"]
    singles = {}
    for name, A in mats.items():
        singles[name] = solve(A, "cuda", v[name], backend="single", reorth="full")[0]
        if name == "road":
            wall, res = _warm_query(A, v[name], backend="single", reorth="full")
            t = res.timings
            print(f"[dist] road backend='single', reorth='full', for comparison: warm solve "
                  f"{wall * 1e3:.1f} ms (lanczos {t['lanczos_s'] * 1e3:.1f} ms, jacobi "
                  f"{t['jacobi_s'] * 1e3:.1f} ms, project {t['project_s'] * 1e3:.1f} ms) on {smi}")
    repro_torch.session_cache_clear()
    phase_shard_kernels(data)
    torch.cuda.empty_cache()
    d = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        for name, A in mats.items():
            for f in ("indptr", "indices", "data"):
                np.save(os.path.join(d, f"{name}_{f}.npy"), getattr(A, f))
            np.save(os.path.join(d, f"{name}_v.npy"), v[name])
        np.save(os.path.join(d, "central_v.npy"), v["central"])
        job = {"dir": d, "path": path}
        road = mats["road"]

        # (a) a world of one over NCCL
        t0 = time.perf_counter()
        (a,) = run_ranks(dist_rank, 1, backend="nccl", device="cuda", timeout=DIST_TIMEOUT, args=(
            {**job, "runs": [("road", "solve", "road", {}),
                             ("fused_spmv", "solve", "road",
                              {"env": {"REPRO_ITER_UPDATE": "fused_spmv"}})]},))
        ra, rf = _rank0("road", [a], road.n), _rank0("fused_spmv", [a], road.n)
        la, lf, ca = ra["launches"], rf["launches"], ra["calls"]
        check(ra["backend"] == "distributed" and ra["spmv_format"] == ("ell",),
              f"(a) {ra['backend']} {ra['spmv_format']}")
        check(la["spmv_ell"] == K and la["lanczos_update"] == K and la["spmv_ell_alpha"] == 0,
              f"(a) launches {la}")
        check(lf["spmv_ell_alpha"] == K and lf["lanczos_update"] == K and lf["spmv_ell"] == 0,
              f"(a) fused_spmv launches {lf}")
        check(ca["all_gather"] == K and ca["reduce_scalar"] == 2 * K + 1
              and ca["reduce_vector"] == K and ca["gather_x"] == 1, f"(a) collective calls {ca}")
        err = _rel_err("(a)", ra["eigenvalues"], singles["road"].eigenvalues, 1e-9)
        errf = _rel_err("(a) fused_spmv", rf["eigenvalues"], singles["road"].eigenvalues, 1e-9)
        print(f"[dist] (a) world of one over NCCL, eigsh(road n={road.n:,}, k={K}, "
              f"backend='distributed'): format {ra['spmv_format']}; per eigsh launches {la}, "
              f"collective calls {ca}; vs backend='single', reorth='full', same v0: max rel err "
              f"{err:.3e} (<= 1e-9); REPRO_ITER_UPDATE=fused_spmv: launches {lf}, max rel err "
              f"{errf:.3e}; spawn + runs {time.perf_counter() - t0:.1f} s")
        print(f"[dist] (a) {_time_line(ra, smi)}")

        # (b), (c), (d): G ranks over gloo, all on cuda:0
        plans = {
            2: [("road", "solve", "road", {}), ("block", "solve", "block", {"format": "bsr"}),
                ("central_f32", "chunked", "central", {"staging": "f32"}),
                ("central_bf16", "chunked", "central", {"staging": "bf16"}),
                ("fault", "fault", "road",
                 {"fault": "spmv_nan@iter=3", "policy": "FFF", "recovery": "auto"})],
            4: [("road", "solve", "road", {}), ("web", "solve", "web", {})],
        }
        want_fmt = {"road": "ell", "web": "hybrid", "block": "bsr"}
        ritz_a = _ritz64(ra)
        out = {}
        for g, runs in plans.items():
            t0 = time.perf_counter()
            out[g] = ranks = run_ranks(dist_rank, g, backend="gloo", device="cuda",
                                       timeout=DIST_TIMEOUT, args=({**job, "runs": runs},))
            print(f"[dist] G={g} ranks over gloo on cuda:0: spawn + runs "
                  f"{time.perf_counter() - t0:.1f} s")
            for tag in (t for t, kind, _, _ in runs if kind == "solve"):
                A, fmt = mats[tag], want_fmt[tag]
                r = _rank0(tag, ranks, A.n)
                kernel = "spmv_bsr" if fmt == "bsr" else "spmv_ell"
                check(r["spmv_format"] == (fmt,) * g, f"G={g} {tag}: format {r['spmv_format']}")
                check(r["launches"][kernel] == K and r["launches"]["lanczos_update"] == K,
                      f"G={g} {tag}: launches {r['launches']}")
                err = _rel_err(f"G={g} {tag}", r["eigenvalues"], singles[tag].eigenvalues, 1e-9)
                vs_a = ""
                if tag == "road":
                    e_a = _rel_err(f"G={g} road vs (a)", r["eigenvalues"], ra["eigenvalues"], 1e-9)
                    e_r = _rel_err(f"G={g} road Ritz vs (a)", _ritz64(r), ritz_a, 1e-9)
                    vs_a = f"; vs (a): {e_a:.3e}, f64 Ritz values {e_r:.3e} (<= 1e-9)"
                print(f"[dist] G={g} {tag} ({fmt}): ranks bit-identical (eigenvalues, tridiagonal, "
                      f"X digest); vs backend='single': max rel err {err:.3e} (<= 1e-9){vs_a}; "
                      f"launches {r['launches']}; collective calls {r['calls']}")
                print(f"[dist] G={g} {tag}: {_balance(r['partition'], A)}")
                print(f"[dist] G={g} {tag}: {_time_line(r, smi)}")

        # (c) the sharded chunk path, against phase 8's unsharded solve
        ranks = out[2]
        for tag, kernel, tol in (("central_f32", "spmv_ell", 1e-9),
                                 ("central_bf16", "spmv_ell_packed", 8e-3)):
            r = _rank0(tag, ranks, chunk_res.n)
            chunks = r["partition"]["num_chunks"]
            check(r["backend"] == "chunked" and r["launches"][kernel] == chunks * K,
                  f"(c) {tag}: launches {r['launches']} over {chunks} chunks")
            check(r["calls"]["all_gather"] == K, f"(c) {tag}: collective calls {r['calls']}")
            err = _rel_err(f"(c) {tag}", r["eigenvalues"], chunk_res.eigenvalues, tol)
            staged = [rk[tag]["partition"]["spmv"]["staging"]["bytes_staged"] for rk in ranks]
            print(f"[dist] (c) G=2 eigsh(diskcsr road_central, backend='chunked', mesh) {tag}: "
                  f"{chunks} chunks, {r['launches'][kernel]} {kernel} launches and "
                  f"{r['calls']['all_gather']} all-gathers per rank, bytes staged per rank "
                  f"{staged}; vs phase 8 (unsharded): max rel err {err:.3e} (<= {tol:.0e}); "
                  f"{_time_line(r, smi)}")

        # (d) a fault at G = 2: every rank takes the reference's step
        for rank, rk in enumerate(ranks):
            steps = [(t["action"], t.get("from"), t.get("to"))
                     for t in rk["fault"]["recovery_trail"] or []]
            check(steps == [("escalate_policy", "FFF", "FCF")], f"(d) rank {rank}: trail {steps}")
        r = _rank0("fault", ranks, road.n)
        check(np.isfinite(r["eigenvalues"].numpy()).all(), "(d) non-finite eigenvalues")
        print(f"[dist] (d) G=2 spmv_nan@iter=3 under FFF, recovery='auto': every rank's trail "
              f"[escalate_policy FFF -> FCF], finite result, ranks bit-identical")
        # mixed_dot is on no solver path: every rank of every run launched it 0 times
        dots = [rk[tag]["launches"]["mixed_dot"]
                for rk in (a, *out[2], *out[4]) for tag in rk]
        check(max(dots) == 0, f"mixed_dot launched {max(dots)} times on the distributed path")
        return {
            "spmv_ell": la["spmv_ell"],
            "lanczos_update": la["lanczos_update"],
            "spmv_ell_alpha": lf["spmv_ell_alpha"],
            "spmv_bsr": out[2][0]["block"]["launches"]["spmv_bsr"],
            "spmv_ell_packed": out[2][0]["central_bf16"]["launches"]["spmv_ell_packed"],
            "mixed_dot": la["mixed_dot"],
        }
    finally:
        shutil.rmtree(d, ignore_errors=True)


# --------------------------------------------------------- phase 14: analysis

# The instantiation of each kernel the main path (FDF: f32 storage, f64
# accumulation) runs; its resources join the kernel's record.
MAIN_INSTANTIATION = {
    "spmv_ell": "spmv_ell_kernel<float, double>",
    "lanczos_update": "lanczos_update_kernel<double, double>",
    "spmv_ell_alpha": "spmv_ell_alpha_kernel<float, double>",
    "spmv_bsr": "spmv_bsr_kernel<float, double, 8>",
    "spmv_ell_packed": "spmv_ell_packed_kernel<__nv_bfloat16, int, float, double>",
    "mixed_dot": "mixed_dot_kernel<float, double>",
}
_ATTRS_RE = re.compile(r"\[kernels\] attrs (.+): registers (\d+), shared (\d+) B, local (\d+) B, "
                       r"occupancy (\d+) blocks/SM")


def measured_solve(run, tag):
    """``run()`` plain, then again with ``REPRO_PRECISION_MEASURE=1`` under
    an outer op counter: ``(result, counter, launches, (plain s, counted
    s))``, each wall time on the host clock, synced.  The counter must
    change no bit of the result."""
    from repro_torch.analysis import op_count

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = run()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    reset_launches()
    os.environ["REPRO_PRECISION_MEASURE"] = "1"
    try:
        with op_count.OpCounter() as counter:
            res = run()
        torch.cuda.synchronize()
    finally:
        del os.environ["REPRO_PRECISION_MEASURE"]
    walls = (t1 - t0, time.perf_counter() - t1)
    launches = read_launches()
    check(torch.equal(res.eigenvalues, plain.eigenvalues)
          and torch.equal(res.eigenvectors, plain.eigenvectors),
          f"{tag}: the counted solve's bits differ from the uncounted one's")
    measured = res.partition["spmv"]["precision"]["ops_by_dtype_measured"]
    check("error" not in measured and measured == counter.ops_by_dtype(),
          f"{tag}: session counts {measured} differ from the outer counter's "
          f"{counter.ops_by_dtype()}")
    return res, counter, launches, walls


def check_kernel_records(tag, counter, launches, contracts) -> None:
    """Each kernel's recorded calls equal its launches, and its recorded ops
    and conversions its launches times its per-launch contract."""
    for name, rec in counter.kernels.items():
        check(rec["calls"] == launches[name],
              f"{tag}: {name} recorded {rec['calls']} calls, launched {launches[name]}")
        ops, convs = contracts[name]
        want = {dt: n * launches[name] for dt, n in ops.items()}
        check(rec["ops"] == want and rec["conversions"] == len(convs) * launches[name],
              f"{tag}: {name} recorded {rec['ops']} ({rec['conversions']} conversions), its "
              f"contract gives {want} ({len(convs) * launches[name]})")
    for name, n in launches.items():
        check(n == 0 or name in counter.kernels, f"{tag}: {name} launched {n} times, recorded none")


def conversions_line(counter, steps: int) -> str:
    """Conversions a Lanczos step by (src, dst), with the elements the
    materialized casts among them write."""
    parts = []
    for (src, dst), n in sorted(counter.conversion_counts().items()):
        elems = counter.cast_elements.get((src, dst), 0)
        parts.append(f"{src}->{dst} {n / steps:.2f}/step ({elems / steps:,.0f} elements cast)")
    return "; ".join(parts)


def phase_analysis(data, smi) -> dict:
    """Phase 14: the analysis on the card (see the module docstring).
    Returns the main-path instantiation's resources and phase 14's
    launches for each kernel."""
    import repro_torch
    from repro_torch.analysis import precision_flow as pf
    from repro_torch.analysis.findings import format_findings
    from repro_torch.core.lanczos import resolve_update_mode
    from repro_torch.core.precision import POLICIES, phase_op_counts
    from repro_torch.kernels.lanczos_fused import spmv_ell_alpha_contract
    from repro_torch.kernels.lanczos_update import lanczos_update_contract
    from repro_torch.kernels.spmv_bsr import spmv_bsr_contract
    from repro_torch.kernels.spmv_ell import spmv_ell_contract
    from repro_torch.sparse import generate

    t0 = time.perf_counter()
    total = {name: 0 for name in KERNEL_ORDER}

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def ell_contracts(csr, pol, block_r=8, block_w=8):
        rows = -(-csr.n // block_r) * block_r
        width = -(-int(csr.row_nnz().max()) // block_w) * block_w
        sdt, cdt, acc = pol.storage, pol.compute, pol.phase_dtype("spmv")
        val, x = meta((rows, width), sdt), meta((csr.n,), sdt)
        return rows * width, {
            "spmv_ell": spmv_ell_contract(val, x, acc),
            "spmv_ell_alpha": spmv_ell_alpha_contract(val, x, meta((csr.n,), acc), acc),
            "lanczos_update": lanczos_update_contract(meta((csr.n,), cdt), cdt),
        }

    def finish(tag, res, counter, launches, walls, pol, n, nnz, m, steps=None):
        reorth = "half" if steps is None else "full"  # eigsh's default; restarted: full
        findings = pf.check_run(pol, counter, n=n, nnz=nnz, m=m, k=K, reorth=reorth,
                                steps=steps, context=tag)
        check(findings == [], f"{tag}: {format_findings(findings)}")
        prec = res.partition["spmv"]["precision"]
        executed = phase_op_counts(pol, n=n, nnz=nnz, m=m, k=K, reorth=reorth, executed=True)
        scale = (steps or m) / m
        print(f"[analysis] {tag}: launches {({k: v for k, v in launches.items() if v})}; "
              f"measured {prec['ops_by_dtype_measured']}, session model {prec['ops_by_dtype']}, "
              f"executed model {({dt: int(c * scale) for dt, c in executed.items()})}; "
              f"0 findings; wall uncounted {walls[0] * 1e3:.1f} ms, counted "
              f"{walls[1] * 1e3:.1f} ms")
        print(f"[analysis] {tag}: conversions {conversions_line(counter, steps or m)}")
        for name, v in launches.items():
            total[name] += v

    # (a) road 4.19M under every rung and the update plans it resolves.
    road, v_road = data["road"], data["v"]["road"]
    repro_torch.session_cache_clear()
    sess = repro_torch.prepare(road, device="cuda")
    runs = 0
    for rung in pf.RUNGS:
        pol = POLICIES[rung]
        nnz, contracts = ell_contracts(road, pol)
        for mode in pf.MODES:
            os.environ["REPRO_ITER_UPDATE"] = mode
            try:
                if resolve_update_mode(pol, device="cuda") != mode:
                    continue  # the rung does not resolve this plan (FCF: unfused only)
                tag = f"road/{rung}/{mode}"
                res, counter, launches, walls = measured_solve(
                    lambda: sess.eigsh(K, policy=rung, v0=v_road), tag)
            finally:
                del os.environ["REPRO_ITER_UPDATE"]
            check(res.partition["spmv"]["iteration_plan"]["effective"] == mode,
                  f"{tag}: ran {res.partition['spmv']['iteration_plan']['effective']}")
            spmv = "spmv_ell_alpha" if mode == "fused_spmv" else "spmv_ell"
            want = {spmv: K, "lanczos_update": 0 if mode == "unfused" else K}
            check(all(launches[n] == c for n, c in want.items()), f"{tag}: launches {launches}")
            check_kernel_records(tag, counter, launches, contracts)
            small, _ = pf.check_policy(pol, "single", mode=mode, device="cuda")
            check(small == [], f"{tag} at n = 64, per phase: {format_findings(small)}")
            finish(tag, res, counter, launches, walls, pol, road.n, nnz, K)
            runs += 1
    check(runs == 13, f"phase 14 ran {runs} rung x plan solves, expected 13")

    # (b) FDF: the BSR matrix, and a restarted tol= solve on road 1M.
    fdf = POLICIES["FDF"]
    block, v_block = data["block"], data["v"]["block"]
    repro_torch.session_cache_clear()
    bsess = repro_torch.prepare(block, device="cuda")
    res, counter, launches, walls = measured_solve(lambda: bsess.eigsh(K, v0=v_block),
                                                   "bsr/FDF")
    check(res.spmv_format == "bsr" and launches["spmv_bsr"] == K, f"bsr: launches {launches}")
    bs = res.partition["spmv"]["block_size"]
    nbr = -(-block.n // bs)
    # Slots a block row: the most distinct block columns of any block row.
    keys = np.unique(np.repeat(np.arange(block.n, dtype=np.int64), block.row_nnz()) // bs * nbr
                     + block.indices // bs)
    slots = int(np.bincount(keys // nbr, minlength=nbr).max())
    bval = meta((nbr, slots, bs, bs), fdf.storage)
    check_kernel_records("bsr/FDF", counter, launches, {
        "spmv_bsr": spmv_bsr_contract(bval, meta((nbr * bs,), fdf.storage), torch.float64),
        "lanczos_update": lanczos_update_contract(meta((block.n,), fdf.compute), fdf.compute)})
    finish("bsr/FDF", res, counter, launches, walls, fdf, block.n, bval.numel(), K)

    road1m = generate("road", 1 << 20, 2.1, seed=0)
    v1m = np.random.default_rng(1).standard_normal(road1m.n)
    repro_torch.session_cache_clear()
    rsess = repro_torch.prepare(road1m, device="cuda")
    res, counter, launches, walls = measured_solve(lambda: rsess.eigsh(K, tol=1e-6, v0=v1m),
                                                   "restarted/FDF")
    check(res.backend == "restarted" and launches["spmv_ell"] == res.iterations,
          f"restarted: backend {res.backend}, launches {launches}, steps {res.iterations}")
    nnz, contracts = ell_contracts(road1m, fdf)
    check_kernel_records("restarted/FDF", counter, launches, contracts)
    finish("restarted/FDF", res, counter, launches, walls, fdf, road1m.n, nnz,
           max(2 * K, K + 8), steps=res.iterations)
    repro_torch.session_cache_clear()

    # (c) the kernel check on the card, in its own process.
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check", "kernels", "--strict",
         "--device", "cuda"], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    print(out.stdout.rstrip())
    check(out.returncode == 0 and "[kernels] 0 finding(s)" in out.stdout,
          f"python -m repro_torch.analysis --check kernels: exit {out.returncode}\n{out.stderr}")
    attrs = {m.group(1): {"registers": int(m.group(2)), "shared_bytes": int(m.group(3)),
                          "local_bytes": int(m.group(4)), "occupancy": int(m.group(5))}
             for m in _ATTRS_RE.finditer(out.stdout)}
    check(len(attrs) == 60, f"the resource report lists {len(attrs)} instantiations, not 60")
    records = {}
    for name, inst in MAIN_INSTANTIATION.items():
        check(inst in attrs, f"no resources reported for {inst}")
        records[name] = {"instantiation": inst, **attrs[inst], "launches_analysis": total[name]}
    print(f"[analysis] phase 14 took {time.perf_counter() - t0:.1f} s on {smi}")
    return records


def phase_device() -> str:
    """Phase 1: the card's name and power limit (``nvidia-smi``, returned),
    the versions, and the build of the kernels with each new kernel's
    registers and spills from the compiler's report."""
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    regs = [ln.strip() for ln in build.BUILD_INFO["log"].splitlines() if "spill" in ln]
    spills = sum(1 for ln in regs if not ln.startswith("0 bytes stack frame, 0 bytes spill"))
    print(f"[device] kernels built in {build.BUILD_INFO['seconds']:.2f} s "
          f"(cached={build.BUILD_INFO['cached']}); {len(regs)} kernel instantiations, "
          f"{spills} with a stack frame or spills")
    log = build.BUILD_INFO["log"].splitlines()
    for i, ln in enumerate(log):
        if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill"):
            entry = next((e for e in reversed(log[:i]) if "Compiling entry function" in e), "")
            print(f"[device]   {ln.strip()} <- {entry.strip()[:150]}")
    for src in ("spmv_ell.cu", "lanczos_fused.cu", "spmv_ell_packed.cu", "mixed_dot.cu"):
        for entry, regs_line, spill_line in kernel_resources(log, src):
            print(f"[device] {src} {entry}: {regs_line}; {spill_line}")
    return smi


def kernel_resources(log, source: str):
    """(entry, registers, spills) of each kernel of one source in the build
    log of ``nvcc -Xptxas -v``."""
    out, section, entry, spill = [], None, None, None
    for ln in log:
        ln = ln.strip()
        if ln.startswith("== "):
            section = ln[3:]
        elif section != source:
            continue
        elif "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
            # _ZN<len>_GLOBAL__N__<hash>_<file>_cu_<hash><len>name_kernelI<args>EEv...
            m = re.search(r"\d+([A-Za-z_]+_kernel)(I.*?)EEv", entry)
            entry = f"{m.group(1)}{m.group(2)}E" if m else entry
        elif "bytes spill" in ln:
            spill = ln
        elif "ptxas info" in ln and ": Used" in ln and entry is not None:
            out.append((entry, ln.split(":", 1)[1].strip(), spill or ""))
            entry = spill = None
    return out


def make_data() -> dict:
    """The matrices and start vectors of every phase, from seeds (host)."""
    from repro_torch.sparse import generate

    t0 = time.perf_counter()
    road = generate("road", 1 << 22, 2.1, seed=0)
    web = generate("web", 1 << 20, 11.0, seed=0)
    small = generate("road", 1 << 16, 2.1, seed=0)
    b = np.random.default_rng(1).random((8, 8))
    block = to_port_csr(sp.kron(small.to_scipy(), sp.csr_matrix((b + b.T) / 2)))
    central = generate("road", 14_081_816, 2.4, seed=0)  # road_central's row count
    tiny_road = generate("road", 1 << 15, 2.1, seed=0)  # one chunk, int16 deltas
    rng = np.random.default_rng(0)
    mats = {"road": road, "web": web, "block": block, "central": central}
    v = {k: rng.standard_normal(m.n) for k, m in mats.items()}
    print(f"[data] road n={road.n:,} nnz={road.nnz:,}; web n={web.n:,} nnz={web.nnz:,}; "
          f"block n={block.n:,} nnz={block.nnz:,}; central road n={central.n:,} "
          f"nnz={central.nnz:,} max row {int(central.row_nnz().max())}; "
          f"generated in {time.perf_counter() - t0:.1f} s")
    return {**mats, "tiny_road": tiny_road, "v": v}


def phase_kernel_records(data) -> dict:
    """Phase 2: every kernel against its plain version; the records of the
    ``{"kernels": [...]}`` line, less the launch counts."""
    records = phase_kernels(data["road"], data["block"])
    records.update(phase_kernels_chunked(data["central"], data["tiny_road"], data["web"]))
    records["spmv_ell"]["chunk"] = records.pop("spmv_ell_chunk")
    for name in KERNEL_ORDER:
        r = records[name]
        lib = ("" if r["library_ms"] is None else
               f"; library {r['library_device_ms']:.4f} ms device, {r['library_ms']:.4f} ms series")
        print(f"[kernels] {name}: device {r['device_ms']:.4f} ms, series {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms{lib}")
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device visible; it runs on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repository)

    smi = phase_device()
    data = make_data()
    road, web, block, central = data["road"], data["web"], data["block"], data["central"]
    v_road, v_web, v_block, v_central = (data["v"][k] for k in ("road", "web", "block", "central"))
    records = phase_kernel_records(data)

    # ---- phase 3: the main path
    main_res, main_launches = phase_main(road, v_road, smi)
    check_loop_never_syncs("main", road, "FDF")

    # ---- phase 4: hybrid
    hyb, hwall, hl = solve(web, "cuda", v_web, policy="FFF")
    print(f"[hybrid] eigsh(web n={web.n:,}, FFF) format={hyb.spmv_format} launches={hl} "
          f"wall {hwall:.3f} s")
    check(hyb.spmv_format == "hybrid", f"web graph picked {hyb.spmv_format}, expected hybrid")
    check(hl["spmv_ell"] == K and hl["lanczos_update"] == K, f"hybrid launches {hl}")
    hyb2, _, _ = solve(web, "cuda", v_web, policy="FFF")
    check(torch.equal(hyb.eigenvalues, hyb2.eigenvalues), "hybrid: two runs differ in their bits")
    hcpu, _, _ = solve(web, "cpu", v_web, policy="FFF")
    err = check_eigs("hybrid", hyb, hcpu, 1e-5)
    print(f"[hybrid] vs host solve: max rel err {err:.3e} (<= 1e-5); repeat run bit-identical")
    check_loop_never_syncs("hybrid", web, "FFF")

    # ---- phase 5: fused_spmv
    os.environ["REPRO_ITER_UPDATE"] = "fused_spmv"
    try:
        fus, fwall, fl = solve(road, "cuda", v_road)
        check_loop_never_syncs("fused_spmv", road, "FDF")
    finally:
        del os.environ["REPRO_ITER_UPDATE"]
    print(f"[fused_spmv] eigsh(road, FDF, REPRO_ITER_UPDATE=fused_spmv) format={fus.spmv_format} "
          f"launches={fl} wall {fwall:.3f} s")
    check(fus.spmv_format == "ell", f"fused_spmv run picked {fus.spmv_format}")
    check(fl["spmv_ell_alpha"] == K and fl["lanczos_update"] == K and fl["spmv_ell"] == 0,
          f"fused_spmv launches {fl}")
    err = check_eigs("fused_spmv", fus, main_res, 1e-9)
    print(f"[fused_spmv] vs main path: max rel err {err:.3e} (<= 1e-9)")

    # ---- phase 6: BSR
    bres, bwall, bl = solve(block, "cuda", v_block)
    print(f"[bsr] eigsh(kron(road 65536, dense 8x8) n={block.n:,}, FDF) format={bres.spmv_format} "
          f"launches={bl} wall {bwall:.3f} s")
    check(bres.spmv_format == "bsr", f"block matrix picked {bres.spmv_format}, expected bsr")
    check(bl["spmv_bsr"] == K and bl["lanczos_update"] == K, f"bsr launches {bl}")
    bcpu, _, _ = solve(block, "cpu", v_block)
    err = check_eigs("bsr", bres, bcpu, 1e-9)
    gap = check_residuals("bsr", bres, block)
    print(f"[bsr] vs host solve: max rel err {err:.3e} (<= 1e-9); residual bound gap {gap:.3e}")
    check_loop_never_syncs("bsr", block, "FDF")

    # ---- phases 8 and 9: chunked, from a diskcsr directory
    from repro_torch.sparse import save_diskcsr

    tmp = tempfile.mkdtemp(prefix="chip_smoke_diskcsr_")
    try:
        t0 = time.perf_counter()
        path = save_diskcsr(os.path.join(tmp, "road_central"), central)
        print(f"[chunked] save_diskcsr: {sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)):,} "
              f"bytes in {time.perf_counter() - t0:.1f} s")
        chunk_res, chunk_launches, dot_launches = phase_chunked(central, v_central, path, smi)
        packed_launches = phase_packed(central, v_central, path, chunk_res, smi)

        # ---- phase 7: warm wall times
        import repro_torch as rt

        rt.session_cache_clear()
        print(f"[warm] session cache {rt.session_cache_info()}: every cold call below "
              "(solve) clears it first, so it prepares anew")

        for tag, A, v, kw in (
            ("ell road FDF", road, v_road, {}),
            ("hybrid web FFF", web, v_web, {"policy": "FFF"}),
            ("bsr kron FDF", block, v_block, {}),
            ("chunked diskcsr road_central FDF", path, v_central, {}),
            ("chunked fp8 diskcsr road_central FDF", path, v_central, {"staging": "fp8"}),
        ):
            chunked = isinstance(A, str)
            if not chunked:  # the chunked phases above timed their cold calls
                _, wall, _ = solve(A, "cuda", v, **kw)
            sess = rt.prepare(A, device="cuda", **kw)
            if chunked:
                sess.eigsh(K, v0=v)  # first query allocates the staging windows
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = sess.eigsh(K, v0=v)
            torch.cuda.synchronize()
            t_solve = time.perf_counter() - t0
            cold = "" if chunked else f"eigsh wall {wall:.3f} s; "
            print(f"[warm] {tag}: {cold}prepare {sess.prepare_s:.3f} s; "
                  f"solve {t_solve * 1e3:.2f} ms (lanczos {r.timings['lanczos_s'] * 1e3:.2f} ms, "
                  f"jacobi {r.timings['jacobi_s'] * 1e3:.2f} ms, project {r.timings['project_s'] * 1e3:.2f} ms) "
                  f"on {smi}")
        os.environ.pop("REPRO_ITER_UPDATE", None)

        # ---- phase 10: the restarted backend and the session's query layer
        phase_restarted(road, web, v_road, smi)

        # ---- phase 11: solve robustness, the device Jacobi, the legacy entry points
        phase_robustness(road, central, block, path, v_road, v_central, v_block, main_res,
                         chunk_res, bres, smi)

        # ---- phase 12: the measured autotuner and the serving layer
        phase_serving(road, web, block, v_road, v_web, v_block, main_res, bres, smi)

        # ---- phase 13: the distributed backend (needs phase 8's directory)
        dist_launches = phase_distributed(data, path, chunk_res, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- phase 14: the analysis on the card
    analysis = phase_analysis(data, smi)

    launches = {
        "spmv_ell": main_launches["spmv_ell"],
        "lanczos_update": main_launches["lanczos_update"],
        "spmv_ell_alpha": fl["spmv_ell_alpha"],
        "spmv_bsr": bl["spmv_bsr"],
        "spmv_ell_packed": packed_launches["bf16 FDF"]["spmv_ell_packed"],
        "mixed_dot": dot_launches,
    }
    print(f"[chunked] default call launches {chunk_launches}")
    kernels = []
    for name in KERNEL_ORDER:
        source, replaces = KERNEL_META[name]
        kernels.append(
            {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches[name], "launches_distributed": dist_launches[name],
             **records[name], **analysis[name]}
        )
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke.py: check failed: {exc}", file=sys.stderr)
        sys.exit(1)
