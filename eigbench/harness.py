"""One run of one cell: set-up, the measured window, the traced window,
the comparison with the plain reference, and the result's line.

A cell is a closed loop with one client on a resident matrix: the
client prepares the matrix once (``repro_torch.prepare``) and then calls
``EigenSession.eigsh(k, num_iters=m, reorth=..., v0=v)`` again and again,
each time with a fresh start vector drawn on the device from
``(seed, solve index)`` before the solve's clock starts.  A solve's
latency runs from the call until its eigenvalues are on the host.

After the window closes, a sample of its solves drawn from the seed is
compared with :mod:`eigbench.reference.lanczos` in float64, once the
memory peak has been read and the program's state freed.
"""

from __future__ import annotations

import gc
import hashlib
import json
import math
import os
import random
import sys
import time

import torch

from eigbench import cells, devinfo, tracing
from eigbench.reference import compare, lanczos

# Top-level module names that the run's process may not hold once the
# window has closed: the JAX package, its harness and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks", "bench_torch")
# How long after the close the loop may run on to reach a sampled solve.
_LATE_S = 60.0
log = devinfo.log


def start_seed(seed: int, i: int) -> int:
    h = hashlib.blake2b(f"{seed}:{i}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & ((1 << 63) - 1)


def start_vector(n: int, dtype, device, seed: int, i: int) -> torch.Tensor:
    """Solve ``i``'s start vector: the same for the program and the
    reference, drawn on ``device`` from ``(seed, i)``."""
    gen = torch.Generator(device=device).manual_seed(start_seed(seed, i))
    return torch.randn((n,), generator=gen, dtype=dtype, device=device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Program:
    """The system under test: a ``repro_torch`` session prepared on the
    cell's matrix, as a user who holds the matrix resident calls it."""

    def __init__(self, root: str, device: str):
        src = os.path.join(root, "src")
        if src not in sys.path:
            sys.path.insert(0, src)
        import repro_torch

        where = os.path.realpath(os.path.dirname(repro_torch.__file__))
        if not where.startswith(os.path.realpath(src) + os.sep):
            raise ImportError(f"repro_torch was loaded from {where}, not from {src}")
        self.rt, self.device, self.session = repro_torch, device, None

    def prepare(self, indptr, indices, data, traffic: dict) -> None:
        from repro_torch.sparse import CSR

        n = len(indptr) - 1
        csr = CSR(indptr=indptr, indices=indices, data=data, shape=(n, n))
        self.session = self.rt.prepare(
            csr, backend=traffic["backend"], policy=traffic["policy"], format=traffic["format"],
            reorth=traffic["reorth"], jacobi=traffic["jacobi"], device=self.device)

    def solve(self, v: torch.Tensor, traffic: dict, policy=None):
        """``(answer, timings, plan)``: the answer a
        :class:`~eigbench.reference.lanczos.RitzPairs` with the eigenvalues
        on the host, the rest where the program left it.  ``policy``
        overrides the traffic's, for the readings of the program's other
        precision paths."""
        extra = {} if policy is None else {"policy": policy}
        res = self.session.eigsh(traffic["k"], num_iters=traffic["num_iters"],
                                 reorth=traffic["reorth"], v0=v, **extra)
        tri = res.tridiag
        return (lanczos.RitzPairs(res.eigenvalues.cpu(), res.eigenvectors, tri.alpha, tri.beta),
                res.timings, str(res.spmv_format))

    def release(self) -> None:
        self.session = None


def run_window(prog, traffic, n, cdt, device, seed, first, seconds, sample=()):
    """Solves ``first, first + 1, ...`` until ``seconds`` of window have
    passed; the answers of the solves in ``sample`` are copied to the
    host with the window's clock stopped.  If the window closes before a
    sampled solve, the loop runs on, untimed, until it is reached."""
    lat, timings, kept, errors = [], [], {}, []
    attempted = failed = 0
    paused = 0.0
    pending = set(sample)
    i = first
    t0 = time.perf_counter()
    window_s = None
    while True:
        v = start_vector(n, cdt, device, seed, i)
        with torch.profiler.record_function("eigbench.solve"):
            ts = time.perf_counter()
            try:
                got, tm, _ = prog.solve(v, traffic)
                ok = bool(torch.isfinite(got.eigenvalues).all())
            except Exception as exc:  # a solve that raises counts as failed
                errors.append(f"solve {i}: {exc!r}"[:500])
                got = None
                ok = False
            te = time.perf_counter()
        if window_s is None:
            attempted += 1
            failed += not ok
            if ok:
                lat.append(te - ts)
                timings.append(tm)
        if i in pending:
            tp = time.perf_counter()
            kept[i] = None if got is None else lanczos.RitzPairs(*(x.to("cpu") for x in got))
            pending.discard(i)
            paused += time.perf_counter() - tp
        del got, v
        i += 1
        now = time.perf_counter()
        if window_s is None and now - t0 - paused >= seconds:
            window_s = now - t0 - paused
        if window_s is not None and (not pending or now - t0 - paused - window_s > _LATE_S):
            break
    return {"latencies": lat, "timings": timings, "kept": kept, "errors": errors,
            "attempted": attempted, "failed": failed, "window_s": window_s,
            "completed": len(lat), "missed": sorted(pending), "next": i}


def _reference_checks(cell, seed, host, kept, device, n, cdt):
    """Each number compared, worst over the sampled solves."""
    tr = cell.traffic
    indptr, indices, data = (torch.from_numpy(x).to(device) for x in host)
    a = lanczos.sparse_matrix(indptr, indices, data.to(torch.float64), lanczos.F64)
    readings = []
    for i, got in sorted(kept.items()):
        if got is None:
            readings.append({name: math.inf for name in compare.NAMES})
            continue
        v = start_vector(n, cdt, device, seed, i)
        ref = lanczos.ritz_pairs(a, v, tr["num_iters"], tr["k"])
        readings.append(compare.gaps(got, ref))
        del ref, v
    return compare.worst(readings), len(readings)


def setup(root: str, cell, seed: int, device, program=None) -> dict:
    """The set-up that the program under test pays: its import, the cell's
    matrix made on ``device`` from the seed and handed over as host CSR
    arrays, ``prepare``, and the warm-up solves."""
    tr, cfg = cell.traffic, cell.config
    prog = program(device) if program is not None else Program(root, device)
    g = cells.generator(root, cfg["generator"]).make(cfg, seed, device)
    if g.n != int(cfg["rows"]) or g.nnz != int(cfg["nnz_generated"]):
        raise RuntimeError(f"generated {g.n} rows / {g.nnz} nnz, the configuration states "
                           f"{cfg['rows']} / {cfg['nnz_generated']}")
    n, nnz = g.n, g.nnz
    vdt = lanczos.DTYPES[tr["values"]]
    host = (g.indptr.cpu().numpy(), g.indices.cpu().numpy(), g.data.to(vdt).cpu().numpy())
    del g
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    cdt = lanczos.DTYPES[tr["precision"]["compute"]]
    tp = time.perf_counter()
    prog.prepare(*host, tr)
    prepare_s = time.perf_counter() - tp
    plan, warm_s = None, []
    for w in range(int(tr["warmup_solves"])):
        v = start_vector(n, cdt, device, seed, -1 - w)
        tw = time.perf_counter()
        _, _, plan = prog.solve(v, tr)
        _sync(device)
        warm_s.append(time.perf_counter() - tw)
        del v
    return {"prog": prog, "host": host, "n": n, "nnz": nnz, "cdt": cdt, "prepare_s": prepare_s,
            "warm_s": warm_s, "plan": plan}


def sample_for(seed: int, seconds: float, warm_s: list, count: int) -> list:
    """Which of the window's solves are compared: ``count`` drawn from the
    seed among the solves the window should reach at the warm-up's pace."""
    est = seconds / max(warm_s[-1], 1e-3) if warm_s else 1.0
    pool = max(count, int(0.9 * est))
    return sorted(random.Random(start_seed(seed, -1000)).sample(range(pool), count))


def _finite(x: float):
    """A reading for the result's line: None where it is not a number."""
    return x if math.isfinite(x) else None


def run(root: str, workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", program=None, forbidden=FORBIDDEN) -> int:
    """One run; prints the result's line and returns 0, or returns
    another code and prints no result.  ``forbidden``: the top-level
    module names the process may not hold once the window has closed (a
    test process that has imported them elsewhere passes its own)."""
    cell = cells.find(root, workload)
    tr = cell.traffic
    gpu = torch.device(device).type == "cuda"
    if gpu:
        why = devinfo.card_missing(cell.chips)
        if why is not None:
            log(f"eigbench: {why}; no result")
            return 3
    su = setup(root, cell, seed, device, program)
    prog, host, n, nnz, cdt, prepare_s, warm_s = (
        su["prog"], su["host"], su["n"], su["nnz"], su["cdt"], su["prepare_s"], su["warm_s"])
    gc.collect()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if gpu else None
    log(f"eigbench: {workload} seed {seed}: {n} rows, {nnz} nnz, plan {su['plan']}; prepare "
        f"{prepare_s:.3f} s, warm-up solves {[round(s, 4) for s in warm_s]} s, set-up "
        f"{setup_s:.3f} s")

    # ---- the measured window
    count = int(tr["compare_solves"])
    sample = sample_for(seed, seconds, warm_s, count)
    if gpu:
        torch.cuda.reset_peak_memory_stats()
    sampler = devinfo.Sampler() if gpu else None
    win = run_window(prog, tr, n, cdt, device, seed, 0, seconds, sample)
    clocks = sampler.stop() if sampler is not None else {}
    window_peak = torch.cuda.max_memory_allocated() if gpu else None
    log(f"eigbench: window {win['window_s']:.3f} s, {win['attempted']} solves, "
        f"{win['failed']} failed, sampled {sample}, missed {win['missed']}; card {clocks}")
    for err in win["errors"][:5]:
        log(f"eigbench: {err}")

    # ---- the traced window
    trc, traced = None, 0
    attempted, failed = win["attempted"], win["failed"]
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if gpu:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        first = win["next"]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            tw = run_window(prog, tr, n, cdt, device, seed, first, seconds)
            _sync(device)
            traced_us = (time.perf_counter() - t0) * 1e6
        tr0 = time.perf_counter()
        trc = tracing.read(prof, traced_us)
        traced = tw["completed"]
        attempted, failed = attempted + tw["attempted"], failed + tw["failed"]
        del prof
        log(f"eigbench: traced window {traced_us / 1e6:.3f} s, {traced} solves, busy "
            f"{trc.busy_us / 1e6:.3f} s; trace read in {time.perf_counter() - tr0:.1f} s")

    # ---- the program's state freed, then the reference
    prog.release()
    gc.collect()
    if gpu:
        torch.cuda.empty_cache()
    tc = time.perf_counter()
    readings, compared = _reference_checks(cell, seed, host, win["kept"], device, n, cdt)
    log(f"eigbench: reference over {compared} solves in {time.perf_counter() - tc:.2f} s")

    found = sorted({m.split(".")[0] for m in sys.modules} & set(forbidden))
    if found:
        log(f"eigbench: the process holds {found}; no result")
        return 4

    # ---- the result's line
    dev = {"platform": "gpu" if gpu else "cpu",
           "kind": torch.cuda.get_device_name(0) if gpu else "cpu",
           "count": cell.chips if gpu else 1,
           "memory_peak_bytes": max(setup_peak, window_peak) if gpu else None}
    if gpu:
        dev["power_limit_w"] = devinfo.power_limit_w()
    if trc is not None and gpu:
        dev["busy_s"] = trc.busy_us / 1e6
        dev["window_s"] = trc.window_us / 1e6
    ctx = {"setup_s": setup_s, "prepare_s": prepare_s, "window": win, "traced_solves": traced,
           "trace": trc, "peak_bytes": window_peak, "device": dev, "n": n, "nnz": nnz,
           "config": cell.config, "traffic": tr}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.metric_reader(root, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {name: {"value": _finite(readings[name]), "limit": float(cell.limits[name])}
              for name in compare.NAMES}
    checks["compared_solves"] = {"value": compared, "limit": count}
    correct = (failed == 0 and win["completed"] > 0 and compared >= count
               and compare.judge(readings, cell.limits))
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trc is not None and gpu:
        out["breakdown"] = {"device_ops": tracing.device_ops(trc),
                            "idle_gaps": tracing.idle_gaps(trc)}
    out["checks"] = checks
    for name, c in checks.items():
        limit = "at least" if name == "compared_solves" else "limit"
        log(f"check {name} {c['value']!r} {limit} {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0
