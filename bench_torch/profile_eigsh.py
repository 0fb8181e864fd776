#!/usr/bin/env python3
"""Where the time of one warm main-path solve goes, on one NVIDIA card.

Prepares ``repro_torch`` on the 4.19M-row road network of ``chip_smoke.py``
(``generate("road", 1 << 22, 2.1, seed=0)``, FDF, k = 8), runs one warm
solve for each update mode under ``torch.profiler`` (the default start
vector, drawn on the card), and prints per
operation device time, the solve's wall time, and the share of that wall
time in which the card ran no kernel.  With ``--tol``, profiles instead one
warm restarted solve (``eigsh(road, k=8, tol=TOL)``, the thick-restart
backend) and splits its card time into the ``spmv_ell`` launches and the
re-orthogonalization's matrix products (cuBLAS gemv/gemm, with the
arrowhead coupling and the Ritz projections), its wall into the steps
and the host Jacobi of each cycle, and gives the device memory the solve
allocates at its peak.  Run from the
repository root:

    python3 bench_torch/profile_eigsh.py [--tol 1e-6] [--out profile_eigsh.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 8


# Device-side records of the profiler itself, not of the program.
_PROFILER_RECORDS = ("Activity Buffer Request",)


def busy_us(events) -> float:
    """Device-busy microseconds: the union of the kernels' and copies' intervals."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in _PROFILER_RECORDS
    )
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_ms_by(events, *needles) -> float:
    """Device milliseconds of the activities whose name holds a needle."""
    return sum(
        e.time_range.elapsed_us()
        for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and any(nd in e.name.lower() for nd in needles)
    ) / 1e3


def profile(sess, **query):
    """One warm query of ``sess`` under ``torch.profiler``: its result, wall
    microseconds, the profile, and the MB the solve allocated on the card
    at its peak beyond what was allocated before it."""
    sess.eigsh(K, **query)  # warm-up: kernels built, allocator warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        res = sess.eigsh(K, **query)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return res, wall_us, prof, (torch.cuda.max_memory_allocated() - before) / 1e6


def top_ops(prof, count: int = 12) -> list:
    table = sorted(
        (
            (e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.key not in _PROFILER_RECORDS
        ),
        key=lambda r: -r[1],
    )
    return [{"op": k, "device_ms": t / 1e3, "count": c} for k, t, c in table[:count]]


def restarted_record(road, tol: float, smi: str) -> dict:
    """One warm restarted solve: steps, restarts, wall, card busy time and
    idle share, and the device time of the SpMV and of the reorth products."""
    import repro_torch

    sess = repro_torch.prepare(road, device="cuda", tol=tol)
    res, wall_us, prof, peak_mb = profile(sess)
    events = prof.events()
    busy = busy_us(events)
    steps = res.iterations
    rec = {
        "mode": f"restarted tol={tol:g}",
        "device": smi,
        "steps": steps,
        "restarts": res.restarts,
        "converged": int(res.converged.sum()),
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / wall_us,
        "spmv_ell_ms": device_ms_by(events, "spmv_ell"),
        "reorth_blas_ms": device_ms_by(events, "gemv", "gemm"),
        "copies_ms": device_ms_by(events, "copy"),
        "peak_extra_mb": peak_mb,
        "timings_ms": {k: v * 1e3 for k, v in res.timings.items()},
        "busy_per_step_ms": busy / 1e3 / steps,
        "top_device_ops": top_ops(prof),
    }
    t = rec["timings_ms"]
    print(f"[{rec['mode']}] {steps} steps, {res.restarts} restarts, {rec['converged']}/{K} "
          f"converged; wall {rec['wall_ms']:.2f} ms: steps {t['lanczos_s']:.2f} ms "
          f"({t['lanczos_s'] / steps:.4f} a step), host Jacobi {t['jacobi_s']:.2f} ms; device "
          f"busy {rec['device_busy_ms']:.2f} ms ({rec['busy_per_step_ms']:.4f} a step), idle "
          f"share {rec['idle_share']:.3f}; spmv_ell {rec['spmv_ell_ms']:.3f} ms, gemv/gemm "
          f"{rec['reorth_blas_ms']:.3f} ms, copies {rec['copies_ms']:.3f} ms; peak "
          f"{peak_mb:.1f} MB allocated beyond the plan")
    for r in rec["top_device_ops"]:
        print(f"    {r['device_ms']:9.3f} ms  x{r['count']:<5d} {r['op'][:90]}")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the records as JSON here")
    ap.add_argument("--tol", type=float, default=None,
                    help="profile one warm restarted solve to this tolerance instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_eigsh.py: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch
    from repro_torch.sparse import generate

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    road = generate("road", 1 << 22, 2.1, seed=0)
    records = []
    for mode in () if args.tol is not None else ("unfused", "fused", "fused_spmv"):
        os.environ["REPRO_ITER_UPDATE"] = mode
        sess = repro_torch.prepare(road, device="cuda")
        res, wall_us, prof, _ = profile(sess)
        busy = busy_us(prof.events())
        rec = {
            "mode": mode,
            "device": smi,
            "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us,
            "timings_ms": {k: v * 1e3 for k, v in res.timings.items()},
            "top_device_ops": top_ops(prof),
        }
        records.append(rec)
        print(f"[{mode}] wall {rec['wall_ms']:.2f} ms, device busy {rec['device_busy_ms']:.2f} ms,"
              f" idle share {rec['idle_share']:.3f}; lanczos {rec['timings_ms']['lanczos_s']:.2f}"
              f" ms, jacobi {rec['timings_ms']['jacobi_s']:.2f} ms,"
              f" project {rec['timings_ms']['project_s']:.2f} ms")
        for r in rec["top_device_ops"]:
            print(f"    {r['device_ms']:9.3f} ms  x{r['count']:<4d} {r['op'][:90]}")
    os.environ.pop("REPRO_ITER_UPDATE", None)
    if args.tol is not None:
        records.append(restarted_record(road, args.tol, smi))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
