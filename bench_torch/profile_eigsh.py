#!/usr/bin/env python3
"""Where the time of one warm main-path solve goes, on one NVIDIA card.

Prepares ``repro_torch`` on the 4.19M-row road network of ``chip_smoke.py``
(``generate("road", 1 << 22, 2.1, seed=0)``, FDF, k = 8), runs one warm
solve for each update mode under ``torch.profiler`` (the default start
vector, drawn on the card), and prints per
operation device time, the solve's wall time, and the share of that wall
time in which the card ran no kernel.  Run from the repository root:

    python3 bench_torch/profile_eigsh.py [--out profile_eigsh.json]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the records as JSON here")
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
    for mode in ("unfused", "fused", "fused_spmv"):
        os.environ["REPRO_ITER_UPDATE"] = mode
        sess = repro_torch.prepare(road, device="cuda")
        sess.eigsh(K)  # warm-up: kernels built, allocator warm
        torch.cuda.synchronize()
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            t0 = time.perf_counter()
            res = sess.eigsh(K)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        busy = busy_us(events)
        table = sorted(
            (
                (e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.self_device_time_total > 0 and e.key not in _PROFILER_RECORDS
            ),
            key=lambda r: -r[1],
        )
        rec = {
            "mode": mode,
            "device": smi,
            "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us,
            "timings_ms": {k: v * 1e3 for k, v in res.timings.items()},
            "top_device_ops": [
                {"op": k, "device_ms": t / 1e3, "count": c} for k, t, c in table[:12]
            ],
        }
        records.append(rec)
        print(f"[{mode}] wall {rec['wall_ms']:.2f} ms, device busy {rec['device_busy_ms']:.2f} ms,"
              f" idle share {rec['idle_share']:.3f}; lanczos {rec['timings_ms']['lanczos_s']:.2f}"
              f" ms, jacobi {rec['timings_ms']['jacobi_s']:.2f} ms,"
              f" project {rec['timings_ms']['project_s']:.2f} ms")
        for r in rec["top_device_ops"]:
            print(f"    {r['device_ms']:9.3f} ms  x{r['count']:<4d} {r['op'][:90]}")
    os.environ.pop("REPRO_ITER_UPDATE", None)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
