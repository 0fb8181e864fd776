#!/usr/bin/env python3
"""Where a benchmark cell's warm solves spend their time, by the program's
own spans: the mean of every key of ``EigenResult.timings`` over a window
of solves run as ``eigbench``'s measured window runs them (its set-up,
start vectors and closed loop), on the card.

    python3 bench_torch/query_split.py --workload CELL --seed N [--seconds 30] \
        [--blocks 4 --block-seconds 10] [--out FILE]

Prints one JSON line: the cell, the card and its power limit, the solves,
``solve_ms`` (the window over the solves), the mean of each ``timings``
key in ms (``host_copy_bytes`` as MiB, the counters ``start_compares``
and ``v0_digests`` as counts a solve), and two differences in ms:
``query_self`` (``query_s`` less the sweep's ``lanczos_s``, ``jacobi_s``
and ``project_s``: the benchmark's ``query_ms``) and ``query_rest`` (the
query's time that no span inside it covers).

What tracing costs when it is on: ``--blocks R`` then runs R pairs of
windows in turns, one untraced and one under ``torch.profiler`` (CPU and
CUDA activities, as the benchmark's traced window), each with its
``solve_ms`` and split; and ``span_us`` is one empty span's host cost with
no profiler and under one.  A checkout whose package has no spans gives
the windows' ``solve_ms`` alone, so two checkouts compare in turns.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from eigbench import cells, harness  # noqa: E402

SWEEP = ("lanczos_s", "jacobi_s", "project_s")
CHILDREN = ("normalize_s", "plan_s", "finish_s") + SWEEP
SCALE = {"host_copy_bytes": 2**-20, "start_compares": 1.0, "v0_digests": 1.0}


def split(timings: list) -> dict:
    keys = sorted({k for t in timings for k in t})
    out = {}
    for k in keys:
        out[k] = SCALE.get(k, 1e3) * statistics.fmean(t[k] for t in timings if k in t)
    if "query_s" in keys:
        out["query_self"] = 1e3 * statistics.fmean(
            t["query_s"] - sum(t[k] for k in SWEEP) for t in timings)
        out["query_rest"] = 1e3 * statistics.fmean(
            t["query_s"] - sum(t.get(k, 0.0) for k in CHILDREN) for t in timings)
    return out


def _window(su, cell, args, first: int, seconds: float) -> dict:
    win = harness.run_window(su["prog"], cell.traffic, su["n"], su["cdt"], args.device,
                             args.seed, first, seconds)
    return {"solves": win["completed"], "failed": win["failed"], "next": win["next"],
            "solve_ms": 1e3 * win["window_s"] / max(win["completed"], 1),
            "ms": split(win["timings"])}


def _profiled():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def span_us(reps: int = 20000) -> dict:
    """One empty span's host microseconds, with no profiler and under one
    (None where the package has no ``core.trace``)."""
    try:
        from repro_torch.core.trace import span
    except ImportError:
        return None
    out = {}
    for name, ctx in (("off", contextlib.nullcontext), ("on", _profiled)):
        with ctx():
            t0 = time.perf_counter()
            for _ in range(reps):
                with span("query_split.empty"):
                    pass
            out[name] = 1e6 * (time.perf_counter() - t0) / reps
    return out


def _power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--blocks", type=int, default=0)
    ap.add_argument("--block-seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = cells.find(ROOT, args.workload)
    su = harness.setup(ROOT, cell, args.seed, args.device)
    rec = {"workload": cell.name, "seed": args.seed, "card": _power_limit()}
    rec.update(_window(su, cell, args, 0, args.seconds))
    blocks = []
    for _ in range(args.blocks):
        for traced in (False, True):
            with _profiled() if traced else contextlib.nullcontext():
                w = _window(su, cell, args, rec["next"], args.block_seconds)
            rec["next"] = w.pop("next")
            blocks.append(dict(w, traced=traced))
    del rec["next"]
    if blocks:
        rec["blocks"] = blocks
        rec["span_us"] = span_us()
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
