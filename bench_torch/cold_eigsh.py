#!/usr/bin/env python3
"""Cold and cached ``repro_torch.eigsh`` wall time on one NVIDIA card.

Runs ``repro_torch.eigsh(road, k=8, v0=v)`` on the 4.19M-row road network of
``chip_smoke.py`` (``generate("road", 1 << 22, 2.1, seed=0)``, FDF, the
fixed path) from a cold start: a fresh process for the matrix, the session
cache cleared before each call.  Where the package has the session cache it
also times the call with the cache off (``REPRO_EIGSH_SESSION_CACHE=0``), a
repeat call on the cached session, and the two parts a cold call pays only
because of the cache: the content digest (``matrix_fingerprint``) and the
cached session's own copy of the CSR (``EigenSession._own_data``).  A
package without the cache (an older checkout) gives the cold wall only, so
the two can be compared in turns on one card:

    python3 bench_torch/cold_eigsh.py [--src SRC] [--label NAME] [--reps 2] [--out FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's).  The kernels are built and warmed on a small matrix
first, so no time here is a build.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 8


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None, help="append the record as one JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cold_eigsh.py: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    import repro_torch
    from repro_torch.sparse import generate

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    cached = hasattr(repro_torch, "session_cache_clear")
    clear = repro_torch.session_cache_clear if cached else (lambda: None)

    small = generate("road", 1 << 12, 2.1, seed=1)
    repro_torch.eigsh(small, K, device="cuda")  # kernels built and warm
    clear()
    road = generate("road", 1 << 22, 2.1, seed=0)
    v0 = np.random.default_rng(0).standard_normal(road.shape[0])

    rec = {"label": args.label, "device": smi, "session_cache": cached,
           "cold_s": [], "cold_prepare_s": []}
    for _ in range(args.reps):
        clear()
        res, wall = _timed(lambda: repro_torch.eigsh(road, K, v0=v0, device="cuda"))
        rec["cold_s"].append(wall)
        rec["cold_prepare_s"].append(res.timings.get("prepare_s"))
    if cached:
        from repro_torch.api import matrix_fingerprint

        rec["cached_s"] = [_timed(lambda: repro_torch.eigsh(road, K, v0=v0, device="cuda"))[1]
                           for _ in range(args.reps)]
        rec["digest_s"] = [_timed(lambda: matrix_fingerprint(road))[1] for _ in range(args.reps)]
        sess = repro_torch.prepare(road, device="cuda")
        rec["own_data_s"] = [_timed(sess._own_data)[1] for _ in range(args.reps)]
        del sess
        clear()
        os.environ["REPRO_EIGSH_SESSION_CACHE"] = "0"
        rec["cold_cache_off_s"] = [
            _timed(lambda: repro_torch.eigsh(road, K, v0=v0, device="cuda"))[1]
            for _ in range(args.reps)
        ]
        os.environ.pop("REPRO_EIGSH_SESSION_CACHE")
    print(smi)
    print(json.dumps(rec))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
