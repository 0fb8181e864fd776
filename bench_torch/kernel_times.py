#!/usr/bin/env python3
"""Phases 1 and 2 of ``chip_smoke.py`` alone, on one NVIDIA card: build the
kernels, hold each against its plain version at the main path's shapes, and
time it (series and device times, bound, plain version, library yardstick).

Run from the root of a checkout:

    python3 bench_torch/kernel_times.py [--out kernel_times.json] [--tag NAME]

Two checkouts run in turns in one call on one card (parent, change, change,
parent) compare two versions of the kernels.  The JSON holds the card's
``nvidia-smi`` name and power limit beside the records.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the records as JSON here")
    ap.add_argument("--tag", default="", help="a name for this run in the JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times.py: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke

    try:
        smi = chip_smoke.phase_device()
        records = chip_smoke.phase_kernel_records(chip_smoke.make_data())
    except chip_smoke.CheckFailed as exc:
        print(f"kernel_times.py: check failed: {exc}", file=sys.stderr)
        return 1
    out = {"tag": args.tag, "device": smi, "root": ROOT, "kernels": records}
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
