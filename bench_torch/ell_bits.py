#!/usr/bin/env python3
"""Digests of ``spmv_ell``'s output bytes from the kernels of one checkout,
on one NVIDIA card, or the comparison of two such files.

The inputs come from seeds (NumPy): the main path's ELL layout
(``generate("road", 1 << 22, 2.1, seed=0)``, width 8) for every
(storage, accum) pair of the precision policies, and random layouts of
1,003 rows and widths 520 and 37, which take the kernel's wide and scalar
paths.  Two versions of the row code must give the same bytes.  From the
root of a checkout:

    python3 bench_torch/ell_bits.py --src OTHER/src --out a.json  # another checkout's kernels
    python3 bench_torch/ell_bits.py --out b.json                  # this checkout's
    python3 bench_torch/ell_bits.py --compare a.json b.json

``--src`` names the ``src`` directory of the checkout whose ``repro_torch``
runs (it builds its kernels into that checkout's ``build/``).  The JSON holds
the card's ``nvidia-smi`` name and power limit beside a SHA-256 of each output.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (storage, accum) pairs of the seven precision policies, by name.
PAIRS = (("float32", "float32"), ("float32", "float64"), ("float64", "float64"),
         ("bfloat16", "float32"), ("float16", "float32"))


def digests() -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.spmv_ell import spmv_ell_kernel_call
    from repro_torch.sparse import generate, to_device_ell

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    road = generate("road", 1 << 22, 2.1, seed=0)
    main = to_device_ell(road, dtype=torch.float64, device=dev)
    layouts = {"road 4194304 x 8": (main.val, main.col, rng.standard_normal(road.n))}
    for width in (520, 37):
        val = rng.standard_normal((1003, width))
        col = rng.integers(0, 2000, (1003, width), dtype=np.int32)
        layouts[f"random 1003 x {width}"] = (torch.as_tensor(val, device=dev),
                                             torch.as_tensor(col, device=dev),
                                             rng.standard_normal(2000))
    out = {}
    for name, (val, col, x) in layouts.items():
        x = torch.as_tensor(x, device=dev)
        for s, a in PAIRS:
            S, A = getattr(torch, s), getattr(torch, a)
            y = spmv_ell_kernel_call(val.to(S), col, x.to(S), accum_dtype=A)
            raw = y.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            out[f"{name} ({s}, {a})"] = hashlib.sha256(raw).hexdigest()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="src directory of the checkout whose kernels run")
    ap.add_argument("--out", help="write the digests as JSON here")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"), help="compare two digest files")
    args = ap.parse_args()
    if args.compare:
        a, b = (json.load(open(p)) for p in args.compare)
        same = [k for k in a["digests"] if b["digests"].get(k) == a["digests"][k]]
        for k in a["digests"]:
            print(f"{'same' if k in same else 'DIFFERENT'}: {k}")
        print(f"{len(same)} of {len(a['digests'])} outputs have the same bytes "
              f"({a['src']} vs {b['src']})")
        return 0 if len(same) == len(a["digests"]) == len(b["digests"]) else 1
    import torch

    if not torch.cuda.is_available():
        print("ell_bits.py: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rec = {"src": os.path.abspath(args.src), "device": smi, "digests": digests()}
    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
