#!/usr/bin/env python3
"""Time the wide and the split paths of the ELL kernels in turns on one
NVIDIA card: ``spmv_ell`` (f32 values, f64 accumulation) and
``spmv_ell_packed`` (bf16 and fp8 values, int32 deltas, x f32, f64
accumulation) on random rows with sorted columns over a 1,048,576-entry
``x`` (the web graph's), at rows {1, 8, 64, 251, 1,024, 2,638, 5,656,
8,192} x widths {264, 1,688, 25,232, 1,047,672} (cases past 2^30 slots
left out).

For each case the wide path and the split path with segments of 1, 2 and
4 vectors a lane (and the plan's own segment) run through each kernel
module's ``launch`` under a forced plan, in turns (wide, split..., split...,
wide); each result is held to the wide path's within 1e-12 of the row
sums of |products|, and a repeat must give its bits.  Device time per
call from ``torch.profiler`` (``chip_smoke.device_ms``: every kernel and
memset of the call, so the split path's reduce launch and, packed, its
memset too).  Run
from the repository root:

    python3 bench_torch/wide_rows.py [--out wide_rows.json] [--rows 1,8] [--widths 264]

Prints one line a case (the plan's choice, each path's device ms and the
bytes it moves a ms) and the card's ``nvidia-smi`` name and power limit;
``--out`` writes the records as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = (1, 8, 64, 251, 1024, 2638, 5656, 8192)
WIDTHS = (264, 1688, 25_232, 1_047_672)
N_X = 1 << 20
MAX_SLOTS = 1 << 30
SEG_VECS = (1, 2, 4)


def make_case(kind: str, rows: int, width: int, g):
    """Random rows of sorted columns on the card: ``(operands, x)`` for
    ``spmv_ell`` (kind "f32") or ``spmv_ell_packed`` ("bf16", "fp8", int32
    deltas, scale 1)."""
    dev = torch.device("cuda")
    col = torch.randint(0, N_X, (rows, width), generator=g, dtype=torch.int32, device=dev)
    col = col.sort(dim=1).values
    val = torch.randn(rows, width, generator=g, dtype=torch.float32, device=dev)
    x = torch.randn(N_X, generator=g, dtype=torch.float32, device=dev)
    if kind == "f32":
        return (val, col), x
    from repro_torch.kernels.spmv_ell_packed import PACKED_VALUE_DTYPES

    base = col[:, :1].contiguous()
    dcol = torch.diff(col, dim=1, prepend=base)
    del col
    scale = torch.ones(rows, 1, dtype=torch.float32, device=dev)
    return (val.to(PACKED_VALUE_DTYPES[kind]), scale, base, dcol), x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the records as JSON here")
    ap.add_argument("--rows", default=",".join(map(str, ROWS)))
    ap.add_argument("--widths", default=",".join(map(str, WIDTHS)))
    ap.add_argument("--kinds", default="f32,bf16,fp8")
    ap.add_argument("--calls", type=int, default=10, help="profiled calls a measurement")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wide_rows.py: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke
    from repro_torch.kernels import spmv_ell, spmv_ell_packed
    from repro_torch.kernels.spmv_ell import sm_count, split_segs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[wide_rows] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    sms = sm_count(torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(0)
    acc = torch.float64
    records = []
    for kind in args.kinds.split(","):
        mod, slots = (spmv_ell, 4) if kind == "f32" else (spmv_ell_packed, 8)
        for width in map(int, args.widths.split(",")):
            for rows in map(int, args.rows.split(",")):
                if rows * width > MAX_SLOTS:
                    continue
                ops, x = make_case(kind, rows, width, g)
                if kind == "f32":
                    aligned = True
                    plan = spmv_ell.ell_launch_plan(width, 4, aligned, rows, sms)
                    abs_ops = (ops[0].abs(), ops[1])
                else:
                    plan = spmv_ell_packed.packed_launch_plan(width, 4, True, rows, sms)
                    abs_ops = (ops[0].float().abs().to(ops[0].dtype), *ops[1:])
                cands = {"wide": (32, "wide", 0)}
                vecs = sorted({v for v in SEG_VECS}
                              | ({plan[2] // (32 * slots)} if plan[1] == "split" else set()))
                for v in vecs:
                    if split_segs(width, slots, v) >= 2:
                        cands[f"split{v}"] = (32, "split", 32 * v * slots)

                def run(p, o=ops, xx=x):
                    return mod.launch(*o, xx, acc, p)

                want = run(cands["wide"])
                terms = float(run(cands["wide"], abs_ops, x.abs()).max())
                for name, p in cands.items():
                    got = run(p)
                    err = float((got - want).abs().max())
                    chip_smoke.check(err <= 1e-12 * max(terms, 1e-300),
                                     f"{kind} {rows} x {width} {name}: error {err:.3e} of "
                                     f"{terms:.3e}")
                    chip_smoke.check(torch.equal(got, run(p)),
                                     f"{kind} {rows} x {width} {name}: bits differ between calls")
                order = list(cands)
                times = {name: [] for name in order}
                for turn in (order, order[::-1]):
                    for name in turn:
                        times[name].append(
                            chip_smoke.device_ms(lambda p=cands[name]: run(p), calls=args.calls))
                moved = chip_smoke.nbytes(*ops) + min(N_X, rows * width) * 4 + rows * 8
                rec = {"kind": kind, "rows": rows, "width": width, "plan": list(plan),
                       "bytes": moved, "device_ms": times,
                       "bound_ms": moved / chip_smoke.HBM_BYTES_PER_S * 1e3}
                records.append(rec)
                best = min(order, key=lambda k: min(times[k]))
                print(f"[wide_rows] {kind} {rows:>5} x {width:>9,}: plan {plan[1]} {plan[2]}; "
                      + "; ".join(f"{k} {min(t):.4f}/{max(t):.4f} ms "
                                  f"({moved / min(t) / 1e6:.0f} GB/s)" for k, t in times.items())
                      + f"; bound {rec['bound_ms']:.4f} ms; fastest {best}")
                del ops, x, abs_ops, want
                torch.cuda.empty_cache()
    out = {"device": smi, "sms": sms, "records": records}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(f"[wide_rows] {len(records)} cases on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
