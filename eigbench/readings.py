"""The readings that a cell's limits for ``correct`` are set from.

    python3 eigbench/readings.py --workload CELL --seeds 11,12,... \\
        [--control-seeds 3] [--seconds 3] [--out FILE]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load with the same number of sampled solves as a run, and for
those solves

* ``program``: the program's numbers against the float64 reference (the
  lower reading is the largest over the seeds);
* ``control.<name>`` (first ``--control-seeds`` seeds): the reference
  computed in each precision that the limits file lists under
  ``controls``, put in the program's place (a number's upper reading is
  the smallest that a control gives over the seeds, where that is three
  times its lower reading or more);
* ``witness.<policy>`` (the same seeds): the program itself under each
  policy that the limits file lists under ``witnesses``, on the same
  start vectors.

One JSON line a seed goes to standard output and, with ``--out``, to a
file.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from eigbench import cells, harness  # noqa: E402
from eigbench.reference import compare, lanczos  # noqa: E402


def readings(root, cell, seed, seconds, control, device, program=None) -> dict:
    tr = cell.traffic
    su = harness.setup(root, cell, seed, device, program)
    prog, n, cdt = su["prog"], su["n"], su["cdt"]
    sample = harness.sample_for(seed, seconds, su["warm_s"], int(tr["compare_solves"]))
    win = harness.run_window(prog, tr, n, cdt, device, seed, 0, seconds, sample)
    witnesses = {}
    for pol in cell.limits.get("witnesses", []) if control else []:
        got = {}
        for i in sample:
            v = harness.start_vector(n, cdt, device, seed, i)
            ans = prog.solve(v, tr, policy=pol)[0]
            got[i] = lanczos.RitzPairs(*(x.to("cpu") for x in ans))
            del ans, v
        witnesses[pol] = got
    prog.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    indptr, indices, data = (torch.from_numpy(x).to(device) for x in su["host"])
    a64 = lanczos.sparse_matrix(indptr, indices, data.to(torch.float64), lanczos.F64)
    controls = {}
    for spec in cell.limits["controls"] if control else []:
        prec = lanczos.Precision.parse(spec)
        controls[spec["name"]] = (prec, lanczos.sparse_matrix(indptr, indices,
                                                               data.to(torch.float64), prec))
    rows = {"program": [], **{f"control.{c}": [] for c in controls},
            **{f"witness.{p}": [] for p in witnesses}}
    t0 = time.perf_counter()
    for i in sample:
        v = harness.start_vector(n, cdt, device, seed, i)
        ref = lanczos.ritz_pairs(a64, v, tr["num_iters"], tr["k"])
        rows["program"].append(compare.gaps(win["kept"][i], ref))
        for name, (prec, a_ctl) in controls.items():
            c = lanczos.ritz_pairs(a_ctl, v, tr["num_iters"], tr["k"], prec)
            rows[f"control.{name}"].append(compare.gaps(c, ref))
        for pol, got in witnesses.items():
            rows[f"witness.{pol}"].append(compare.gaps(got[i], ref))
    ref_s = (time.perf_counter() - t0) / max(len(sample), 1)
    out = {"workload": cell.name, "seed": seed, "solves": win["completed"],
           "sample": sample, "reference_s_per_solve": ref_s}
    for key, rs in rows.items():
        if rs:
            out[key] = compare.worst(rs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = cells.find(ROOT, args.workload)
    for j, seed in enumerate(int(s) for s in args.seeds.split(",")):
        rec = readings(ROOT, cell, seed, args.seconds, j < args.control_seeds, args.device)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
