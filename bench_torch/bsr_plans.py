#!/usr/bin/env python3
"""Time ``spmv_bsr`` under several launch plans on one NVIDIA card: the
choice of lanes a block-row and slots a step (``kBsrPlan`` in
``csrc/spmv_bsr.cu``) for f32 values, the storage of the FDF policy.

Each plan builds ``csrc/spmv_bsr.cu`` alone, with the f32 rows of the table
replaced, into its own library under ``build/bsr_plans/`` (all builds in
parallel), then every plan is timed in turns (1, 2, ..., n, n, ..., 1) on
``chip_smoke.py`` phase 2's three matrices: kron(road 262,144, dense 4 x 4),
kron(road 65,536, dense 8 x 8) and kron(road 16,384, dense 16 x 16), each
about 16.8M nnz, f32 values, f64 accumulation.  Run from the repository
root:

    python3 bench_torch/bsr_plans.py [--out bsr_plans.json]

Prints, per plan and matrix, the device and series ms (``chip_smoke``'s
``device_ms`` and ``time_ms``) and the error against ``ref.spmv_bsr_ref``;
then the compiler's registers of each plan's ``<float, double>`` kernels,
the bound, ``torch.mv`` on a BSR tensor and the card's ``nvidia-smi`` name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
WORK = os.path.join(ROOT, "build", "bsr_plans")
# Candidate (lanes a block-row, slots a step) for f32 values at BS 4, 8, 16:
# plan i takes the i-th entry of each edge.
CANDIDATES = {
    4: ((2, 2), (2, 1), (2, 4), (4, 2), (4, 4), (1, 4)),
    8: ((4, 2), (4, 1), (2, 2), (8, 2), (4, 4), (2, 4)),
    16: ((8, 1), (8, 2), (4, 1), (16, 1), (16, 2), (4, 2)),
}
ROAD_ROWS = {4: 1 << 18, 8: 1 << 16, 16: 1 << 14}
SEEDS = {4: 4, 8: 1, 16: 16}  # chip_smoke.py's: make_data's rng(1) at BS 8, rng(bs) otherwise


def plan_name(i: int) -> str:
    return "_".join(f"bs{bs}-{c[i][0]}x{c[i][1]}" for bs, c in CANDIDATES.items())


def build_plans() -> dict:
    """Build one library per plan; returns name -> (library, registers)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    src = open(os.path.join(CSRC, "spmv_bsr.cu")).read()
    common = open(os.path.join(CSRC, "common.cuh")).read()
    procs = {}
    for i in range(len(CANDIDATES[4])):
        name = plan_name(i)
        text = src
        for bs, cands in CANDIDATES.items():
            lanes, unroll = cands[i]
            text, n = re.subn(rf"\{{4, {bs}, \d+, \d+\}}", f"{{4, {bs}, {lanes}, {unroll}}}", text)
            if n != 1:
                raise RuntimeError(f"kBsrPlan's f32 row for BS {bs} not found once")
        out = os.path.join(WORK, name)
        os.makedirs(out, exist_ok=True)
        open(os.path.join(out, "spmv_bsr.cu"), "w").write(text)
        open(os.path.join(out, "common.cuh"), "w").write(common)
        lib = os.path.join(out, "libbsr.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", os.path.join(out, "spmv_bsr.cu"),
               "-o", lib]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        regs, entry = {}, None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                entry = m.group(1)
            elif ": Used" in ln and entry and "spmv_bsr_kernelIfdLi" in entry:
                bs = int(re.search(r"spmv_bsr_kernelIfdLi(\d+)E", entry).group(1))
                regs[bs] = ln.split(": Used", 1)[1].strip()
        built[name] = (lib, regs)
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the records as JSON here")
    args = ap.parse_args()
    import numpy as np
    import scipy.sparse as sp
    import torch

    if not torch.cuda.is_available():
        print("bsr_plans.py: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels import build, ref
    from repro_torch.sparse import generate, to_device_bsr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    built = build_plans()
    dev = torch.device("cuda")
    S, A = chip_smoke.MAIN_PAIR
    g = torch.Generator(device=dev).manual_seed(0)
    mats = {}
    for bs, rows in ROAD_ROWS.items():
        b = np.random.default_rng(SEEDS[bs]).random((bs, bs))
        small = generate("road", rows, 2.1, seed=0)
        csr = chip_smoke.to_port_csr(sp.kron(small.to_scipy(), sp.csr_matrix((b + b.T) / 2)))
        bsr = to_device_bsr(csr, block_size=bs, dtype=S, device=dev)
        nbr, slots, _, _ = bsr.val.shape
        x = torch.randn(nbr * bs, generator=g, dtype=torch.float64, device=dev).to(S)
        t_b, by = chip_smoke.bound(chip_smoke.nbytes(bsr.val, bsr.bcol, x) + nbr * bs * A.itemsize,
                                   2.0 * bsr.val.numel(), A)
        lib = chip_smoke.library_bsr(csr, S, x, bs)
        want = ref.spmv_bsr_ref(bsr.val, bsr.bcol, x, A)
        mats[bs] = {"val": bsr.val, "bcol": bsr.bcol, "x": x, "want": want,
                    "layout": f"{nbr} x {slots} x {bs} x {bs}", "bound_ms": t_b, "bound_by": by,
                    "torch_mv_device_ms": None if lib is None else chip_smoke.device_ms(lib),
                    "torch_mv_ms": None if lib is None else chip_smoke.time_ms(lib)}
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name, (path, _) in built.items():
        lib = ctypes.CDLL(path)
        lib.repro_spmv_bsr.restype = I
        lib.repro_spmv_bsr.argtypes = [I, I, P, P, P, P, L, I, I, P]
        libs[name] = lib

    def runner(lib, m):
        nbr, slots, bs, _ = m["val"].shape
        y = torch.empty(nbr * bs, dtype=A, device=dev)
        args = (build.dtype_code(S), build.dtype_code(A), build.ptr(m["val"]),
                build.ptr(m["bcol"]), build.ptr(m["x"]), build.ptr(y), nbr, slots, bs,
                build.stream_of(y))

        def run():
            chip_smoke.check(lib.repro_spmv_bsr(*args) == 0, "spmv_bsr launch failed")
            return y
        return run

    order = list(built) + list(reversed(built))
    runs = []
    for name in order:
        rec = {"plan": name}
        for bs, m in mats.items():
            run = runner(libs[name], m)
            err = float((run().double() - m["want"].double()).abs().max())
            chip_smoke.check(err <= chip_smoke.RTOL[A] * float(m["want"].abs().max()),
                             f"{name} BS {bs}: error {err}")
            rec[f"bs{bs}"] = {"device_ms": chip_smoke.device_ms(run), "ms": chip_smoke.time_ms(run),
                              "max_abs_err": err}
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {bs: {k: v for k, v in m.items() if k not in ("val", "bcol", "x", "want")}
               for bs, m in mats.items()}
    print(json.dumps({"registers": {n: r for n, (_, r) in built.items()}, "matrices": summary}))
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "runs": runs,
                       "registers": {n: r for n, (_, r) in built.items()},
                       "matrices": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
