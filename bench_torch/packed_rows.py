#!/usr/bin/env python3
"""Time ``spmv_ell_packed`` with 2, 3 and 4 rows in flight per thread on one
NVIDIA card: the choice of ``kPackedRows`` in ``csrc/spmv_ell_packed.cu``.

Each count builds from a copy of this checkout's ``src`` with the constant
replaced (under ``build/packed_rows/``, all builds in parallel), then times
the kernel in turns (2, 3, 4, 4, 3, 2) on chunks made from seeds:
``generate("road", 1 << 18, 2.4)`` as one 262,144 x 8 chunk (int32 deltas,
the size of a chunk of ``chip_smoke.py`` phase 8) in bf16 and fp8, and
``generate("road", 1 << 15, 2.1)`` (int16 deltas).  x f32, accumulation f64,
as under FDF.  Run from the repository root:

    python3 bench_torch/packed_rows.py [--out packed_rows.json]

Prints, per count, the compiler's registers for the bf16 + int32 instantiation
and the device and series ms of each chunk (``chip_smoke.device_ms`` and
``time_ms``), with the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "packed_rows")
CONST = "constexpr int kPackedRows = {};"
COUNTS = (2, 3, 4)
# name -> generate("road", n, degree, seed=0), staged as one chunk
CHUNKS = {"road_1_18": (1 << 18, 2.4), "road_1_15": (1 << 15, 2.1)}


def variant(rows: int) -> str:
    """A copy of ``src`` whose packed kernel keeps ``rows`` rows in flight."""
    dst = os.path.join(WORK, f"rows{rows}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"), os.path.join(dst, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, "src", "repro_torch", "kernels", "csrc", "spmv_ell_packed.cu")
    text = open(path).read()
    found = re.findall(r"constexpr int kPackedRows = \d+;", text)
    if len(found) != 1:
        raise RuntimeError(f"kPackedRows not found once in {path}")
    open(path, "w").write(text.replace(found[0], CONST.format(rows)))
    return os.path.join(dst, "src")


def time_variant(src: str, chunks: str) -> dict:
    """In a fresh process: build ``src``'s kernels, time the packed kernel."""
    sys.path.insert(0, src)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.spmv_ell_packed import pack_ell_chunk, spmv_ell_packed_kernel_call

    build.load()
    regs = [ln.strip() for ln in build.BUILD_INFO["log"].splitlines()]
    entry = next(i for i, ln in enumerate(regs)
                 if "Compiling entry" in ln and "spmv_ell_packed_kernelI13__nv_bfloat16ifd" in ln)
    used = next(ln for ln in regs[entry:] if ": Used" in ln).split(":", 1)[1].strip()
    data = np.load(chunks)
    dev = torch.device("cuda")
    out = {"registers (bf16, int32, f32, f64)": used}
    for key in CHUNKS:
        val, col, n = data[key + "_val"], data[key + "_col"], int(data[key + "_n"])
        x = torch.as_tensor(np.random.default_rng(0).standard_normal(n), dtype=torch.float32,
                            device=dev)
        for mode in ("bf16", "fp8"):
            packed = [t.to(dev) for t in pack_ell_chunk(val, col, mode)]
            run = lambda: spmv_ell_packed_kernel_call(*packed, x, accum_dtype=torch.float64)  # noqa: E731
            err = float((run() - ref.spmv_ell_packed_ref(*packed, x, torch.float64)).abs().max())
            chip_smoke.check(err <= 1e-12 * float(run().abs().max()), f"{key} {mode}: error {err}")
            out[f"{key} {tuple(packed[0].shape)} {mode} {chip_smoke.dname(packed[3].dtype)}"] = {
                "device_ms": chip_smoke.device_ms(run), "ms": chip_smoke.time_ms(run),
                "max_abs_err": err}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the records as JSON here")
    ap.add_argument("--time", nargs=2, metavar=("SRC", "CHUNKS"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        print(json.dumps(time_variant(*args.time)))
        return 0
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("packed_rows.py: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.sparse import generate

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    os.makedirs(WORK, exist_ok=True)
    chunks = os.path.join(WORK, "chunks.npz")
    arrays = {}
    for key, (n, deg) in CHUNKS.items():
        m = generate("road", n, deg, seed=0)
        arrays[key + "_val"], arrays[key + "_col"] = chip_smoke.ell_chunk(m, 0, m.n)
        arrays[key + "_n"] = m.n
    np.savez(chunks, **arrays)
    srcs = {rows: variant(rows) for rows in COUNTS}
    builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                                "from repro_torch.kernels import build; build.load()", src])
              for src in srcs.values()]
    if any([b.wait() for b in builds]):  # wait for every build
        print("packed_rows.py: a build failed", file=sys.stderr)
        return 1
    runs = []
    for rows in COUNTS + tuple(reversed(COUNTS)):
        proc = subprocess.run([sys.executable, __file__, "--time", srcs[rows], chunks],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append({"rows_in_flight": rows, **json.loads(proc.stdout.strip().splitlines()[-1])})
        print(json.dumps(runs[-1]), flush=True)
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
