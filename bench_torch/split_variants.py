#!/usr/bin/env python3
"""Time variants of ``spmv_ell_packed``'s split path on one NVIDIA card:
what its decoupled look-back costs, and two other ways to run it.

Each variant rewrites ``csrc/spmv_ell_packed.cu`` as text and builds it
alone into its own library under ``build/split_variants/`` (all builds in
parallel), as ``bsr_plans.py`` does; every variant then runs the packed
split path (bf16 values, int32 deltas, x f32, f64 accumulation; segments of
4 vectors a lane) on ``wide_rows.py``'s random rows, each variant in turn
on each shape:

* ``kernel``: the source as it is (32 tiles a look-back step);
* ``window4``: four status words a lane, 128 tiles a look-back step;
* ``late_ticket``: the next tile's ticket taken after the tile, not while
  it finishes;
* ``no_lookback``: every tile takes 0 as its column before (wrong columns,
  within ``x``: a timing of the path without its scan, never a result).

Run from the repository root:

    python3 bench_torch/split_variants.py [--out split_variants.json]

Prints the device ms of each variant on each shape (``chip_smoke.device_ms``:
the memset, the kernel and the reduce launch), and the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
WORK = os.path.join(ROOT, "build", "split_variants")
SHAPES = ((1, 1_047_672), (8, 1_047_672), (251, 25_232), (251, 1_047_672))
WINDOW4 = """__device__ __forceinline__ unsigned tile_prefix(const unsigned long long* status, long long tile,
                                                int lane) {
  unsigned excl = 0;
  long long j = tile - 1;
  while (true) {
    unsigned long long w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long k = j - 4LL * lane - i;
      w[i] = kInclusive;
      if (k >= 0) w[i] = *reinterpret_cast<const volatile unsigned long long*>(status + k);
    }
    int first = 4;
#pragma unroll
    for (int i = 3; i >= 0; --i)
      if ((w[i] & ~0xffffffffULL) == kInclusive) first = i;
    const unsigned with_incl = __ballot_sync(0xffffffffu, first < 4);
    const int stop = with_incl ? __ffs(with_incl) - 1 : 32;
    const int upto = lane < stop ? 4 : lane == stop ? first + 1 : 0;
    bool ready = true;
    unsigned sum = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < upto) {
        ready &= w[i] != 0ULL;
        sum += word_value(w[i]);
      }
    if (!__all_sync(0xffffffffu, ready)) {
      __nanosleep(64);
      continue;
    }
    excl += __reduce_add_sync(0xffffffffu, sum);
    if (with_incl) return excl;
    j -= 128;
  }
}

"""
TICKET = "    if (threadIdx.x == 0) block_ticket = atomicAdd(words, 1ULL);\n    if (warp == 0) {"
TAIL = "      if (lane == 0) partials[t] = acc;\n    }\n  }\n}"


def variant_sources(src: str) -> dict:
    i0 = src.index("__device__ __forceinline__ unsigned tile_prefix(")
    i1 = src.index("// The split path.  Scratch:")
    edits = {
        "kernel": [],
        "late_ticket": [(TICKET, "    if (warp == 0) {"),
                        (TAIL, TAIL[:-6] + "\n    __syncthreads();\n    if (threadIdx.x == 0) "
                               "block_ticket = atomicAdd(words, 1ULL);\n    __syncthreads();\n  }\n}")],
        "no_lookback": [("const unsigned before = tile_prefix(status, tile, lane);",
                         "const unsigned before = 0u;")],
    }
    out = {"window4": src[:i0] + WINDOW4 + src[i1:]}
    for name, subs in edits.items():
        text = src
        for a, b in subs:
            if a not in text:
                raise RuntimeError(f"{name}: the text to rewrite is not in the source")
            text = text.replace(a, b)
        out[name] = text
    return {name: out[name] for name in ("kernel", "window4", "late_ticket", "no_lookback")}


def build_variants() -> dict:
    from repro_torch.kernels import build

    src = open(os.path.join(CSRC, "spmv_ell_packed.cu")).read()
    procs = {}
    for name, text in variant_sources(src).items():
        out = os.path.join(WORK, name)
        os.makedirs(out, exist_ok=True)
        for header in ("common.cuh", "ell_row.cuh"):
            with open(os.path.join(out, header), "w") as f:
                f.write(open(os.path.join(CSRC, header)).read())
        with open(os.path.join(out, "spmv_ell_packed.cu"), "w") as f:
            f.write(text)
        lib = os.path.join(out, "libsplit.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared",
               os.path.join(out, "spmv_ell_packed.cu"), "-o", lib]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        handle = ctypes.CDLL(lib)
        fn = handle.repro_spmv_ell_packed
        fn.restype, fn.argtypes = build._SIGNATURES["repro_spmv_ell_packed"]
        libs[name] = handle
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the records as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("split_variants.py: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "bench_torch"))
    import chip_smoke
    import wide_rows
    from repro_torch.kernels import build, spmv_ell_packed

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    libs = build_variants()
    real = build.load()

    class Library:  # a variant's packed entry point, the real library for the rest
        def __init__(self, variant):
            self.variant = variant

        def __getattr__(self, name):
            return getattr(self.variant if name == "repro_spmv_ell_packed" else real, name)

    g = torch.Generator(device="cuda").manual_seed(0)
    plan = (32, "split", 32 * 4 * 8)
    records = []
    try:
        for rows, width in SHAPES:
            ops, x = wide_rows.make_case("bf16", rows, width, g)
            times = {}
            for name, lib in libs.items():
                build._LIB = Library(lib)
                run = lambda: spmv_ell_packed.launch(*ops, x, torch.float64, plan)  # noqa: E731
                times[name] = chip_smoke.device_ms(run, calls=10)
            build._LIB = real
            records.append({"rows": rows, "width": width, "device_ms": times})
            print(f"[split_variants] bf16 {rows} x {width:,}: "
                  + "; ".join(f"{k} {t:.4f} ms" for k, t in times.items()))
            del ops, x
    finally:
        build._LIB = real
    out = {"device": smi, "records": records}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(f"[split_variants] on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
