"""The benchmark of ``repro_torch`` (the port's package under ``src/``).

    python3 eigbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Runs one cell of ``BENCHMARK.json`` on the card this process sees: set-up
(the cell's matrix made on the card from the seed, ``repro_torch.prepare``,
warm-up solves), then ``--seconds`` of warm top-k solves in a closed loop,
then, with ``--trace 1``, the same again under ``torch.profiler``, then the
comparison of a sample of the window's solves with the float64 reference.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit;
the same numbers are the last lines of standard error.

Exits 3 with no result when no CUDA card is visible, or fewer than the
cell asks for; exits 4 with no result when the process holds JAX or the
JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Kernel and compiler caches at fixed paths inside the checkout, so that
# only a checkout's first run builds.
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
# The checkout's root in place of this script's folder, so that the
# benchmark's modules are imported as the ``eigbench`` package only.
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from eigbench import harness

    return harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                       t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
