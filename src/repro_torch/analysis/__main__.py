"""CLI: ``python -m repro_torch.analysis [--check NAME]... [--strict] [--device D]``.

Exit status: 0 when clean (or when not ``--strict``), 1 when ``--strict``
and any finding survived suppression.  ``--summary-out`` appends a one-line
result.  On the card the ``kernels`` pass also prints every kernel
instantiation's registers, shared and local bytes and occupancy.  There is
no ``--vmem-budget-mb``: the card has no VMEM.
"""

from __future__ import annotations

import argparse
import sys
import time

from . import CHECKS, format_findings, resolve_device, run_checks


def _summary_line(results, elapsed: float, device: str) -> str:
    total = sum(len(v) for v in results.values())
    per = ", ".join(f"{k}: {len(v)}" for k, v in results.items())
    status = "clean" if total == 0 else f"{total} finding(s)"
    return f"static analysis: {status} ({per}) in {elapsed:.1f}s on {device}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Precision flow, Hopper launch checks, concurrency and config discipline "
        "of the PyTorch port.",
    )
    parser.add_argument("--check", action="append", choices=CHECKS,
                        help="run only this pass (repeatable; default: all)")
    parser.add_argument("--strict", action="store_true", help="exit 1 on any finding")
    parser.add_argument("--device", choices=("cpu", "cuda"), default=None,
                        help="where the precision and kernels passes run (default: the card; "
                        "without one the run fails, so pass --device cpu for the host)")
    parser.add_argument("--repo-root", default=".",
                        help="tree the AST passes lint (default: cwd)")
    parser.add_argument("--summary-out", default=None,
                        help="append a one-line summary to this file")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    t0 = time.time()
    results = run_checks(args.check, repo_root=args.repo_root, device=device)
    elapsed = time.time() - t0

    total = 0
    for name, findings in results.items():
        print(f"[{name}] {len(findings)} finding(s)")
        if findings:
            print(format_findings(findings))
        total += len(findings)
    if "kernels" in results and device == "cuda":
        from .kernel_check import format_attrs, read_kernel_attrs

        print(format_attrs(read_kernel_attrs()))
    line = _summary_line(results, elapsed, device)
    print(line)
    if args.summary_out:
        with open(args.summary_out, "a", encoding="utf-8") as fh:
            fh.write(line + "\n")
    return 1 if (args.strict and total) else 0


if __name__ == "__main__":
    sys.exit(main())
