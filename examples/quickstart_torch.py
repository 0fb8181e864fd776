"""Quickstart of the PyTorch port: Top-K eigenpairs of a sparse graph matrix,
the counterpart of ``examples/quickstart.py``.

One call to ``repro_torch.eigsh`` converts the matrix, picks the SpMV
format, runs mixed-precision Lanczos through the Hopper kernels and reports
convergence.  Runs on the card unless ``--device cpu`` (the kernels' plain
versions on the host):

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import eigsh
from repro_torch.core import make_operator
from repro_torch.core.metrics import eigsh_reference, pairwise_orthogonality_deg, reconstruction_error
from repro_torch.sparse import generate


def web_graph():
    """A power-law web graph, symmetric-normalized adjacency (spectrum in [-1, 1])."""
    return generate("web", n=1 << 14, avg_deg=8.0, seed=0, values="normalized")


def solve(csr, device, v0=None):
    """The quickstart's one call (``v0``: an explicit start vector, else the
    seeded default)."""
    return eigsh(csr, k=8, policy="FDF", reorth="full", num_iters=32, v0=v0, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    csr = web_graph()
    print(f"matrix: n={csr.n:,} nnz={csr.nnz:,}")

    # one call: coercion, backend dispatch, precision policy, convergence report
    result = solve(csr, args.device)
    print(result.summary())

    print("top-8 |eigenvalues|:", result.eigenvalues.cpu().numpy())
    op = make_operator(csr, impl="coo", dtype=torch.float32, device=args.device)
    err = reconstruction_error(op, result.eigenvalues, result.eigenvectors,
                               accum_dtype=torch.float64)
    print(f"mean L2 reconstruction error ||Mx - λx||: {err:.2e}")
    print(f"mean pairwise eigenvector angle: {pairwise_orthogonality_deg(result.eigenvectors):.2f}°")

    ref_vals, _ = eigsh_reference(csr, 8)  # ARPACK — the paper's CPU baseline
    print("ARPACK agrees to:", float(np.abs(result.eigenvalues.cpu().numpy() - ref_vals).max()))
    print(f"solver wall time: {result.wall_time_s:.2f}s "
          f"(lanczos {result.timings['lanczos_s']:.2f}s, jacobi {result.timings['jacobi_s']:.3f}s)")
    return result


if __name__ == "__main__":
    main()
