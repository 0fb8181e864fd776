"""Spectral clustering with the Top-K eigensolver on the PyTorch port, the
counterpart of ``examples/spectral_graph.py``.

Builds a planted-partition graph (4 communities), computes the top
eigenvectors of the normalized adjacency with the mixed-precision Lanczos
solver, embeds vertices in spectral space, clusters with k-means (NumPy),
and reports clustering accuracy vs the planted labels.  Runs on the card
unless ``--device cpu``:

    PYTHONPATH=src python examples/spectral_graph_torch.py [--device cpu]

The graph is the reference example's, unchanged: ``csr_from_coo`` keeps the
sampled edges one-directional and the normalization divides by row counts,
so the matrix is not symmetric and its spectrum leaves [-1, 1].  The
accuracy assertion below fails in both packages for that reason.
"""

import argparse
import itertools

import numpy as np

from repro_torch import eigsh
from repro_torch.sparse import csr_from_coo


def planted_partition(n=8192, k=4, p_in=12.0, p_out=1.0, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, n)
    # sample edges: in-community with rate p_in/n per pair-bucket, cross p_out/n
    m_in = int(n * p_in / 2)
    m_out = int(n * p_out / 2)
    rows, cols = [], []
    for c in range(k):
        idx = np.where(labels == c)[0]
        r = rng.choice(idx, size=m_in // k * 2)
        rows.append(r[: m_in // k]); cols.append(r[m_in // k :])
    rows.append(rng.integers(0, n, m_out)); cols.append(rng.integers(0, n, m_out))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = np.ones_like(rows, dtype=np.float64)
    csr = csr_from_coo(rows, cols, vals, n)
    # normalized adjacency
    deg = np.maximum(csr.row_nnz(), 1).astype(np.float64)
    dinv = 1.0 / np.sqrt(deg)
    rix = np.repeat(np.arange(n), csr.row_nnz())
    csr.data = csr.data * dinv[rix] * dinv[csr.indices]
    return csr, labels


def kmeans(x, k, iters=50, seed=0):
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), k, replace=False)]
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        a = d.argmin(1)
        centers = np.stack([x[a == c].mean(0) if (a == c).any() else centers[c] for c in range(k)])
    return a


def accuracy(pred, truth, k):
    # best label permutation (greedy; k=4 so fine)
    best = 0.0
    for perm in itertools.permutations(range(k)):
        mapped = np.array([perm[p] for p in pred])
        best = max(best, (mapped == truth).mean())
    return best


def cluster(csr, labels, device, v0=None):
    """``(result, accuracy)``: the example's solve (``v0``: an explicit start
    vector, else the seeded default), its row-normalized spectral embedding,
    k-means and the accuracy against the planted labels."""
    res = eigsh(csr, k=4, policy="FDF", reorth="full", num_iters=24, v0=v0, device=device)
    emb = res.eigenvectors.cpu().double().numpy()
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    pred = kmeans(emb, 4)
    return res, accuracy(pred, labels, 4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    csr, labels = planted_partition()
    print(f"graph: n={csr.n:,} nnz={csr.nnz:,}, 4 planted communities")
    res, acc = cluster(csr, labels, args.device)
    print("top-4 eigenvalues:", res.eigenvalues.cpu().numpy(),
          f"(backend={res.backend}, {int(res.converged.sum())}/4 converged)")
    print(f"spectral clustering accuracy vs planted labels: {acc:.3f}")
    assert acc > 0.85, "clustering should recover planted communities"


if __name__ == "__main__":
    main()
