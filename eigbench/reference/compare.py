"""The numbers that decide ``correct``: how far a solve's eigenpairs lie
from the reference's, each against its limit.

Both sides' pairs are put in ascending order of ``lambda`` before they are
matched, so that two Ritz values of nearly equal magnitude and opposite
sign cannot swap places between the sides; a Ritz vector is compared up
to its sign.

* ``eig_gap``: the largest ``|lambda_prog - lambda_ref|`` over the
  largest ``|lambda_ref|``.
* ``vec_gap``: the largest ``min(||x_prog - x_ref||, ||x_prog + x_ref||)
  / ||x_ref||`` over the pairs.
* ``tri_gap``: the largest gap between the sweep's tridiagonal (its
  ``alpha`` and ``beta``, in the compute dtype) and the reference's, over
  the largest of the reference's entries.  The eigenpairs leave the solve
  rounded to the output dtype, which hides the compute dtype's rounding;
  the tridiagonal does not, so this is the number that sees float32 sums
  in place of float64 ones.
"""

from __future__ import annotations

import math

import torch

NAMES = ("eig_gap", "vec_gap", "tri_gap")


def _host(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", torch.float64).reshape(-1)


def gaps(got, ref) -> dict:
    """The three numbers for one solve: ``got`` is the program's answer
    (any device), ``ref`` the reference's, both
    :class:`~eigbench.reference.lanczos.RitzPairs`."""
    evecs, ref_evecs = got.eigenvectors, ref.eigenvectors
    lp, lr = _host(got.eigenvalues), _host(ref.eigenvalues)
    tp = [_host(got.alpha), _host(got.beta)]
    tr = [_host(ref.alpha), _host(ref.beta)]
    if (lp.shape != lr.shape or tuple(evecs.shape) != tuple(ref_evecs.shape)
            or [t.shape for t in tp] != [t.shape for t in tr]):
        return {name: math.inf for name in NAMES}
    ip, ir = torch.argsort(lp), torch.argsort(lr)
    eig = float((lp[ip] - lr[ir]).abs().max() / lr.abs().max())
    tri = float(max((p - r).abs().max() for p, r in zip(tp, tr))
                / max(r.abs().max() for r in tr))
    dev = ref_evecs.device
    vec = []
    for a, b in zip(ip.tolist(), ir.tolist()):
        xp = evecs[:, a].to(dev, torch.float64)
        xr = ref_evecs[:, b].to(torch.float64)
        d = torch.minimum(torch.linalg.vector_norm(xp - xr), torch.linalg.vector_norm(xp + xr))
        vec.append(float(d / torch.linalg.vector_norm(xr)))
    if not all(math.isfinite(x) for x in [eig, tri, *vec]):
        return {name: math.inf for name in NAMES}
    return {"eig_gap": eig, "vec_gap": max(vec), "tri_gap": tri}


def worst(readings: list) -> dict:
    """The largest reading of each number over several solves."""
    return {name: max((r[name] for r in readings), default=math.inf) for name in NAMES}


def judge(readings: dict, limits: dict) -> bool:
    return all(readings[name] <= limits[name] for name in NAMES)
