"""Paper-technique-in-the-framework on the PyTorch port: Hessian spectrum
during LM training, the counterpart of ``examples/hessian_spectrum.py``.

Trains a small LM and probes the top-K |eigenvalues| of the loss Hessian
with the paper's mixed-precision Lanczos (matrix-free HVP operator) at
several checkpoints — the curvature trace practitioners use to diagnose
sharpness and learning-rate stability (lambda_max vs 2/eta).  Runs on the
card unless ``--device cpu``:

    PYTHONPATH=src python examples/hessian_spectrum_torch.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.precision import FDF, FFF
from repro_torch.core.tree import tree_map
from repro_torch.models.common import split_tree
from repro_torch.models.model import init_model
from repro_torch.training import DataConfig, OptConfig, TrainConfig, Trainer, data_stream
from repro_torch.training.data import synthetic_batch
from repro_torch.training.spectral import hessian_spectrum, hessian_topk


def init_params(cfg, device):
    """The model's weights from a seeded host generator, moved to ``device``
    (the same weights on either device)."""
    params, _ = split_tree(init_model(torch.Generator().manual_seed(0), cfg))
    return tree_map(lambda t: t.to(device), params)


def setup(device):
    """``(cfg, params, DataConfig, probe batch)`` of the example."""
    cfg = get_config("qwen3-0.6b", smoke=True)
    dc = DataConfig(batch=4, seq_len=32, seed=3)
    return cfg, init_params(cfg, device), dc, synthetic_batch(cfg, dc, 10**6, device=device)


def init_spectrum(params, cfg, probe, v0=None):
    """The probe at initialization (``v0``: an explicit start vector of
    length n, else the seeded default)."""
    return hessian_spectrum(params, cfg, probe, k=4, policy=FDF, num_iters=12, v0=v0)


def main(argv=None, v0=None):
    """Runs the example; returns ``{"init": λ, "steps": {step: λ}, "fff":
    λ}`` (top-4 |λ(H)| as f64 arrays)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg, params, dc, probe = setup(args.device)
    res0 = init_spectrum(params, cfg, probe, v0=v0)
    ev0 = res0.eigenvalues.detach().cpu().double().numpy()
    print(f"init      top-4 |λ(H)|: {np.round(ev0, 4)}   "
          f"(eigsh backend={res0.backend}, max residual {res0.residuals.max():.1e})")

    out = {"init": ev0, "steps": {}}
    with tempfile.TemporaryDirectory(prefix="repro_hess") as ckpt_dir:
        tc = TrainConfig(opt=OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=80),
                         ckpt_every=1000, ckpt_dir=ckpt_dir)
        tr = Trainer(cfg, tc, params)
        for phase in range(2):
            tr.run(data_stream(cfg, dc, start_step=tr.step, device=args.device),
                   num_steps=tr.step + 40, log_fn=lambda *_: None)
            ev = hessian_topk(tr.params, cfg, probe, k=4, policy=FDF, num_iters=12)
            out["steps"][tr.step] = ev
            lr = 3e-3
            print(f"step {tr.step:4d} top-4 |λ(H)|: {np.round(ev, 4)}   "
                  f"(2/η = {2/lr:.0f} — stable while |λ|max below this)")
        # mixed-precision comparison on the same operator (the paper's knob)
        ev_fff = hessian_topk(tr.params, cfg, probe, k=4, policy=FFF, num_iters=12)
    print(f"policy FFF vs FDF λmax delta: {abs(ev_fff[0] - ev[0]):.2e}")
    out["fff"] = ev_fff
    return out


if __name__ == "__main__":
    main()
