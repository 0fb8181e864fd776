"""The encoder-decoder and VLM families (seamless-m4t-medium, qwen2-vl-72b)
on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither ``jax`` nor the reference package, so it runs on a machine that has
only PyTorch: from the repository root,

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_encdec_vlm_gpu.py

At the ``SMOKE`` configs (f32, TF32 off): the card's prefill and decode
logits within rel 1e-4 of the host's (f32 sums in another order over a few
layers), the card's decode within the reference's 2e-2 of the card's own
forward on one more token (for the VLM, past the prefixed patches); the
decode path launches none of the kernels, and a Hessian probe through the
encoder and the cross attention launches ``lanczos_update`` once a Lanczos
step and no other kernel.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.kernels import lanczos_fused, lanczos_update, mixed_dot, spmv_bsr, spmv_ell
from repro_torch.kernels import spmv_ell_packed
from repro_torch.models.common import split_tree
from repro_torch.models.model import decode_step, forward, init_model, prefill
from repro_torch.training.data import DataConfig, synthetic_batch
from repro_torch.training.spectral import hessian_spectrum

ARCHS = ["seamless-m4t-medium", "qwen2-vl-72b"]
KERNELS = (spmv_ell.spmv_ell_kernel_call, lanczos_update.lanczos_update_kernel_call,
           lanczos_update.lanczos_update_multi_kernel_call,
           lanczos_fused.spmv_ell_alpha_kernel_call, spmv_bsr.spmv_bsr_kernel_call,
           spmv_ell_packed.spmv_ell_packed_kernel_call, mixed_dot.mixed_dot_kernel_call)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _smoke(arch):
    cfg = get_config(arch, smoke=True)
    return cfg, split_tree(init_model(torch.Generator().manual_seed(1), cfg))[0]


def _on(params, dev):
    return tree.tree_map(lambda t: t.to(dev), params)


def _reset():
    for fn in KERNELS:
        fn.launches = 0


def _launches():
    return {fn.__name__: fn.launches for fn in KERNELS}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_the_card_matches_host_and_forward(cuda, arch):
    cfg, params = _smoke(arch)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 31)).astype(np.int32))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32))
    n_frames = 19 if cfg.family == "encdec" else 5
    frames = torch.from_numpy((rng.standard_normal((2, n_frames, cfg.d_model)) * 0.02)
                              .astype(np.float32))
    out = {}
    _reset()
    for dev in ("cpu", cuda):
        p = _on(params, dev)
        st, lp = prefill(p, cfg, {"tokens": toks.to(dev), "frames": frames.to(dev)}, max_len=64)
        ld, st = decode_step(p, cfg, st, nxt.to(dev))
        out[str(dev)] = (lp.cpu(), ld.cpu(), p, st.step)
    assert all(v == 0 for v in _launches().values()), _launches()
    s = toks.shape[1] + (n_frames if cfg.family == "vlm" else 0)
    assert out["cuda"][3] == out["cpu"][3] == s + 1
    for i, tag in ((0, "prefill"), (1, "decode")):
        want, got = out["cpu"][i], out["cuda"][i]
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-4, f"{arch} {tag}: card vs host rel err {err:.3e}"
    full, _ = forward(out["cuda"][2], cfg, {"tokens": torch.cat([toks, nxt], 1).to(cuda),
                                            "frames": frames.to(cuda)})
    got, want = out["cuda"][1][:, :cfg.vocab], full[:, -1, :cfg.vocab].cpu()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_probe_with_frames_runs_the_update_kernel(cuda, arch):
    cfg, params = _smoke(arch)
    batch = {k: v.to(cuda) for k, v in
             synthetic_batch(cfg, DataConfig(batch=2, seq_len=32, seed=5), 0, device="cpu").items()}
    assert "frames" in batch
    _reset()
    res = hessian_spectrum(_on(params, cuda), cfg, batch, k=4)
    launches = _launches()
    assert launches.pop("lanczos_update_kernel_call") == 8
    assert all(v == 0 for v in launches.values()), launches
    ev = res.eigenvalues.cpu().numpy()
    assert np.isfinite(ev).all() and np.all(np.diff(np.abs(ev)) <= 0)
