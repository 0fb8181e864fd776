"""The LM decode path, the LM engine and the new families' Hessian probe on
the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither ``jax`` nor the reference package, so it runs on a machine that has
only PyTorch: from the repository root,

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_decode_gpu.py

At the ``SMOKE`` configs (f32): the card's prefill and decode logits within
rel 1e-4 of the host's (f32 sums in another order over a few layers; TF32
off), and within the reference's 2e-2 of the card's own forward; greedy
tokens of ``Engine`` equal the host's where each step's top-2 gap exceeds
that agreement; the decode path launches none of the six kernels; a probe
of each new family launches ``lanczos_update`` once a Lanczos step and no
other kernel.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.kernels import lanczos_fused, lanczos_update, mixed_dot, spmv_bsr, spmv_ell
from repro_torch.kernels import spmv_ell_packed
from repro_torch.models.common import split_tree
from repro_torch.models.model import decode_step, forward, init_model, prefill
from repro_torch.serving.lm import Engine, ServeConfig
from repro_torch.training.data import DataConfig, synthetic_batch
from repro_torch.training.spectral import hessian_spectrum

FAMILIES = ["mixtral-8x7b", "arctic-480b", "recurrentgemma-2b", "mamba2-130m"]
KERNELS = (spmv_ell.spmv_ell_kernel_call, lanczos_update.lanczos_update_kernel_call,
           lanczos_fused.spmv_ell_alpha_kernel_call, spmv_bsr.spmv_bsr_kernel_call,
           spmv_ell_packed.spmv_ell_packed_kernel_call, mixed_dot.mixed_dot_kernel_call)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _smoke(arch, cache="bf16"):
    cfg = dataclasses.replace(get_config(arch, smoke=True), kv_cache_dtype=cache)
    return cfg, split_tree(init_model(torch.Generator().manual_seed(1), cfg))[0]


def _on(params, dev):
    return tree.tree_map(lambda t: t.to(dev), params)


def _reset():
    for fn in KERNELS:
        fn.launches = 0


def _launches():
    return {fn.__name__: fn.launches for fn in KERNELS}


@pytest.mark.gpu
@pytest.mark.parametrize("arch,cache", [("qwen3-0.6b", "bf16"), ("qwen1.5-32b", "int8"),
                                        ("mixtral-8x7b", "int8"), ("recurrentgemma-2b", "bf16"),
                                        ("mamba2-130m", "bf16")])
def test_decode_on_the_card_matches_host_and_forward(cuda, arch, cache):
    cfg, params = _smoke(arch, cache)
    rng = np.random.default_rng(4)
    b, s = (1, 40) if cfg.window else (2, 31)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32))
    out = {}
    _reset()
    for dev in ("cpu", cuda):
        p = _on(params, dev)
        st, lp = prefill(p, cfg, {"tokens": toks.to(dev)}, max_len=64)
        ld, st = decode_step(p, cfg, st, nxt.to(dev))
        out[str(dev)] = (lp.cpu(), ld.cpu(), p)
    assert all(v == 0 for v in _launches().values()), _launches()
    for i, tag in ((0, "prefill"), (1, "decode")):
        want, got = out["cpu"][i], out["cuda"][i]
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-4, f"{arch}/{cache} {tag}: card vs host rel err {err:.3e}"
    ref_cfg = dataclasses.replace(cfg, capacity_factor=100.0) if cfg.n_experts else cfg
    full, _ = forward(out["cuda"][2], ref_cfg, {"tokens": torch.cat([toks, nxt], 1).to(cuda)})
    got, want = out["cuda"][1][:, :cfg.vocab], full[:, -1, :cfg.vocab].cpu()
    if cache == "int8":  # the reference's int8 bound
        assert float((got - want).abs().max()) < 0.15
    else:
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b", "recurrentgemma-2b",
                                  "mamba2-130m"])
def test_engine_on_the_card_matches_host(cuda, arch):
    cfg, params = _smoke(arch)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (2, 29))
                            .astype(np.int32))
    runs = {}
    for dev in ("cpu", cuda):
        eng = Engine(cfg, _on(params, dev), ServeConfig(max_len=64))
        gaps = []
        orig = eng._decode

        def watched(orig=orig, gaps=gaps, **kw):
            logits, st = orig(**kw)
            top2 = logits[:, :cfg.vocab].topk(2).values
            gaps.append(float((top2[:, 0] - top2[:, 1]).min() / logits[:, :cfg.vocab].abs().max()))
            return logits, st

        eng._decode = watched
        tokens, info = eng.generate({"tokens": toks.to(dev)}, 6)
        runs[str(dev)] = (tokens.cpu(), info["token_logprobs"].cpu(), gaps)
    (ht, hl, hg), (ct, cl, _) = runs["cpu"], runs["cuda"]
    assert min(hg[:-1]) > 1e-4, f"a near tie on the host: {hg}"
    torch.testing.assert_close(ct, ht)
    assert float((cl - hl).abs().max()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_probe_of_a_new_family_runs_the_update_kernel(cuda, arch):
    cfg, params = _smoke(arch)
    batch = {k: v.to(cuda) for k, v in
             synthetic_batch(cfg, DataConfig(batch=2, seq_len=32, seed=5), 0, device="cpu").items()}
    _reset()
    res = hessian_spectrum(_on(params, cuda), cfg, batch, k=4)
    launches = _launches()
    assert launches.pop("lanczos_update_kernel_call") == 8
    assert all(v == 0 for v in launches.values()), launches
    ev = res.eigenvalues.cpu().numpy()
    assert np.isfinite(ev).all() and np.all(np.diff(np.abs(ev)) <= 0)
