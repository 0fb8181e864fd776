"""The port's dense decoder (``repro_torch.models``, ``repro_torch.configs``)
against the reference on the same weights (CPU).

The reference's params (``jax.device_get(split_tree(init_model(...))[0])``)
are carried into the port by ``params_from_numpy``, so both packages compute
the same function.  Tolerances (f32 smoke configs): logits within rel 1e-5
of max |logits|, the loss within rel 1e-6; attention and RoPE within 1e-5
(max abs error over max |reference|).  Each assert message prints the error
it measured.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.attention import _chunked_gqa as jax_chunked_gqa
from repro.models.common import apply_rope as jax_apply_rope
from repro.models.common import rms_norm as jax_rms_norm
from repro.models.common import split_tree as jax_split_tree
from repro.models.model import forward as jax_forward
from repro.models.model import init_model as jax_init_model
from repro.models.model import loss_fn as jax_loss_fn
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import synthetic_batch as jax_synthetic_batch
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import tree
from repro_torch.models.attention import _chunked_gqa
from repro_torch.models.common import apply_rope, rms_norm, split_tree
from repro_torch.models.model import (
    forward,
    init_model,
    loss_fn,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.training.data import DataConfig, synthetic_batch

DENSE = ["qwen3-0.6b", "codeqwen1.5-7b", "phi3-medium-14b", "qwen1.5-32b"]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module")
def carried():
    """Per arch: (reference cfg, reference params, port cfg, port params)."""
    out = {}
    for arch in DENSE:
        jc = jax_get_config(arch, smoke=True)
        jp = jax.device_get(jax_split_tree(jax_init_model(jax.random.PRNGKey(0), jc))[0])
        out[arch] = (jc, jp, get_config(arch, smoke=True), params_from_numpy(jp, device="cpu"))
    return out


def _batches(jc, tc, seq):
    jb = jax_synthetic_batch(jc, JaxDataConfig(batch=2, seq_len=seq, seed=5), 0)
    tb = synthetic_batch(tc, DataConfig(batch=2, seq_len=seq, seed=5), 0, device="cpu")
    return jb, tb


@pytest.mark.parametrize("seq", [16, 40], ids=["one-chunk", "padded-kv"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_loss_match_reference(carried, arch, seq):
    """seq 40 > attn_chunk 32: the KV padding path."""
    jc, jp, tc, tp = carried[arch]
    jb, tb = _batches(jc, tc, seq)
    want = np.asarray(jax_forward(jp, jc, jb)[0])
    got = forward(tp, tc, tb)[0].detach().numpy()
    assert got.shape == want.shape
    err = rel(got, want)
    assert err <= 1e-5, f"{arch} seq {seq}: logits rel err {err:.3e}"
    lw, lg = float(jax_loss_fn(jp, jc, jb)[0]), float(loss_fn(tp, tc, tb)[0])
    lerr = abs(lg - lw) / abs(lw)
    assert lerr <= 1e-6, f"{arch} seq {seq}: loss {lg} vs {lw}, rel err {lerr:.3e}"


@pytest.mark.parametrize("vocab", [512, 500], ids=["unpadded", "padded-vocab"])
def test_windowed_forward_matches_reference(vocab):
    """A sliding window (mixtral-style) over a sequence longer than the KV
    chunk; vocab 500 pads to 512 (masked logits)."""
    jc = dataclasses.replace(jax_get_config("qwen3-0.6b", smoke=True), window=9, vocab=vocab)
    tc = dataclasses.replace(get_config("qwen3-0.6b", smoke=True), window=9, vocab=vocab)
    jp = jax.device_get(jax_split_tree(jax_init_model(jax.random.PRNGKey(2), jc))[0])
    tp = params_from_numpy(jp, device="cpu")
    jb, tb = _batches(jc, tc, 40)
    want = np.asarray(jax_forward(jp, jc, jb)[0])
    got = forward(tp, tc, tb)[0].detach().numpy()
    live = slice(0, tc.vocab)
    err = rel(got[..., live], want[..., live])
    assert err <= 1e-5, f"window 9, vocab {vocab}: logits rel err {err:.3e}"
    assert np.all(got[..., tc.vocab:] <= -1e29)
    lw, lg = float(jax_loss_fn(jp, jc, jb)[0]), float(loss_fn(tp, tc, tb)[0])
    assert abs(lg - lw) / abs(lw) <= 1e-6, f"loss {lg} vs {lw}"


def _attn_inputs(seed=1, B=2, S=37, H=4, KV=2, D=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return q, k, v, pos


@pytest.mark.parametrize("window", [None, 9])
def test_chunked_gqa_matches_naive(window):
    """Online-softmax chunked GQA == naive softmax attention (the port of
    the reference's oracle test)."""
    q, k, v, pos = _attn_inputs()
    B, S, H, D = q.shape
    KV = k.shape[2]
    got = _chunked_gqa(*(torch.from_numpy(a) for a in (q, k, v, pos, pos)), causal=True,
                       window=window, chunk=8).numpy()
    kr, vr = np.repeat(k, H // KV, axis=2), np.repeat(v, H // KV, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kr) / np.sqrt(D)
    mask = pos[:, :, None] >= pos[:, None, :]
    if window is not None:
        mask &= pos[:, None, :] > pos[:, :, None] - window
    s = np.where(mask[:, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhqk,bkhd->bqhd", p, vr)
    err = rel(got, want)
    assert err <= 1e-5, f"window {window}: chunked vs naive rel err {err:.3e}"


@pytest.mark.parametrize("causal,window,chunk", [(True, None, 8), (True, 9, 8), (False, None, 16),
                                                 (True, None, 64)])
def test_chunked_gqa_matches_reference(causal, window, chunk):
    q, k, v, pos = _attn_inputs(seed=3)
    kv_pos = pos.copy()
    kv_pos[:, -3:] = -1  # empty slots
    want = np.asarray(jax_chunked_gqa(*(jnp.asarray(a) for a in (q, k, v, pos, kv_pos)),
                                      causal=causal, window=window, chunk=chunk))
    got = _chunked_gqa(*(torch.from_numpy(a) for a in (q, k, v, pos, kv_pos)), causal=causal,
                       window=window, chunk=chunk).numpy()
    err = rel(got, want)
    assert err <= 1e-5, f"causal {causal} window {window} chunk {chunk}: rel err {err:.3e}"


@pytest.mark.parametrize("sections", [None, (2, 3, 3)], ids=["rope", "mrope"])
def test_apply_rope_matches_reference(sections):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    shape = (3, 2, 8) if sections else (2, 8)
    pos = rng.integers(0, 100, shape).astype(np.int32)
    want = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4, sections))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4, sections).numpy()
    err = rel(got, want)
    assert err <= 1e-5, f"sections {sections}: rel err {err:.3e}"
    # rotation preserves per-pair norms
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), np.linalg.norm(x, axis=-1), rtol=1e-5)
    if sections:  # equal plane ids == plain rope
        same = torch.from_numpy(np.stack([pos[0]] * 3))
        a = apply_rope(torch.from_numpy(x), same, 1e4, sections)
        b = apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), 1e4)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    """f32 statistic, x kept in its dtype, scale ``1 + w``."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = np.asarray(jax_rms_norm(jx, jnp.asarray(w), 1e-6).astype(jnp.float32))
    got = rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    err = rel(got.float().numpy(), want)
    tol = 1e-6 if dtype == "float32" else float(torch.finfo(torch.bfloat16).eps)
    assert err <= tol, f"{dtype}: rel err {err:.3e}"


def _dtype_name(v):
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    try:
        return jnp.dtype(v).name
    except TypeError:
        return v


@pytest.mark.parametrize("smoke", [False, True], ids=["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", DENSE)
def test_configs_match_reference(arch, smoke):
    want, got = jax_get_config(arch, smoke), get_config(arch, smoke)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            a, b = _dtype_name(a), _dtype_name(b)
        assert a == b, f"{arch} {'SMOKE' if smoke else 'CONFIG'}.{f.name}: {b!r} vs {a!r}"
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]


def test_registry_lists_the_dense_family():
    """The dense archs and, since the other families landed, all ten of the
    reference's archs: each loads, ``CONFIG`` and ``SMOKE``."""
    from repro.configs import ARCHS as JAX_ARCHS

    assert sorted(ARCHS) == sorted(JAX_ARCHS) and len(ARCHS) == 10
    assert set(DENSE) <= set(ARCHS)
    for arch in ARCHS:
        for smoke in (False, True):
            cfg = get_config(arch, smoke=smoke)
            assert cfg.name == arch


def test_lm_modules_import_neither_jax_nor_the_reference():
    """``configs.env`` loads without the model stack (lazy ``ARCHS``), and the
    LM side imports neither ``jax`` nor ``repro``."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import repro_torch.configs.env\n"
        "assert 'repro_torch.models.model' not in sys.modules\n"
        "import repro_torch.configs.qwen3_0_6b, repro_torch.configs.codeqwen1_5_7b\n"
        "import repro_torch.configs.phi3_medium_14b, repro_torch.configs.qwen1_5_32b\n"
        "import repro_torch.configs.mixtral_8x7b, repro_torch.configs.arctic_480b\n"
        "import repro_torch.configs.recurrentgemma_2b, repro_torch.configs.mamba2_130m\n"
        "import repro_torch.models.rglru, repro_torch.models.ssd, repro_torch.models.model\n"
        "import repro_torch.distributed.sharding, repro_torch.serving.lm\n"
        "import repro_torch.serving, repro_torch.serving.engine\n"
        "import repro_torch.training, repro_torch.training.spectral\n"
        "import repro_torch.training.compression, repro_torch.launch.train\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_param_tree_names_and_flat_order_match_reference(carried):
    """The tree's leaf names are jax's key paths, and the flat vector is
    ``ravel_pytree``'s: the HVP's vector and the checkpoints rest on both."""
    from jax.flatten_util import ravel_pytree

    jc, jp, tc, tp = carried["qwen3-0.6b"]
    jnames = ["/".join(str(k) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [n for n, _ in tree.leaves_with_names(tp)] == jnames
    flat = np.asarray(ravel_pytree(jp)[0])
    np.testing.assert_array_equal(torch.cat([t.reshape(-1) for t in tree.leaves(tp)]).numpy(), flat)


def test_init_shapes_and_numpy_round_trip(carried):
    """The port's own init draws the reference's tree (shapes, dtypes), and
    ``params_to_numpy`` inverts ``params_from_numpy``."""
    jc, jp, tc, tp = carried["codeqwen1.5-7b"]
    own, axes = split_tree(init_model(torch.Generator().manual_seed(0), tc))
    jshapes = [(n, tuple(a.shape), a.dtype.name) for n, a in
               [("/".join(str(k) for k in p), a)
                for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]]]
    tshapes = [(n, tuple(t.shape), str(t.dtype).replace("torch.", ""))
               for n, t in tree.leaves_with_names(own)]
    assert tshapes == jshapes
    assert axes["blocks"]["dense_0"]["attn"]["wq"] == ("layers", "embed", "qkv")
    back = params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
    # the embedding draws N(0, 0.02); fan-in projections stay within 2/sqrt(d)
    emb = own["embed"]
    assert 0.015 < float(emb.std()) < 0.025
    wq = own["blocks"]["dense_0"]["attn"]["wq"]
    assert float(wq.abs().max()) <= 2.0 / np.sqrt(tc.d_model) + 1e-6
