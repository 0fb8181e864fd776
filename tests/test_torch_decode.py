"""The port's decode path (``prefill``, ``decode_step``, the bf16/int8 and
ring KV caches, ``decode_state_axes``) against the reference on the same
weights (CPU, f32 ``SMOKE`` configs), and the reference's decode tests on
the port.

Tolerances, max abs error over max |reference|, from what a sum in another
order costs in f32: logits and float state leaves within 1e-5 (measured
below 2e-6); slot positions equal.  An int8 cache leaf may differ from the
reference's by one quantization step where the two packages' K/V (equal to
a few ulps) straddle a rounding tie: at most 1 in 1,000 values, each by at
most 1; its logits then within 1e-3 (one step of one element of one head).
The port's decode against its own forward keeps the reference's 2e-2 (0.15
for the int8 cache).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import model as jm
from repro.models.common import split_tree as jax_split_tree
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import synthetic_batch as jax_synthetic_batch
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.models import attention, model as tm
from repro_torch.models.common import split_tree
from repro_torch.training.data import DataConfig, synthetic_batch

ARCHS = ["qwen3-0.6b", "codeqwen1.5-7b", "phi3-medium-14b", "qwen1.5-32b",
         "mixtral-8x7b", "arctic-480b", "recurrentgemma-2b", "mamba2-130m"]
FAMILIES = ["mixtral-8x7b", "arctic-480b", "recurrentgemma-2b", "mamba2-130m"]
# (arch, KV cache): mamba2 has no attention, so no cache to quantize.
CASES = [(a, c) for a in ARCHS for c in ("bf16", "int8") if not (a == "mamba2-130m" and c == "int8")]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def carried():
    """Per arch: (reference cfg, reference params, port cfg, port params)."""
    out = {}
    for arch in ARCHS:
        jc = jax_get_config(arch, smoke=True)
        jp = jax.device_get(jax_split_tree(jm.init_model(jax.random.PRNGKey(0), jc))[0])
        out[arch] = (jc, jp, get_config(arch, smoke=True), tm.params_from_numpy(jp))
    return out


def _prompt(cfg, seed=42):
    """A prompt longer than the window on windowed archs (B 1 x S 40 against
    a window of 32), else B 2 x S 31 (odd: chunk padding); and 2 next tokens."""
    rng = np.random.default_rng(seed)
    b, s = (1, 40) if cfg.window else (2, 31)
    return (rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            rng.integers(0, cfg.vocab, (2, b, 1)).astype(np.int32))


def _state_leaves(state):
    """(name, array) of the layer and remainder states, in flatten order."""
    return [(n, np.asarray(v)) for n, v in
            tree.leaves_with_names((state.layers, tuple(state.rem)))]


def _compare_states(tag, got, want):
    assert [n for n, _ in got] == [n for n, _ in want], tag
    for (name, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, f"{tag} {name}: {g.dtype}{g.shape} vs {w.dtype}{w.shape}"
        if w.dtype == np.int8:
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, \
                f"{tag} {name}: int8 off by up to {d.max()} at {(d > 0).mean():.2e} of values"
        elif w.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=f"{tag} {name}")
        else:
            err = rel(g, w)
            assert err <= 1e-5, f"{tag} {name}: rel err {err:.3e}"


@pytest.mark.parametrize("arch,cache", CASES)
def test_prefill_and_decode_match_reference(carried, arch, cache):
    """prefill, then two decode steps: logits and the whole state tree, leaf
    by leaf, after each (windowed archs past the window, so the ring has
    wrapped)."""
    jc, jp, tc, tp = carried[arch]
    jc, tc = (dataclasses.replace(c, kv_cache_dtype=cache) for c in (jc, tc))
    toks, nxt = _prompt(tc)
    tol = 1e-3 if cache == "int8" else 1e-5
    jst, jl = jm.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, max_len=64)
    tst, tl = tm.prefill(tp, tc, {"tokens": t(toks)}, max_len=64)
    assert tst.step == int(jst.step) == toks.shape[1]
    err = rel(tl.numpy(), jl)
    assert err <= tol, f"{arch}/{cache} prefill logits rel err {err:.3e}"
    _compare_states(f"{arch}/{cache} prefill", _state_leaves(tst),
                    _state_leaves(jax.device_get(jst)))
    for i in range(2):
        jl, jst = jm.decode_step(jp, jc, jst, jnp.asarray(nxt[i]))
        tl, tst = tm.decode_step(tp, tc, tst, t(nxt[i]))
        err = rel(tl.numpy(), jl)
        assert err <= tol, f"{arch}/{cache} decode {i} logits rel err {err:.3e}"
        _compare_states(f"{arch}/{cache} decode {i}", _state_leaves(tst),
                        _state_leaves(jax.device_get(jst)))
    assert tst.step == int(jst.step)


def _plain(x):
    """A NamedTuple tree as plain nested tuples and dicts (either package's)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__,) + tuple((f, _plain(getattr(x, f))) for f in x._fields)
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    return x


@pytest.mark.parametrize("arch,cache", CASES)
def test_decode_state_axes_match_reference(arch, cache):
    jc = dataclasses.replace(jax_get_config(arch, smoke=True), kv_cache_dtype=cache)
    tc = dataclasses.replace(get_config(arch, smoke=True), kv_cache_dtype=cache)
    assert _plain(tm.decode_state_axes(tc)) == _plain(jm.decode_state_axes(jc))
    # and the same full-width structure the dry-run would shard
    full = dataclasses.replace(get_config(arch), kv_cache_dtype=cache)
    jfull = dataclasses.replace(jax_get_config(arch), kv_cache_dtype=cache)
    assert _plain(tm.decode_state_axes(full)) == _plain(jm.decode_state_axes(jfull))


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "recurrentgemma-2b"])
def test_init_decode_state_matches_reference(arch):
    """Empty caches (-1 slot positions, the window's slots) and zero
    recurrent states, in the reference's tree."""
    jc = dataclasses.replace(jax_get_config(arch, smoke=True), kv_cache_dtype="int8")
    tc = dataclasses.replace(get_config(arch, smoke=True), kv_cache_dtype="int8")
    js = jax.device_get(jm.init_decode_state(jc, 2, 64, step=5))
    ts = tm.init_decode_state(tc, 2, 64, step=5, device="cpu")
    assert ts.step == 5 and ts.cross is None
    _compare_states(arch, _state_leaves(ts), _state_leaves(js))


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_loss_match_reference(carried, arch):
    """seq 40: past the smoke window (32) of recurrentgemma, a ragged tail
    for mamba2's chunk (16); the MoE archs at 32 (a whole group of 64
    tokens), with their aux in the loss."""
    jc, jp, tc, tp = carried[arch]
    seq = 32 if jc.n_experts else 40
    jb = jax_synthetic_batch(jc, JaxDataConfig(batch=2, seq_len=seq, seed=5), 0)
    tb = synthetic_batch(tc, DataConfig(batch=2, seq_len=seq, seed=5), 0)
    jl, jaux = jm.forward(jp, jc, jb)
    tl, taux = tm.forward(tp, tc, tb)
    err = rel(tl.numpy(), jl)
    assert err <= 1e-5, f"{arch}: logits rel err {err:.3e}"
    a, b = float(taux["moe_aux"]), float(jaux["moe_aux"])
    assert abs(a - b) <= 1e-6 * max(1.0, abs(b)), f"{arch}: moe_aux {a} vs {b}"
    lw, lg = float(jm.loss_fn(jp, jc, jb)[0]), float(tm.loss_fn(tp, tc, tb)[0])
    assert abs(lg - lw) / abs(lw) <= 1e-6, f"{arch}: loss {lg} vs {lw}"


# ------------------------------------------------- the reference's tests


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(carried, arch):
    """The reference's ``test_decode_matches_forward`` on the port:
    prefill(S) + decode(t) == forward(S+1) (the MoE forward dropless)."""
    _, _, cfg, params = carried[arch]
    rng = np.random.default_rng(42)
    b, s = 2, 31
    toks = t(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
    state, _ = tm.prefill(params, cfg, {"tokens": toks}, max_len=64)
    nxt = t(rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32))
    lg_dec, _ = tm.decode_step(params, cfg, state, nxt)
    ref_cfg = dataclasses.replace(cfg, capacity_factor=100.0) if cfg.n_experts else cfg
    lg_ref, _ = tm.forward(params, ref_cfg, {"tokens": torch.cat([toks, nxt], 1)})
    torch.testing.assert_close(lg_dec[:, :cfg.vocab], lg_ref[:, -1, :cfg.vocab],
                               rtol=2e-2, atol=2e-2)


def test_kv_quantization_roundtrip():
    """The reference's test on the port: within one quantization step of amax."""
    x = t(np.random.default_rng(0).standard_normal((2, 16, 4, 32)) * 3.0).to(torch.bfloat16)
    q, s = attention.quantize_kv(x)
    back = q.float() * s[..., None]
    err = float((back - x.float()).abs().max() / (x.float().abs().max() + 1e-9))
    assert err < 1.5 / 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_reference(dtype):
    """The same int8 values (``round`` is half to even in both) and scales
    within 1 ulp, on values that include exact rounding ties."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 16, 4, 32)) * 3.0).astype(np.float32)
    x[..., 0] = 127.0 / 4.0  # amax 31.75 on these rows: x / scale hits .5 ties
    x[..., 1] = 2.5 / 4.0
    jx = jnp.asarray(x, jnp.dtype(dtype))
    jq, js = (np.asarray(a) for a in jax_attention.quantize_kv(jx))
    tq, ts = attention.quantize_kv(t(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(tq.numpy(), jq)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    ulps = np.abs(ts.numpy().view(np.int32) - js.view(np.int32)).max()
    assert ulps <= 1, f"scales differ by {ulps} ulp"


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "mixtral-8x7b"])
def test_int8_cache_decode_matches_forward(carried, arch):
    """The reference's test on the port: the int8 cache's decode within 0.15
    of the forward's logits."""
    _, _, cfg, params = carried[arch]
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    rng = np.random.default_rng(1)
    toks = t(rng.integers(0, cfg.vocab, (2, 31)).astype(np.int32))
    st, _ = tm.prefill(params, cfg8, {"tokens": toks}, max_len=64)
    assert any(v.dtype == torch.int8 for v in tree.leaves(st.layers))
    nxt = t(rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32))
    lgd, _ = tm.decode_step(params, cfg8, st, nxt)
    ref_cfg = dataclasses.replace(cfg, capacity_factor=100.0) if cfg.n_experts else cfg
    lgr, _ = tm.forward(params, ref_cfg, {"tokens": torch.cat([toks, nxt], 1)})
    err = float((lgd[:, :cfg.vocab] - lgr[:, -1, :cfg.vocab]).abs().max())
    assert err < 0.15, err


def test_windowed_ring_cache_evicts_correctly(carried):
    """The reference's test on the port: the SWA cache keeps exactly the
    last ``window`` positions through decode."""
    _, _, cfg, params = carried["mixtral-8x7b"]  # window 32
    rng = np.random.default_rng(2)
    s = 40
    st, _ = tm.prefill(params, cfg, {"tokens": t(rng.integers(0, cfg.vocab, (1, s)).astype(np.int32))},
                       max_len=64)
    cache = st.layers["moe_0"]
    assert cache.k.shape[-3] == cfg.window
    sp = cache.slot_pos.numpy()
    assert sp.min() >= s - cfg.window and sp.max() == s - 1
    for _ in range(3):
        tok = t(rng.integers(0, cfg.vocab, (1, 1)).astype(np.int32))
        _, st = tm.decode_step(params, cfg, st, tok)
    sp = st.layers["moe_0"].slot_pos.numpy()
    assert sp.max() == s + 2 and sp.min() >= s + 3 - cfg.window
    # every slot holds a distinct position: the last `window` of them
    assert sorted(sp[0, 0].tolist()) == list(range(s + 3 - cfg.window, s + 3))


def test_decode_step_consumes_the_state(carried):
    """``decode_step`` writes the caches and recurrent states in place: the
    state it returns holds the same buffers, one step on."""
    _, _, cfg, params = carried["recurrentgemma-2b"]
    toks = t(np.random.default_rng(3).integers(0, cfg.vocab, (1, 9)).astype(np.int32))
    st, _ = tm.prefill(params, cfg, {"tokens": toks}, max_len=16)
    before = [v.clone() for v in tree.leaves(st.layers)]
    ptrs = [v.data_ptr() for v in tree.leaves(st.layers)]
    _, st2 = tm.decode_step(params, cfg, st, toks[:, :1])
    assert st2.step == st.step + 1 == 10
    assert [v.data_ptr() for v in tree.leaves(st2.layers)] == ptrs
    assert all(not torch.equal(a, b) for a, b in zip(before, tree.leaves(st2.layers)))


def test_encdec_and_vlm_still_raise():
    for arch in ("seamless-m4t-medium", "qwen2-vl-72b"):
        with pytest.raises(KeyError, match="encdec/vlm"):
            get_config(arch)
    for family in ("encdec", "vlm"):
        cfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True), family=family)
        with pytest.raises(ValueError, match="encdec/vlm"):
            tm.init_decode_state(cfg, 1, 8, device="cpu")
        with pytest.raises(ValueError, match="encdec/vlm"):
            split_tree(tm.init_model(torch.Generator(), cfg))
