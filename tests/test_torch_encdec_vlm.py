"""The port's encoder-decoder and VLM families (seamless-m4t-medium,
qwen2-vl-72b) against the reference on the same weights and inputs (CPU).

The reference's params are carried into the port with ``params_from_numpy``
and the inputs (tokens and frames) are drawn with NumPy, so both packages
compute the same function at the f32 ``SMOKE`` configs.  Tolerances (max
abs error over max |reference|) are those of ``test_torch_families.py``,
each set from what a sum in another order costs in f32: logits, gradients,
updated params, decode states and HVPs within 1e-5, losses within 1e-6.
The port's decode against its own forward keeps the reference's 2e-2.
Each assert message prints the error it measured.
"""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.operators import HvpOperator as JaxHvpOperator
from repro.models import model as jm
from repro.models.common import split_tree as jax_split_tree
from repro.serving.lm import Engine as JaxEngine
from repro.serving.lm import ServeConfig as JaxServeConfig
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import synthetic_batch as jax_synthetic_batch
from repro.training.train_loop import TrainConfig as JaxTrainConfig
from repro.training.train_loop import make_train_step as jax_make_train_step
from repro.training.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.core.operators import HvpOperator
from repro_torch.models import model as tm
from repro_torch.models.common import split_tree
from repro_torch.serving.lm import Engine, ServeConfig
from repro_torch.training import DataConfig, OptConfig, TrainConfig, Trainer, data_stream
from repro_torch.training.data import synthetic_batch
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_loop import make_train_step

ARCHS = ["seamless-m4t-medium", "qwen2-vl-72b"]


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
        out[arch] = (jc, jp, get_config(arch, smoke=True), tm.params_from_numpy(jp, device="cpu"))
    return out


def _batches(jc, tc, seq=24, batch=2, seed=5, step=0):
    jb = jax_synthetic_batch(jc, JaxDataConfig(batch=batch, seq_len=seq, seed=seed), step)
    tb = synthetic_batch(tc, DataConfig(batch=batch, seq_len=seq, seed=seed), step, device="cpu")
    return jb, tb


def _prompt(cfg, seed=42, b=2, s=23):
    """Tokens, frames (encoder frames of 19 positions, or 5 patches), and
    two next tokens, all from NumPy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    n_frames = 19 if cfg.family == "encdec" else 5
    frames = (rng.standard_normal((b, n_frames, cfg.d_model)) * 0.02).astype(np.float32)
    nxt = rng.integers(0, cfg.vocab, (2, b, 1)).astype(np.int32)
    return toks, frames, nxt


def _dtype_name(v):
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    try:
        return jnp.dtype(v).name
    except TypeError:
        return v


# ------------------------------------------------------------ configs, init


@pytest.mark.parametrize("smoke", [False, True], ids=["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch, smoke):
    want, got = jax_get_config(arch, smoke), get_config(arch, smoke)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            a, b = _dtype_name(a), _dtype_name(b)
        assert a == b, f"{arch} {'SMOKE' if smoke else 'CONFIG'}.{f.name}: {b!r} vs {a!r}"


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_tree(carried, arch):
    """The port's own init gives the reference's leaf names, shapes and
    dtypes: the ``enc`` stack, ``enc_norm`` and ``blocks/dec_0`` with its
    ``nx`` and ``xattn`` for encdec."""
    jc, jp, tc, tp = carried[arch]
    own, _ = split_tree(tm.init_model(torch.Generator().manual_seed(0), tc))
    want = [("/".join(str(k) for k in p), tuple(a.shape), a.dtype.name)
            for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]]
    got = [(n, tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for n, v in tree.leaves_with_names(own)]
    assert got == want
    assert all(bool(torch.isfinite(v).all()) for v in tree.leaves(own))
    names = {n for n, _, _ in got}
    if tc.family == "encdec":
        assert "['enc_norm']" in names and "['blocks']/['dec_0']/['xattn']/['wk']" in names


@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_batch_is_byte_equal(arch, hosts):
    """Tokens, labels and frames from the reference's stream: encdec frames
    (B, S, d) and vlm patches (B, S // 8, d) with labels -1 over them."""
    jc, tc = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    for step in (0, 7, 10**6):
        for host in range(hosts):
            jd = JaxDataConfig(batch=4, seq_len=24, seed=3, num_hosts=hosts, host_id=host)
            td = DataConfig(batch=4, seq_len=24, seed=3, num_hosts=hosts, host_id=host)
            want, got = jax_synthetic_batch(jc, jd, step), synthetic_batch(tc, td, step, device="cpu")
            assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
            for k in want:
                w, g = np.asarray(want[k]), got[k].numpy()
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f"{arch} {k} step {step}"
    b = synthetic_batch(tc, DataConfig(batch=2, seq_len=24), 0, device="cpu")
    if tc.family == "vlm":
        assert b["frames"].shape == (2, 3, tc.d_model)
        assert b["labels"].shape == (2, 27) and bool((b["labels"][:, :3] == -1).all())
    else:
        assert b["frames"].shape == (2, 24, tc.d_model)


# ------------------------------------------------------- sequence path


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(carried, arch):
    """Synthetic batches at seq 40 (attention chunks of 32: a ragged tail);
    vlm with 5 patches prefixed, so its M-RoPE positions count them."""
    jc, jp, tc, tp = carried[arch]
    jb, tb = _batches(jc, tc, seq=40)
    jl, _ = jm.forward(jp, jc, jb)
    tl, _ = tm.forward(tp, tc, tb)
    assert tuple(tl.shape) == tuple(jl.shape)
    err = rel(tl.numpy(), jl)
    assert err <= 1e-5, f"{arch}: logits rel err {err:.3e}"
    lw, lg = float(jm.loss_fn(jp, jc, jb)[0]), float(tm.loss_fn(tp, tc, tb)[0])
    assert abs(lg - lw) / abs(lw) <= 1e-6, f"{arch}: loss {lg} vs {lw}"


@pytest.mark.parametrize("arch", ARCHS)
def test_explicit_positions_match_reference(carried, arch):
    """``batch["positions"]`` given: vlm with distinct (3, B, S) M-RoPE
    planes (temporal, height, width), encdec with (B, S) offsets."""
    jc, jp, tc, tp = carried[arch]
    toks, frames, _ = _prompt(tc)
    rng = np.random.default_rng(11)
    s = toks.shape[1] + (frames.shape[1] if tc.family == "vlm" else 0)
    if tc.family == "vlm":
        pos = np.cumsum(rng.integers(0, 3, (3, 2, s)), axis=-1).astype(np.int32)
    else:
        pos = (np.arange(s)[None] + rng.integers(0, 9, (2, 1))).astype(np.int32)
    jl, _ = jm.forward(jp, jc, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames),
                                "positions": jnp.asarray(pos)})
    tl, _ = tm.forward(tp, tc, {"tokens": t(toks), "frames": t(frames), "positions": t(pos)})
    err = rel(tl.numpy(), jl)
    assert err <= 1e-5, f"{arch}: logits rel err {err:.3e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_gradient_matches_reference(carried, arch):
    """The loss gradient of every leaf, the encoder's and the cross
    attention's included, within 1e-5 of max |g| over the whole tree."""
    jc, jp, tc, tp = carried[arch]
    jb, tb = _batches(jc, tc, seq=24)
    jg = jax.grad(lambda p: jm.loss_fn(p, jc, jb)[0])(jp)
    leaves = [v.clone().requires_grad_(True) for v in tree.leaves(tp)]
    loss = tm.loss_fn(tree.unflatten(tp, leaves), tc, tb)[0]
    tg = torch.autograd.grad(loss, leaves)
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
    assert len(want) == len(tg)
    scale = max(np.abs(w).max() for w in want)
    for (name, _), g, w in zip(tree.leaves_with_names(tp), tg, want):
        err = float(np.abs(g.numpy().astype(np.float64) - w).max() / scale)
        assert err <= 1e-5, f"{arch} {name}: grad err {err:.3e} of max|g|"
    assert all(np.abs(w).max() > 0 for w in want if w.size > 1 and w.ndim > 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_reference(carried, arch):
    """One AdamW step of ``make_train_step`` from fresh state on the same
    batch: moments within 1e-5, metrics within 1e-6, params within 1e-5 of
    max |p| plus what the gradients' own 1e-5 (``test_gradient_matches_
    reference``) becomes through the first step's ``g / (|g| + eps)``: its
    derivative ``eps / (|g| + eps)^2`` times lr, large where |g| nears eps."""
    jc, jp, tc, tp = carried[arch]
    jb, tb = _batches(jc, tc, seq=24)
    tcfg = TrainConfig()
    jstep = jax.jit(jax_make_train_step(jc, JaxTrainConfig()))
    wp, ws, wm = jstep(jp, jax_init_opt_state(jp), jb)
    gp, gs, gm = make_train_step(tc, tcfg)(tp, init_opt_state(tp), tb)
    for key in ("loss", "grad_norm", "lr"):
        err = abs(float(gm[key]) - float(wm[key])) / abs(float(wm[key]))
        assert err <= 1e-6, f"{arch} {key}: {float(gm[key])} vs {float(wm[key])}"
    jg = jax.tree_util.tree_leaves(jax.grad(lambda p: jm.loss_fn(p, jc, jb)[0])(jp))
    scale = min(tcfg.opt.clip_norm / float(wm["grad_norm"]), 1.0)
    gmax = max(np.abs(np.asarray(g)).max() for g in jg) * scale
    lr, eps = float(wm["lr"]), tcfg.opt.eps
    for (name, b), a, g0, p0 in zip(tree.leaves_with_names(gp), jax.tree_util.tree_leaves(wp), jg,
                                    jax.tree_util.tree_leaves(jp)):
        a, g = np.asarray(a, np.float64), np.abs(np.asarray(g0, np.float64)) * scale
        bound = 1e-5 * np.abs(a).max() + lr * eps * 1e-5 * gmax / (g + eps) ** 2
        excess = (np.abs(b.numpy() - a) - bound).max()
        assert excess <= 0, f"{arch} {name}: params off by {excess:.3e} beyond the bound"
        assert np.abs(a - np.asarray(p0)).max() > 0, f"{arch} {name}: no step taken"
    for want, got in ((ws.m, gs.m), (ws.v, gs.v)):
        for a, b in zip(jax.tree_util.tree_leaves(want), tree.leaves(got)):
            err = rel(b.numpy(), np.asarray(a))
            assert err <= 1e-5, f"{arch}: moment rel err {err:.3e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_hvp_matches_reference(carried, arch):
    """Reverse over reverse through the encoder and the cross attention
    (encdec) and the prefixed patches (vlm): the port's HVP within rel 1e-5
    of max |Hv| of the reference's, on one NumPy vector.  The frames are
    inputs, so ``n`` counts the parameters only."""
    jc, jp, tc, tp = carried[arch]
    jb, tb = _batches(jc, tc, seq=24)
    jop = JaxHvpOperator(lambda p: jm.loss_fn(p, jc, jb)[0], jp)
    top = HvpOperator(lambda p: tm.loss_fn(p, tc, tb)[0], tp)
    assert top.n == jop.n == sum(v.numel() for v in tree.leaves(tp))
    v = np.random.default_rng(0).standard_normal(top.n).astype(np.float32)
    want = np.asarray(jop.matvec(jnp.asarray(v)))
    got = top.matvec(t(v)).numpy()
    err = rel(got, want)
    assert err <= 1e-5, f"{arch}: HVP rel err {err:.3e} of max|Hv|"


# ------------------------------------------------------------- decode


def _state_leaves(state):
    """(name, array) of the layer, remainder and cross states, in flatten order."""
    return [(n, np.asarray(v)) for n, v in
            tree.leaves_with_names((state.layers, tuple(state.rem), state.cross))]


def _compare_states(tag, got, want):
    assert [n for n, _ in got] == [n for n, _ in want], tag
    for (name, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, \
            f"{tag} {name}: {g.dtype}{g.shape} vs {w.dtype}{w.shape}"
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=f"{tag} {name}")
        else:
            err = rel(g, w)
            assert err <= 1e-5, f"{tag} {name}: rel err {err:.3e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(carried, arch):
    """prefill, then two decode steps: logits and the whole state tree
    (self-attention caches and, for encdec, the stacked cross K/V with the
    encoder positions), leaf by leaf, after each."""
    jc, jp, tc, tp = carried[arch]
    toks, frames, nxt = _prompt(tc)
    jst, jl = jm.prefill(jp, jc, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
                         max_len=64)
    tst, tl = tm.prefill(tp, tc, {"tokens": t(toks), "frames": t(frames)}, max_len=64)
    s = toks.shape[1] + (frames.shape[1] if tc.family == "vlm" else 0)
    assert tst.step == int(jst.step) == s
    assert (tst.cross is None) == (jst.cross is None) == (tc.family != "encdec")
    err = rel(tl.numpy(), jl)
    assert err <= 1e-5, f"{arch} prefill logits rel err {err:.3e}"
    _compare_states(f"{arch} prefill", _state_leaves(tst), _state_leaves(jax.device_get(jst)))
    for i in range(2):
        jl, jst = jm.decode_step(jp, jc, jst, jnp.asarray(nxt[i]))
        tl, tst = tm.decode_step(tp, tc, tst, t(nxt[i]))
        err = rel(tl.numpy(), jl)
        assert err <= 1e-5, f"{arch} decode {i} logits rel err {err:.3e}"
        _compare_states(f"{arch} decode {i}", _state_leaves(tst),
                        _state_leaves(jax.device_get(jst)))
    assert tst.step == int(jst.step) == s + 2


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(carried, arch):
    """prefill(S) + decode(t) == forward(S+1) on the same frames: for vlm
    the decode position runs on past the patches."""
    _, _, cfg, params = carried[arch]
    toks, frames, nxt = _prompt(cfg)
    state, _ = tm.prefill(params, cfg, {"tokens": t(toks), "frames": t(frames)}, max_len=64)
    lg_dec, _ = tm.decode_step(params, cfg, state, t(nxt[0]))
    lg_ref, _ = tm.forward(params, cfg, {"tokens": torch.cat([t(toks), t(nxt[0])], 1),
                                         "frames": t(frames)})
    torch.testing.assert_close(lg_dec[:, :cfg.vocab], lg_ref[:, -1, :cfg.vocab],
                               rtol=2e-2, atol=2e-2)
    err = rel(lg_dec.numpy(), lg_ref[:, -1].numpy())
    assert err <= 1e-5, f"{arch}: decode vs forward rel err {err:.3e}"


def _plain(x):
    """A NamedTuple tree as plain nested tuples and dicts (either package's)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__,) + tuple((f, _plain(getattr(x, f))) for f in x._fields)
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    return x


@pytest.mark.parametrize("smoke", [False, True], ids=["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_axes_match_reference(arch, smoke):
    jc, tc = jax_get_config(arch, smoke), get_config(arch, smoke)
    assert _plain(tm.decode_state_axes(tc)) == _plain(jm.decode_state_axes(jc))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_decode_state_matches_reference(arch):
    """Empty caches and, for encdec, zero cross K/V of ``enc_len`` positions."""
    jc, tc = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    js = jax.device_get(jm.init_decode_state(jc, 2, 64, step=5, enc_len=7))
    ts = tm.init_decode_state(tc, 2, 64, step=5, enc_len=7, device="cpu")
    assert ts.step == 5
    _compare_states(arch, _state_leaves(ts), _state_leaves(js))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_matches_reference(carried, arch):
    """``Engine.generate`` on a prompt batch with frames: six greedy tokens
    and their log-probabilities against the reference's engine."""
    jc, jp, tc, tp = carried[arch]
    toks, frames, _ = _prompt(tc, seed=7)
    je = JaxEngine(jc, jp, JaxServeConfig(max_len=64))
    te = Engine(tc, tp, ServeConfig(max_len=64))
    jt, jinfo = je.generate({"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}, 6)
    tt, tinfo = te.generate({"tokens": t(toks), "frames": t(frames)}, 6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    err = np.abs(tinfo["token_logprobs"].numpy() - np.asarray(jinfo["token_logprobs"])).max()
    assert err <= 1e-4, f"{arch}: logprobs max abs err {err:.3e}"
    assert tinfo["final_state"].step == int(jinfo["final_state"].step)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_steps_and_probes(carried, arch):
    """``Trainer`` takes AdamW steps on batches with frames and a Hessian
    probe runs at step 2 (FFF on the CPU: the plain versions)."""
    _, _, tc, tp = carried[arch]
    tcfg = TrainConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=4),
                       ckpt_every=100, ckpt_dir=tempfile.mkdtemp(), spectral_every=2)
    tr = Trainer(tc, tcfg, tp,
                 probe_batch_fn=lambda: synthetic_batch(tc, DataConfig(batch=2, seq_len=16, seed=2), 0, device="cpu"))
    hist = tr.run(data_stream(tc, DataConfig(batch=2, seq_len=16, seed=1), device="cpu"), num_steps=2,
                  log_fn=lambda *_: None)
    assert len(hist) == 2 and np.isfinite(hist).all() and tr.rollbacks == 0
    ev = np.asarray(tr.spectra[2])
    assert ev.shape == (4,) and np.isfinite(ev).all()
    assert np.all(np.diff(np.abs(ev)) <= 0)


def test_launch_train_runs_seamless(tmp_path):
    """``launch/train.py --arch seamless-m4t-medium --smoke`` in process."""
    from repro_torch.launch import train

    tr = train.main(["--arch", "seamless-m4t-medium", "--smoke", "--device", "cpu", "--steps", "2",
                     "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert tr.step == 2
