"""The port's training side (``repro_torch.training``, ``HvpOperator``,
``launch.train``) against the reference on the same weights and data (CPU),
and the reference's trainer tests ported to the port.

Tolerances: the Hessian-vector product within rel 1e-5 of max |Hv| of the
reference's (the reference's own f32 HVP agrees with an f64 one to
1.1-1.4e-6 of max |Hv| at this size); Hessian eigenvalues under FDF with one
shared NumPy start vector within rel 1e-5 of |lambda|max; one optimizer step
rel 1e-5 of max |param|; the learning rate and the global norm rel 1e-6;
batches byte for byte.  Each assert message prints the error it measured.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.configs import get_config as jax_get_config
from repro.core.operators import HvpOperator as JaxHvpOperator
from repro.models.common import split_tree as jax_split_tree
from repro.models.model import init_model as jax_init_model
from repro.models.model import loss_fn as jax_loss_fn
from repro.training import DataConfig as JaxDataConfig
from repro.training import synthetic_batch as jax_synthetic_batch
from repro.training.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.training.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.training.compression import compress_tree as jax_compress_tree
from repro.training.compression import ef_compress_tree as jax_ef_compress_tree
from repro.training.compression import init_ef_state as jax_init_ef_state
from repro.training.optimizer import OptConfig as JaxOptConfig
from repro.training.optimizer import adafactor_update as jax_adafactor_update
from repro.training.optimizer import adamw_update as jax_adamw_update
from repro.training.optimizer import global_norm as jax_global_norm
from repro.training.optimizer import init_factored_state as jax_init_factored_state
from repro.training.optimizer import init_opt_state as jax_init_opt_state
from repro.training.optimizer import lr_at as jax_lr_at
from repro_torch.configs import get_config
from repro_torch.core import tree
from repro_torch.core.operators import HvpOperator
from repro_torch.core.precision import FDF
from repro_torch.models.common import split_tree
from repro_torch.models.model import init_model, loss_fn, params_from_numpy, params_to_numpy
from repro_torch.training import (
    CheckpointManager,
    DataConfig,
    OptConfig,
    TrainConfig,
    Trainer,
    data_stream,
    make_train_step,
    synthetic_batch,
)
from repro_torch.training.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.training.compression import compress_tree, ef_compress_tree, init_ef_state
from repro_torch.training.optimizer import (
    adafactor_update,
    adamw_update,
    global_norm,
    init_factored_state,
    init_opt_state,
    lr_at,
)
from repro_torch.training.spectral import hessian_spectrum, hessian_topk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-0.6b"


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def np_tree(t):
    return [np.asarray(x) for x in jax.tree.leaves(t)]


@pytest.fixture(scope="module")
def carried():
    """(reference cfg, reference params, port cfg, port params), qwen3 smoke."""
    jc = jax_get_config(ARCH, smoke=True)
    jp = jax.device_get(jax_split_tree(jax_init_model(jax.random.PRNGKey(0), jc))[0])
    return jc, jp, get_config(ARCH, smoke=True), params_from_numpy(jp, device="cpu")


@pytest.fixture(scope="module")
def hvp_pair(carried):
    jc, jp, tc, tp = carried
    jb = jax_synthetic_batch(jc, JaxDataConfig(batch=2, seq_len=16, seed=5), 0)
    tb = synthetic_batch(tc, DataConfig(batch=2, seq_len=16, seed=5), 0, device="cpu")
    jop = JaxHvpOperator(lambda p: jax_loss_fn(p, jc, jb)[0], jp)
    top = HvpOperator(lambda p: loss_fn(p, tc, tb)[0], tp)
    return jop, top, tb


# ---------------------------------------------------------------- the HVP


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hvp_matches_reference(hvp_pair, seed):
    jop, top, _ = hvp_pair
    assert top.n == jop.n == 143_904
    v = np.random.default_rng(seed).standard_normal(top.n).astype(np.float32)
    want = np.asarray(jop.matvec(jnp.asarray(v)))
    got = top.matvec(torch.from_numpy(v)).numpy()
    err = rel(got, want)
    assert err <= 1e-5, f"HVP rel err {err:.3e} of max|Hv|"


def test_hvp_is_symmetric(hvp_pair):
    _, top, _ = hvp_pair
    u, w = (torch.from_numpy(x) for x in
            np.random.default_rng(3).standard_normal((2, top.n)).astype(np.float32))
    a, b = float(w @ top.matvec(u)), float(u @ top.matvec(w))
    err = abs(a - b) / abs(a)
    assert err <= 1e-5, f"<w, Hu> = {a}, <u, Hw> = {b}: rel {err:.3e}"


def test_hvp_remat_gives_the_same_numbers(carried, hvp_pair):
    """``remat="full"`` recomputes each layer in the backward pass
    (non-reentrant checkpoint, which supports the double backward)."""
    import dataclasses

    _, _, tc, tp = carried
    _, top, tb = hvp_pair
    nc = dataclasses.replace(tc, remat="none")
    plain = HvpOperator(lambda p: loss_fn(p, nc, tb)[0], tp)
    v = torch.from_numpy(np.random.default_rng(4).standard_normal(top.n).astype(np.float32))
    err = rel(top.matvec(v).numpy(), plain.matvec(v).numpy())
    assert err <= 1e-6, f"remat vs none: rel err {err:.3e}"


def test_hessian_spectrum_matches_reference_fdf(carried, hvp_pair):
    """FDF, one NumPy start vector, the reference's solver defaults."""
    jc, jp, tc, tp = carried
    jop, _, tb = hvp_pair
    v0 = np.random.default_rng(11).standard_normal(jop.n)
    want = repro.eigsh(jop, 4, policy="FDF", backend="single", reorth="full", num_iters=8, v0=v0)
    got = hessian_spectrum(tp, tc, tb, k=4, policy=FDF, v0=v0, num_iters=8)
    w, g = np.asarray(want.eigenvalues), got.eigenvalues.numpy()
    err = float(np.abs(g - w).max() / np.abs(w).max())
    assert err <= 1e-5, f"eigenvalues {g} vs {w}: rel err {err:.3e}"
    assert got.backend == "single" and got.eigenvectors.shape == (tp_n(tp), 4)


def tp_n(tp) -> int:
    return sum(t.numel() for t in tree.leaves(tp))


def test_spectral_monitor_hessian(carried):
    """The reference's ``test_spectral_monitor_hessian``, on the port:
    default FFF top-K on the HVP operator of a real model."""
    _, _, tc, tp = carried
    batch = synthetic_batch(tc, DataConfig(batch=2, seq_len=16, seed=5), 0, device="cpu")
    evals = hessian_topk(tp, tc, batch, k=3, num_iters=8)
    assert evals.shape == (3,)
    assert np.all(np.isfinite(evals))
    assert abs(evals[0]) >= abs(evals[-1])  # |lambda| ordering


# ---------------------------------------------------------- optimizer, data


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.05).astype(np.float32), params)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_one_optimizer_step_matches_reference(carried, opt):
    """One step from fresh state on the same grads; the smoke tree has
    stacked (3-D) leaves, so Adafactor's per-slice path runs."""
    _, jp, _, tp = carried
    g = _grads(jp, 1)
    jcfg, tcfg = JaxOptConfig(warmup_steps=2, decay_steps=10), OptConfig(warmup_steps=2,
                                                                          decay_steps=10)
    tg = params_from_numpy(g, device="cpu")
    if opt == "adamw":
        wp, ws, wm = jax.jit(jax_adamw_update, static_argnums=3)(g, jax_init_opt_state(jp), jp,
                                                                 jcfg)
        gp, gs, gm = adamw_update(tg, init_opt_state(tp), tp, tcfg)
        states = [(ws.m, gs.m), (ws.v, gs.v)]
    else:
        wp, ws, wm = jax.jit(jax_adafactor_update, static_argnums=3)(
            g, jax_init_factored_state(jp), jp, jcfg)
        gp, gs, gm = adafactor_update(tg, init_factored_state(tp), tp, tcfg)
        states = [(ws.vr, gs.vr), (ws.vc, gs.vc)]
    assert int(gs.step) == int(ws.step) == 1
    for a, b in zip(np_tree(wp), tree.leaves(gp)):
        err = rel(b.numpy(), a)
        assert err <= 1e-5, f"{opt}: params rel err {err:.3e}"
    for want, got in states:
        for a, b in zip(np_tree(want), tree.leaves(got)):
            err = rel(b.numpy(), a)
            assert err <= 1e-5, f"{opt}: state rel err {err:.3e}"
    for key in ("grad_norm", "lr"):
        err = abs(float(gm[key]) - float(wm[key])) / abs(float(wm[key]))
        assert err <= 1e-6, f"{opt} {key}: {float(gm[key])} vs {float(wm[key])}"


@pytest.mark.parametrize("step", [0, 1, 3, 50, 99, 100, 5000, 20000])
def test_lr_schedule_matches_reference(step):
    cfg, jcfg = OptConfig(), JaxOptConfig()
    want = float(jax_lr_at(jcfg, jnp.asarray(step, jnp.int32)))
    got = float(lr_at(cfg, torch.tensor(step, dtype=torch.int32)))
    assert abs(got - want) <= 1e-6 * abs(want), f"step {step}: lr {got} vs {want}"


def test_global_norm_matches_reference(carried):
    _, jp, _, tp = carried
    want, got = float(jax_global_norm(jp)), float(global_norm(tp))
    assert abs(got - want) <= 1e-6 * want, f"global norm {got} vs {want}"


@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3-medium-14b"])
def test_synthetic_batch_is_byte_equal(arch, hosts):
    jc, tc = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    for step in (0, 7, 10**6):
        for host in range(hosts):
            jd = JaxDataConfig(batch=4, seq_len=24, seed=3, num_hosts=hosts, host_id=host)
            td = DataConfig(batch=4, seq_len=24, seed=3, num_hosts=hosts, host_id=host)
            want, got = jax_synthetic_batch(jc, jd, step), synthetic_batch(tc, td, step, device="cpu")
            assert sorted(got) == sorted(want)
            for k in want:
                w, g = np.asarray(want[k]), got[k].numpy()
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f"{arch} {k} step {step}"
    stream = data_stream(tc, DataConfig(batch=2, seq_len=8), start_step=5, device="cpu")
    assert torch.equal(next(stream)["tokens"],
                       synthetic_batch(tc, DataConfig(batch=2, seq_len=8), 5, device="cpu")["tokens"])


def test_compression_matches_reference(carried):
    _, jp, _, _ = carried
    g = _grads(jp, 2)
    want, got = jax_compress_tree(g), compress_tree(params_from_numpy(g, device="cpu"))
    for a, b in zip(np_tree(want), tree.leaves(got)):
        err = rel(b.numpy(), a)
        assert err <= 1e-6, f"compress_tree rel err {err:.3e}"
    # error feedback: three steps carry the same residuals
    jef, tef = jax_init_ef_state(g), init_ef_state(params_from_numpy(g, device="cpu"))
    for step in range(3):
        gs = _grads(jp, 10 + step)
        jsent, jef = jax_ef_compress_tree(gs, jef)
        tsent, tef = ef_compress_tree(params_from_numpy(gs, device="cpu"), tef)
        for a, b in zip(np_tree(jsent) + np_tree(jef.residual),
                        tree.leaves(tsent) + tree.leaves(tef.residual)):
            err = float(np.abs(b.numpy() - a).max())
            assert err <= 1e-6 * max(float(np.abs(a).max()), 1e-3), \
                f"ef step {step}: abs err {err:.3e}"


# ------------------------------------------- the reference's trainer tests


@pytest.fixture(scope="module")
def tiny(carried):
    _, _, tc, tp = carried
    return tc, tp


def test_train_loss_decreases(tiny, tmp_path):
    cfg, params = tiny
    tc = TrainConfig(opt=OptConfig(peak_lr=3e-3, warmup_steps=5, decay_steps=40),
                     ckpt_every=100, ckpt_dir=str(tmp_path))
    tr = Trainer(cfg, tc, params)
    hist = tr.run(data_stream(cfg, DataConfig(batch=8, seq_len=64, seed=1), device="cpu"), num_steps=40,
                  log_fn=lambda *_: None)
    assert np.mean(hist[-5:]) < hist[0] - 0.5, f"loss {hist[0]:.4f} -> {np.mean(hist[-5:]):.4f}"


def test_grad_accumulation_matches_full_batch(tiny):
    """accum_steps=2 on batch 8 == accum_steps=1 on the same batch."""
    cfg, params = tiny
    batch = synthetic_batch(cfg, DataConfig(batch=8, seq_len=32, seed=3), 0, device="cpu")
    p1, _, m1 = make_train_step(cfg, TrainConfig(accum_steps=1))(params, init_opt_state(params),
                                                                 batch)
    p2, _, m2 = make_train_step(cfg, TrainConfig(accum_steps=2))(params, init_opt_state(params),
                                                                 batch)
    d = max(float((a - b).abs().max()) for a, b in zip(tree.leaves(p1), tree.leaves(p2)))
    assert d < 5e-3, f"max param diff {d:.3e}"
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-2


def test_checkpoint_roundtrip_and_retention(tiny, tmp_path):
    _, params = tiny
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep_n=2)
    opt = init_opt_state(params)
    for s in (1, 2, 3):
        mgr.save(s, {"params": params, "opt": opt}, extra={"tag": s})
    assert latest_step(d) == 3
    assert not os.path.exists(os.path.join(d, "step_00000001"))  # retention
    step, restored, extra = mgr.restore_latest({"params": params, "opt": opt})
    assert step == 3 and extra["tag"] == 3
    for a, b in zip(tree.leaves(restored["params"]), tree.leaves(params)):
        assert torch.equal(a, b)
    assert restored["opt"].step.dtype == torch.int32 and restored["opt"].step.shape == ()


def test_checkpoint_atomic_tmp_cleanup(tiny, tmp_path):
    _, params = tiny
    d = str(tmp_path)
    save_checkpoint(d, 7, {"p": params})
    assert latest_step(d) == 7
    assert not any(x.startswith(".tmp") for x in os.listdir(d))
    t = save_checkpoint(d, 8, {"p": params}, async_write=True)
    t.join(timeout=60)
    assert not t.is_alive() and latest_step(d) == 8


def test_nan_rollback(tiny, tmp_path):
    """Poisoned loss once; the trainer restores and continues."""
    cfg, params = tiny
    tc = TrainConfig(opt=OptConfig(peak_lr=3e-3, warmup_steps=2, decay_steps=30),
                     ckpt_every=5, ckpt_dir=str(tmp_path), async_ckpt=False)
    tr = Trainer(cfg, tc, params)
    orig = tr.step_fn
    calls = {"n": 0}

    def sometimes_nan(p, o, b):
        calls["n"] += 1
        p2, o2, m = orig(p, o, b)
        if calls["n"] == 7:
            m = dict(m, loss=torch.tensor(float("nan")))
        return p2, o2, m

    tr.step_fn = sometimes_nan
    hist = tr.run(data_stream(cfg, DataConfig(batch=4, seq_len=32, seed=2), device="cpu"), num_steps=12,
                  log_fn=lambda *_: None)
    assert tr.rollbacks == 1
    assert tr.step == 12
    assert all(np.isfinite(hist))


def test_resume_from_checkpoint(tiny, tmp_path):
    cfg, params = tiny
    tc = TrainConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=20),
                     ckpt_every=5, ckpt_dir=str(tmp_path), async_ckpt=False)
    tr1 = Trainer(cfg, tc, params)
    tr1.run(data_stream(cfg, DataConfig(batch=4, seq_len=32, seed=4), device="cpu"), num_steps=10,
            log_fn=lambda *_: None)
    tr2 = Trainer(cfg, tc, params)  # "preemption": a new trainer, the same directory
    assert tr2.try_resume()
    assert tr2.step == 10
    for a, b in zip(tree.leaves(tr2.params), tree.leaves(tr1.params)):
        assert torch.equal(a, b)
    assert int(tr2.opt_state.step) == 10


def test_trainer_spectral_probe(tiny, tmp_path):
    """``spectral_every`` probes the Hessian into ``spectra`` at its steps."""
    cfg, params = tiny
    dc = DataConfig(batch=2, seq_len=16, seed=6)
    tc = TrainConfig(opt=OptConfig(warmup_steps=1, decay_steps=4), spectral_every=2,
                     spectral_k=2, ckpt_dir=str(tmp_path))
    tr = Trainer(cfg, tc, params, probe_batch_fn=lambda: synthetic_batch(cfg, dc, 10**6, device="cpu"))
    tr.run(data_stream(cfg, dc, device="cpu"), num_steps=4, log_fn=lambda *_: None)
    assert sorted(tr.spectra) == [2, 4]
    assert all(ev.shape == (2,) and np.isfinite(ev).all() for ev in tr.spectra.values())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_params_checkpoint_cross_read(carried, tmp_path, writer):
    """Each package loads a params checkpoint the other wrote (one layout,
    one set of leaf names)."""
    _, jp, _, tp = carried
    d = str(tmp_path)
    if writer == "reference":
        jax_save_checkpoint(d, 4, {"params": jp}, extra={"by": writer})
        got, extra = load_checkpoint(d, 4, {"params": tp})
        for a, b in zip(tree.leaves(got["params"]), jax.tree.leaves(jp)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        save_checkpoint(d, 4, {"params": tp}, extra={"by": writer})
        got, extra = jax_load_checkpoint(d, 4, {"params": jp})
        for a, b in zip(jax.tree.leaves(got["params"]), tree.leaves(tp)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert extra == {"by": writer}


def test_params_numpy_round_trip_through_own_init():
    cfg = get_config(ARCH, smoke=True)
    params = split_tree(init_model(torch.Generator().manual_seed(3), cfg))[0]
    back = params_from_numpy(params_to_numpy(params), device="cpu")
    for a, b in zip(tree.leaves(back), tree.leaves(params)):
        assert torch.equal(a, b)


def test_launch_train_smoke_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--steps", "4", "--spectral-every", "2", "--batch", "2",
         "--seq", "16", "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "0.1M params (143,904)" in out.stdout
    assert out.stdout.count("Hessian top-|λ|") == 2, out.stdout
    from repro_torch.launch import train as launch_train

    # a world of one trains without a mesh whatever --mesh-model says (the
    # reference's rule: its mesh needs more than one device)
    tr = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh-model", "2",
                            "--steps", "1", "--batch", "2", "--seq", "16", "--ckpt-dir",
                            str(tmp_path / "mesh_model_2")])
    assert tr.step == 1
