"""The sharded trainer on the host: the smoke qwen3 on 2 gloo ranks over a
``(data=1, model=2)`` mesh and 4 over ``(2, 2)`` (``launch.ranks``, rank
functions in ``tests/torch_sharded_ranks.py``), against the unsharded port
and the reference's train step on the same NumPy weights and batches.

Tolerances (f32 compute): losses within rel 1e-5 of the unsharded port's and
the reference's, and bit-equal on every rank; params after 3 AdamW steps
within rel 1e-5 of max |param| of both (a sharded matmul sums in another
order: the rounding of a few ulps, through Adam's normalized update);
a sharded checkpoint resumed unsharded gives its bits back, and the
unsharded run's checkpoint resumed sharded is that run (within the same rel
1e-5 of the sharded run); the sharded Hessian probe's eigenvalues
rank-identical and within rel 1e-4 of |lambda|max of the unsharded probe
from the same start vector at G = 4 (4 Lanczos steps carry the HVP's
rounding differences into the Ritz values).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.common import split_tree as jax_split_tree
from repro.models.model import init_model as jax_init_model
from repro.training import DataConfig as JaxDataConfig
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import make_train_step as jax_make_train_step
from repro.training import synthetic_batch as jax_synthetic_batch
from repro.training.optimizer import OptConfig as JaxOptConfig
from repro.training.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.core import tree
from repro_torch.core.operators import HvpOperator
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.model import loss_fn
from repro_torch.training import DataConfig, Trainer, data_stream, synthetic_batch
from repro_torch.training.spectral import hessian_spectrum

import torch_sharded_ranks as sr

STEPS, BATCH, SEQ, K, ITERS = 3, 8, 32, 2, 4


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference's weights, the unsharded port's run (and its step-3
    checkpoint), the reference's 3 steps, the unsharded probe, then both
    sharded runs."""
    jc = jax_get_config(sr.ARCH, smoke=True)
    jp = jax.device_get(jax_split_tree(jax_init_model(jax.random.PRNGKey(0), jc))[0])
    params_np = jax.tree.map(np.asarray, jp)
    cfg, params, _ = sr.smoke_setup(params_np)
    tmp = tmp_path_factory.mktemp("sharded")
    dc = DataConfig(batch=BATCH, seq_len=SEQ, seed=0)

    tr = Trainer(cfg, sr.train_config(str(tmp / "unsharded"), STEPS), params)
    losses = tr.run(data_stream(cfg, dc, device="cpu"), num_steps=STEPS, log_every=10**9)
    port_params = [t.detach().numpy() for t in tree.leaves(tr.params)]

    step = jax.jit(jax_make_train_step(jc, JaxTrainConfig(opt=JaxOptConfig(warmup_steps=2,
                                                                           decay_steps=10))))
    p, o, ref_losses = jp, jax_init_opt_state(jp), []
    for i in range(STEPS):
        p, o, m = step(p, o, jax_synthetic_batch(jc, JaxDataConfig(batch=BATCH, seq_len=SEQ,
                                                                   seed=0), i))
        ref_losses.append(float(m["loss"]))
    ref_params = [np.asarray(x) for x in jax.tree.leaves(p)]

    n = sum(t.numel() for t in tree.leaves(params))
    v0 = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    probe = hessian_spectrum(params, cfg, synthetic_batch(cfg, dc, 0, device="cpu"), k=K, num_iters=ITERS,
                             v0=torch.from_numpy(v0))
    hvp_x = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    batch0 = synthetic_batch(cfg, dc, 0, device="cpu")
    hvp_want = HvpOperator(lambda p: loss_fn(p, cfg, batch0)[0], params).matvec(
        torch.from_numpy(hvp_x)).numpy()

    def spawn(shape, seq_mesh):
        job = {"params": params_np, "shape": shape, "steps": STEPS, "batch": BATCH, "seq": SEQ,
               "ckpt_sharded": str(tmp / f"sharded_{shape[0]}x{shape[1]}"),
               "ckpt_unsharded": str(tmp / "unsharded"), "v0": v0, "k": K, "iters": ITERS,
               "seq_mesh": seq_mesh, "probe": seq_mesh is not None,
               "force_patch": seq_mesh is None, "hvp_x": hvp_x, "hvp_want": hvp_want}
        return run_ranks(sr.train_rank, shape[0] * shape[1], args=(job,), backend="gloo",
                         device="cpu", timeout=240)

    with ThreadPoolExecutor(2) as pool:  # both worlds at once
        futs = {shape: pool.submit(spawn, shape, seq)
                for shape, seq in (((1, 2), None), ((2, 2), (1, 4)))}
        runs = {shape: f.result() for shape, f in futs.items()}
    return {"cfg": cfg, "params": params, "losses": losses, "port_params": port_params,
            "ref_losses": ref_losses, "ref_params": ref_params, "evals": probe.eigenvalues,
            "n": n, "runs": runs, "tmp": tmp, "dc": dc}


SHAPES = [(1, 2), (2, 2)]


@pytest.mark.parametrize("shape", SHAPES)
def test_losses_are_rank_identical_and_match(setup, shape):
    ranks = setup["runs"][shape]
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"], [x["losses"] for x in ranks]
    for name, want in (("port", setup["losses"]), ("reference", setup["ref_losses"])):
        err = rel(ranks[0]["losses"], want)
        assert err <= 1e-5, f"{shape} losses vs the unsharded {name}: rel err {err:.3e}"


@pytest.mark.parametrize("shape", SHAPES)
def test_params_after_three_steps_match(setup, shape):
    got = setup["runs"][shape][0]["params"]
    for name, want in (("port", setup["port_params"]), ("reference", setup["ref_params"])):
        for a, b in zip(got, want):
            err = rel(a, b)
            assert err <= 1e-5, f"{shape} params vs the unsharded {name}: rel err {err:.3e}"


@pytest.mark.parametrize("shape", SHAPES)
def test_params_and_moments_are_sharded(setup, shape):
    """The layouts are the rule engine's (some leaf sharded on each mesh
    axis), the moments laid out as the params, and a rank holds less than
    the whole of params + m + v."""
    r = setup["runs"][shape][0]
    assert r["opt_placements"] == r["placements"]
    assert any("Shard" in p for p in r["placements"])
    whole = 3 * 4 * setup["n"]
    assert r["local_bytes"] < whole, (r["local_bytes"], whole)


@pytest.mark.parametrize("shape", SHAPES)
def test_unsharded_checkpoint_resumes_sharded(setup, shape):
    for r in setup["runs"][shape]:
        assert r["resumed"] and r["resumed_step"] == STEPS and r["resumed_layout"]
        assert r["resume_err"] <= 1e-5 * max(np.abs(a).max() for a in setup["port_params"]), \
            r["resume_err"]


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_checkpoint_resumes_unsharded(setup, shape):
    tr = Trainer(setup["cfg"], sr.train_config(str(setup["tmp"] / f"sharded_{shape[0]}x{shape[1]}"),
                                                STEPS), setup["params"])
    assert tr.try_resume() and tr.step == STEPS
    for a, b in zip(tree.leaves(tr.params), setup["runs"][shape][0]["params"]):
        assert np.array_equal(a.numpy(), b), "the checkpoint holds the sharded run's bits"


def test_sharded_probe_matches_unsharded(setup):
    """At G = 4, (2, 2)."""
    ranks = setup["runs"][(2, 2)]
    for r in ranks[1:]:
        assert r["evals"] == ranks[0]["evals"], "rank eigenvalues differ"
    assert sum(r["n_local"] for r in ranks) == setup["n"], "owned slices must cover n once"
    want = setup["evals"].numpy()
    err = float(np.abs(np.asarray(ranks[0]["evals"]) - want).max() / np.abs(want).max())
    assert err <= 1e-4, f"probe eigenvalues vs unsharded: rel err {err:.3e}"


def test_differentiable_backwards_keep_the_hvp(setup):
    """``sharding.differentiable_backwards`` (what PyTorch releases without
    differentiable DTensor backwards get, the card's 2.11 among them)
    forced on at (1, 2): a sharded HVP within rel 1e-5 of the unsharded one
    (without differentiable backwards it came to 0.37 of its norm)."""
    for r in setup["runs"][(1, 2)]:
        assert r["patched_hvp_err"] <= 1e-5, r["patched_hvp_err"]


def test_sequence_split_attention_gradients(setup):
    """(1, 4): 2 KV heads on a 4-wide model axis, so the attention core
    splits the queries and the keys' gradients are partial sums."""
    r = setup["runs"][(2, 2)][0]
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(setup["params"])]
    batch = synthetic_batch(setup["cfg"], setup["dc"], 0, device="cpu")
    loss, _ = loss_fn(tree.unflatten(setup["params"], leaves), setup["cfg"], batch)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(r["seq_loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    for g, want in zip(r["seq_grads"], grads):
        err = rel(g, want.numpy())
        assert err <= 1e-5, f"seq-split gradients rel err {err:.3e}"


def test_launch_mesh_rule():
    """The reference's mesh rule: (data, model) over more than one rank, an
    error when --mesh-model does not divide the world, no mesh for one."""
    from repro_torch.launch.train import make_train_mesh

    assert make_train_mesh(1, 2, "cpu") is None
    with pytest.raises(ValueError, match="does not divide"):
        make_train_mesh(6, 4, "cpu")


def test_host_staged_collectives_on_gloo_ranks():
    """``distributed/host_staged.py``'s kernels (what the card's ranks run
    for DTensor's CUDA collectives), called on host tensors: the results of
    gloo's own collectives."""
    out = run_ranks(sr.staged_rank, 2, backend="gloo", device="cpu", timeout=120)
    for r in out:
        assert r["ag"] == r["ag_ref"] and r["ar"] == r["ar_ref"] and r["rs"] == r["rs_ref"]
        assert r["a2a"] == r["a2a_ref"] and r["bc"] == r["bc_ref"]

