"""The port's LM decode engine (``repro_torch.serving.lm``) against the
reference's ``repro.serving.lm.Engine`` on the same weights (CPU, f32
``SMOKE`` configs).

Greedy tokens must be equal: every step's top-2 logit gap is checked to
exceed the logits' agreement (1e-5 of max |logit|), so an argmax that
differed would be a fault, not a tie.  Token log-probabilities within 1e-4
absolute (a log-softmax of logits that agree to 1e-5 relative).  Sampled
tokens (temperature > 0) come from a seeded ``torch.Generator``, so they
are checked for reproducibility, not against ``jax.random``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jm
from repro.models.common import split_tree as jax_split_tree
from repro.serving.lm import Engine as JaxEngine
from repro.serving.lm import ServeConfig as JaxServeConfig
from repro_torch.configs import get_config
from repro_torch.models import model as tm
from repro_torch.serving.lm import Engine, ServeConfig

CASES = [("qwen3-0.6b", "bf16"), ("qwen1.5-32b", "int8"), ("mixtral-8x7b", "bf16"),
         ("recurrentgemma-2b", "int8"), ("mamba2-130m", "bf16")]
STEPS = 6


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    jc = jax_get_config(arch, smoke=True)
    return jax.device_get(jax_split_tree(jm.init_model(jax.random.PRNGKey(0), jc))[0])


def _engines(arch, cache, sc=None):
    jc = dataclasses.replace(jax_get_config(arch, smoke=True), kv_cache_dtype=cache)
    tc = dataclasses.replace(get_config(arch, smoke=True), kv_cache_dtype=cache)
    jp = _reference_params(arch)
    sc = sc or {}
    return (JaxEngine(jc, jp, JaxServeConfig(max_len=64, **sc)),
            Engine(tc, tm.params_from_numpy(jp), ServeConfig(max_len=64, **sc)), tc)


def _prompt(cfg, b=2, s=29, seed=7):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch,cache", CASES)
def test_generate_greedy_matches_reference(arch, cache):
    """Six greedy tokens after a 29-token prompt (mixtral's smoke window is
    32: its ring wraps), with each step's logits held to the reference's."""
    je, te, tc = _engines(arch, cache)
    toks = _prompt(tc)
    jt, jinfo = je.generate({"tokens": jnp.asarray(toks)}, STEPS)
    gaps = []
    orig = te._decode

    def watched(**kw):  # the top-2 gap of the logits each step samples from
        logits, st = orig(**kw)
        top2 = logits[:, :tc.vocab].topk(2).values
        gaps.append(float((top2[:, 0] - top2[:, 1]).min() / logits[:, :tc.vocab].abs().max()))
        return logits, st

    te._decode = watched
    tt, tinfo = te.generate({"tokens": torch.from_numpy(toks)}, STEPS)
    assert min(gaps[:-1]) > 1e-5, f"a near tie: top-2 gaps {gaps}"
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tt.dtype == torch.int32 and tt.shape == (2, STEPS)
    err = np.abs(tinfo["token_logprobs"].numpy() - np.asarray(jinfo["token_logprobs"])).max()
    assert err <= 1e-4, f"{arch}/{cache}: logprobs max abs err {err:.3e}"
    assert tinfo["final_state"].step == int(jinfo["final_state"].step) == 29 + STEPS


def test_eos_pads_the_rest_of_a_row():
    """After a row emits ``eos_id`` it emits ``pad_id``, as in the reference."""
    je, te, tc = _engines("qwen3-0.6b", "bf16")
    toks = _prompt(tc)
    free, _ = te.generate({"tokens": torch.from_numpy(toks)}, STEPS)
    eos = int(free[0, 1])
    je, te, _ = _engines("qwen3-0.6b", "bf16", {"eos_id": eos, "pad_id": 3})
    tt, _ = te.generate({"tokens": torch.from_numpy(toks)}, STEPS)
    jt, _ = je.generate({"tokens": jnp.asarray(toks)}, STEPS)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    first = int(np.argmax(tt[0].numpy() == eos))
    assert first <= 1 and (tt[0, first + 1:] == 3).all()


def test_sampling_is_reproducible_from_the_seed():
    _, te, tc = _engines("mamba2-130m", "bf16", {"temperature": 1.0})
    batch = {"tokens": torch.from_numpy(_prompt(tc))}
    a, ia = te.generate(batch, STEPS, seed=1)
    b, _ = te.generate(batch, STEPS, seed=1)
    c, _ = te.generate(batch, STEPS, seed=2)
    torch.testing.assert_close(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < tc.vocab
    assert bool((ia["token_logprobs"] <= 0).all())
