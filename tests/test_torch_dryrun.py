"""The port's dry-run (``repro_torch.launch.dryrun``, ``configs/shapes.py``)
against the reference's units: the parameter-count bands, the cell plans,
the accumulation steps, the 33-cell ``applicable`` matrix and every input
spec (shapes and dtypes, meta tensors against ``ShapeDtypeStruct``s); then
one cell run end to end at world 256, qwen3-0.6b ``train_4k``, whose
per-rank argument bytes must equal those reckoned from the reference's
specs (each leaf's shape divided by the mesh axes its spec names).
"""

import math
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import applicable as jax_applicable
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.distributed import sharding as jax_sharding
from repro.launch.dryrun import accum_steps_for as jax_accum_steps_for
from repro.launch.dryrun import estimate_param_count as jax_estimate_param_count
from repro.launch.dryrun import plan_cell as jax_plan_cell
from repro.models.common import split_tree as jax_split_tree
from repro.models.model import init_model as jax_init_model
from repro_torch.configs import SHAPES, applicable, get_config, input_specs
from repro_torch.core import tree
from repro_torch.launch import dryrun

CELLS = [(a, s) for a in ARCHS for s in JAX_SHAPES if jax_applicable(a, s)]


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def test_shapes_and_the_applicable_matrix():
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, spec in SHAPES.items():
        js = JAX_SHAPES[name]
        assert (spec.seq_len, spec.global_batch, spec.mode) == (js.seq_len, js.global_batch,
                                                                 js.mode)
    matrix = {(a, s): applicable(a, s) for a in ARCHS for s in SHAPES}
    assert matrix == {(a, s): jax_applicable(a, s) for a in ARCHS for s in SHAPES}
    assert sum(matrix.values()) == len(CELLS) == 33


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_count_estimate_equals_the_reference(arch):
    assert dryrun.estimate_param_count(get_config(arch)) == \
        jax_estimate_param_count(jax_get_config(arch))


@pytest.mark.parametrize("ndev", [256, 512])
def test_plan_cell_and_accum_steps_equal_the_reference(ndev):
    for arch, shape in CELLS:
        tc, topt, tn = dryrun.plan_cell(get_config(arch), SHAPES[shape], ndev)
        jc, jopt, jn = jax_plan_cell(jax_get_config(arch), JAX_SHAPES[shape], ndev)
        assert (topt, tn, tc.kv_cache_dtype) == (jopt, jn, jc.kv_cache_dtype), (arch, shape)
        assert _dtype_name(tc.param_dtype) == jnp.dtype(jc.param_dtype).name, (arch, shape)
        assert dryrun.accum_steps_for(tc, SHAPES[shape], topt) == \
            jax_accum_steps_for(jc, JAX_SHAPES[shape], jopt), (arch, shape)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    """Every input of every cell, on meta: the batch and, for decode, each
    tensor of the state template (the port keeps ``step`` as host data)."""
    jc, _, _ = jax_plan_cell(jax_get_config(arch), JAX_SHAPES[shape], 256)
    tc, _, _ = dryrun.plan_cell(get_config(arch), SHAPES[shape], 256)
    want = jax_input_specs(jc, JAX_SHAPES[shape])
    got = input_specs(tc, SHAPES[shape])
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "state":
            jl = [v for p, v in jax.tree_util.tree_flatten_with_path(want[key])[0]
                  if jax.tree_util.keystr(p) != ".step"]
        else:
            jl = jax.tree.leaves(want[key])
        tl = [t for t in tree.leaves(got[key]) if isinstance(t, torch.Tensor)]
        assert len(tl) == len(jl), (key, len(tl), len(jl))
        for t, j in zip(tl, jl):
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(j.shape) and _dtype_name(t.dtype) == j.dtype.name, \
                (key, tuple(t.shape), t.dtype, j.shape, j.dtype)
    if SHAPES[shape].mode == "decode":
        assert got["state"].step == SHAPES[shape].seq_len - 1


def _reckoned_bytes(shape, dtype, spec, sizes) -> int:
    """Rank 0's bytes of a leaf laid out as the reference's ``spec``."""
    local = list(shape)
    for i, part in enumerate(spec):
        names = (part,) if isinstance(part, str) else (part or ())
        local[i] //= math.prod(sizes[n] for n in names)
    return math.prod(local) * jnp.dtype(dtype).itemsize


def test_one_cell_end_to_end_at_world_256():
    """qwen3-0.6b x train_4k on (16, 16): the step runs on meta DTensors over
    a fake world of 256; params, AdamW state and inputs per rank equal the
    bytes of the reference's specs; collectives and flops are counted."""
    rec = dryrun.lower_cell("qwen3-0.6b", "train_4k", multi_pod=False, verbose=False)
    sizes = {"data": 16, "model": 16}
    ctx = jax_sharding.ShardingCtx(mesh=types.SimpleNamespace(shape=sizes),
                                   rules=dict(jax_sharding.DEFAULT_RULES))
    jc, opt, _ = jax_plan_cell(jax_get_config("qwen3-0.6b"), JAX_SHAPES["train_4k"], 256)
    assert opt == rec["optimizer"] == "adamw"
    vals, axes = jax_split_tree(jax.eval_shape(lambda: jax_init_model(jax.random.PRNGKey(0), jc)))
    ax = jax.tree.leaves(axes, is_leaf=jax_sharding._is_axes_leaf)
    params = sum(_reckoned_bytes(v.shape, v.dtype, jax_sharding.logical_spec(v.shape, a, ctx),
                                 sizes) for v, a in zip(jax.tree.leaves(vals), ax))
    moments = sum(_reckoned_bytes(v.shape, jnp.float32,
                                  jax_sharding.logical_spec(v.shape, a, ctx), sizes)
                  for v, a in zip(jax.tree.leaves(vals), ax))
    inputs = sum(_reckoned_bytes(v.shape, v.dtype,
                                 jax_sharding.logical_spec(v.shape, ("batch", None), ctx), sizes)
                 for v in jax_input_specs(jc, JAX_SHAPES["train_4k"]).values())
    got = rec["argument_bytes"]
    assert got["params"] == params
    assert got["opt_state"] == 2 * moments + 4  # m, v and the int32 step
    assert got["inputs"] == inputs
    assert got["total"] == params + 2 * moments + 4 + inputs
    coll = rec["collectives"]
    assert coll["counts"] == coll["comm_debug_counts"] and coll["total_bytes"] > 0
    assert set(coll["counts"]) <= {"all-gather", "reduce-scatter", "all-reduce", "all-to-all",
                                   "collective-permute"}
    assert coll["bytes_by_op"].get("all-reduce", 0) > 0 and rec["flops"] > 0
    # the world's rank 0 reckons the same params + state bytes through state_bytes
    sb = dryrun.state_bytes(get_config("qwen3-0.6b"), (16, 16))
    assert sb["params"] == params and sb["opt_state"] == 2 * moments + 4


def test_collective_bytes_keys_and_ring_factor():
    out = dryrun.collective_bytes([("all-gather", 2048), ("all-reduce", 4096),
                                   ("reduce-scatter", 512), ("all-reduce", 4)])
    assert out["counts"] == {"all-gather": 1, "all-reduce": 2, "reduce-scatter": 1}
    assert out["bytes_by_op"]["all-reduce"] == 2 * 4100
    assert out["total_bytes"] == 2048 + 2 * 4100 + 512
