"""The port's logical-axis rule engine (``repro_torch.distributed.sharding``)
against the reference's (``repro.distributed.sharding``).

The rule cases of ``tests/test_sharding.py`` run on a real ``DeviceMesh`` of
8 ranks (a fake process group, in a subprocess: no default group is left
in the test process).  The parity tests resolve every parameter and
decode-state leaf of all ten archs at full width on both production meshes
with both engines; ``logical_spec`` reads only the mesh's axis sizes, so a
stand-in whose ``shape`` is ``{axis: size}`` serves both (the reference's
shapes come from ``jax.eval_shape``, the port's from meta tensors).  Specs
compare entry for entry, as strings.
"""

import functools
import json
import os
import subprocess
import sys
import types

import jax
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jax_sharding
from repro.launch.dryrun import plan_cell as jax_plan_cell
from repro.models.common import split_tree as jax_split_tree
from repro.models.model import decode_state_axes as jax_decode_state_axes
from repro.models.model import init_decode_state as jax_init_decode_state
from repro.models.model import init_model as jax_init_model
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import tree
from repro_torch.distributed import sharding
from repro_torch.launch.dryrun import plan_cell
from repro_torch.models.common import MetaGenerator, split_tree
from repro_torch.models.model import decode_state_axes, init_decode_state, init_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = {"1pod": {"data": 16, "model": 16}, "2pod": {"pod": 2, "data": 16, "model": 16}}

_SCRIPT = r"""
import json
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import distribute_tensor
from repro_torch.distributed.sharding import (
    hint, logical_spec, named_sharding, sharding_ctx, tree_shardings)
from repro_torch.launch.mesh import make_flat_mesh, make_mesh, make_production_mesh

out = {"blocks": {}}
for rank in range(8):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=8)
    try:
        if rank == 0:
            mesh = make_mesh((2, 4), ("data", "model"), "cpu")
            kv = ("batch", "cache_seq", "act_kv_heads", None)
            moe = ("expert", "embed", "moe_mlp")
            with sharding_ctx(mesh):
                out["heads_divisible"] = str(logical_spec((8, 64, 16, 128), kv))
                out["heads_fallback"] = str(logical_spec((8, 64, 10, 128), kv))
                out["expert_ok"] = str(logical_spec((8, 4096, 512), moe))
                out["expert_fallback"] = str(logical_spec((3, 4096, 512), moe))
                out["batch_1"] = str(logical_spec((1, 524288), ("batch", None)))
                out["no_double_use"] = str(logical_spec((8, 512, 512), ("batch", "mlp", "act_mlp")))
                out["placements"] = str(named_sharding((8, 64, 16, 128), kv).placements)
                meta = {"a": torch.empty(8, 512, device="meta")}
                tr = tree_shardings(meta, {"a": ("batch", "mlp")})
                out["tree"] = str(tr["a"].placements)
                x = torch.zeros(8, 512)
                y = hint(x, "batch", "mlp")
                out["hint"] = [str(y.placements), list(y.to_local().shape)]
                flat, half = make_flat_mesh(device_type="cpu"), make_flat_mesh(4, "model", "cpu")
                out["flat"] = [[list(m.shape), list(m.mesh_dim_names), m.mesh.tolist()]
                               for m in (flat, half)]
                try:
                    make_production_mesh(device_type="cpu")
                except ValueError as e:
                    out["production_on_8"] = str(e)
        # pod-major blocks of a dimension split over ("pod", "data")
        mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        with sharding_ctx(mesh3):
            ns = named_sharding((8, 4), ("batch", None))
            t = distribute_tensor(torch.arange(32).reshape(8, 4), mesh3, ns.placements,
                                  src_data_rank=None)
            out["blocks"][rank] = [list(mesh3.get_coordinate()), t.to_local()[:, 0].tolist()]
            if rank == 0:
                out["spec3"] = str(ns.spec)
    finally:
        dist.destroy_process_group()
print("JSON:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def specs():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
                          env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("JSON:")][-1]
    return json.loads(line[5:])


# The reference's six rule cases: its test's expected strings.
@pytest.mark.parametrize("case,want", [
    ("heads_divisible", "PartitionSpec('data', None, 'model', None)"),
    ("heads_fallback", "PartitionSpec('data', 'model', None, None)"),
    ("expert_fallback", "PartitionSpec(None, 'data', 'model')"),
    ("batch_1", "PartitionSpec(None, None)"),
])
def test_reference_rule_cases(specs, case, want):
    assert specs[case] == want


def test_expert_parallel_and_mesh_axis_used_once(specs):
    assert specs["expert_ok"].startswith("PartitionSpec('model'")
    assert specs["no_double_use"].count("'model'") == 1


def test_rule_cases_equal_the_reference_engine(specs):
    """The same cases through the reference's ``logical_spec`` (a stand-in
    (2, 4) mesh: it reads only the axis sizes)."""
    ctx = jax_sharding.ShardingCtx(mesh=types.SimpleNamespace(shape={"data": 2, "model": 4}),
                                   rules=dict(jax_sharding.DEFAULT_RULES))
    cases = {
        "heads_divisible": ((8, 64, 16, 128), ("batch", "cache_seq", "act_kv_heads", None)),
        "heads_fallback": ((8, 64, 10, 128), ("batch", "cache_seq", "act_kv_heads", None)),
        "expert_ok": ((8, 4096, 512), ("expert", "embed", "moe_mlp")),
        "expert_fallback": ((3, 4096, 512), ("expert", "embed", "moe_mlp")),
        "batch_1": ((1, 524288), ("batch", None)),
        "no_double_use": ((8, 512, 512), ("batch", "mlp", "act_mlp")),
    }
    for name, (shape, axes) in cases.items():
        assert specs[name] == str(jax_sharding.logical_spec(shape, axes, ctx)), name


def test_placements_of_resolved_specs(specs):
    assert specs["placements"] == "(Shard(dim=0), Shard(dim=2))"
    assert specs["tree"] == "(Shard(dim=0), Shard(dim=1))"
    assert specs["hint"] == ["(Shard(dim=0), Shard(dim=1))", [4, 128]]


def test_mesh_builders(specs):
    """``make_flat_mesh`` over all ranks and over the first 4;
    ``make_production_mesh`` needs its 256 ranks, as ``jax.make_mesh``
    needs its devices."""
    assert specs["flat"] == [[[8], ["data"], list(range(8))], [[4], ["model"], [0, 1, 2, 3]]]
    assert specs["production_on_8"] == \
        "mesh {'data': 16, 'model': 16} needs 256 ranks, the world has 8"


def test_pod_data_blocks_are_pod_major(specs):
    """A dimension split over ("pod", "data") on a (2, 2, 2) mesh: the rank
    at coordinate (p, d, m) holds block p * 2 + d, as JAX lays out
    ``PartitionSpec(("pod", "data"))``."""
    assert specs["spec3"] == "PartitionSpec(('pod', 'data'), None)"
    for rank, (coord, col) in specs["blocks"].items():
        p, d, _ = coord
        blk = p * 2 + d
        assert col == [4 * (2 * blk), 4 * (2 * blk + 1)], (rank, coord, col)


def test_hint_is_a_noop_without_a_context():
    x = torch.zeros(4, 8)
    assert sharding.hint(x, "batch", None) is x
    assert sharding.logical_spec((4, 8), ("batch", None)) == sharding.PartitionSpec()
    assert sharding.named_sharding((4, 8), ("batch", None)) is None
    assert sharding.current_ctx() is None


def test_exports_match_the_reference():
    import repro.distributed as jd
    import repro_torch.distributed as td

    for name in ("DEFAULT_RULES", "hint", "logical_spec", "named_sharding", "sharding_ctx"):
        assert hasattr(jd, name) and hasattr(td, name), name
    assert td.DEFAULT_RULES == jd.DEFAULT_RULES
    assert sharding.PRIORITY == jax_sharding.PRIORITY


def _ctx(module, sizes):
    return module.ShardingCtx(mesh=types.SimpleNamespace(shape=dict(sizes)),
                              rules=dict(module.DEFAULT_RULES))


def _jax_leaves(values, axes):
    """(name, shape, axes) of each leaf, names without separators."""
    flat = jax.tree_util.tree_flatten_with_path(values)[0]
    ax = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_flatten_with_path(
        axes, is_leaf=jax_sharding._is_axes_leaf)[0]}
    return [(jax.tree_util.keystr(p), tuple(v.shape), ax.get(jax.tree_util.keystr(p)))
            for p, v in flat]


def _port_leaves(values, axes):
    by_name = sharding._axes_by_name(axes)
    return [(name.replace("/", ""), tuple(v.shape), by_name.get(name))
            for name, v in tree.leaves_with_names(values) if isinstance(v, torch.Tensor)]


def _compare(jax_leaves, port_leaves, mesh):
    jctx, tctx = _ctx(jax_sharding, MESHES[mesh]), _ctx(sharding, MESHES[mesh])
    assert [n for n, _, _ in port_leaves] == [n for n, _, _ in jax_leaves]
    for (name, jshape, jaxes), (_, tshape, taxes) in zip(jax_leaves, port_leaves):
        assert jshape == tshape, name
        assert tuple(jaxes) == tuple(taxes), name
        want = str(jax_sharding.logical_spec(jshape, jaxes, jctx))
        got = str(sharding.logical_spec(tshape, taxes, tctx))
        assert got == want, f"{name} {jshape} {jaxes}: {got} vs {want}"
    return len(port_leaves)


@functools.lru_cache(maxsize=None)
def _param_leaves(arch):
    """Both packages' parameter leaves of ``arch`` at full width (abstract)."""
    jc = jax_get_config(arch)
    jvals, jaxes = jax_split_tree(jax.eval_shape(lambda: jax_init_model(jax.random.PRNGKey(0), jc)))
    tvals, taxes = split_tree(init_model(MetaGenerator(), get_config(arch)))
    return _jax_leaves(jvals, jaxes), _port_leaves(tvals, taxes)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_equal_the_reference(arch, mesh):
    n = _compare(*_param_leaves(arch), mesh)
    assert n >= 8


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_state_specs_equal_the_reference(arch, mesh):
    """The decode state of decode_32k (planned as the dry-run plans it, so
    int8 caches carry their scales) on both engines."""
    ndev = 512 if mesh == "2pod" else 256
    shape = SHAPES["decode_32k"]
    jc, _, _ = jax_plan_cell(jax_get_config(arch), JAX_SHAPES["decode_32k"], ndev)
    tc, _, _ = plan_cell(get_config(arch), shape, ndev)
    b, s = shape.global_batch, shape.seq_len
    enc = min(4096, s // 8)
    jstate = jax.eval_shape(lambda: jax_init_decode_state(jc, b, s, step=s - 1, enc_len=enc))
    tstate = init_decode_state(tc, b, s, step=s - 1, enc_len=enc, device="meta")
    jl = [x for x in _jax_leaves(jstate, jax_decode_state_axes(jc)) if x[0] != ".step"]
    n = _compare(jl, _port_leaves(tstate, decode_state_axes(tc)), mesh)
    assert n >= 2
    assert tc.kv_cache_dtype == jc.kv_cache_dtype
