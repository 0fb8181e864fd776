"""Multi-pod dry-run: run every (arch x shape) cell once on the production
meshes, on meta tensors over a fake process group, and extract the
per-rank footprint, collectives and flops (``repro/launch/dryrun.py``).

The reference lowers and compiles each cell with XLA on 512 placeholder
host devices.  The port has no compiler to ask: it runs the cell's step
itself, as rank 0 of a fake world of 256 ``(data=16, model=16)`` or 512
``(pod=2, data=16, model=16)`` ranks (``torch.testing``'s fake process
group: every collective returns at once, nothing moves), on DTensors whose
shards live on the meta device (shapes and dtypes, no storage), under a
``"cpu"``-typed ``DeviceMesh``.  So a cell runs in seconds of host time
with no memory for its tensors, and what rank 0 would hold, send and
compute is what this run records.

Per cell this script:
  1. builds the arch config (bf16 compute / f32 params, full remat),
  2. plans it (``plan_cell``: optimizer, param dtype, int8 KV cache),
  3. places params, optimizer state and inputs as DTensors through the
     logical rule engine (distributed/sharding.py),
  4. runs ``make_train_step``, ``prefill`` or ``decode_step`` once under
     ``sharding_ctx(mesh)``, counting
     - ``argument_bytes``: rank 0's shard bytes of params, optimizer state
       and inputs (the reference's ``argument_size_in_bytes``),
     - ``collectives``: each collective DTensor issued, counted by
       ``CommDebugMode`` and sized by its result tensor, with the ring
       factor 2 on all-reduce, under ``collective_bytes``'s keys,
     - ``flops``: rank 0's local flops (``torch.utils.flop_counter``'s
       formulas on the local ops),
  5. writes one JSON record per (cell, mesh).

XLA's temporary bytes, its HLO text and the CPU-upcast artifact estimate
have no counterpart here (see ROADMAP, "names not ported, by design").

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out artifacts/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# The fake world's device kind: DTensor shards on the meta device need a
# host-typed mesh ("cuda" would initialize a card, and hang without one).
MESH_DEVICE = "cpu"

# collective packet name -> the reference's HLO op name
_COLL_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def collective_bytes(records) -> Dict[str, Any]:
    """Sum the result-buffer bytes of each collective ``(op, bytes)``.

    Ring-algorithm wire factors: all-reduce moves ~2x its buffer
    (reduce-scatter + all-gather phases); the others ~1x."""
    per_op: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for op, nbytes in records:
        factor = 2.0 if op == "all-reduce" else 1.0
        per_op[op] = per_op.get(op, 0.0) + nbytes * factor
        counts[op] = counts.get(op, 0) + 1
    return {"bytes_by_op": per_op, "counts": counts, "total_bytes": sum(per_op.values())}


class _LocalCounter(TorchDispatchMode):
    """The local ops one rank runs: DTensor ops are handed back to DTensor
    (``NotImplemented``), so only the local shard's ops and the collectives
    DTensor issues reach this mode.  Records each collective's result bytes
    and sums the flops of the local ops."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops_of = flop_registry
        self.collectives = []
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = getattr(func, "overloadpacket", None)
        if packet is None:
            return out
        name = _COLL_NAMES.get(packet.__name__)
        if name is not None and func.namespace in ("_c10d_functional", "c10d_functional"):
            outs = out if isinstance(out, (list, tuple)) else [out]
            self.collectives.append((name, sum(_nbytes(o) for o in outs)))
        elif packet in self._flops_of:
            self.flops += int(self._flops_of[packet](*args, **kwargs, out_val=out))
        return out


def accum_steps_for(cfg, shape, optimizer: str = "adamw") -> int:
    """Gradient-accumulation microbatching for the big archs: the remat-saved
    activation stack scales with the per-step microbatch, so models with
    L x d_model beyond ~200k split the global batch (standard practice —
    global batch semantics unchanged).

    The adafactor/bf16 giants (arctic-480b) accumulate in bf16 (the f32
    gradient-sum tree would cost params x 4 B/device ~ 7.5 GiB)."""
    if shape.mode != "train":
        return 1
    if optimizer == "adafactor":
        return 4
    score = cfg.n_layers * cfg.d_model
    if score >= 400_000:  # qwen2-vl-72b (80x8192), qwen1.5-32b (64x5120)
        return 8
    if score >= 200_000:  # phi3 (40x5120)
        return 4
    return 1


def estimate_param_count(cfg) -> int:
    """Rough parameter count (embedding + blocks), for optimizer selection."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_padded
    hd = cfg.hd
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
    mlp = 3 * d * f
    if cfg.n_experts:
        mlp = cfg.n_experts * 3 * d * f + (3 * d * f if cfg.dense_residual else 0)
    if cfg.family == "ssm":
        di = cfg.d_inner
        per_layer = d * (2 * di + 2 * cfg.ssm_state + cfg.n_ssm_heads) + di * d
    elif cfg.family == "hybrid_rglru":
        w = cfg.lru_width or d
        per_layer = (2 * (2 * d * w + w * d + 2 * w * w + 3 * d * f) + (attn + 3 * d * f)) // 3
    else:
        per_layer = attn + mlp
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    layers = cfg.n_layers + cfg.n_enc_layers
    return int(emb + layers * per_layer)


def plan_cell(cfg, shape, num_devices: int, hbm_per_chip: int = 16 * 2**30):
    """Production planning: optimizer + param dtype for this cell.

    AdamW keeps f32 params + f32 m/v (12 B/param).  When that exceeds ~60%
    of pod HBM (leaving room for activations), switch to bf16 params +
    Adafactor factored second moment (~2.1 B/param) — the arctic-480b case.
    Serving always uses bf16 params.
    """
    n_params = estimate_param_count(cfg)
    if shape.mode != "train":
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
        if shape.mode == "decode" and cfg.family not in ("ssm",):
            # KV bytes at bf16; quantize to int8 when the pod share is large
            w = min(shape.seq_len, cfg.window or shape.seq_len)
            kv_bytes = 2 * cfg.n_layers * shape.global_batch * w * cfg.n_kv_heads * cfg.hd * 2
            if kv_bytes / num_devices > 4 * 2**30:
                cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        return cfg, "none", n_params
    adamw_bytes = 12 * n_params
    if adamw_bytes > 0.6 * num_devices * hbm_per_chip:
        return dataclasses.replace(cfg, param_dtype=torch.bfloat16), "adafactor", n_params
    return cfg, "adamw", n_params


def _build_cell(arch: str, shape_name: str):
    from ..configs import SHAPES, get_config, input_specs

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16, remat="full", scan_layers=True)
    shape = SHAPES[shape_name]
    return cfg, shape, input_specs(cfg, shape)


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor leaf of ``tree``."""
    from torch.distributed.tensor import DTensor

    from ..core import tree as _tree

    total = 0
    for t in _tree.leaves(tree):
        if isinstance(t, DTensor):
            total += _nbytes(t.to_local())
        elif isinstance(t, torch.Tensor):
            total += _nbytes(t)
    return total


def opt_state_template(params, axes, optimizer: str):
    """The optimizer state's template (meta, f32) and its logical axes, as
    the reference's dry-run places it: AdamW's m and v as the params;
    Adafactor's row moments by the axes less the last, its column moments
    by the axes less the second to last."""
    from ..core import tree as _tree
    from ..distributed.sharding import _axes_by_name
    from ..training.optimizer import FactoredState, OptState

    def f32(shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    step = torch.zeros((), dtype=torch.int32, device="meta")
    if optimizer == "adafactor":
        vr = _tree.tree_map(lambda p: f32(p.shape[:-1] if p.ndim >= 2 else p.shape), params)
        vc = _tree.tree_map(lambda p: f32(p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else ()),
                            params)
        # per-leaf axes tuples where the tensors were, read by name
        by_name = _axes_by_name(axes)
        names = [n for n, _ in _tree.leaves_with_names(params)]
        vr_axes = _tree.unflatten(params, [_slice_axes(by_name[n], True) for n in names])
        vc_axes = _tree.unflatten(params, [_slice_axes(by_name[n], False) for n in names])
        return (FactoredState(step=step, vr=vr, vc=vc),
                FactoredState(step=(), vr=vr_axes, vc=vc_axes))
    m = _tree.tree_map(lambda p: f32(p.shape), params)
    v = _tree.tree_map(lambda p: f32(p.shape), params)
    return OptState(step=step, m=m, v=v), OptState(step=(), m=axes, v=axes)


def _slice_axes(a, rows: bool):
    if rows:
        return a[:-1] if len(a) >= 2 else a
    return a[:-2] + a[-1:] if len(a) >= 2 else ()


def state_bytes(cfg, shape, axes=("data", "model"), rank: int = 0,
                optimizer: str = "adamw") -> Dict[str, int]:
    """What one rank of a ``shape`` mesh holds of the params and the
    optimizer state of ``cfg``, as the dry-run lays them out (rank ``rank``
    of a fake world, meta tensors): ``{"params", "opt_state", "total"}``."""
    import math

    from ..distributed.sharding import distribute_tree, sharding_ctx
    from ..models.common import MetaGenerator, split_tree
    from ..models.model import init_model
    from .mesh import make_mesh

    with fake_world(math.prod(shape), rank=rank):
        mesh = make_mesh(shape, axes, MESH_DEVICE)
        with sharding_ctx(mesh):
            params_meta, p_axes = split_tree(init_model(MetaGenerator(), cfg))
            opt_tmpl, opt_axes = opt_state_template(params_meta, p_axes, optimizer)
            out = {"params": local_bytes(distribute_tree(params_meta, p_axes)),
                   "opt_state": local_bytes(distribute_tree(opt_tmpl, opt_axes))}
    return {**out, "total": out["params"] + out["opt_state"]}


def lower_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True) -> Dict:
    """Run one cell on one production mesh (a fake world of 256 or 512)."""
    from functools import partial

    from torch.distributed.tensor.debug import CommDebugMode

    from ..distributed.sharding import distribute_tree, sharding_ctx
    from ..training.data import BATCH_AXES
    from ..models.common import MetaGenerator, split_tree
    from ..models.model import decode_state_axes, decode_step, init_model, prefill
    from ..training import TrainConfig, make_train_step
    from .mesh import make_production_mesh

    cfg, shape, specs = _build_cell(arch, shape_name)
    world = 512 if multi_pod else 256
    with fake_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=MESH_DEVICE)
        cfg, optimizer, n_params = plan_cell(cfg, shape, world)
        if shape.mode == "decode":  # state template must match the planned dtype
            from ..configs import input_specs as _ispecs

            specs = _ispecs(cfg, shape)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        rec: Dict[str, Any] = {
            "arch": arch, "shape": shape_name, "mesh": f"{sizes}",
            "num_devices": world, "mode": shape.mode, "optimizer": optimizer,
            "est_params": n_params,
        }
        t0 = time.perf_counter()
        with sharding_ctx(mesh):
            params_meta, axes = split_tree(init_model(MetaGenerator(), cfg))
            params = distribute_tree(params_meta, axes)
            batch = {k: distribute_tree(v, BATCH_AXES[k]) for k, v in specs.items()
                     if k in BATCH_AXES}
            args_bytes = {"params": local_bytes(params), "inputs": local_bytes(batch)}
            if shape.mode == "train":
                opt_tmpl, opt_axes = opt_state_template(params_meta, axes, optimizer)
                opt = distribute_tree(opt_tmpl, opt_axes)
                args_bytes["opt_state"] = local_bytes(opt)
                accum = accum_steps_for(cfg, shape, optimizer)
                rec["accum_steps"] = accum
                accum_dtype = torch.bfloat16 if optimizer == "adafactor" else None
                step_fn = make_train_step(
                    cfg, TrainConfig(accum_steps=accum, optimizer=optimizer,
                                     accum_dtype=accum_dtype))
                run = partial(step_fn, params, opt, batch)
            elif shape.mode == "prefill":
                run = partial(prefill, params, cfg, batch,
                              max_len=min(shape.seq_len, cfg.window or shape.seq_len))
            else:
                state = distribute_tree(specs["state"], decode_state_axes(cfg))
                args_bytes["state"] = local_bytes(state)
                run = partial(decode_step, params, cfg, state, batch["tokens"])
            rec["place_s"] = round(time.perf_counter() - t0, 2)
            t1 = time.perf_counter()
            counter = _LocalCounter()
            with CommDebugMode() as comm, counter:
                run()
            rec["run_s"] = round(time.perf_counter() - t1, 2)
        counts = {_COLL_NAMES[p.__name__]: 0 for p in comm.get_comm_counts()
                  if p.__name__ in _COLL_NAMES}
        for p, n in comm.get_comm_counts().items():
            if p.__name__ in _COLL_NAMES:
                counts[_COLL_NAMES[p.__name__]] += n
        rec["argument_bytes"] = {**args_bytes, "total": sum(args_bytes.values())}
        rec["collectives"] = collective_bytes(counter.collectives)
        rec["collectives"]["comm_debug_counts"] = counts
        rec["flops"] = counter.flops
    if verbose:
        print(
            f"[{arch} x {shape_name} x {'2pod' if multi_pod else '1pod'}] "
            f"run={rec['run_s']}s args/rank={rec['argument_bytes']['total'] / 2**30:.2f}GiB "
            f"flops/rank={rec['flops']:.3e} "
            f"coll={rec['collectives']['total_bytes'] / 2**30:.3f}GiB "
            f"{rec['collectives']['counts']}"
        )
    return rec


class fake_world:
    """A fake default process group of ``world`` ranks (this process is
    ``rank``, 0 by default) for the duration of the block; the group is
    destroyed on exit, so no later code in the process sees a "distributed"
    default group."""

    def __init__(self, world: int, rank: int = 0):
        self.world, self.rank = world, rank

    def __enter__(self):
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore

        if dist.is_initialized():
            raise RuntimeError("the dry-run needs a process without a default process group")
        dist.init_process_group("fake", store=FakeStore(), rank=self.rank, world_size=self.world)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()
        return False


def summary_table(directory: str) -> str:
    """A Markdown table of the records in ``directory`` (``--all --out``):
    per cell, each mesh's per-rank argument GiB, collective GiB and counts
    (all-gather / reduce-scatter / all-reduce), flops and run seconds."""
    recs = {}
    for name in sorted(os.listdir(directory)):
        if name.endswith(".json"):
            with open(os.path.join(directory, name)) as f:
                r = json.load(f)
            recs[(r["arch"], r["shape"], r["num_devices"])] = r

    def cols(r):
        if r is None:
            return "missing | | | |"
        c = r["collectives"]
        n = c["counts"]
        return (f"{r['argument_bytes']['total'] / 2**30:.2f} | {c['total_bytes'] / 2**30:.1f} | "
                f"{n.get('all-gather', 0)}/{n.get('reduce-scatter', 0)}/{n.get('all-reduce', 0)} | "
                f"{r['flops']:.2e} | {r['run_s']:.0f}")

    cells = sorted({(a, s) for a, s, _ in recs}, key=lambda c: (c[0], c[1]))
    lines = ["| cell | plan | (16,16) args GiB | coll GiB | AG/RS/AR | flops | s | "
             "(2,16,16) args GiB | coll GiB | AG/RS/AR | flops | s |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for a, sh in cells:
        one, two = recs.get((a, sh, 256)), recs.get((a, sh, 512))
        plan = (one or two)["optimizer"] + (f" x{(one or two)['accum_steps']}"
                                            if (one or two).get("accum_steps", 1) > 1 else "")
        lines.append(f"| {a} {sh} | {plan} | {cols(one)} | {cols(two)} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", type=str)
    ap.add_argument("--shape", type=str)
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", type=str, default=None,
                    help="comma-separated archs: --all over these only (one process a group)")
    ap.add_argument("--out", type=str, default=None, help="JSON output path or dir (--all)")
    ap.add_argument("--table", type=str, default=None,
                    help="print the Markdown table of a --all --out directory and exit")
    args = ap.parse_args(argv)

    from ..configs import ARCHS, SHAPES, applicable

    if args.table:
        print(summary_table(args.table))
        return None

    if args.all:
        archs = args.archs.split(",") if args.archs else list(ARCHS)
        cells = [(a, s) for a in archs for s in SHAPES if applicable(a, s)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    t_all = time.perf_counter()
    results, failures = [], []
    for arch, shp in cells:
        try:
            if not args.multi_pod_only:
                results.append(lower_cell(arch, shp, multi_pod=False))
            if not args.single_pod_only:
                results.append(lower_cell(arch, shp, multi_pod=True))
        except Exception as e:  # noqa: BLE001 — report and continue
            import traceback

            failures.append((arch, shp, f"{type(e).__name__}: {e}"))
            traceback.print_exc()
    if args.out:
        if args.all or len(results) > 1:
            os.makedirs(args.out, exist_ok=True)
            for rec in results:
                tag = "2pod" if rec["num_devices"] == 512 else "1pod"
                path = os.path.join(args.out, f"{rec['arch']}__{rec['shape']}__{tag}.json")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
        else:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    if failures:
        print("FAILURES:")
        for a, s, e in failures:
            print(f"  {a} x {s}: {e}")
        sys.exit(1)
    print(f"dry-run OK: {len(results)} runs in {time.perf_counter() - t_all:.1f} s")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
