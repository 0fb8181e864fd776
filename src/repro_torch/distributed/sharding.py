"""Logical-axis sharding rule engine (MaxText-style, with fallbacks), over a
``torch.distributed`` ``DeviceMesh`` (``repro/distributed/sharding.py``).

Every parameter and activation in the model zoo is annotated with *logical*
axis names.  A rule table maps each name to an ordered list of candidate mesh
axes; resolution walks the tensor's axes left-to-right picking the first
candidate whose mesh size divides the dimension AND whose mesh axes are not
already used by this tensor.  This gives graceful degradation on awkward
architectures (e.g. 10 attention heads on a 16-wide model axis -> heads stay
replicated and the engine shards head_dim or the KV sequence instead), which
is what lets one rule table cover all 10 assigned architectures.

The active (mesh, rules) pair is installed via ``sharding_ctx`` by the
launcher / dry-run; with no context, ``hint`` is a no-op so single-device
smoke tests run the exact same model code.

The port's layout is DTensor's: a resolved spec becomes one placement per
mesh dimension (``Shard(i)`` where the spec puts that mesh axis on tensor
dimension ``i``, else ``Replicate()``).  A dimension sharded over
``("pod", "data")`` is ``Shard(i)`` on both mesh dimensions, split in mesh
order: pod-major blocks, as JAX lays out the same spec.  Under a context
with a mesh, ``hint`` redistributes a DTensor to its resolved placements
(a plain tensor counts as replicated), and DTensor's implicit replication
is on, so the plain tensors the model code builds (positions, masks, zero
accumulators) join DTensor arithmetic as replicated values.

``distribute_tree`` lays a tree out by its axes; ``constrain``,
``split_last`` and ``keep_layout`` fix layouts DTensor cannot choose;
``to_local`` / ``from_local`` run a computation on each rank's shards with
the gradient layouts a double backward needs (the Hessian-vector product).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..core import tree as _tree

__all__ = [
    "DEFAULT_RULES",
    "PartitionSpec",
    "ShardingCtx",
    "sharding_ctx",
    "current_ctx",
    "logical_spec",
    "hint",
    "constrain",
    "settle",
    "keep_layout",
    "split_last",
    "as_dtensor",
    "to_local",
    "from_local",
    "named_sharding",
    "NamedSharding",
    "tree_shardings",
    "distribute_tree",
    "mesh_sizes",
]

Candidate = Optional[Tuple[str, ...]]

# Ordered candidates per logical axis.  None = replicate.
DEFAULT_RULES: Dict[str, List[Candidate]] = {
    # --- activations ---
    "batch": [("pod", "data"), ("data",), None],
    "seq": [None],
    # sequence parallelism: the residual stream at layer boundaries (and thus
    # the remat-saved activation stack) is sharded over 'model'; attention
    # re-gathers inside the layer.
    "act_seq": [("model",), None],
    "act_embed": [None],
    "act_heads": [("model",), None],
    "act_kv_heads": [("model",), None],
    "act_mlp": [("model",), None],
    "act_vocab": [("model",), None],
    "act_expert": [("model",), None],
    "cache_seq": [("model",), None],  # KV-cache fallback when heads don't divide
    "act_ssm_inner": [("model",), None],
    # --- parameters (FSDP over 'data', TP over 'model') ---
    "vocab": [("model",), None],
    "embed": [("data",), None],  # FSDP axis
    "heads": [("model",), None],
    "kv_heads": [("model",), None],
    "head_dim": [None],
    "qkv": [("model",), None],  # fused q/k/v output dim
    "mlp": [("model",), None],
    "expert": [("model",), None],
    "moe_mlp": [("model",), None],  # falls back to TP-within-expert (mixtral)
    "conv": [None],
    "lru": [("model",), None],
    "ssm_inner": [("model",), None],
    "ssm_state": [None],
    "ssm_heads": [("model",), None],
    "layers": [None],  # stacked-layer leading axis
    "stage": [None],  # pipeline stage axis
}

# Resolution order: higher-priority logical axes claim mesh axes first, so a
# KV-cache (batch, seq, kv_heads, dim) gives 'model' to kv_heads when the
# head count divides, and only otherwise to the cache seq axis.
PRIORITY = {
    "vocab": 10,
    "heads": 10,
    "kv_heads": 10,
    "act_heads": 10,
    "act_kv_heads": 10,
    "expert": 10,
    "act_expert": 10,
    "batch": 9,
    "mlp": 8,
    "act_mlp": 8,
    "moe_mlp": 7,
    "qkv": 8,
    "lru": 8,
    "ssm_inner": 8,
    "act_ssm_inner": 8,
    "ssm_heads": 8,
    "embed": 6,
    "act_seq": 4,
    "cache_seq": 3,
}


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a tensor: ``None``, an axis name, or a
    tuple of names.  Prints and compares as the reference's
    ``jax.sharding.PartitionSpec`` does (``PartitionSpec('data', None)``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    __str__ = __repr__


P = PartitionSpec


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (its ``shape`` is a tuple,
    named by ``mesh_dim_names``) or of any object whose ``shape`` already is
    that mapping."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("the mesh has no dimension names")
    return dict(zip(names, tuple(shape)))


@dataclasses.dataclass
class ShardingCtx:
    mesh: Optional[object]
    rules: Dict[str, List[Candidate]]

    @property
    def sizes(self) -> Dict[str, int]:
        return mesh_sizes(self.mesh)

    def axis_size(self, names: Tuple[str, ...]) -> int:
        sizes = self.sizes
        return math.prod(sizes[n] for n in names)


_STACK: List[ShardingCtx] = []


def current_ctx() -> Optional[ShardingCtx]:
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[Dict] = None):
    """Install ``(mesh, DEFAULT_RULES updated by rules)``.  With a
    ``DeviceMesh`` (anything with ``mesh_dim_names``), DTensor's implicit
    replication is on inside the block, and DTensor's backwards are made
    differentiable where they are not (:func:`differentiable_backwards`)."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _STACK.append(ShardingCtx(mesh=mesh, rules=merged))
    try:
        with contextlib.ExitStack() as stack:
            if mesh is not None and hasattr(mesh, "mesh_dim_names"):
                from torch.distributed.tensor.experimental import implicit_replication

                differentiable_backwards()
                stack.enter_context(implicit_replication())
            yield _STACK[-1]
    finally:
        _STACK.pop()


_PATCHED = []


def differentiable_backwards(force: bool = False) -> bool:
    """Make DTensor's own backward steps differentiable where this PyTorch's
    are not (idempotent; returns whether they were patched).

    The Hessian-vector product differentiates a gradient, so every step of
    the first backward must itself be recorded.  In PyTorch releases whose
    ``Redistribute.backward`` wraps its result in a new DTensor (2.11: no
    ``NestedRedistribute``), the redistributions of the first backward, and
    ``to_local`` / ``from_local``'s, are cut from the graph: the second
    derivative through every collective is lost (on the card, sharded
    HVPs at 0.37 of the unsharded norm).  Here each of those three
    backwards, when grad mode is on (a ``create_graph=True`` backward),
    performs the same layout change through differentiable DTensor calls
    (``redistribute``, ``from_local``, ``to_local``); with grad mode off it
    runs PyTorch's own.  Process-wide; a release with differentiable
    backwards is left alone unless ``force``."""
    if _PATCHED:
        return True
    import inspect

    import torch
    from torch.distributed.tensor import DTensor, Replicate, _api, _redistribute

    if hasattr(_redistribute, "NestedRedistribute") and not force:
        return False
    from torch.distributed.tensor import _utils

    _normalize_placements_for_grad = _api._normalize_placements_for_grad
    compute_global_tensor_info = getattr(_api, "compute_global_tensor_info",
                                         getattr(_utils, "compute_global_tensor_info", None))

    red, to_t, from_t = _redistribute.Redistribute, _api._ToTorchTensor, _api._FromTorchTensor
    nones = {f: len(inspect.signature(f.forward).parameters) - 2 for f in (red, to_t, from_t)}
    orig = {f: f.backward for f in (red, to_t, from_t)}

    def redistribute_backward(ctx, grad_output):
        if not torch.is_grad_enabled() or not hasattr(ctx, "current_spec"):
            return orig[red](ctx, grad_output)
        prev = ctx.current_spec
        want = getattr(ctx, "backward_dtype", None) or getattr(ctx, "original_dtype",
                                                                grad_output.dtype)
        g = grad_output if grad_output.dtype == want else grad_output.to(want)
        target = tuple(Replicate() if (c.is_shard() or c.is_replicate()) and t.is_partial() else t
                       for c, t in zip(g.placements, prev.placements))
        if target != tuple(g.placements):
            g = g.redistribute(prev.device_mesh, target)
        out = getattr(ctx, "original_dtype", g.dtype)
        return (g if g.dtype == out else g.to(out),) + (None,) * nones[red]

    def to_torch_backward(ctx, grad_output):
        if grad_output is None or not torch.is_grad_enabled():
            return orig[to_t](ctx, grad_output)
        spec = ctx.dtensor_spec
        gp = ctx.grad_placements or _normalize_placements_for_grad(spec.placements)
        _, stride = compute_global_tensor_info(grad_output, spec.mesh, spec.placements)
        g = DTensor.from_local(grad_output, spec.mesh, tuple(gp), run_check=False,
                               shape=spec.tensor_meta.shape, stride=tuple(stride))
        return (g,) + (None,) * nones[to_t]

    def from_torch_backward(ctx, grad_output):
        if grad_output is None or not torch.is_grad_enabled():
            return orig[from_t](ctx, grad_output)
        norm = tuple(_normalize_placements_for_grad(ctx.forward_input_placements))
        g = grad_output
        if tuple(g.placements) != norm:
            g = g.redistribute(ctx.forward_input_device_mesh, norm)
        return (g.to_local(),) + (None,) * nones[from_t]

    red.backward = staticmethod(redistribute_backward)
    to_t.backward = staticmethod(to_torch_backward)
    from_t.backward = staticmethod(from_torch_backward)
    _PATCHED.append(orig)
    return True


def logical_spec(
    shape: Sequence[int], axes: Sequence[Optional[str]], ctx: Optional[ShardingCtx] = None
) -> PartitionSpec:
    """Resolve logical axis names to a PartitionSpec for this shape."""
    ctx = ctx or current_ctx()
    if ctx is None or ctx.mesh is None:
        return P()
    assert len(shape) == len(axes), f"shape {shape} vs axes {axes}"
    sizes = ctx.sizes
    used: set = set()
    parts: List = [None] * len(shape)
    order = sorted(
        range(len(shape)),
        key=lambda i: -PRIORITY.get(axes[i], 5) if axes[i] is not None else 0,
    )
    for i in order:
        dim, name = shape[i], axes[i]
        if name is None:
            continue
        for cand in ctx.rules.get(name, [None]):
            if cand is None:
                break
            if any(a in used for a in cand):
                continue
            if any(a not in sizes for a in cand):
                continue
            if dim % ctx.axis_size(cand) == 0:
                used.update(cand)
                parts[i] = cand[0] if len(cand) == 1 else cand
                break
    return P(*parts)


def placements_of(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``: per mesh dimension,
    ``Shard(i)`` for the tensor dimension ``i`` that names it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for i, part in enumerate(spec):
        for a in (part,) if isinstance(part, str) else (part or ()):
            dim_of[a] = i
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate() for n in mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A resolved layout: the mesh, the spec and its DTensor placements (a
    leaf of the trees :func:`tree_shardings` returns)."""

    mesh: object
    spec: PartitionSpec
    placements: tuple


def named_sharding(
    shape: Sequence[int], axes: Sequence[Optional[str]], ctx: Optional[ShardingCtx] = None
) -> Optional[NamedSharding]:
    """The layout of a tensor of ``shape`` with logical ``axes`` over the
    context's mesh, or None without a mesh."""
    ctx = ctx or current_ctx()
    if ctx is None or ctx.mesh is None:
        return None
    spec = logical_spec(shape, axes, ctx)
    return NamedSharding(ctx.mesh, spec, placements_of(spec, ctx.mesh))


def hint(x, *axes: Optional[str]):
    """Redistribute ``x`` to the placements its logical ``axes`` resolve to;
    ``x`` itself without a mesh context."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None:
        return x
    return constrain(x, logical_spec(x.shape, axes, ctx), ctx.mesh)


def constrain(x, spec: Optional[PartitionSpec], mesh, placements=None):
    """``x`` laid out as ``spec`` (or as explicit ``placements``) over
    ``mesh``; a plain tensor counts as replicated."""
    want = tuple(placements) if placements is not None else placements_of(spec, mesh)
    x = as_dtensor(x, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def settle(x):
    """``x`` with any pending partial sum over a mesh dimension reduced (to
    ``Replicate``): the explicit resolution of an op whose DTensor result
    stays partial where a later op's redistribution cannot take it.  A
    plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh,
                          [Replicate() if p.is_partial() else p for p in x.placements])


def as_dtensor(x, mesh):
    """``x`` as a DTensor over ``mesh``: a plain tensor counts as replicated."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def to_local(x, mesh, placements, grad_placements=None):
    """This rank's shard of ``x`` laid out as ``placements`` (redistributed
    first when it is not).  ``grad_placements`` is the layout of the
    gradient the local computation hands back (default ``placements``): a
    replicated input of a computation split over a mesh dimension gets
    ``Partial()`` there."""
    x = constrain(x, None, mesh, placements)
    return x.to_local(grad_placements=tuple(grad_placements or placements))


def from_local(t, mesh, placements, shape):
    """The DTensor of global ``shape`` whose shard on this rank is ``t`` (a
    ``Partial()`` placement: this rank's term of a sum).

    Its backward is its own: the gradient is laid out as ``placements``
    with partial sums replicated (a differentiable redistribution), then
    handed to ``t`` through ``to_local`` whose gradient layout is
    ``placements`` itself.  DTensor's ``from_local`` hands it through a
    ``to_local`` that calls a partial term replicated, which is right for a
    first backward but cuts the double backward of a Hessian-vector
    product: the cotangent of each rank's copy of the gradient is a term of
    a sum over that axis."""
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= d
    return _FromLocal.apply(t, mesh, tuple(placements), tuple(shape), tuple(reversed(stride)))


def _grad_placements(placements) -> tuple:
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if p.is_partial() else p for p in placements)


def _from_local_fn():
    import torch
    from torch.distributed.tensor import DTensor

    class FromLocal(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, mesh, placements, shape, stride):
            ctx.mesh, ctx.placements = mesh, placements
            return DTensor.from_local(t, mesh, placements, run_check=False, shape=shape,
                                      stride=stride)

        @staticmethod
        def backward(ctx, g):
            want = _grad_placements(ctx.placements)
            if tuple(g.placements) != want:
                g = g.redistribute(ctx.mesh, want)
            return g.to_local(grad_placements=ctx.placements), None, None, None, None

    return FromLocal


class _Lazy:
    """An autograd Function built on first use (torch.distributed.tensor is
    imported only when a mesh is)."""

    def __init__(self, make):
        self._make, self._fn = make, None

    def apply(self, *args):
        if self._fn is None:
            self._fn = self._make()
        return self._fn.apply(*args)


_FromLocal = _Lazy(_from_local_fn)


def keep_layout(x):
    """``x``, whose gradient is laid out as ``x`` is before it flows on
    (a differentiable redistribution in the backward pass): the guard of a
    reshape whose backward could not split or merge a gradient sharded on
    another dimension.  A plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return _GradLayout.apply(x, tuple(x.placements))


def split_last(t, shape, axes):
    """``t`` (..., a * b) reshaped to ``shape`` (..., a, b).  Under a mesh,
    ``t`` is first laid out as the split will be by the logical ``axes`` of
    ``shape`` (the merged dimension takes the split's first part), so the
    split never cuts a sharded dimension unevenly (8 KV heads, 24 SSD heads
    on a 16-wide model axis), and the gradient comes back in that layout."""
    ctx = current_ctx()
    if ctx is None or ctx.mesh is None:
        return t.reshape(shape)
    spec = logical_spec(tuple(shape), axes, ctx)
    t = constrain(t, PartitionSpec(*spec[:-1]), ctx.mesh)
    return keep_layout(t.reshape(shape))


def _grad_layout_fn():
    import torch

    class GradLayout(torch.autograd.Function):
        """Identity whose backward lays the incoming gradient out as
        ``placements`` (a differentiable redistribution)."""

        @staticmethod
        def forward(ctx, x, placements):
            ctx.placements = placements
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            if tuple(g.placements) != ctx.placements:
                g = g.redistribute(g.device_mesh, ctx.placements)
            return g, None

    return GradLayout


_GradLayout = _Lazy(_grad_layout_fn)


def _is_axes_leaf(x) -> bool:
    return x is None or (
        isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)
    )


def _axes_by_name(axes_tree) -> Dict[str, tuple]:
    """``{leaf name: axes tuple}`` of an axes tree whose leaves are tuples of
    axis names (named as :func:`repro_torch.core.tree.leaves_with_names`
    names the matching value leaves)."""
    out: Dict[str, tuple] = {}

    def walk(x, path):
        if _is_axes_leaf(x) and not (hasattr(x, "_fields")):
            if x is not None:
                out["/".join(path)] = x
            return
        kids = _tree._children(x)
        if kids is None:
            return
        for name, c in kids:
            walk(c, path + [name])

    walk(axes_tree, [])
    return out


def tree_shardings(values_tree, axes_tree, ctx: Optional[ShardingCtx] = None):
    """Zip a tree of tensors with a same-structure tree of logical-axes
    tuples into :class:`NamedSharding` leaves (None without a mesh).

    Axes tuples are themselves trees and ``()`` is both "scalar" and "empty
    container", so leaves are matched by *name* rather than position; axes
    entries with no matching value (empty containers, None branches) are
    ignored, and a value with no axes entry is replicated."""
    ctx = ctx or current_ctx()
    by_name = _axes_by_name(axes_tree)
    named = _tree.leaves_with_names(values_tree)
    out = []
    for name, v in named:
        if not hasattr(v, "shape"):  # host data (a decode state's step)
            out.append(None)
            continue
        a = by_name.get(name)
        a = a if a is not None else (None,) * len(v.shape)
        out.append(named_sharding(v.shape, a, ctx))
    return _tree.unflatten(values_tree, out) if named else values_tree


def distribute_tree(values_tree, axes_tree, ctx: Optional[ShardingCtx] = None):
    """``values_tree`` with each tensor leaf a DTensor over the context's
    mesh, laid out by its logical axes (matched by name, as in
    :func:`tree_shardings`); other leaves unchanged.  Every rank keeps its
    own chunk of its own tensor (``src_data_rank=None``: no collective), so
    each rank must hold the same values (a seeded init, a checkpoint, meta
    tensors).  ``values_tree`` itself without a mesh."""
    ctx = ctx or current_ctx()
    if ctx is None or ctx.mesh is None:
        return values_tree
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    by_name = _axes_by_name(axes_tree)
    out = []
    for name, v in _tree.leaves_with_names(values_tree):
        if not isinstance(v, torch.Tensor) or isinstance(v, DTensor):
            out.append(v)
            continue
        a = by_name.get(name)
        ns = named_sharding(v.shape, a if a is not None else (None,) * v.ndim, ctx)
        d = distribute_tensor(v, ctx.mesh, ns.placements, src_data_rank=None)
        if v.device.type != "meta":  # own the shard: the whole tensor may be freed
            d = DTensor.from_local(d.to_local().clone(), ctx.mesh, d.placements,
                                   run_check=False, shape=d.shape, stride=d.stride())
        out.append(d)
    return _tree.unflatten(values_tree, out)
