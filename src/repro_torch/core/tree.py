"""Trees of tensors: the port's counterpart of ``jax.tree_util`` for the
params, optimizer-state and checkpoint trees of the LM side.

A tree is a dict, list, tuple or ``NamedTuple`` of trees, or a leaf (any
other value; ``None`` is an empty subtree, as in JAX).  Leaves come out in
JAX's order: dict keys sorted, sequences by index, ``NamedTuple`` fields in
declaration order.  So the leaves, flattened and concatenated, map element
for element onto ``jax.flatten_util.ravel_pytree`` of the same tree, and
:func:`leaves_with_names` gives the names ``jax.tree_util.
tree_flatten_with_path`` gives (``['params']/['embed']``, ``.m``, ``[0]``),
which the checkpoint layout of both packages stores.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["leaves", "leaves_with_names", "tree_map", "unflatten"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x) -> List[Tuple[str, Any]]:
    """(name, child) pairs of an inner node in flatten order, or None for a leaf."""
    if isinstance(x, dict):
        return [(f"[{k!r}]", x[k]) for k in sorted(x)]
    if _is_namedtuple(x):
        return [(f".{f}", getattr(x, f)) for f in x._fields]
    if isinstance(x, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(x)]
    return None


def _rebuild(x, new_children: list):
    if isinstance(x, dict):
        return dict(zip(sorted(x), new_children))
    if _is_namedtuple(x):
        return type(x)(*new_children)
    return type(x)(new_children)


def leaves_with_names(tree) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` in flatten order; names join the path with ``/``."""
    out: List[Tuple[str, Any]] = []

    def walk(x, path):
        if x is None:
            return
        kids = _children(x)
        if kids is None:
            out.append(("/".join(path), x))
            return
        for name, c in kids:
            walk(c, path + [name])

    walk(tree, [])
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_names(tree)]


def unflatten(tree, new_leaves) -> Any:
    """A tree shaped like ``tree`` with ``new_leaves`` in flatten order."""
    it = iter(new_leaves)

    def build(x):
        if x is None:
            return None
        kids = _children(x)
        if kids is None:
            return next(it)
        return _rebuild(x, [build(c) for _, c in kids])

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure)."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("tree_map: trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
