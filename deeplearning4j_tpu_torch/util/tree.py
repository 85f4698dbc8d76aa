"""Nested dict/list trees of tensors, in jax.tree_util's order.

The JAX package keeps params, states and updater states as pytrees; the
port keeps the same nested dicts. `leaves` walks them in jax.tree_util
flatten order — dict keys sorted at every level, list/tuple items in
order, no leaf for None or an empty container — which is also the order
of `jax.flatten_util.ravel_pytree` and of the arrays in a JAX model zip.
"""

from __future__ import annotations

from typing import Any, List


def leaves(tree) -> List[Any]:
    """Leaves of a nested dict/list tree in jax.tree_util order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves(tree[k]))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for v in tree:
            out.extend(leaves(v))
        return out
    return [tree]


def unflatten(like, values, pos=0):
    """Rebuild `like`'s structure from `values` (in `leaves` order).
    Returns (tree, next position)."""
    if like is None:
        return None, pos
    if isinstance(like, dict):
        out = {}
        for k in sorted(like):
            out[k], pos = unflatten(like[k], values, pos)
        return {k: out[k] for k in like}, pos
    if isinstance(like, (list, tuple)):
        items = []
        for v in like:
            item, pos = unflatten(v, values, pos)
            items.append(item)
        return type(like)(items), pos
    return values[pos], pos + 1


def tree_map(fn, tree, *rest):
    """fn over corresponding leaves of trees with `tree`'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *[r[i] for r in rest])
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)
