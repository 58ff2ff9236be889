"""Nested-dict trees of tensors in the reference's pytree order: a dict's
children in sorted key order (``jax.tree.flatten``'s order for dicts),
so the i-th leaf here is the reference's i-th leaf."""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    """The leaves of a nested dict in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def map_tree(fn: Callable, *trees):
    """``fn`` over the leaves of trees of one structure, as a new tree."""
    if isinstance(trees[0], dict):
        return {k: map_tree(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)


def unflatten(like, values: List[Any]):
    """A tree shaped as ``like`` whose leaves are ``values`` in order."""
    it = iter(values)
    out = map_tree(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
