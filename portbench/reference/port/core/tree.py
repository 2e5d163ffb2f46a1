"""Nested dict/list parameter trees (the port's stand-in for `jax.tree`).

Dict keys are visited in sorted order, as `jax.tree` does, so two trees with
the same structure flatten to the same leaf order whatever order their keys
were inserted in.
"""
from __future__ import annotations


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like `like` holding `leaves` (in `tree_leaves` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
