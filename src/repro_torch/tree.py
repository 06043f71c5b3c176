"""Nested-dict parameter trees, the port's stand-in for the reference's
pytrees.  Leaves come in ``jax.tree.leaves`` order: every dict's keys
sorted, depth first.  Optimizer sums (the global gradient norm) and
checkpoint keys follow that order.
"""
from __future__ import annotations


def flatten(tree: dict, prefix: tuple = ()) -> list:
    """[(path, leaf)] in sorted-key order; ``path`` is the tuple of keys
    from the root."""
    out = []
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            out.extend(flatten(node, prefix + (key,)))
        else:
            out.append((prefix + (key,), node))
    return out


def unflatten(paths, leaves) -> dict:
    """The inverse of :func:`flatten`."""
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def leaves(tree: dict) -> list:
    return [leaf for _, leaf in flatten(tree)]


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` applied leaf-wise over trees of one structure."""
    return {key: tree_map(fn, node, *(r[key] for r in rest))
            if isinstance(node, dict) else fn(node, *(r[key] for r in rest))
            for key, node in tree.items()}
