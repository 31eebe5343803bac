"""The port's parameter trees (nested dicts and lists of tensors) walked in
one fixed order, JAX's: dict entries by sorted key, list items by index.
The optimizers map over trees with it and the checkpoint manager numbers
its shards by it, so a leaf's place never depends on insertion order."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def leaves(tree) -> List[Any]:
    """Every leaf of ``tree`` in the fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def paths(tree, prefix=()) -> List[tuple]:
    """Each leaf's path (its dict keys and list indices) in the fixed
    order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [q for i, t in enumerate(tree)
                for q in paths(t, prefix + (i,))]
    return [prefix]


def unflatten(like, items) -> Any:
    """A tree shaped as ``like`` whose leaves are ``items`` (an iterable,
    consumed in the fixed order)."""
    it: Iterator = iter(items)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}      # keep the caller's order
        if isinstance(node, (list, tuple)):
            return type(node)(build(t) for t in node)
        return next(it)
    return build(like)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    return unflatten(tree, (fn(*xs) for xs in
                            zip(leaves(tree), *(leaves(r) for r in rest))))
