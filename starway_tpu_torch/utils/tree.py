"""Parameter and optimizer trees: nested dicts, lists, tuples and
NamedTuples of tensors.

Leaves come out in JAX's flatten order (dict keys sorted, sequences in
order, ``None`` an empty subtree), so a tree flattened here lines up leaf
for leaf with the same tree flattened by ``jax.tree_util``; checkpoints
(utils/checkpoint.py) rely on that order.
"""

from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for node in tree for x in tree_leaves(node)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    if isinstance(tree, (list, tuple)):
        kids = [tree_map(fn, node, *(r[i] for r in rest))
                for i, node in enumerate(tree)]
        if _is_namedtuple(tree):
            return type(tree)(*kids)
        return type(tree)(kids)
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in flatten order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {key: None for key in node}  # keep the caller's key order
            for key in sorted(node):
                out[key] = build(node[key])
            return out
        if isinstance(node, (list, tuple)):
            kids = [build(x) for x in node]
            return type(node)(*kids) if _is_namedtuple(node) else type(node)(
                kids)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has places")
    return out
