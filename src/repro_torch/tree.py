"""Nested dicts and lists of tensors (the port's params, optimizer and
train states), walked in the order ``jax.tree_util`` walks the
reference's: dict keys sorted, list items by index."""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Tuple


def named_leaves(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs; a name is the leaf's path, keys and list
    indices joined by dots (the reference checkpoint's leaf names)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in named_leaves(v, prefix + (str(i),))]
    return [(".".join(prefix), tree)]


def tree_leaves(tree) -> List[Any]:
    """The leaves, in :func:`named_leaves` order."""
    return [leaf for _, leaf in named_leaves(tree)]


def tree_unflatten(like, leaves: Iterable) -> Any:
    """A tree shaped like ``like`` whose leaves are ``leaves``, taken in
    :func:`named_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees shaped like it."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
