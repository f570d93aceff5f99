"""Nested dicts and lists of tensors (the port's params, optimizer and
train states), walked in the order ``jax.tree_util`` walks the
reference's: dict keys sorted, list items by index.  As in
``jax.tree_util``, ``is_leaf`` stops the walk at the nodes it accepts
(the sharding specs' tuples, for one)."""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, Tuple


def named_leaves(tree, prefix: Tuple[str, ...] = (), *,
                 is_leaf: Optional[Callable] = None) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs; a name is the leaf's path, keys and list
    indices joined by dots (the reference checkpoint's leaf names)."""
    if is_leaf is None or not is_leaf(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in named_leaves(
                tree[k], prefix + (str(k),), is_leaf=is_leaf)]
        if isinstance(tree, (list, tuple)):
            return [x for i, v in enumerate(tree) for x in named_leaves(
                v, prefix + (str(i),), is_leaf=is_leaf)]
    return [(".".join(prefix), tree)]


def tree_leaves(tree, *, is_leaf: Optional[Callable] = None) -> List[Any]:
    """The leaves, in :func:`named_leaves` order."""
    return [leaf for _, leaf in named_leaves(tree, is_leaf=is_leaf)]


def tree_unflatten(like, leaves: Iterable, *,
                   is_leaf: Optional[Callable] = None) -> Any:
    """A tree shaped like ``like`` whose leaves are ``leaves``, taken in
    :func:`named_leaves` order."""
    it = iter(leaves)

    def build(t):
        if is_leaf is not None and is_leaf(t):
            return next(it)
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
