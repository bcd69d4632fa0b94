"""Leaves of nested dicts, lists and tuples, in the JAX package's tree order.

The reference flattens its parameter, optimizer and cache trees with
``jax.tree_util``: dict keys sorted, sequences in index order, ``None`` an
empty subtree.  Every byte stream the port derives from a tree (the ML
workload families, a captured pytree, the parameters of a model) walks it in
that order through :func:`tree_flatten_with_path`, so both packages see the
same bytes.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_flatten_with_path(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs depth first; a path holds dict keys and list
    indices from the root down."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in tree_flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree) for pair in tree_flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree: Any) -> list[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure), called in :func:`tree_leaves` order; the
    result has ``tree``'s structure, dict keys sorted."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def path_str(path: tuple) -> str:
    """A path as the reference names it: keys and indices joined by ``/``."""
    return "/".join(str(k) for k in path)


__all__ = ["path_str", "tree_flatten_with_path", "tree_leaves", "tree_map"]
