"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Leaves are visited in sorted key order, which is the order
``jax.tree.leaves`` gives a dict, so sums over leaves add in the
reference's order.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple


def tree_map(fn: Callable, tree: Dict[str, Any], *rest: Dict[str, Any]):
    """``fn`` over corresponding leaves of trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves_with_path(tree, path: Tuple[str, ...] = ()
                          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (k,))
    else:
        yield path, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map_with_path(fn: Callable, tree, *rest,
                       path: Tuple[str, ...] = ()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts and
    NamedTuples (a decode cache) of the same structure; the path holds
    dict keys and NamedTuple field names, as JAX's key paths name them. A
    ``None`` subtree stays ``None``, as an empty subtree does in JAX."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(
            tree_map_with_path(fn, getattr(tree, f),
                               *(getattr(r, f) for r in rest),
                               path=path + (f,))
            for f in tree._fields))
    return fn(path, tree, *rest)
