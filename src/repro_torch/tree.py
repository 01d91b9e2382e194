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
