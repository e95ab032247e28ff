"""Nested dicts of tensors, the port's stand-in for the reference's pytrees.

Leaves are visited in JAX's order for dicts (keys sorted at every level),
so a leaf's path and its place in a flattened list match
``jax.tree_util.tree_flatten_with_path`` on the reference's state.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves_with_paths(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """``[(path, leaf), ...]`` of a nested dict, keys sorted at every level."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out.extend(leaves_with_paths(tree[key], prefix + (str(key),)))
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), as a new nested dict."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in sorted(tree)}


def unflatten(tree: Any, values: List[Any]) -> Any:
    """``tree``'s structure holding ``values`` in :func:`leaves`' order."""
    it = iter(values)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out

