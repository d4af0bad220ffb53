"""Helpers over parameter trees: nested dicts and lists of tensors."""
from __future__ import annotations

from typing import Any, Callable

import torch


def tree_leaves(tree: Any) -> list:
    """Leaves in a fixed order (dict keys sorted, as jax.tree_util does)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like: Any, leaves) -> Any:
    """The tree of ``like``'s structure holding ``leaves`` in
    ``tree_leaves`` order (dict keys sorted)."""
    return _build(like, iter(leaves))


def _build(t: Any, it) -> Any:
    # a module-level recursion: a closure that calls itself is a reference
    # cycle, which would keep ``leaves`` alive until a garbage collection
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(x, it) for x in t)
    return next(it)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """Flatten with '/'-joined string paths (dict keys / list indices)."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), t) for i, t in enumerate(tree))
    else:
        return [(prefix, tree)]
    return [pl for k, t in items
            for pl in tree_paths(t, f"{prefix}/{k}" if prefix else k)]


def tree_zeros_like(tree: Any, dtype=None) -> Any:
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype), tree)


def global_norm(tree: Any) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def trainable(tree: Any) -> Any:
    """The same tensors as leaves that require grad."""
    return tree_map(lambda x: x.detach().requires_grad_(True), tree)


def tree_map_with_path_str(fn: Callable[[str, Any], Any], tree: Any,
                           prefix: str = "") -> Any:
    """Map a function of (path_string, leaf) over a tree; paths as
    ``tree_paths`` writes them."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path_str(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path_str(fn, t, f"{prefix}/{i}" if prefix else str(i))
                          for i, t in enumerate(tree))
    return fn(prefix, tree)
