"""Nested dicts of tensors as the JAX package's pytrees.

``jax.tree.flatten`` walks a dict in sorted key order, depth first; the live
runtime's segments, the optimizers' leaf order, the gradient norm's sum and
the checkpoint's leaf files all follow it, so the port walks its trees the
same way. A leaf is anything that is not a dict; a path is the keys joined
by ``/``, as the reference's checkpoint names its leaves.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flatten order: keys sorted at every level."""
    out = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            out.extend(flatten(tree[key], path))
        else:
            out.append((path, tree[key]))
    return out


def unflatten(pairs) -> dict:
    tree: dict = {}
    for path, leaf in pairs:
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten_like(tree, new_leaves) -> dict:
    """A tree of ``tree``'s paths holding ``new_leaves`` in flatten order."""
    return unflatten(zip((path for path, _ in flatten(tree)), new_leaves))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``;
    empty dicts are kept."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in sorted(tree)}
    return fn(tree, *rest)
