"""Nested containers of tensors, walked in the reference's pytree order.

The port's counterpart of the few ``jax.tree_util`` calls the reference's
optimizer, train step and checkpoints make.  A tree is dicts, lists, tuples
and NamedTuples of leaves; ``None`` is an empty subtree.  The walk visits
dict keys in sorted order and sequences by index, as ``jax.tree_util``
flattens them, so a leaf's ``/``-joined path (``"stack/pos0/ffn/w1/
factors/0"``) and its position in the flat list are the reference's: the
Shampoo ``kron`` keys, shape-group order and checkpoint manifests of the
two packages agree.
"""
from __future__ import annotations

from typing import Any, Callable


def _children(node) -> list[tuple[str, Any]] | None:
    """``(key, child)`` pairs of a container in flatten order; None for a
    leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _walk(node, prefix: list, out: list) -> None:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append(("/".join(prefix), node))
        return
    for k, c in kids:
        _walk(c, prefix + [k], out)


def leaves_with_path(tree) -> list[tuple[str, Any]]:
    """``[(path, leaf), ...]`` in the reference's flatten order.  (The walk
    is a module function: a recursive closure would be a reference cycle
    that keeps the list, and every leaf in it, alive until the next garbage
    collection.)"""
    out: list[tuple[str, Any]] = []
    _walk(tree, [], out)
    return out


def leaves(tree) -> list:
    """The leaves in the reference's flatten order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def map(fn: Callable, tree, *rest):  # noqa: A001 - jax.tree.map's name
    """``fn`` on each leaf (with the matching leaves of ``rest``, trees of
    the same structure), in a tree of the same structure."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    vals = [map(fn, c, *(r[i] for r in rest)) for i, (_, c) in enumerate(kids)]
    if hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


def unflatten_like(tree, new_leaves) -> Any:
    """A tree of ``tree``'s structure holding ``new_leaves`` (in flatten
    order)."""
    it = iter(new_leaves)
    out = map(lambda _: next(it), tree)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out


__all__ = ["leaves_with_path", "leaves", "map", "unflatten_like"]
