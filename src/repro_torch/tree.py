"""Parameter trees: nested dicts and lists (or tuples) of tensors.

The JAX package walks its trees with ``jax.tree``; this package's trees are
plain containers, walked here in the same leaf order as ``jax.tree``: dict
keys sorted, sequences in order.
"""

from __future__ import annotations

from typing import Any, Callable


def _children(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order (None is no leaf)."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def leaves_with_paths(tree: Any) -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in leaf order; a path joins the keys and list
    indices from the root with ``/`` (``dense_stack/3/attn/w_q``)."""
    out = []

    def visit(prefix, node):
        kids = _children(node)
        if kids is None:
            if node is not None:
                out.append((prefix, node))
            return
        for key, child in kids:
            visit(f"{prefix}/{key}" if prefix else str(key), child)

    visit("", tree)
    return out


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` applied to each leaf; returns a tree of ``tree``'s structure
    (None stays None)."""
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree)])


def unflatten(tree: Any, new_leaves) -> Any:
    """A tree of ``tree``'s structure whose leaves, in leaf order, are
    ``new_leaves``."""
    it = iter(new_leaves)
    missing = object()

    def build(node):
        kids = _children(node)
        if kids is None:
            if node is None:
                return None
            leaf = next(it, missing)
            if leaf is missing:
                raise ValueError("unflatten: fewer leaves than the tree has")
            return leaf
        built = [(key, build(child)) for key, child in kids]
        if isinstance(node, dict):
            by_key = dict(built)
            return {k: by_key[k] for k in node}     # the tree's own key order
        return type(node)(child for _, child in built)

    out = build(tree)
    if next(it, missing) is not missing:
        raise ValueError("unflatten: more leaves than the tree has")
    return out
