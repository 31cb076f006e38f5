"""Trees of tensors -- nested dicts, lists, tuples and NamedTuples -- in the
order JAX flattens them (dict keys sorted), so a tree's leaves, and a
checkpoint's keys, line up with the JAX package's pytrees.  ``None`` is an
empty subtree."""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["children", "flatten_with_paths", "unflatten", "tree_leaves", "tree_map"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def children(node) -> list[tuple[str, Any]] | None:
    """``(key, child)`` pairs of a container node, None for a leaf."""
    if _is_namedtuple(node):
        return [(name, getattr(node, name)) for name in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    return None


def flatten_with_paths(tree: Any, prefix: str = "", is_leaf=None) -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs, the path's keys joined by ``/``; a node for
    which ``is_leaf`` says True is a leaf."""
    if tree is None:
        return []
    kids = None if is_leaf is not None and is_leaf(tree) else children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += flatten_with_paths(child, f"{prefix}/{key}" if prefix else key, is_leaf)
    return out


def unflatten(template: Any, leaves: dict[str, Any], prefix: str = "", is_leaf=None) -> Any:
    """``template``'s structure with each leaf replaced by ``leaves[path]``."""
    if template is None:
        return None
    kids = None if is_leaf is not None and is_leaf(template) else children(template)
    if kids is None:
        return leaves[prefix]

    def sub(key, child):
        return unflatten(child, leaves, f"{prefix}/{key}" if prefix else key, is_leaf)

    if _is_namedtuple(template):
        return type(template)(*(sub(k, c) for k, c in kids))
    if isinstance(template, (tuple, list)):
        return type(template)(sub(k, c) for k, c in kids)
    return {k: sub(str(k), template[k]) for k in template}


def tree_leaves(tree: Any) -> list:
    return [leaf for _path, leaf in flatten_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf=None) -> Any:
    """``fn`` of each leaf of ``tree`` and the leaves at the same paths of
    ``rest`` (trees of ``tree``'s structure)."""
    paths = flatten_with_paths(tree, is_leaf=is_leaf)
    others = [dict(flatten_with_paths(r, is_leaf=is_leaf)) for r in rest]
    return unflatten(tree, {p: fn(leaf, *(o[p] for o in others)) for p, leaf in paths},
                     is_leaf=is_leaf)
