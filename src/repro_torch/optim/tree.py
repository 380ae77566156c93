"""Parameter trees as the port's optimizer walks them.

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors (None is an empty subtree), the shape of ``init_params``' and
``init_cnn``'s trees and of :class:`~repro_torch.optim.adamw.OptState`.
Leaves come out in the first tree's order; a second tree is read by the
first one's keys, so two dicts with their keys in different orders line up.
"""
from __future__ import annotations

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_leaves_like", "tree_map"]

_LEAF = object()


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``
    (trees with at least ``tree``'s structure, dict entries found by key)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError(f"trees differ: a sequence of {len(tree)} against "
                             f"{[len(r) for r in rest]}")
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_flatten(tree):
    """(leaves, treedef): ``tree_unflatten(treedef, leaves)`` is ``tree``."""
    leaves = []
    treedef = tree_map(lambda x: leaves.append(x) or _LEAF, tree)
    return leaves, treedef


def tree_unflatten(treedef, leaves):
    it = iter(leaves)
    out = tree_map(lambda _: next(it), treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree has places")
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_leaves_like(template, tree) -> list:
    """The leaves of ``tree`` in ``template``'s order (read by its keys)."""
    return tree_leaves(tree_map(lambda _, x: x, template, tree))
