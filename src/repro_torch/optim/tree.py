"""Nested dict/list containers of tensors: leaves and maps.

The port's parameters, gradients and optimiser moments are plain nested
dicts and lists.  Leaves come in the order of the reference's pytrees
(dict keys sorted, lists in order), the order the checkpoint store keys
them in; a :class:`~repro_torch.optim.quant.QTensor` is one leaf.
"""
from __future__ import annotations


def _is_node(x) -> bool:
    return isinstance(x, dict) or (isinstance(x, (list, tuple))
                                   and not hasattr(x, "_fields"))


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if _is_node(tree):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure), into a tree of ``tree``'s shape;
    ``fn`` sees the leaves in :func:`tree_leaves`'s order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_node(tree):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
