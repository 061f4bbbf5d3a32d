"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Leaves are visited in sorted-key order, the order ``jax.tree.leaves``
gives a dict, so per-leaf lists (the optimizer's expert mask) line up with
the JAX package's. ``keyed_leaves`` names each leaf of a whole state (a
``NamedTuple`` of dicts) by the string ``jax.tree_util.keystr`` gives it,
the key of the JAX package's checkpoint files.
"""
from __future__ import annotations

import numpy as np
import torch


def leaves_with_path(tree, prefix: str = "") -> list:
    """[(path, leaf)] with paths like 'layers/moe/gate', in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_path(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``), keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten(tree, flat) -> dict:
    """A tree shaped like ``tree`` whose leaves are ``flat``, given in
    ``leaves`` order (sorted keys; ``tree_map`` walks insertion order)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        return next(it)
    return build(tree)


def keyed_leaves(tree, prefix: str = "") -> list:
    """[(key, leaf)] in the order and with the keys of
    ``jax.tree_util.tree_flatten_with_path`` and ``keystr``: a NamedTuple's
    fields in order as ``.field``, a dict's keys sorted as ``['key']``, a
    list's or tuple's items as ``[i]``; ``None`` holds no leaf. A
    ``TrainState`` gives ``.params['embed']['table']``, ``.opt.step``,
    ``.opt.master['embed']['table']``, ..."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields for kv in keyed_leaves(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in keyed_leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in keyed_leaves(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


@torch.no_grad()
def assign(dst, src, key: str = "leaf") -> None:
    """Write ``src`` (a tensor or an array) into the leaf ``dst`` in place:
    a tensor keeps its storage, device and dtype, a numpy array its dtype.
    The shapes must be equal (no broadcasting)."""
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{key}: shape {tuple(src.shape)} does not fit the leaf's "
                         f"{tuple(dst.shape)}")
    if isinstance(dst, torch.Tensor):
        dst.copy_(src if isinstance(src, torch.Tensor) else torch.from_numpy(np.asarray(src)))
    elif isinstance(dst, np.ndarray):
        np.copyto(dst, np.asarray(src), casting="unsafe")
    else:
        raise TypeError(f"{key}: a {type(dst).__name__} leaf cannot be written in place")
