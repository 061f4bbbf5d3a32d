"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Leaves are visited in sorted-key order, the order ``jax.tree.leaves``
gives a dict, so per-leaf lists (the optimizer's expert mask) line up with
the JAX package's.
"""
from __future__ import annotations


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
