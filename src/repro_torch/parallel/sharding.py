"""The parameter layout of the ``ep`` role (the JAX package's
``parallel/sharding.py::_param_spec`` under EP): the routed expert stacks
``layers/moe/{gate,up,down}``, (L, E, d, f) / (L, E, f, d), are split on E
across the ranks, rank r holding experts ``[r * E / world, (r + 1) * E /
world)``; every other leaf is replicated. A stack whose E does not divide
by ``world`` stays whole, as the JAX rule leaves it unsplit.

The JAX package also splits ``embed/table`` and ``head/table`` on the vocab
over the model axis; that is a memory layout of its compiler, not part of
the math, and the port keeps them replicated.
"""
from __future__ import annotations

from repro_torch.tree import leaves_with_path

STACKS = ("gate", "up", "down")


def is_expert_stack_path(path: str) -> bool:
    """True for the routed expert stacks: ``.../moe/{gate,up,down}``, never
    the router or the shared experts."""
    parts = path.split("/")
    return len(parts) >= 2 and parts[-2] == "moe" and parts[-1] in STACKS


def _expert_axis(path: str, leaf, world: int):
    """The axis of E to split, or None: axis 1 of a model's (L, E, d, f)
    stack, axis 0 of one block's (E, d, f)."""
    if not is_expert_stack_path(path) or leaf.ndim not in (3, 4):
        return None
    ax = leaf.ndim - 3
    return ax if leaf.shape[ax] % world == 0 else None


def expert_shard(params: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s share of a parameter tree (or of any tree shaped like
    it: AdamW master, moments, gradients; or of one MoE block's params):
    each expert stack's slice of E (a view, no copy), the other leaves as
    they are."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k) for k, v in node.items()}
        ax = _expert_axis(prefix, node, world)
        if ax is None:
            return node
        el = node.shape[ax] // world
        return node.narrow(ax, rank * el, el)
    return walk(params, "")


def replicated_leaves(tree: dict) -> tuple[bool, ...]:
    """Per leaf of a tree whose expert stacks ``expert_shard`` split, in
    leaf order: True where every rank holds the whole leaf (its gradient is
    summed over the ranks), False for the rank's expert slices."""
    return tuple(not is_expert_stack_path(path) for path, _ in leaves_with_path(tree))


