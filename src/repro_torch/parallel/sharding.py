"""The parameter layout of the ``pp``, ``ep`` and ``tp`` roles (the JAX
package's ``parallel/sharding.py::param_specs`` on a plan mesh): with a
'pp' axis the leading layer dim of every ``layers/`` leaf is split across
the pipeline stages, stage p holding layers ``[p * L / pp, (p + 1) * L /
pp)`` (``parallel.pipeline``); the routed expert
stacks ``layers/moe/{gate,up,down}``, (L, E, d, f) / (L, E, f, d), are split
on E across the 'ep' ranks, rank r holding experts ``[r * E / ep, (r + 1) *
E / ep)``, and on their d_ff dim across the 'tp' ranks (expert-TP). Under
'tp' also the attention and the dense and shared-expert MLPs are split as
Megatron splits them: wq, wk, wv and gate, up on their output columns (the
heads, d_ff), wo and down on their input rows. Every other leaf is
replicated. A dim that its axis does not divide stays whole, as the JAX
rule leaves it unsplit; each rule is taken on the per-layer shape, the
leading layer dims (``stacked_dims``: ``layers/``, ``rem/`` one;
``groups/`` two) split only by 'pp', and only that of ``layers/``.

With ``fsdp`` (ZeRO-3, the JAX rule ``fsdp_wrap``) the 'data' axis
splits the params too, after the entries above: on the largest per-layer
dim that is still whole and that dp divides (the sort is stable, so on a tie
the lower dim), for the expert stacks, the router, attention, the dense and
shared MLPs and the SSM mixers' projections; never the embedding and head
tables, the norms or the other small leaves, and never a stacked layer dim.

The JAX package also splits ``embed/table`` and ``head/table`` on the vocab
over the model axis; that is a memory layout of its compiler, not part of
the math, and the port keeps them replicated. It splits the SSM mixers'
in and out projections over 'tp' too; the port refuses tp for the ssm and
hybrid archs (``parallel.plan``) and keeps them whole here.

On a ``ProcessGrid`` the same layout is data, ``param_placements``: per
leaf, per dim, the tuple of grid axes that split it (the port's form of a
JAX ``PartitionSpec``, every dim listed, ``()`` for a whole dim). The
sharded optimizer (``optim.epso``) takes placements as input, so its
parity tests can feed it the JAX package's own ``param_specs``.
``tile_slices`` says which tile of a global leaf a rank holds under any
placement: a rank's params (``rank_shard``), the expert slices
(``expert_shard``), the optimizer shards (``convert``) and the grid
checkpoints (``checkpoint``) all cut by it.
"""
from __future__ import annotations

from repro_torch.tree import leaves_with_path, tree_map

STACKS = ("gate", "up", "down")


def is_expert_stack_path(path: str) -> bool:
    """True for the routed expert stacks: ``.../moe/{gate,up,down}``, never
    the router or the shared experts."""
    parts = path.split("/")
    return len(parts) >= 2 and parts[-2] == "moe" and parts[-1] in STACKS


def _expert_axis(path: str, leaf, world: int):
    """The axis of E to split, or None: axis 1 of a model's (L, E, d, f)
    stack, axis 0 of one block's (E, d, f)."""
    ndim = len(leaf.shape)
    if not is_expert_stack_path(path) or ndim not in (3, 4):
        return None
    ax = ndim - 3
    return ax if leaf.shape[ax] % world == 0 else None


def shard_index(axes: tuple, coords: dict, axis_sizes: dict) -> int:
    """The linear index of the rank at ``coords`` over ``axes``, mesh-major
    (major-to-minor): its tile of a dim split over ``axes``, its row of a
    bucket gathered over them."""
    k = 0
    for a in axes:
        k = k * axis_sizes[a] + coords[a]
    return k


def tile_slices(place, shape, coords: dict, axis_sizes: dict) -> tuple:
    """The slices of a global leaf of ``shape`` that the rank at ``coords``
    holds under ``place`` (per dim, the tuple of grid axes splitting it):
    each dim cut by its axes, major-to-minor (GSPMD's tiling of a tuple
    spec). The one statement of which tile a rank holds: the expert
    slices, the SO/EPSO state shards (``convert``) and the checkpoints'
    gather and scatter (``checkpoint``) all cut by it."""
    out = []
    for d, n in enumerate(shape):
        axes = place[d] if d < len(place) else ()
        parts = 1
        for a in axes:
            parts *= axis_sizes[a]
        blk = n // parts
        k = shard_index(axes, coords, axis_sizes)
        out.append(slice(k * blk, (k + 1) * blk))
    return tuple(out)


def expert_shard(params: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s share of a parameter tree (or of any tree shaped like
    it: AdamW master, moments, gradients; or of one MoE block's params)
    over ``world`` EP ranks: each expert stack's tile of ``param_placements``
    (a view, no copy), the other leaves as they are."""
    sizes = {"ep": world}
    return tree_map(lambda t, place: t[tile_slices(place, t.shape, {"ep": rank}, sizes)]
                    if any(place) else t, params, param_placements(params, sizes))


def stacked_dims(path: str) -> int:
    """The leading layer dims of a leaf at ``path``, or of each leaf of the
    subtree at ``path + '/'``: ``layers/`` and ``rem/`` one, the hybrid's
    ``groups/`` two, every other (the shared block's, the tables') none."""
    if path.startswith("groups/"):
        return 2
    return 1 if path.startswith(("layers/", "rem/")) else 0


def _tp_dim(path: str, inner: tuple):
    """The per-layer dim of a leaf that 'tp' splits, or None: the Megatron
    split of attention and of the dense and shared MLPs, the d_ff dim of an
    expert stack."""
    name = path.rsplit("/", 1)[-1]
    if is_expert_stack_path(path) and len(inner) == 3:
        return 1 if name == "down" else 2
    if len(inner) != 2:
        return None
    if name in ("wq", "wk", "wv", "up", "gate"):
        return 1
    if name in ("wo", "down"):
        return 0
    return None


def _fsdp_wrapped(path: str, inner: tuple) -> bool:
    """Whether ``fsdp`` may split a leaf over 'data': the leaves the JAX
    ``_param_spec`` passes through ``fsdp_wrap``, matched on the path as
    it matches them, with ``inner`` the per-layer shape."""
    p = "/" + path
    if any(k in p for k in ("/moe/gate", "/moe/up", "/moe/down")) and "shared" not in p \
            and len(inner) == 3:
        return True
    if "/moe/router" in p:
        return True
    if p.endswith(("embed/table", "head/table")):
        return False
    if p.endswith(("/wq", "/wk", "/wv", "/wo")):
        return True
    if p.endswith(("/up", "/gate", "/down")) and len(inner) == 2:
        return True
    return p.endswith(("/in_proj", "/out_proj", "/conv_w", "/x_proj", "/dt_proj"))


def param_placements(params: dict, axis_sizes: dict, *, split_experts: bool = True,
                     fsdp: bool = False) -> dict:
    """The placement of each leaf of a *global* parameter tree (any leaves
    with ``.shape``) on a grid with ``axis_sizes`` (its axes of size > 1):
    with a 'pp' axis the leading layer dim of each ``layers/`` leaf on
    ('pp',) where pp divides it, an expert stack's E dim on ('ep',) where
    'ep' is an axis and divides it (not with ``split_experts=False``, the
    dense MoE path that holds every expert), and with a 'tp' axis each
    leaf's tp dim (``_tp_dim``) on ('tp',) where tp divides it; with
    ``fsdp`` and a 'data' axis, then, the largest whole per-layer dim that
    dp divides of each leaf ``fsdp_wrap`` takes, on ('data',); every other
    dim and leaf whole."""
    n_ep = axis_sizes.get("ep", 1) if split_experts else 1
    n_tp = axis_sizes.get("tp", 1)
    n_pp = axis_sizes.get("pp", 1)
    n_dp = axis_sizes.get("data", 1) if fsdp else 1

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k) for k, v in node.items()}
        place = [()] * len(node.shape)
        if n_pp > 1 and prefix.startswith("layers/") and node.shape[0] % n_pp == 0:
            place[0] = ("pp",)
        ax = _expert_axis(prefix, node, n_ep) if n_ep > 1 else None
        if ax is not None:
            place[ax] = ("ep",)
        if n_tp > 1:
            lead = stacked_dims(prefix)
            dim = _tp_dim(prefix, tuple(node.shape[lead:]))
            if dim is not None and node.shape[lead + dim] % n_tp == 0:
                place[lead + dim] = ("tp",)
        lead = stacked_dims(prefix)
        inner = tuple(node.shape[lead:])
        if n_dp > 1 and _fsdp_wrapped(prefix, inner):
            for i in sorted(range(len(inner)), key=lambda i: -inner[i]):
                if not place[lead + i] and inner[i] % n_dp == 0:
                    place[lead + i] = ("data",)
                    break
        return tuple(place)
    return walk(params, "")


def rank_shard(params: dict, place: dict, coords: dict, axis_sizes: dict) -> dict:
    """The tiles of a global tree (params, or any tree shaped like them)
    that the rank at ``coords`` holds under ``place``
    (``param_placements``): views, no copy; a whole leaf as it is."""
    return tree_map(lambda t, pl: t[tile_slices(pl, t.shape, coords, axis_sizes)]
                    if any(pl) else t, params, place)


def replicated_leaves(tree: dict) -> tuple[bool, ...]:
    """Per leaf of a tree whose expert stacks ``expert_shard`` split, in
    leaf order: True where every rank holds the whole leaf (its gradient is
    summed over the ranks), False for the rank's expert slices."""
    return tuple(not is_expert_stack_path(path) for path, _ in leaves_with_path(tree))


