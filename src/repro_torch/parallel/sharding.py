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

The embedding and head tables (``embed/table``, ``head/table``, (V_pad,
d)) are split on their vocab rows over the model axis, the JAX rule's
``mdl = tp or ep``: over 'tp' where the grid has a 'tp' axis, else over
'ep'; a table stays whole where that axis does not divide the padded
vocab (a 'tp' axis that does not divide it leaves it whole, as in JAX,
with no fall back to 'ep'). Rank k of the axis holds rows ``[k * V_pad /
n, (k + 1) * V_pad / n)``; the lookup and the cross-entropy over such a
tile are ``parallel.vocab``'s. The JAX package splits the SSM mixers' in
and out projections over 'tp' too; the port refuses tp for the ssm and
hybrid archs (``parallel.plan``) and keeps them whole here.

On a ``ProcessGrid`` the same layout is data, ``param_placements``: per
leaf, per dim, the tuple of grid axes that split it (the port's form of a
JAX ``PartitionSpec``, every dim listed, ``()`` for a whole dim). The
sharded optimizer (``optim.epso``) takes placements as input, so its
parity tests can feed it the JAX package's own ``param_specs``.
``tile_slices`` says which tile of a global leaf a rank holds under any
placement: a rank's params (``rank_shard``), an EP rank's share
(``ep_shard``), the optimizer shards (``convert``) and the grid
checkpoints (``checkpoint``) all cut by it.
"""
from __future__ import annotations

from repro_torch.tree import leaves, tree_map

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


def ep_shard(params: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s share of a parameter tree (or of any tree shaped like
    it: AdamW master, moments, gradients; or of one MoE block's params) over
    ``world`` EP ranks, the grid ('ep', ``world``) alone: each leaf's tile of
    ``param_placements`` on it (a view, no copy): the expert stacks' slices
    and the tables' vocab rows, which the JAX 'ep' role splits too; the
    other leaves as they are."""
    sizes = {"ep": world}
    return rank_shard(params, param_placements(params, sizes), {"ep": rank}, sizes)


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


def is_table_path(path: str) -> bool:
    """True for the embedding and head tables, ``embed/table`` and
    ``head/table``."""
    return ("/" + path).endswith(("/embed/table", "/head/table"))


def vocab_axis(axis_sizes: dict, vocab_rows: int):
    """The grid axis that splits the tables' ``vocab_rows`` (the padded
    vocab), or None: the JAX ``mdl = tp or ep``, 'tp' where the grid has
    a 'tp' axis of size > 1, else 'ep' where it has one, and only where
    that axis divides the rows."""
    for a in ("tp", "ep"):
        n = axis_sizes.get(a, 1)
        if n > 1:
            return a if vocab_rows % n == 0 else None
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
    if is_table_path(path):
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
    dense MoE path that holds every expert), with a 'tp' axis each
    leaf's tp dim (``_tp_dim``) on ('tp',) where tp divides it, the
    tables' vocab rows on ``vocab_axis`` (never on 'data'); with
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
        if is_table_path(prefix) and len(node.shape) == 2:
            ax = vocab_axis(axis_sizes, node.shape[0])
            if ax is not None:
                place[0] = (ax,)
            return tuple(place)
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


def replicated_leaves(place: dict) -> tuple[bool, ...]:
    """Per leaf of a placement tree (``param_placements``), in leaf order:
    True where no grid axis splits the leaf, so every rank holds it whole
    (its gradient is summed over the ranks), False for a tile: the expert
    slices, the vocab rows of a split table."""
    return tuple(not any(pl) for pl in leaves(place))
