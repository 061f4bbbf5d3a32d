"""The DP x EP x TP process grid: the port's counterpart of the JAX package's
plan mesh ``('data', 'ep', 'tp')`` (``parallel/plan.py``), whose batch spans
(data, ep) (``parallel/sharding.py::ep_batch_axes``) and whose 'tp' axis
splits the weights of every rank of it.

``dp * ep * tp`` ranks, mesh-major with tp innermost: rank ``(d * ep + e) *
tp + t`` has coordinates ``{'data': d, 'ep': e, 'tp': t}``, the canonical
order of the sharded optimizer's update axes (``optim.epso.update_axis_order``).
Rank (d, e, t) takes rows ``d * ep + e`` of the batch (the tp ranks of one
(d, e) hold the same rows), holds expert slice e of the expert stacks and,
with tp > 1, its tile t of every tp-split weight (``sharding.param_placements``).
Each rank sees a group for every set of axes, each an ``EPGroup`` over
which the collectives of ``parallel.ep`` run; the ones the port uses:

* ``ep``     the ``ep`` ranks of (d, t): the MoE block's token gathers and
             all-to-alls, the expert offset ``e * E / ep``;
* ``tp``     the ``tp`` ranks of (d, e): the tensor-parallel sums
             (``tp_copy``, ``tp_reduce``);
* ``data``   the ``dp`` ranks of (e, t): the expert slices' gradients are
             summed over it;
* ('data', 'ep')  the ranks of one tp coordinate, which split the batch:
             the loss's global token count, the gradients of the leaves
             the batch axes do not split;
* ``world``  every rank.

An axis of size 1 gets a group of one rank with no process group (its
collectives are the identity). An ``EPGroup`` on its own is the dp = tp = 1
grid (``as_grid``).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional, Union

import torch.distributed as dist

from .ep import EPGroup

AXES = ("data", "ep", "tp")
BATCH_AXES = ("data", "ep")      # the axes that split the batch's rows


def _alone(g: EPGroup) -> EPGroup:
    return EPGroup(None, 0, 1, g.device, g.backend)


@dataclass(frozen=True)
class ProcessGrid:
    """One rank's view of the dp x ep x tp grid. ``multi``: the groups of
    two axes of size > 1, keyed by their frozenset (``init_grid`` makes
    them)."""
    world: EPGroup
    data: EPGroup
    ep: EPGroup
    tp: Optional[EPGroup] = None
    multi: dict = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        if self.tp is None:
            object.__setattr__(self, "tp", _alone(self.world))

    @property
    def sizes(self) -> dict:
        """{'data': dp, 'ep': ep, 'tp': tp}."""
        return {"data": self.data.world, "ep": self.ep.world, "tp": self.tp.world}

    @property
    def coords(self) -> dict:
        """{'data': d, 'ep': e, 'tp': t} of this rank."""
        return {"data": self.data.rank, "ep": self.ep.rank, "tp": self.tp.rank}

    @property
    def axis_sizes(self) -> dict:
        """The grid's axes of size > 1 in mesh order, the ``mesh.shape`` of
        the sharded optimizer's placement functions (``optim.epso``): the
        JAX plan drops its size-1 axes too."""
        return {a: n for a, n in self.sizes.items() if n > 1}

    def group(self, axes) -> EPGroup:
        """The group spanning ``axes`` (a subset of the grid's axes): its
        ranks differ only in those coordinates, and its rank order is the
        mesh-major order over them."""
        axes = frozenset(a for a in axes if self.sizes[a] > 1)
        if not axes:
            return _alone(self.world)
        if axes == frozenset(self.axis_sizes):
            return self.world
        if len(axes) == 1:
            return getattr(self, next(iter(axes)))
        return self.multi[axes]

    def peer(self, axis: str, coord: int) -> int:
        """The global rank whose coordinates are this rank's but ``coord``
        on ``axis``."""
        return rank_of(dict(self.coords, **{axis: coord}), self.sizes)


def rank_of(coords: dict, sizes: dict) -> int:
    """The global rank ``(d * ep + e) * tp + t`` at ``coords``."""
    return (coords["data"] * sizes["ep"] + coords["ep"]) * sizes.get("tp", 1) \
        + coords.get("tp", 0)


def rank_coords(rank: int, sizes: dict) -> dict:
    """The coordinates ``{'data': d, 'ep': e, 'tp': t}`` of global rank
    ``rank`` = (d * ep + e) * tp + t on a grid of ``sizes``
    (``ProcessGrid.sizes``; a missing 'tp' is 1)."""
    tp = sizes.get("tp", 1)
    de, t = divmod(rank, tp)
    return {"data": de // sizes["ep"], "ep": de % sizes["ep"], "tp": t}


def init_grid(group: EPGroup, dp: int, ep: int, tp: int = 1) -> ProcessGrid:
    """Build the dp x ep x tp grid over ``group`` (the whole world, as
    ``init_ep_group`` returns it). Every rank must call this, in the same
    order relative to its other collectives: ``new_group`` is collective
    over the world, and every rank creates every group, in one order."""
    if dp < 1 or ep < 1 or tp < 1 or dp * ep * tp != group.world:
        raise ValueError(f"a {dp} x {ep} x {tp} grid needs {dp * ep * tp} ranks, the group "
                         f"has {group.world}")
    sizes = {"data": dp, "ep": ep, "tp": tp}
    live = [a for a in AXES if sizes[a] > 1]
    subs = {}
    for n in range(1, len(live)):
        for axes in itertools.combinations(live, n):
            rest = [a for a in AXES if a not in axes]
            own = None
            for fixed in itertools.product(*(range(sizes[a]) for a in rest)):
                base = dict(zip(rest, fixed))
                ranks = [rank_of({**base, **dict(zip(axes, c))}, sizes)
                         for c in itertools.product(*(range(sizes[a]) for a in axes))]
                pg = dist.new_group(ranks)
                if group.rank in ranks:
                    own = EPGroup(pg, ranks.index(group.rank), len(ranks), group.device,
                                  group.backend)
            subs[frozenset(axes)] = own
    if len(live) == 1:
        subs[frozenset(live)] = group

    def axis(a):
        return subs.get(frozenset((a,)), _alone(group)) if sizes[a] > 1 else _alone(group)

    return ProcessGrid(group, axis("data"), axis("ep"), axis("tp"),
                       {k: v for k, v in subs.items() if len(k) > 1})


def as_grid(g: Union[EPGroup, ProcessGrid, None]) -> Optional[ProcessGrid]:
    """A grid, or an ``EPGroup`` taken as the dp = tp = 1 grid (all its
    ranks on 'ep'), or None."""
    if g is None or isinstance(g, ProcessGrid):
        return g
    return ProcessGrid(g, _alone(g), g)
