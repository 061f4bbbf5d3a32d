"""The DP x PP x EP x TP process grid: the port's counterpart of the JAX
package's plan mesh ``('data', 'pp', 'ep', 'tp')`` (``parallel/plan.py``),
whose batch spans (data, ep) (``parallel/sharding.py::ep_batch_axes``),
whose 'pp' axis holds the pipeline stages (``parallel.pipeline``) and whose
'tp' axis splits the weights of every rank of it.

``dp * pp * ep * tp`` ranks, mesh-major with tp innermost: rank ``((d * pp
+ p) * ep + e) * tp + t`` has coordinates ``{'data': d, 'pp': p, 'ep': e,
'tp': t}``; with pp = 1 that is ``(d * ep + e) * tp + t``, the canonical
order of the sharded optimizer's update axes (``optim.epso.update_axis_order``).
Rank (d, p, e, t) takes rows ``d * ep + e`` of the batch (the pp and tp
ranks of one (d, e) hold the same rows), runs pipeline stage p on its
layer slice, holds expert slice e of the expert stacks and, with tp > 1,
its tile t of every tp-split weight (``sharding.param_placements``). Each
rank sees a group for every set of axes, each an ``EPGroup`` over which
the collectives of ``parallel.ep`` run; the ones the port uses:

* ``ep``     the ``ep`` ranks of (d, p, t): the MoE block's token gathers
             and all-to-alls, the expert offset ``e * E / ep``;
* ``tp``     the ``tp`` ranks of (d, p, e): the tensor-parallel sums
             (``tp_copy``, ``tp_reduce``);
* ``pp``     the ``pp`` stages of (d, e, t): the activations and their
             gradients handed between stages, the sums of the gradients of
             the leaves every stage holds whole;
* ``data``   the ``dp`` ranks of (p, e, t): the expert slices' gradients
             are summed over it, and the fsdp gathers and
             reduce-scatters run over it (``parallel.fsdp``);
* ('data', 'ep')  the ranks of one (pp, tp) coordinate, which split the
             batch: the loss's global token count, the gradients of the
             leaves the batch axes do not split;
* ``world``  every rank.

An axis of size 1 gets a group of one rank with no process group (its
collectives are the identity). An ``EPGroup`` on its own is the dp = pp =
tp = 1 grid (``as_grid``).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional, Union

import torch.distributed as dist

from .ep import EPGroup

AXES = ("data", "pp", "ep", "tp")
BATCH_AXES = ("data", "ep")      # the axes that split the batch's rows
# the axes a gradient is summed over where they do not split its leaf: the
# batch axes, and 'pp', whose stages each give their share of the gradient
# of a leaf every stage holds whole (the embedding, the final norm, the head)
SUM_AXES = ("data", "pp", "ep")


def _alone(g: EPGroup) -> EPGroup:
    return EPGroup(None, 0, 1, g.device, g.backend)


@dataclass(frozen=True)
class ProcessGrid:
    """One rank's view of the dp x pp x ep x tp grid. ``multi``: the groups
    of two or more axes of size > 1, keyed by their frozenset (``init_grid``
    makes them)."""
    world: EPGroup
    data: EPGroup
    ep: EPGroup
    tp: Optional[EPGroup] = None
    multi: dict = field(default_factory=dict, compare=False, repr=False)
    pp: Optional[EPGroup] = None

    def __post_init__(self):
        for a in ("tp", "pp"):
            if getattr(self, a) is None:
                object.__setattr__(self, a, _alone(self.world))

    @property
    def sizes(self) -> dict:
        """{'data': dp, 'pp': pp, 'ep': ep, 'tp': tp}."""
        return {"data": self.data.world, "pp": self.pp.world, "ep": self.ep.world,
                "tp": self.tp.world}

    @property
    def coords(self) -> dict:
        """{'data': d, 'pp': p, 'ep': e, 'tp': t} of this rank."""
        return {"data": self.data.rank, "pp": self.pp.rank, "ep": self.ep.rank,
                "tp": self.tp.rank}

    @property
    def spec(self) -> tuple:
        """The ``grid=`` of ``parallel.spawn`` that builds this grid
        (``grid_spec``)."""
        s = self.sizes
        return grid_spec(s["data"], s["ep"], s["tp"], s["pp"])

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


def grid_spec(dp: int, ep: int, tp: int = 1, pp: int = 1) -> tuple:
    """The ``grid=`` tuple of ``parallel.spawn`` (the arguments of
    ``init_grid`` after the group): (dp, ep), (dp, ep, tp) with tp > 1, and
    (dp, ep, tp, pp) with pp > 1."""
    if pp > 1:
        return (dp, ep, tp, pp)
    return (dp, ep) + ((tp,) if tp > 1 else ())


def rank_of(coords: dict, sizes: dict) -> int:
    """The global rank ``((d * pp + p) * ep + e) * tp + t`` at ``coords``
    (a missing 'pp' or 'tp' is coordinate 0 of size 1)."""
    dp_ = coords["data"] * sizes.get("pp", 1) + coords.get("pp", 0)
    return (dp_ * sizes["ep"] + coords["ep"]) * sizes.get("tp", 1) + coords.get("tp", 0)


def rank_coords(rank: int, sizes: dict) -> dict:
    """The coordinates ``{'data': d, 'pp': p, 'ep': e, 'tp': t}`` of global
    rank ``rank`` = ((d * pp + p) * ep + e) * tp + t on a grid of ``sizes``
    (``ProcessGrid.sizes``; a missing 'pp' or 'tp' is 1)."""
    tp, pp = sizes.get("tp", 1), sizes.get("pp", 1)
    dpe, t = divmod(rank, tp)
    dp_, e = divmod(dpe, sizes["ep"])
    return {"data": dp_ // pp, "pp": dp_ % pp, "ep": e, "tp": t}


def init_grid(group: EPGroup, dp: int, ep: int, tp: int = 1, pp: int = 1) -> ProcessGrid:
    """Build the dp x pp x ep x tp grid over ``group`` (the whole world, as
    ``init_ep_group`` returns it). Every rank must call this, in the same
    order relative to its other collectives: ``new_group`` is collective
    over the world, and every rank creates every group, in one order."""
    if min(dp, ep, tp, pp) < 1 or dp * pp * ep * tp != group.world:
        raise ValueError(f"a {dp} x {pp} x {ep} x {tp} (dp x pp x ep x tp) grid needs "
                         f"{dp * pp * ep * tp} ranks, the group has {group.world}")
    sizes = {"data": dp, "pp": pp, "ep": ep, "tp": tp}
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
                       {k: v for k, v in subs.items() if len(k) > 1}, pp=axis("pp"))


def as_grid(g: Union[EPGroup, ProcessGrid, None]) -> Optional[ProcessGrid]:
    """A grid, or an ``EPGroup`` taken as the dp = pp = tp = 1 grid (all
    its ranks on 'ep'), or None."""
    if g is None or isinstance(g, ProcessGrid):
        return g
    return ProcessGrid(g, _alone(g), g)
