"""The DP x EP process grid: the port's counterpart of the JAX package's plan
mesh ``('data', 'ep')`` (``parallel/plan.py``), whose batch spans (data, ep)
(``parallel/sharding.py::ep_batch_axes``).

``dp * ep`` ranks, mesh-major: rank ``d * ep + e`` has coordinates
``{'data': d, 'ep': e}``, the canonical order of the sharded optimizer's
update axes (``optim.epso.update_axis_order``). Rank (d, e) takes rows
``rank`` of the batch and holds expert slice ``e`` of the expert stacks.
Each rank sees three groups, each an ``EPGroup`` over which the
collectives of ``parallel.ep`` run:

* ``ep``     the ``ep`` ranks of data replica d: the MoE block's token
             gathers, the expert offset ``e * E / ep``;
* ``data``   the ``dp`` ranks holding expert slice e: the expert slices'
             gradients are summed over it;
* ``world``  every rank: the loss's global token count and router terms,
             the replicated leaves' gradients.

An axis of size 1 gets a group of one rank with no process group (its
collectives are the identity). An ``EPGroup`` on its own is the dp = 1
grid (``as_grid``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch.distributed as dist

from .ep import EPGroup

AXES = ("data", "ep")


def _alone(g: EPGroup) -> EPGroup:
    return EPGroup(None, 0, 1, g.device, g.backend)


@dataclass(frozen=True)
class ProcessGrid:
    """One rank's view of the dp x ep grid."""
    world: EPGroup
    data: EPGroup
    ep: EPGroup

    @property
    def sizes(self) -> dict:
        """{'data': dp, 'ep': ep}."""
        return {"data": self.data.world, "ep": self.ep.world}

    @property
    def coords(self) -> dict:
        """{'data': d, 'ep': e} of this rank."""
        return {"data": self.data.rank, "ep": self.ep.rank}

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
        axes = {a for a in axes if self.sizes[a] > 1}
        if not axes:
            return _alone(self.world)
        if axes == {"data", "ep"}:
            return self.world
        return self.data if axes == {"data"} else self.ep

    def peer(self, axis: str, coord: int) -> int:
        """The global rank whose coordinates are this rank's but ``coord``
        on ``axis``."""
        c = dict(self.coords, **{axis: coord})
        return c["data"] * self.sizes["ep"] + c["ep"]


def rank_coords(rank: int, sizes: dict) -> dict:
    """The coordinates ``{'data': d, 'ep': e}`` of global rank ``rank`` = d
    * ep + e on a grid of ``sizes`` (``ProcessGrid.sizes``)."""
    return {"data": rank // sizes["ep"], "ep": rank % sizes["ep"]}


def init_grid(group: EPGroup, dp: int, ep: int) -> ProcessGrid:
    """Build the dp x ep grid over ``group`` (the whole world, as
    ``init_ep_group`` returns it). Every rank must call this, in the same
    order relative to its other collectives: ``new_group`` is collective
    over the world."""
    if dp < 1 or ep < 1 or dp * ep != group.world:
        raise ValueError(f"a {dp} x {ep} grid needs {dp * ep} ranks, the group has "
                         f"{group.world}")
    d, e = divmod(group.rank, ep)

    def sub(member_lists, index, rank):
        if dp == 1 or ep == 1:
            # the one group of size > 1 is the world itself; no new group
            return group if len(member_lists[index]) > 1 else _alone(group)
        pgs = [dist.new_group(ranks) for ranks in member_lists]
        return EPGroup(pgs[index], rank, len(member_lists[index]), group.device, group.backend)

    ep_sub = sub([[dd * ep + ee for ee in range(ep)] for dd in range(dp)], d, e)
    data_sub = sub([[dd * ep + ee for dd in range(dp)] for ee in range(ep)], e, d)
    return ProcessGrid(group, data_sub, ep_sub)


def as_grid(g: Union[EPGroup, ProcessGrid, None]) -> Optional[ProcessGrid]:
    """A grid, or an ``EPGroup`` taken as the dp = 1 grid (all its ranks on
    'ep'), or None."""
    if g is None or isinstance(g, ProcessGrid):
        return g
    return ProcessGrid(g, _alone(g), g)
