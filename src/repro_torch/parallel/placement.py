"""Expert placement and live EP rebalancing: port of the JAX package's
``parallel/placement.py``.

The 'ep' axis splits the expert dim of every ``(L, E, ...)`` expert stack
in *position* order: EP rank ``r`` holds positions ``[r * EL, (r + 1) *
EL)``. Without a placement, position == global expert id, so a hot expert
pins its rank at the top of every dispatch. ``ExpertPlacement`` decouples
the two: ``perm[l][pos]`` is the global expert id stored at position
``pos`` of layer ``l``. The model needs only the inverse (global id ->
position, ``inverse_array``): the router keeps producing global ids, and
the MoE block translates them to positions before the dispatch plan
(``core.moe``), so router weights, routing, the aux loss and the
telemetry stay in global-id space.

A placement change is data movement only (``apply_placement``): the same
experts in new homes, their SO/EPSO optimizer states with them. For
``experts_per_token <= 2`` the EP combine's sum over ranks is a reordering
of at most two addends plus exact zeros, so a train step is bit-identical
across a move under dropless dispatch; with top 3 and more it may
reassociate. Under capacity dispatch the groups share one pool in position
order and pairs past its end drop, so a placement changes which pairs drop
once the pool overflows. The grad norm takes the expert stacks per (layer,
expert) slice in global-id order (``optim.adamw.expert_slice_sumsq``, both
update paths), so the clip scale cannot reassociate across a move.

``RebalanceController`` (the launcher's loop): sum the per-step
``moe_counts`` (global ids) over a window of N steps; at a window's end,
if the rank imbalance (max/mean rank load under the live placement)
exceeds the threshold, propose a greedy LPT placement and adopt it only if
it strictly lowers the imbalance. Counts are summed over layers, so the
controller proposes one row for every layer; the placement itself is per
layer, and the model takes a row per layer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tree import keyed_leaves, leaves_with_path

from .ep import all_gather_dim
from .sharding import tile_slices


def _as_rows(perm) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(int(v) for v in row) for row in perm)


@dataclasses.dataclass(frozen=True)
class ExpertPlacement:
    """Per-layer expert -> position permutation. ``perm[l][pos]`` = global
    expert id stored at position ``pos`` (EP rank ``pos // (E / ep)``) of
    layer ``l``."""
    num_layers: int
    num_experts: int
    perm: Tuple[Tuple[int, ...], ...]

    def __post_init__(self):
        rows = _as_rows(self.perm)
        object.__setattr__(self, "perm", rows)
        if len(rows) != self.num_layers:
            raise ValueError(f"placement has {len(rows)} rows for "
                             f"num_layers={self.num_layers}")
        want = tuple(range(self.num_experts))
        for l, row in enumerate(rows):
            if tuple(sorted(row)) != want:
                raise ValueError(
                    f"placement row {l} is not a permutation of "
                    f"0..{self.num_experts - 1}: {row}")

    @classmethod
    def identity(cls, num_layers: int, num_experts: int) -> "ExpertPlacement":
        row = tuple(range(num_experts))
        return cls(num_layers, num_experts, (row,) * num_layers)

    @classmethod
    def broadcast(cls, row: Sequence[int], num_layers: int) -> "ExpertPlacement":
        """One permutation for every layer (the controller's case: its
        counts are summed over layers)."""
        r = tuple(int(v) for v in row)
        return cls(num_layers, len(r), (r,) * num_layers)

    @property
    def is_identity(self) -> bool:
        ident = tuple(range(self.num_experts))
        return all(row == ident for row in self.perm)

    def perm_array(self) -> np.ndarray:
        """(L, E) int32: position -> global expert id."""
        return np.array(self.perm, dtype=np.int32)

    def inverse_array(self) -> np.ndarray:
        """(L, E) int32: global expert id -> position, the map the model
        takes."""
        return np.argsort(self.perm_array(), axis=1).astype(np.int32)

    def relative_to(self, new: "ExpertPlacement") -> np.ndarray:
        """(L, E) int32 gather map moving arrays live under this placement
        to ``new``: ``W_new[l, pos] = W_live[l, rel[l, pos]]``, with
        ``rel[pos] = inv[new.perm[pos]]``."""
        if (new.num_layers, new.num_experts) != (self.num_layers, self.num_experts):
            raise ValueError(f"placement shape mismatch: "
                             f"({self.num_layers},{self.num_experts}) vs "
                             f"({new.num_layers},{new.num_experts})")
        return np.take_along_axis(self.inverse_array(), new.perm_array(), axis=1)

    def to_manifest(self) -> dict:
        return {"num_layers": self.num_layers, "num_experts": self.num_experts,
                "perm": [list(row) for row in self.perm]}

    @classmethod
    def from_manifest(cls, d: Optional[dict]) -> Optional["ExpertPlacement"]:
        if d is None:
            return None
        return cls(int(d["num_layers"]), int(d["num_experts"]), _as_rows(d["perm"]))


# ----------------------------------------------------------------------------
# load metrics and the greedy (LPT) balancing permutation
# ----------------------------------------------------------------------------

def rank_loads(counts, perm_row: Sequence[int], ep: int) -> np.ndarray:
    """(ep,) summed expert load per EP rank under one placement row;
    ``counts`` in global-id order."""
    c = np.array(counts, dtype=np.float64)
    E = c.shape[0]
    if E % ep:
        raise ValueError(f"ep={ep} does not divide num_experts={E}")
    placed = c[np.array(perm_row, dtype=np.int64)]
    return placed.reshape(ep, E // ep).sum(axis=1)


def imbalance(counts, perm_row: Sequence[int], ep: int) -> float:
    """max/mean rank load (>= 1.0; 1.0 when balanced or without load)."""
    loads = rank_loads(counts, perm_row, ep)
    mean = loads.mean()
    return float(loads.max() / mean) if mean > 0 else 1.0


def greedy_perm(counts, ep: int) -> Tuple[int, ...]:
    """LPT: experts by descending load (stable), each onto the least-loaded
    rank with a free slot (lowest rank on ties); within a rank, slots in
    global-id order. Returns a position -> global id row."""
    c = np.array(counts, dtype=np.float64)
    E = c.shape[0]
    if E % ep:
        raise ValueError(f"ep={ep} does not divide num_experts={E}")
    slots = E // ep
    loads = np.zeros(ep)
    members = [[] for _ in range(ep)]
    for g in np.argsort(-c, kind="stable"):
        r = min((r for r in range(ep) if len(members[r]) < slots),
                key=lambda r: (loads[r], r))
        members[r].append(int(g))
        loads[r] += c[g]
    return tuple(v for m in members for v in sorted(m))


# ----------------------------------------------------------------------------
# moving a live state
# ----------------------------------------------------------------------------

def is_expert_stack(path: str, shape, num_layers: int, num_experts: int) -> bool:
    """True for the routed expert stacks a placement permutes,
    ``layers/moe/{gate,up,down}`` with a leading (L, E, ...): never the
    router (global-id space), never shared experts. Under EP pass the
    rank's count of experts to match its slices."""
    if "moe" not in path or "shared" in path:
        return False
    leaf = path.rsplit("/", 1)[-1]
    return (leaf in ("gate", "up", "down") and len(shape) >= 3
            and shape[0] == num_layers and shape[1] == num_experts)


def _take_rows(t: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """``out[l, pos] = t[l, rel[l, pos]]`` for an (L, E, ...) tensor."""
    return t[torch.arange(t.shape[0], device=t.device)[:, None], rel]


def permute_expert_tree(tree, rel, num_layers: int, num_experts: int, _path: str = ""):
    """A new tree whose whole (L, E, ...) expert stacks are gathered on dim
    1 by ``rel`` (``ExpertPlacement.relative_to``); the other leaves are the
    same tensors. A params tree or any tree mirroring it (master, m, v)."""
    if isinstance(tree, dict):
        return {k: permute_expert_tree(v, rel, num_layers, num_experts,
                                       f"{_path}/{k}" if _path else k)
                for k, v in tree.items()}
    if is_expert_stack(_path, tuple(tree.shape), num_layers, num_experts):
        return _take_rows(tree, torch.as_tensor(np.asarray(rel), device=tree.device).long())
    return tree


def _state_stacks(state, layout: Optional[dict], num_layers: int, num_experts: int):
    """(key, tensor, global shape, placement) of each expert-stack leaf of
    a ``TrainState`` (params, master, m and v), each distinct tensor once
    (a float32 param shares its tensor with its master weight)."""
    seen = set()
    trees = [(".params", state.params)] + [(f".opt.{f}", getattr(state.opt, f))
                                          for f in ("master", "m", "v")]
    for prefix, tree in trees:
        for (key, t), (path, _) in zip(keyed_leaves(tree, prefix), leaves_with_path(tree)):
            shape, place = layout[key] if layout is not None else (tuple(t.shape), ())
            if not is_expert_stack(path, shape, num_layers, num_experts):
                continue
            ident = (t.data_ptr(), t.dtype, tuple(t.shape))
            if ident in seen:
                continue
            seen.add(ident)
            yield key, t, shape, place


@torch.no_grad()
def apply_placement(state, current: ExpertPlacement, new: ExpertPlacement, *,
                    grid=None, layout: Optional[dict] = None):
    """Move a ``TrainState`` from ``current`` to ``new`` in place: every
    expert stack of the params and of the AdamW master, m and v takes
    ``W_new[l, pos] = W_live[l, rel[l, pos]]`` (``rel =
    current.relative_to(new)``); the router and the other leaves stay,
    also a table that 'ep' splits on its vocab rows (the stacks are found
    by their path and (L, E) shape, ``is_expert_stack``, not by 'ep').
    Returns (the state, its own tensors; the bytes this rank sent).

    Without a grid the stacks are whole and gathered on dim 1. On a
    ``ProcessGrid`` (``layout``: ``train.state_layout`` of the run, each
    leaf's global shape and placement) a rank's tile of a stack holds the
    positions its placement gives it on dim 1: the tile is all-gathered
    over the axes splitting dim 1 (minor first: 'ep', and 'data' where an
    SO/EPSO state splits it), the positions taken by ``rel``, and the
    rank's own positions cut back out; the other dims keep the rank's
    slice, since the SO/EPSO state placements only add axes to other dims.
    Under fsdp (``state_layout(..., fsdp=True)``) a tile of an expert stack
    is the rank's 'ep' slice cut on its d or f dim over 'data', and its
    expert dim carries 'ep' alone in every mode: the move gathers over
    'ep' and keeps the 'data' cut, so each rank moves its 'data' tile of
    every (layer, expert) slice. One leaf at a time, so the transient is
    one leaf gathered over those axes. Every slice written is a copy of its
    source: no arithmetic."""
    L, E = current.num_layers, current.num_experts
    rel = current.relative_to(new)
    if grid is not None and layout is None:
        raise ValueError("apply_placement on a grid needs the state's layout "
                         "(layout=train.state_layout(...))")
    sizes = grid.axis_sizes if grid is not None else {}
    sent = 0
    for _, t, shape, place in _state_stacks(state, layout if grid is not None else None, L, E):
        full = t
        for a in reversed(place[1] if len(place) > 1 else ()):
            g = grid.group((a,))
            sent += full.numel() * full.element_size() * (g.world - 1)
            full = all_gather_dim(full, g, 1)
        rows = rel
        if grid is not None:
            tiles = tile_slices(place, shape, grid.coords, sizes)
            rows = rel[tiles[0]]
        moved = _take_rows(full, torch.as_tensor(rows, device=t.device).long())
        if grid is not None:
            moved = moved[:, tiles[1]]
        t.copy_(moved)
        del full, moved
    return state, sent


# ----------------------------------------------------------------------------
# the host-side windowed controller (launch/train.py)
# ----------------------------------------------------------------------------

class RebalanceController:
    """Sums per-step ``moe_counts`` (global ids) over ``interval``-step
    windows and proposes greedy placements when the live rank imbalance
    exceeds ``threshold``. Owns the live placement."""

    def __init__(self, *, num_layers: int, num_experts: int, ep: int, interval: int,
                 threshold: float, placement: Optional[ExpertPlacement] = None):
        if interval < 1:
            raise ValueError(f"rebalance interval must be >= 1, got {interval}")
        if threshold < 1.0:
            raise ValueError(f"rebalance threshold is a max/mean ratio, "
                             f"must be >= 1.0, got {threshold}")
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.ep = ep
        self.interval = interval
        self.threshold = threshold
        self.placement = placement or ExpertPlacement.identity(num_layers, num_experts)
        self.window = np.zeros(num_experts, dtype=np.float64)
        self.steps_in_window = 0
        self.rebalances = 0

    def observe(self, counts) -> float:
        """Fold one step's (E,) counts into the window; returns that step's
        rank imbalance under the live placement."""
        c = np.array(counts, dtype=np.float64)
        self.window += c
        self.steps_in_window += 1
        return imbalance(c, self.placement.perm[0], self.ep)

    def window_full(self) -> bool:
        return self.steps_in_window >= self.interval

    def reset_window(self) -> None:
        """Drop the partial window (a relaunch replays its steps)."""
        self.window = np.zeros(self.num_experts, dtype=np.float64)
        self.steps_in_window = 0

    def propose(self, *, force: bool = False) -> Optional[ExpertPlacement]:
        """The greedy placement of the windowed counts, adopted and returned
        when it strictly lowers the windowed imbalance and (unless forced)
        the imbalance exceeds the threshold; else None. A forced call also
        adopts a different row that does not lower it. Resets the window."""
        counts, n = self.window, self.steps_in_window
        self.reset_window()
        if n == 0 or counts.sum() <= 0:
            return None
        cur = imbalance(counts, self.placement.perm[0], self.ep)
        if not force and cur <= self.threshold:
            return None
        row = greedy_perm(counts, self.ep)
        if imbalance(counts, row, self.ep) >= cur and not (
                force and row != self.placement.perm[0]):
            return None
        new = ExpertPlacement.broadcast(row, self.num_layers)
        if new == self.placement:
            return None
        self.placement = new
        self.rebalances += 1
        return new
