"""The SO/EPSO optimizer update on a ``ProcessGrid``, bucketed and
overlappable: port of the JAX package's ``optim/overlap.py``.

In the JAX package GSPMD derives the paper's collectives from the placement
mismatch between grads/params and states; here each is one explicit
``torch.distributed`` call per bucket of an ``epso.UpdatePlan``:

* gradients are reduce-scattered in ``grad_reduce_dtype`` onto the state
  shards over the bucket's batch axes ('data', 'ep'), then summed over the
  axes of ``grid.SUM_AXES`` (the batch axes, and 'pp' for the leaves every
  pipeline stage holds whole) the state replicates and the param does not
  split (an all-reduce of the shard): each rank receives its shard of
  every leaf and never the whole gradient. The 'tp' ranks hold the same
  rows, so a gradient is never summed over 'tp': a state split over 'tp'
  that its param does not split takes the rank's own part of the
  gradient; SO/EPSO add no 'pp' to a state (the JAX rule), so the stage
  tiles' states stay on their stage. An fsdp tile's gradient arrives
  summed over 'data' (``parallel.fsdp``): its param placement uses
  'data', so neither its bucket's reduce-scatter nor the sum over the axes
  the state replicates runs over 'data' again;
* the global grad norm comes from the shards: one scalar all-reduce per
  distinct state-axis set; the expert stacks take the canonical (L, E)
  slice-sum path (gathered over the axes tiling dims 0 and 1, summed over
  the rest in rank order, 'data' then 'tp', put in global-id order under
  an expert placement, then reduced in one fixed order), so that the clip
  scale is the same whichever rank holds an expert. The gradients' own
  reduce-scatters and all-reduces are gloo's, which may associate an
  element by its offset once a group has 3 ranks or more: a step is the
  same bits across an expert move for dp <= 2 alone;
* ``adamw_leaf`` runs on each shard, in place;
* the updated master shards are cast to the param dtype and gathered, one
  buffer per bucket, over the bucket's axes, and written into the params
  (the rank's tiles: an fsdp tile is put together from its state shards,
  never into the whole leaf).

``impl``: 'xla' gathers a bucket with one ``all_gather``, 'ring' with the
hierarchical ring of neighbour exchanges (``_ring_all_gather``), both
issued asynchronously: bucket b's gather runs while bucket b + 1 is
updated, and bucket b is written into the params after bucket b + 1's
gather is issued. 'off' is the same sharded math with each leaf its own
bucket (the caller plans it so) and every collective blocking: the
counterpart of the eager tail GSPMD derives in the JAX step.

A gathered buffer's rows enumerate shards major-to-minor over the bucket's
axes (the grid's rank order over them); a leaf's shard is cut by its
state placement, the added axes of each dim major-to-minor (as GSPMD tiles
a tuple spec). ``shard_of`` cuts and ``_assemble_leaf`` reassembles with
the same linearisation.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.parallel.ep import all_gather_dim
from repro_torch.parallel.grid import SUM_AXES, ProcessGrid
from repro_torch.parallel.sharding import shard_index
from repro_torch.tree import leaves

from .adamw import AdamWState, adamw_leaf_, clip_scale, sum_in_rank_order
from .epso import UpdatePlan, update_axis_order

OVERLAP_IMPLS = ("off", "ring", "xla")


def resolve_opt_overlap(setting: Optional[str], mode: str, axis_sizes) -> str:
    """Resolve an ``opt_overlap`` request to 'off' | 'ring' | 'xla'.
    ``None``/'auto' is 'ring' for ``epso`` on a grid with update axes and
    'off' otherwise. Explicit 'ring'/'xla' need a sharded mode and a grid
    with update axes; explicit 'off' always wins. ``axis_sizes``: the
    grid's axes of size > 1 (``ProcessGrid.axis_sizes``), or None."""
    s = "auto" if setting is None else str(setting)
    if s == "off":
        return "off"
    has_axes = bool(axis_sizes) and bool(update_axis_order(axis_sizes))
    if s == "auto":
        return "ring" if (mode == "epso" and has_axes) else "off"
    if s not in ("ring", "xla"):
        raise ValueError(f"opt_overlap must be one of {('auto',) + OVERLAP_IMPLS}, "
                         f"got {setting!r}")
    if mode not in ("so", "epso"):
        raise ValueError(f"opt_overlap={s!r} needs opt_shard in {{'so','epso'}} (got "
                         f"{mode!r}): the overlap schedules the sharded-state collectives")
    if not has_axes:
        raise ValueError(f"opt_overlap={s!r} needs a grid with update axes "
                         f"(pod/data/model/ep/tp)")
    return s


# ----------------------------------------------------------------------------
# shard layout
# ----------------------------------------------------------------------------

def leaf_axes(leaf) -> tuple:
    """The axes a leaf's state adds, in canonical order (its bucket's)."""
    added = {a for _, axes in leaf.added for a in axes}
    return update_axis_order(dict.fromkeys(added))


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


def block_shape(shape, leaf, axis_sizes) -> tuple:
    """The shape of a leaf's state shard: each dim over its added axes."""
    added = dict(leaf.added)
    return tuple(n // _prod(axis_sizes[a] for a in added.get(d, ()))
                 for d, n in enumerate(shape))


def _rows(t: torch.Tensor, axes: tuple, leaf, axis_sizes) -> torch.Tensor:
    """A param-local leaf as (N, shard numel): row k is the shard of the
    rank whose linear index over ``axes`` (major-to-minor) is k. The
    inverse of ``_assemble_leaf``."""
    added = dict(leaf.added)
    shape, names = [], []
    for d, n in enumerate(t.shape):
        split = added.get(d, ())
        for a in split:
            shape.append(axis_sizes[a])
            names.append(a)
        shape.append(n // _prod(axis_sizes[a] for a in split))
        names.append(None)
    perm = [names.index(a) for a in axes] + [i for i, nm in enumerate(names) if nm is None]
    return t.reshape(shape).permute(perm).reshape(_prod(axis_sizes[a] for a in axes), -1)


def shard_of(t: torch.Tensor, leaf, coords: dict, axis_sizes: dict) -> torch.Tensor:
    """A copy of this rank's state shard of the param-local leaf ``t``."""
    axes = leaf_axes(leaf)
    if not axes:
        return t.clone()
    row = _rows(t, axes, leaf, axis_sizes)[shard_index(axes, coords, axis_sizes)]
    return row.reshape(block_shape(t.shape, leaf, axis_sizes)).clone()


def _assemble_leaf(seg: torch.Tensor, bucket_axes: tuple, leaf, blk_shape: tuple,
                   axis_sizes: dict) -> torch.Tensor:
    """(N, *blk) gathered shards -> the param-local leaf: each rank-index
    axis moved next to the dim it split (major-to-minor) and merged."""
    sizes = tuple(axis_sizes[a] for a in bucket_axes)
    t = seg.reshape(sizes + tuple(blk_shape))
    k = len(sizes)
    added = dict(leaf.added)
    perm, out_shape = [], []
    for d in range(len(blk_shape)):
        mult = 1
        for a in added.get(d, ()):
            perm.append(bucket_axes.index(a))
            mult *= axis_sizes[a]
        perm.append(k + d)
        out_shape.append(mult * blk_shape[d])
    return t.permute(perm).reshape(out_shape)


# ----------------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------------

def _ring_all_gather(flat: torch.Tensor, axes: tuple, grid: ProcessGrid):
    """Hierarchical ring over ``axes`` (canonical order), a generator that
    yields after issuing each neighbour exchange and returns (N, S).

    The minor-most axis goes first: n - 1 exchanges, each sending the last
    block received to the rank one below on the axis and receiving from
    the one above; block k of the ring (shard (c + k) % n for coordinate c)
    is received straight into row (c + k) % n of the level's buffer, so
    the rows end up in rank order, enumerating shards major-to-minor over
    ``axes``.

    gloo's point-to-point ops read and write host memory only: handed a
    CUDA tensor they abort the process (the probe in PERF.md, on the H100).
    Over gloo a CUDA ring is therefore staged explicitly through pinned
    host buffers: the own shard is copied into one, the exchanges run in
    them, and the gathered rows go back to the card in one asynchronous
    copy. No other collective of the port is staged."""
    staged = flat.is_cuda and grid.world.backend == "gloo"
    host = torch.device("cpu") if staged else flat.device
    sizes, coords = grid.sizes, grid.coords
    cur = flat[None]
    for a in reversed(axes):
        n, c = sizes[a], coords[a]
        if n == 1:
            continue
        group = grid.group((a,)).group
        dst, src = grid.peer(a, (c - 1) % n), grid.peer(a, (c + 1) % n)
        out = torch.empty((n,) + tuple(cur.shape), dtype=cur.dtype, device=host,
                          pin_memory=staged)
        out[c].copy_(cur)
        p = out[c]
        for k in range(1, n):
            nxt = out[(c + k) % n]
            works = dist.batch_isend_irecv([dist.P2POp(dist.isend, p, dst, group),
                                            dist.P2POp(dist.irecv, nxt, src, group)])
            yield
            for w in works:
                w.wait()
            p = nxt
        cur = out.reshape((n * cur.shape[0],) + tuple(cur.shape[1:]))
    return cur.to(flat.device, non_blocking=True) if staged else cur


class _Gather:
    """One bucket's all-gather of (S,) into (N, S), issued on construction
    (blocking under 'off'); ``wait()`` completes it."""

    def __init__(self, flat: torch.Tensor, axes: tuple, grid: ProcessGrid, impl: str):
        self.out = self.work = self.ring = None
        if impl == "ring":
            self.ring = _ring_all_gather(flat, axes, grid)
            self._step()
            return
        g = grid.group(axes)
        self.out = torch.empty((g.world,) + tuple(flat.shape), dtype=flat.dtype,
                               device=flat.device)
        self.work = dist.all_gather(list(self.out.unbind(0)), flat, group=g.group,
                                    async_op=impl != "off")

    def _step(self) -> bool:
        try:
            next(self.ring)
            return True
        except StopIteration as stop:
            self.out, self.ring = stop.value, None
            return False

    def wait(self) -> torch.Tensor:
        while self.ring is not None and self._step():
            pass
        if self.work is not None:
            self.work.wait()
        return self.out


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    if group.world > 1:
        dist.all_reduce(t, group=group.group)
    return t


# ----------------------------------------------------------------------------
# the update
# ----------------------------------------------------------------------------

@torch.no_grad()
def overlapped_adamw_update(grads: list, state: AdamWState, params: list, *,
                            plan: UpdatePlan, grid: ProcessGrid, impl: str, state_specs: list,
                            lr, beta1=0.9, beta2=0.99, eps=1e-8, weight_decay=0.1,
                            grad_clip=1.0, clip_enabled=None,
                            grad_reduce_dtype=torch.bfloat16, expert_norm=None):
    """One SO/EPSO step on a grid. ``grads``: the param-local gradients in
    leaf order (their values already rounded to ``grad_reduce_dtype``),
    not yet summed over the ranks; ``state``: master, m and v holding this
    rank's shards (``shard_of``), updated in place; ``params``: the
    param-local leaves in leaf order, overwritten with the gathered
    update. ``state_specs``: each leaf's state placement (leaf order).
    ``expert_norm``: as in ``adamw.global_norm``, a ``(mask, inv)`` pair
    (the mask flags the expert stacks; ``inv``, the (L, E) id -> position
    rows of the live expert placement, or None). A placement moves slices
    along the expert dim only, so the plan's buckets are the same under any
    placement. Returns (new_state, metrics {grad_norm, clip_scale})."""
    if impl not in OVERLAP_IMPLS:
        raise ValueError(f"impl must be one of {OVERLAP_IMPLS}, got {impl!r}")
    n = len(grads)
    if plan.n_leaves != n:
        raise ValueError(f"the update plan has {plan.n_leaves} leaves, the gradients {n}")
    sizes, coords = grid.axis_sizes, grid.coords
    blocking = impl == "off"
    ma, mo, vo = leaves(state.master), leaves(state.m), leaves(state.v)
    dev = ma[0].device

    # 1. gradients onto the state shards: reduce-scattered over the bucket's
    # batch axes, the rows of the other axes ('tp') the rank's own, then
    # summed over the sum axes the state replicates
    shards = [None] * n
    pending = []
    for bucket in plan.buckets:
        red = tuple(a for a in bucket.axes if a in SUM_AXES)
        by_rest = {}
        for lf in bucket.leaves:
            rest = tuple(a for a in sizes if a in SUM_AXES and a not in lf.psum_axes)
            by_rest.setdefault(rest, []).append(lf)
        for rest, lfs in by_rest.items():
            rows = torch.cat([_rows(grads[lf.index].to(grad_reduce_dtype), bucket.axes, lf,
                                    sizes) for lf in lfs], dim=1)
            if red != bucket.axes:
                rows = rows.reshape([sizes[a] for a in bucket.axes] + [-1])[
                    tuple(slice(None) if a in red else coords[a] for a in bucket.axes)]
                rows = rows.reshape(-1, rows.shape[-1])
            work = None
            if red:
                g = grid.group(red)
                out = torch.empty(rows.shape[1], dtype=rows.dtype, device=rows.device)
                work = dist.reduce_scatter(out, list(rows.unbind(0)), group=g.group,
                                           async_op=not blocking)
            else:
                out = rows[0]
            pending.append((rest, lfs, out, work))
    for rest, lfs, out, work in pending:
        if work is not None:
            work.wait()
        _all_reduce_(out, grid.group(rest))
        blks = [block_shape(grads[lf.index].shape, lf, sizes) for lf in lfs]
        for lf, blk, part in zip(lfs, blks, out.split([_prod(b) for b in blks])):
            shards[lf.index] = part.view(blk).float()
    del pending

    # 2. the global grad norm from the shards
    ex_mask = expert_norm[0] if expert_norm is not None else ()
    inv = expert_norm[1] if expert_norm is not None else None
    norm_groups, expert_leaves = {}, []
    for bucket in plan.buckets:
        for lf in bucket.leaves:
            if lf.index < len(ex_mask) and ex_mask[lf.index]:
                expert_leaves.append(lf)
            else:
                norm_groups.setdefault(lf.psum_axes, []).append(lf.index)
    expert_leaves.sort(key=lambda lf: lf.index)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for axes, idxs in sorted(norm_groups.items()):
        loc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in idxs:
            loc = loc + torch.sum(torch.square(shards[i]))
        total = total + (_all_reduce_(loc, grid.group(axes)) if axes else loc)
    for lf in expert_leaves:
        s = torch.sum(torch.square(shards[lf.index]), dim=tuple(range(2, shards[lf.index].ndim)))
        spec, lead = state_specs[lf.index], []
        for d in (0, 1):
            for a in reversed(spec[d] if d < len(spec) else ()):
                s = all_gather_dim(s, grid.group((a,)), d)
                lead.append(a)
        # the other axes in rank order too ('data', then 'tp'): an
        # all-reduce may associate an element by its offset, which a move
        # changes
        for a in sorted((a for a in lf.psum_axes if a not in lead), key=lambda a: a != "data"):
            s = sum_in_rank_order(s, grid.group((a,)))
        if inv is not None:
            s = torch.gather(s, 1, inv.long())
        total = total + torch.sum(s)
    gnorm = torch.sqrt(total)
    scale = clip_scale(gnorm, grad_clip, clip_enabled)

    # 3. AdamW on the shards, then each bucket's gather, one bucket behind
    step = state.step + 1
    t = step.to(torch.float32)
    hyper = dict(scale=scale, lr=lr, bc1=1.0 - beta1 ** t, bc2=1.0 - beta2 ** t, beta1=beta1,
                 beta2=beta2, eps=eps, weight_decay=weight_decay)

    def finish(bucket, gather):
        full = gather.wait()
        off = 0
        for lf in bucket.leaves:
            blk = block_shape(params[lf.index].shape, lf, sizes)
            sz = _prod(blk)
            seg = full[:, off:off + sz].reshape((full.shape[0],) + blk)
            params[lf.index].copy_(_assemble_leaf(seg, bucket.axes, lf, blk, sizes))
            off += sz

    prev = None
    for bucket in plan.buckets:
        pieces = []
        for lf in bucket.leaves:
            i = lf.index
            adamw_leaf_(shards[i], ma[i], mo[i], vo[i], **hyper)
            shards[i] = None
            if bucket.axes:
                pieces.append(ma[i].to(params[i].dtype).reshape(-1))
            elif params[i].data_ptr() != ma[i].data_ptr():
                params[i].copy_(ma[i])
        cur = None
        if bucket.axes:
            cur = (bucket, _Gather(torch.cat(pieces), bucket.axes, grid, impl))
        if prev is not None:
            finish(*prev)
        prev = cur
    if prev is not None:
        finish(*prev)
    return (AdamWState(step, state.master, state.m, state.v),
            {"grad_norm": gnorm, "clip_scale": scale})
