"""Sharded Optimizer (SO) and EP-Aware Sharded Optimizer (EPSO), paper §3.2:
port of the JAX package's ``optim/epso.py``.

Placements are data here (``parallel.sharding.param_placements``): per
leaf, per dim, the tuple of grid axes that split it, ``()`` for a whole
dim, every dim listed (a JAX ``PartitionSpec`` with its trailing ``None``
entries written out and each entry a tuple). Axis sizes come from a dict
in mesh order, the JAX ``mesh.shape``, so that meshes with 'pod', 'model'
or 'tp' can be planned (the port's grid has 'data', 'ep' and 'tp').

* ``mode='so'``   every state leaf gains the DP axes ('pod', 'data') only:
  a parameter replicated over the model-like axes keeps its states
  replicated there, the waste the paper names;
* ``mode='epso'`` the states of such parameters are split over the
  model-like axes too (DP x EP ways); the expert stacks keep their 'ep'
  split and gain 'data' on another dim (Figure 6);
* ``mode='none'`` the states are placed as the parameters.

Each group of axes goes on the largest unsharded dim it divides, falling
back to its axes one by one; a leaf too small to divide stays whole. The
rules are the JAX package's, kept equal by tests/test_torch_epso.py.

``plan_update_buckets`` groups the leaves by the axes their states add to
their params' placement and packs them, in leaf order, into size-capped
buckets: each bucket's gradient reduce-scatter and updated-param all-gather
is one collective (``optim.overlap``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

from repro_torch.tree import keyed_leaves, leaves, tree_map

# canonical linear-rank order over the update axes: mesh-major, matching the
# major-to-minor order of a tuple placement, so a bucket's gathered rows
# enumerate shards as the per-leaf placements tile them
_UPDATE_AXIS_ORDER = ("pod", "data", "model", "ep", "tp")

DEFAULT_BUCKET_BYTES = 4 << 20


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _padded(place, shape) -> list:
    return list(place) + [()] * (len(shape) - len(place))


def _augment(place, shape, axes_groups, axis_sizes) -> tuple:
    """Add ``axes_groups`` (a list of tuples of axes) to a placement."""
    entries = _padded(place, shape)
    used = {a for e in entries for a in e}
    for group in axes_groups:
        # order-preserving dedupe: an axis repeated inside one group is
        # placed once
        fill, seen = [], set()
        for a in group:
            if a not in used and a in axis_sizes and a not in seen:
                fill.append(a)
                seen.add(a)
        group = tuple(fill)
        if not group:
            continue
        size = 1
        for a in group:
            size *= axis_sizes[a]
        # largest unsharded divisible dim
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if not entries[i] and shape[i] % size == 0 and size > 1:
                entries[i] = group
                used.update(group)
                break
        else:
            # try splitting the group (e.g. only 'data' fits, not 'model')
            for a in group:
                for i in order:
                    if not entries[i] and shape[i] % axis_sizes[a] == 0 \
                            and axis_sizes[a] > 1:
                        entries[i] = (a,)
                        used.add(a)
                        break
    return tuple(entries)


def optimizer_state_specs(params, placements, axis_sizes: dict, mode: str = "epso"):
    """The placement of each of master, m and v, a tree like ``params``
    (leaves with ``.shape``) from the params' ``placements``. Without axes
    (``axis_sizes`` empty or None) every state is whole."""
    if not axis_sizes:
        return tree_map(lambda leaf: ((),) * len(leaf.shape), params)
    dp_axes = tuple(a for a in ("pod", "data") if a in axis_sizes)
    # the model-like axes: the legacy shared 'model' axis, or the plan
    # mesh's dedicated 'ep'/'tp' axes, treated alike
    model_axes = tuple(a for a in ("model", "ep", "tp") if a in axis_sizes)

    def one(leaf, place):
        shape = tuple(leaf.shape)
        if mode == "so":
            groups = [dp_axes]
        elif mode == "epso":
            # one joint group; _augment skips the axes the param already
            # uses (the experts keep 'ep' and gain DP on another dim)
            groups = [dp_axes + model_axes]
        elif mode == "none":
            return tuple(_padded(place, shape))
        else:
            raise ValueError(mode)
        return _augment(place, shape, groups, axis_sizes)

    return tree_map(one, params, placements)


def state_bytes_per_device(params, placements, axis_sizes: dict, mode: str) -> int:
    """Per-rank bytes of the fp32 (master, m, v) states, from shapes: the
    EPSO-against-SO memory comparison (paper Table 3)."""
    if not axis_sizes:
        return sum(_numel(leaf.shape) for leaf in leaves(params)) * 12
    specs = optimizer_state_specs(params, placements, axis_sizes, mode)
    per_dev = 0
    for leaf, spec in zip(leaves(params), leaves(specs)):
        denom = 1
        for e in spec:
            for a in e:
                denom *= axis_sizes[a]
        per_dev += _numel(leaf.shape) // denom
    return per_dev * 12    # 4 B * (master + m + v)


# ---------------------------------------------------------------------------
# bucket planner for the overlapped update (optim/overlap.py)
# ---------------------------------------------------------------------------

def update_axis_order(axis_sizes: dict) -> Tuple[str, ...]:
    """The axes SO/EPSO may add to a state placement, in the canonical rank
    order the bucket collectives linearise over."""
    return tuple(a for a in _UPDATE_AXIS_ORDER if a in axis_sizes)


class UpdateLeaf(NamedTuple):
    """One leaf inside an update bucket. ``added``: ``((dim, (axis, ...)),
    ...)``, the axes (major-to-minor) that the state placement adds to the
    param placement on param-local dim ``dim``; their union is the bucket's
    ``axes``. ``psum_axes``: every axis the state placement uses, in mesh
    order: a scalar reduction over the leaf's shards is summed over them."""
    index: int                 # position in leaf order
    path: str                  # key path as jax.tree_util.keystr gives it
    added: Tuple[Tuple[int, Tuple[str, ...]], ...]
    psum_axes: Tuple[str, ...]


class UpdateBucket(NamedTuple):
    axes: Tuple[str, ...]      # gather axes, canonical order; () = local only
    leaves: Tuple[UpdateLeaf, ...]
    elems: int                 # global elements across the bucket's leaves


class UpdatePlan(NamedTuple):
    buckets: Tuple[UpdateBucket, ...]
    axes: Tuple[str, ...]      # union of all buckets' axes
    n_leaves: int
    mode: str


def plan_update_buckets(params, placements, axis_sizes: dict, mode: str, *,
                        max_bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> UpdatePlan:
    """Group the leaves of ``params`` (global shapes) into size-capped update
    buckets. Leaves are keyed by the axes their state placement adds and
    packed greedily in leaf order, ``max_bucket_bytes`` of fp32 master
    weights per bucket; a leaf larger than the cap gets its own bucket.
    Leaves whose state placement equals their param placement form
    ``axes=()`` buckets (a local update, no collective)."""
    axis_sizes = axis_sizes or {}
    order = update_axis_order(axis_sizes)
    pspecs = leaves(placements)
    ospecs = leaves(optimizer_state_specs(params, placements, axis_sizes, mode))
    flat = keyed_leaves(params)
    assert len(flat) == len(pspecs) == len(ospecs)

    mesh_order = tuple(axis_sizes)
    out = []
    for i, ((path, leaf), ps, os_) in enumerate(zip(flat, pspecs, ospecs)):
        shape = tuple(leaf.shape)
        added = []
        for d in range(len(shape)):
            pe = ps[d] if d < len(ps) else ()
            oe = os_[d] if d < len(os_) else ()
            if oe[:len(pe)] != pe:
                raise ValueError(f"state placement {os_} does not extend param placement "
                                 f"{ps} at dim {d} of {path}")
            extra = oe[len(pe):]
            if extra:
                denom = 1
                for a in oe:
                    denom *= axis_sizes[a]
                if shape[d] % denom != 0:
                    raise ValueError(f"dim {d} of {path} ({shape}) not divisible by state "
                                     f"placement {os_}")
                added.append((d, extra))
        state_axes = {a for e in os_ for a in e}
        psum_axes = tuple(a for a in mesh_order if a in state_axes)
        out.append(UpdateLeaf(i, path, tuple(added), psum_axes))

    max_elems = max(max_bucket_bytes // 4, 1)
    buckets = []
    open_buckets = {}      # signature -> (leaves, elems)
    for lf, (_, leaf) in zip(out, flat):
        sig = tuple(a for a in order if any(a in axes for _, axes in lf.added))
        cur = open_buckets.get(sig)
        size = _numel(leaf.shape)
        if cur is not None and cur[1] + size > max_elems and cur[0]:
            buckets.append(UpdateBucket(sig, tuple(cur[0]), cur[1]))
            cur = None
        if cur is None:
            cur = ([], 0)
        cur[0].append(lf)
        open_buckets[sig] = (cur[0], cur[1] + size)
    for sig, (ls, elems) in open_buckets.items():
        if ls:
            buckets.append(UpdateBucket(sig, tuple(ls), elems))
    # deterministic schedule: buckets in leaf order of their first leaf
    buckets.sort(key=lambda b: b.leaves[0].index)
    union = tuple(a for a in order if any(a in b.axes for b in buckets))
    return UpdatePlan(tuple(buckets), union, len(out), mode)
