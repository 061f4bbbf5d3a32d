"""FSDP (ZeRO-3) on the grid's 'data' axis: the gather of one layer's
tiles, the port's counterpart of what the JAX compiler does to the
``fsdp`` layout (``parallel/sharding.py::fsdp_wrap``) inside a layer.

Under ``ParallelConfig.fsdp_params`` rank d of the 'data' axis holds its
tile of every leaf that ``sharding.param_placements(..., fsdp=True)``
splits: the layer weights, each cut on one per-layer dim. ``LayerGather``
makes a layer's weights whole for that layer's forward and backward
alone, for every arch: the dense and moe blocks, the SSM layers of the
ssm arch's ``layers`` and of the hybrid's ``groups`` (two stacked dims)
and ``rem``. ``models.model.forward`` and ``pipeline_stage_forward`` call
it inside the function that block remat checkpoints, so the checkpoint
saves the tiles, and its recompute in the backward gathers again; outside
a layer's own forward and backward no rank holds that layer's gathered
weights or their whole gradient. The hybrid's shared attention+MLP block
runs after every group without block remat (as in the JAX package), so
``forward`` gathers it once a forward, in float32 (the compute-dtype bits,
widened): autograd adds its applications' cotangents in float32, as the
step without fsdp adds the cast-backs of its float32 params, before the
one reduce-scatter. A tile is cut from the rank's share of the leaf over
the grid's other axes: an expert stack's 'ep' slice (in the positions of
an expert placement, which moves whole (layer, expert) slices and leaves
the tiles' cut alone), a tp shard, the layers of its pipeline stage. The
gather makes that share whole over 'data', no more: what the layer takes
on the rank under EP, TP and PP. The group is the 'data' group of the
rank's ('pp', 'ep', 'tp') coordinate. Under pp a stage gathers a layer
three times a microbatch (its F tick's forward without autograd, its B
tick's forward, the recompute) and reduce-scatters it once; otherwise
twice and once.

* forward: one all-gather over 'data' of the layer's tiles, cast to the
  compute dtype and packed into one flat buffer, leaf after leaf; each
  leaf is then put together along its split dim, the ranks' blocks in
  'data' order (``tile_slices``' order). A tile cut on a dim other than 0
  is no row block of its leaf, so the blocks are packed and unpacked per
  leaf, never sliced from the whole. The layers cast every weight to the
  compute dtype where they use it, once, so a gather in that dtype gives
  them the same bits at a fraction of the bytes, and their gradients are
  the ones the cast's backward would hand on;
* backward: each whole gradient rounded to ``reduce_dtype`` (the paper's
  bf16 gradient reduction), packed as the forward unpacked, and one
  reduce-scatter over 'data' onto the tiles, summed over the ranks. gloo
  runs it as an all-reduce, which may add an element's values in an order
  that depends on its offset once 'data' has 3 ranks or more: an expert
  slice's gradient is the same bits across an expert move for dp <= 2
  alone.

The collectives are called directly, not through ``parallel.ep``'s taped
ones: under 'block_sc' a ``CollectiveTape`` would keep the gathered
weights from the forward to the recompute, the memory FSDP frees.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, unflatten

from .sharding import stacked_dims


def _pack(parts, dims, world: int) -> torch.Tensor:
    """(world, n): row r holds rank r's block of each whole leaf of
    ``parts`` along its dim of ``dims``, flattened, leaf after leaf."""
    rows = []
    for t, d in zip(parts, dims):
        shape = tuple(t.shape)
        cut = shape[:d] + (world, shape[d] // world) + shape[d + 1:]
        rows.append(t.reshape(cut).movedim(d, 0).reshape(world, -1))
    return torch.cat(rows, dim=1)


def _unpack(full: torch.Tensor, shapes, dims) -> list:
    """The whole leaves of a (world, n) buffer of packed tiles of
    ``shapes``, each put together along its dim of ``dims``."""
    world, out, off = full.shape[0], [], 0
    for shape, d in zip(shapes, dims):
        n = math.prod(shape)
        blocks = full[:, off:off + n].reshape((world,) + tuple(shape))
        out.append(blocks.movedim(0, d).reshape(
            tuple(shape[:d]) + (world * shape[d],) + tuple(shape[d + 1:])))
        off += n
    return out


class _GatherTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gather, dims, out_dtype, *tiles):
        ctx.gather, ctx.dims = gather, dims
        ctx.shapes = [tuple(t.shape) for t in tiles]
        ctx.dtypes = [t.dtype for t in tiles]
        g = gather.group
        flat = torch.cat([t.reshape(-1).to(gather.dtype) for t in tiles])
        full = flat.new_empty((g.world, flat.numel()))
        dist.all_gather(list(full.unbind(0)), flat, group=g.group)
        gather.stats["all_gather"] += 1
        gather.stats["gathered_bytes"] += full.numel() * full.element_size()
        whole = _unpack(full, ctx.shapes, dims)
        if out_dtype is not None:
            whole = [w.to(out_dtype) for w in whole]
        return tuple(whole)

    @staticmethod
    def backward(ctx, *grads):
        gather = ctx.gather
        g = gather.group
        packed = _pack([d.to(gather.reduce_dtype) for d in grads], ctx.dims, g.world)
        out = packed.new_empty(packed.shape[1])
        dist.reduce_scatter(out, list(packed.unbind(0)), group=g.group)
        gather.stats["reduce_scatter"] += 1
        tiles, off = [], 0
        for shape, dtype in zip(ctx.shapes, ctx.dtypes):
            n = math.prod(shape)
            tiles.append(out[off:off + n].view(shape).to(dtype))
            off += n
        return (None, None, None, *tiles)


class LayerGather:
    """The gather of one layer's 'data' tiles over ``group``, the grid's
    'data' group of the rank's ('pp', 'ep', 'tp') coordinate: ``gather(lp,
    part)`` takes a layer's params (one layer of the top-level subtree
    ``part``, past its ``sharding.stacked_dims``, or of a stage's slice of
    ``layers``; the shared block whole; tiles where the placement splits
    them over 'data') and returns them with those leaves whole over
    'data', the rank's share over the other axes, differentiably (the
    module docstring). ``place``: the placements of
    the whole params tree (``param_placements(..., fsdp=True)``); ``dtype``:
    the compute dtype, which the leaves are gathered in and come in, unless
    the call asks for ``out_dtype`` (their cotangents then add up in it).
    ``stats`` counts the all-gathers, the reduce-scatters and the bytes of
    the whole layers gathered, from the start."""

    def __init__(self, place: dict, group, reduce_dtype: torch.dtype, dtype: torch.dtype):
        # per part and leaf, the per-layer dim 'data' splits (the
        # placement's, less the stacked layer dims), or None
        self.dims = {part: tuple(next((d - stacked_dims(part + "/") for d, axes in enumerate(pl)
                                       if "data" in axes), None) for pl in leaves(sub))
                     for part, sub in place.items()}
        self.group = group
        self.reduce_dtype = reduce_dtype
        self.dtype = dtype
        self.stats = {"all_gather": 0, "reduce_scatter": 0, "gathered_bytes": 0}

    def __call__(self, lp: dict, part: str = "layers", out_dtype=None) -> dict:
        dims = self.dims[part]
        flat = leaves(lp)
        cut = [i for i, d in enumerate(dims) if d is not None]
        if not cut or self.group.world == 1:
            return lp
        whole = _GatherTiles.apply(self, tuple(dims[i] for i in cut), out_dtype,
                                   *(flat[i] for i in cut))
        for i, w in zip(cut, whole):
            flat[i] = w
        return unflatten(lp, flat)
