"""The training step, on one device or over a dp x ep process grid, and the
serving lowerings: port of the JAX package's ``train/trainer.py``
(``TrainState``, ``init_state``, ``make_train_step``,
``make_prefill_step``, ``make_serve_step``).

The paper's recipe (§2.1): bf16 forward and backward on fp32 params
(cast inside the layers), gradient accumulation over microbatches in f32,
the gradient rounded to ``grad_reduce_dtype`` (bf16) as the reduction
would, warmup + cosine LR, global-norm clipping only after warmup, AdamW on
fp32 master weights. The MoE expert stacks take their grad-norm share per
(layer, expert) slice, as the JAX step does.

Data, expert and tensor parallelism (``grid``, a ``parallel.ProcessGrid``,
the layout of the JAX plan mesh ('data', 'pp', 'ep', 'tp'), its 'pp' axis
below; an ``ep_group`` alone is the dp = pp = tp = 1 grid): rank (d, e, t)
holds expert slice e of the expert
stacks, with tp > 1 its tile t of every tp-split leaf
(``parallel.sharding.param_placements``), a whole copy of every other leaf,
and takes rows d * ep + e of the batch. It backpropagates its share of the
global loss (``models.loss_fn``); the MoE blocks' collectives run over its
'ep' group, the tensor-parallel sums over its 'tp' group. The optimizer
state is placed by ``opt_sharding_mode`` (paper §3.2, ``optim.epso``):

* 'none': master, m and v as the params (float32 params share the master's
  tensors). Each leaf's gradient, rounded to ``grad_reduce_dtype``, is
  summed in that dtype over the batch axes ('data', 'ep') that do not split
  it: a whole or tp-split leaf's over both, the expert slices' over 'data'
  (their sum over 'ep' arrives through the collectives' backward), never
  over 'tp', whose ranks hold the same rows. The grad norm counts each
  distinct tile once (the squares of tp-split leaves summed over 'tp'), so
  every rank takes the same step;
* 'so' / 'epso': each rank's master, m and v hold its shard of each leaf,
  and the params are separate tensors. The gradients are reduce-scattered
  onto the shards, AdamW runs on them, and the updated shards are gathered
  back into the params, bucket by bucket (``optim.overlap``, with
  ``ParallelConfig.opt_overlap`` 'off', 'ring', 'xla' or 'auto').

The embedding and head tables are split on their vocab rows over 'tp',
or over 'ep' without 'tp' (the JAX ``mdl = tp or ep``;
``param_placements``), and looked up and unembedded over that group
(``parallel.vocab``). A 'tp'-split table's gradient is the rank's own, as
any tp shard's; an 'ep'-split table's already covers every 'ep' rank's
tokens, so it is summed over 'data' and 'pp' alone, and the grad norm
adds its squares over 'ep'.

An expert placement (``parallel.placement.ExpertPlacement``) runs the
MoE blocks on stacks stored in placed order (``apply_placement`` moves a
state there) and takes the expert stacks' grad-norm share in global-id
order, so a placed step is the unplaced one's computation, its experts
in other homes.

The all-to-all Stage 1 (``MoEConfig.stage1 = 'a2a'``) and expert-TP run
inside the MoE block (``core.moe``) and change nothing here.

Pipeline parallelism (``ParallelConfig.pp_stages`` = pp > 1, the JAX
step's ``pp_loss_and_grads``): the batch (the rank's rows) is split into
``microbatches`` and the ``pp_schedule`` tick table ('gpipe' or '1f1b')
is walked by ``parallel.pipeline.run_schedule`` over the stage pieces of
``models.model`` (``embed_tokens``, ``pipeline_stage_forward``,
``lm_head_nll``): a forward tick saves its stage's input, the backward
tick recomputes the stage from it under autograd. Gradients add up in
microbatch order and are divided by the microbatch count; ce comes from
the last stage, the router terms, counts and drops from every stage, and
loss = ce + (aux_coef * aux + z_coef * z) / num_layers. Without a 'pp'
axis one process runs every stage (the JAX masked executor's role, any
microbatch count). On a grid with a 'pp' axis of pp stages rank (d, p, e,
t) holds layers [p L / pp, (p + 1) L / pp) and the embedding, final norm
and head whole, runs stage p's ticks alone (only stage 0 embeds, only the
last stage runs the head), and hands activations and their gradients to
its neighbour stages (``parallel.pipeline.StageLink``); each stage's MoE
blocks run on its 'ep' and 'tp' groups. The gradients of the leaves every
stage holds whole are summed over 'pp' besides the batch axes, those of
the layer tiles never; the metrics are summed over 'pp', so every rank
reports the same. ``pp_impl`` 'shardmap' checks that pp divides the
microbatches on such a grid; 'masked' runs the same executor with any
count (the JAX executors agree to about 1 ulp).

FSDP (``ParallelConfig.fsdp_params``, ZeRO-3 on the 'data' axis, the JAX
``fsdp`` layout): rank (d, p, e, t) holds its 'data' tile of every leaf
that ``param_placements(..., fsdp=True)`` splits, cut from its share over
the other axes (an expert stack's 'ep' slice, a tp shard, the layers of
stage p). Under 'none' its master, m and v are those tiles; under 'so'
and 'epso' they are cut from the tiles by the state placement
``optim.epso.optimizer_state_specs`` gives on the fsdp param placements,
which adds only the axes a tile does not use yet ('epso' on a ('data',
'ep') grid: 'ep' for a layer tile, nothing for an expert stack; never
'pp', so a stage's tiles keep their state on the stage). Each layer's
tiles are gathered inside the function that block remat checkpoints
(``parallel.fsdp.LayerGather`` over the rank's 'data' group, in
``compute_dtype``, into the rank's share: an expert stack's 'ep' slice, a
tp shard); the gather's backward reduce-scatters the layer's gradients
onto the tiles, in ``grad_reduce_dtype``, once a microbatch, so a tile
takes no sum over 'data' in the update, only over the batch axes that do
not split it ('ep' for a layer tile, none for an expert stack), never over
'tp' and, a stage's layers, never over 'pp'; the grad norm sums their
squares over 'data' (and over 'tp', 'pp' and 'ep' where they split them).
A pipeline stage gathers a layer at its F tick (without autograd), at its
B tick's forward and in the recompute: three gathers and one
reduce-scatter a layer and microbatch. It runs for every arch the port
trains, on every grid and in every optimizer mode the arch takes, with a
'block' or 'block_sc' remat policy (another policy is refused, ROADMAP.md
§1 item 5.1e): the SSM layers of the ssm arch and of the hybrid's
``groups`` and ``rem`` are gathered as the dense blocks are, the hybrid's
shared block once a forward (``models.model.forward``), its tiles
reduce-scattered once a microbatch and, split over 'data', never summed
over it again. Under an expert placement the expert tiles are cut from
the placed stacks (``apply_placement`` moves them), and the grad norm sums
each (layer, expert) slice's squares over 'data' in rank order before it
takes the slices in global-id order (``optim.adamw.expert_slice_sumsq``),
so that a step computes the same across a move.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import (PP_ARCH_TYPES, decode_step, embed_tokens, forward,
                                      init_params, lm_head_nll, loss_fn, pipeline_stage_forward,
                                      prefill_with_cache, table_split)
from repro_torch.core.moe import uses_ep
from repro_torch.optim import (AdamWState, adamw_init, adamw_update, expert_leaf_mask,
                               warmup_cosine)
from repro_torch.optim.epso import (DEFAULT_BUCKET_BYTES, UpdatePlan, optimizer_state_specs,
                                    plan_update_buckets)
from repro_torch.optim.overlap import overlapped_adamw_update, resolve_opt_overlap, shard_of
from repro_torch.parallel.ep import EPGroup, all_reduce_sum
from repro_torch.parallel.fsdp import LayerGather
from repro_torch.parallel.grid import BATCH_AXES, SUM_AXES, ProcessGrid, as_grid
from repro_torch.parallel.pipeline import (StageLink, _check_stage_divisible,
                                           check_pp_microbatches, run_schedule, schedule_ticks)
from repro_torch.parallel.placement import ExpertPlacement
from repro_torch.parallel.plan import FSDP_ITEM, refuse
from repro_torch.parallel.sharding import param_placements, rank_shard
from repro_torch.serve.engine import dropless_cfg, make_decode_fn, serving_grid
from repro_torch.tree import keyed_leaves, leaves, tree_map, unflatten

OPT_SHARDING_MODES = ("none", "so", "epso")


class TrainState(NamedTuple):
    params: dict          # params in TrainConfig.param_dtype
    opt: AdamWState       # fp32 master + moments (under SO/EPSO the rank's shards)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _grid(ep_group, grid) -> Optional[ProcessGrid]:
    if ep_group is not None and grid is not None:
        raise ValueError("pass an ep_group or a grid, not both")
    return as_grid(ep_group if grid is None else grid)


def _shards_experts(cfg: ModelConfig, grid: Optional[ProcessGrid]) -> bool:
    """Whether the grid's 'ep' axis splits this model's expert stacks."""
    return (grid is not None and grid.ep.world > 1 and cfg.is_moe
            and uses_ep(cfg.moe, grid.ep.world))


def _opt_mode(mode: Optional[str]) -> str:
    mode = "none" if mode is None else mode
    if mode not in OPT_SHARDING_MODES:
        raise ValueError(f"opt_sharding_mode must be one of {OPT_SHARDING_MODES}, got {mode!r}")
    return mode


def placements(cfg: ModelConfig, shapes: dict, axis_sizes: dict, *,
               fsdp: bool = False) -> dict:
    """``param_placements`` of ``cfg``'s global ``shapes`` on a grid with
    ``axis_sizes``, as the step runs them: the expert stacks split over
    'ep' only where the MoE block runs EP (``core.moe.uses_ep``; else the
    dense path holds every expert); with ``fsdp`` the 'data' tiles too."""
    split = cfg.moe is None or uses_ep(cfg.moe, axis_sizes.get("ep", 1))
    return param_placements(shapes, axis_sizes, split_experts=split, fsdp=fsdp)


def opt_layout(cfg: ModelConfig, grid: Optional[ProcessGrid], mode: str, *,
               max_bucket_bytes: int = DEFAULT_BUCKET_BYTES,
               fsdp: bool = False) -> tuple[UpdatePlan, list]:
    """The SO/EPSO layout of ``cfg``'s parameters on ``grid``: the update
    plan and each leaf's state placement (leaf order), from the global
    shapes (``init_params`` on the meta device) and the port's param
    placements (``fsdp``: with the 'data' tiles, so that a state adds only
    the axes its tile does not use). Without a grid every state is whole."""
    shapes = init_params(cfg, device="meta")
    sizes = grid.axis_sizes if grid is not None else {}
    place = placements(cfg, shapes, sizes, fsdp=fsdp)
    plan = plan_update_buckets(shapes, place, sizes, mode, max_bucket_bytes=max_bucket_bytes)
    return plan, leaves(optimizer_state_specs(shapes, place, sizes, mode))


def state_layout(cfg: ModelConfig, axis_sizes: dict, mode: Optional[str], *,
                 fsdp: bool = False) -> dict:
    """``{key: (global shape, placement)}`` for every leaf of a
    ``TrainState`` of ``cfg`` on a grid whose axes of size > 1 are
    ``axis_sizes`` (``ProcessGrid.axis_sizes``) under ``opt_sharding_mode``
    ``mode``, keyed as ``tree.keyed_leaves`` keys the state (the checkpoint
    files' keys): the params as ``param_placements`` places them, master, m
    and v by their state placement, the step whole. The params appear a
    second time under their keys in a params tree alone (a model-only
    checkpoint's keys). A rank holds ``parallel.sharding.tile_slices`` of
    each global leaf. ``checkpoint.Checkpointer(layout=)`` takes it."""
    shapes = init_params(cfg, device="meta")
    place = placements(cfg, shapes, axis_sizes, fsdp=fsdp)
    specs = optimizer_state_specs(shapes, place, axis_sizes, _opt_mode(mode))
    flat = [(key, tuple(leaf.shape)) for key, leaf in keyed_leaves(shapes)]
    out = {key: (shape, p) for (key, shape), p in zip(flat, leaves(place))}
    out.update({".params" + key: v for key, v in list(out.items())})
    out[".opt.step"] = ((), ())
    for what in ("master", "m", "v"):
        out.update({f".opt.{what}{key}": (shape, spec)
                    for (key, shape), spec in zip(flat, leaves(specs))})
    return out


def _cut(tree: dict, plan: UpdatePlan, grid: ProcessGrid) -> dict:
    """Copies of this rank's SO/EPSO shards of a param-local tree (the
    rank's tiles: ``plan``'s leaves cut them on the axes the state adds to
    their placement alone)."""
    by_index = {lf.index: lf for b in plan.buckets for lf in b.leaves}
    order = {id(t): i for i, t in enumerate(leaves(tree))}
    return tree_map(lambda t: shard_of(t, by_index[order[id(t)]], grid.coords,
                                       grid.axis_sizes), tree)


def init_state(cfg: ModelConfig, train: TrainConfig, *, seed: int = 0,
               device: DeviceLike = None, ep_group: Optional[EPGroup] = None,
               grid: Optional[ProcessGrid] = None,
               opt_sharding_mode: Optional[str] = None, fsdp: bool = False) -> TrainState:
    """Random params (``init_params`` from ``seed``) and a fresh AdamW
    state, on ``cuda`` unless ``device`` says otherwise (on a grid, its
    device). On a grid (or an ``ep_group``): the rank's share of the state
    that ``init_state(cfg, train, seed=seed)`` gives on one process, its
    optimizer state cut by ``opt_sharding_mode`` (None: 'none'). ``fsdp``:
    the params are the rank's 'data' tiles too (``ParallelConfig.
    fsdp_params``), and master, m and v are cut from them: under 'none'
    the tiles themselves (float32 params keep sharing the master's
    tensors), under 'so' and 'epso' the shards of the tiles."""
    grid = _grid(ep_group, grid)
    mode = _opt_mode(opt_sharding_mode)
    if device is None and grid is not None:
        device = grid.world.device
    params = init_params(cfg, seed=seed, device=device)
    if grid is not None and grid.axis_sizes:
        # copy the rank's tiles (expert slices, tp shards, fsdp tiles), so
        # that the whole leaves are freed
        sizes = grid.axis_sizes
        params = tree_map(lambda s, t: s.clone() if s.shape != t.shape else s,
                          rank_shard(params, placements(cfg, params, sizes, fsdp=fsdp),
                                     grid.coords, sizes),
                          params)
    pd = _dtype(train.param_dtype)
    if mode == "none" or grid is None:
        return TrainState(tree_map(lambda p: p.to(pd), params), adamw_init(params))
    plan, _ = opt_layout(cfg, grid, mode, fsdp=fsdp)
    master = _cut(tree_map(lambda p: p.detach().to(torch.float32), params), plan, grid)
    opt = AdamWState(torch.zeros((), dtype=torch.int32, device=params["embed"]["table"].device),
                     master, tree_map(torch.zeros_like, master),
                     tree_map(torch.zeros_like, master))
    # the params no longer share the master's tensors: each step writes the
    # gathered update into them
    return TrainState(tree_map(lambda p: p.to(pd, copy=True), params), opt)


def make_train_step(cfg: ModelConfig, parallel: ParallelConfig, train: TrainConfig, *,
                    opt_sharding_mode: Optional[str] = None, placement=None,
                    ep_group: Optional[EPGroup] = None, grid: Optional[ProcessGrid] = None):
    """Build ``train_step(state, batch) -> (state, metrics)``. batch:
    {"tokens", "labels"}, each (global_batch, seq) int, or on a grid (or
    ``ep_group``) the rank's rows of it (every rank the same count); labels
    < 0 are masked. The step updates the state in place and returns it;
    metrics are device tensors, on a grid the same on every rank: loss, lr,
    ce, grad_norm, clip_scale and, for MoE, moe_counts (every expert),
    moe_load and moe_drops (with one microbatch also moe_aux, moe_z and
    ntok, as in the JAX step). ``opt_sharding_mode``: 'none' (None),
    'so' or 'epso', the layout ``init_state`` gave the state; the SO/EPSO
    collectives are scheduled by ``parallel.opt_overlap``
    (``optim.overlap.resolve_opt_overlap``). The update plan is built here,
    once. ``placement``: the ``ExpertPlacement`` the state's expert stacks
    are stored in (None or the identity: global-id order); the metrics stay
    in global ids. ``parallel.fsdp_params``: the state is the one
    ``init_state(fsdp=True)`` gives (the module docstring);
    ``train_step.fsdp_gather`` is then its ``parallel.fsdp.LayerGather``,
    whose ``stats`` count the gathers, the reduce-scatters and the bytes
    gathered. With ``parallel.pp_stages`` > 1 the step pipelines (the
    module docstring; its metrics, as the JAX PP step's: loss, lr, ce,
    grad_norm, clip_scale and, for MoE, moe_counts, moe_load, moe_drops),
    and ``train_step.loss_and_grads(params, batch) -> (loss, metrics,
    grads)`` is its pipelined half alone; ``train_step.saved_peak`` holds,
    after a step, the most stage inputs each of the process's stages kept
    saved at once, and ``train_step.router_terms`` the step's ``moe_aux``
    and ``moe_z`` (the per-layer means over the microbatches, as
    ``loss_fn``'s metrics; the JAX PP step's metrics leave them out)."""
    pl_inv = _placement_rows(cfg, placement)
    grid = _grid(ep_group, grid)
    mode = _opt_mode(opt_sharding_mode)
    ov_impl = resolve_opt_overlap(parallel.opt_overlap, mode,
                                  grid.axis_sizes if grid is not None else None)
    if (parallel.moe_dispatch is not None and cfg.moe is not None
            and cfg.moe.dispatch != parallel.moe_dispatch):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=parallel.moe_dispatch))
    cd = _dtype(train.compute_dtype)
    pd = _dtype(train.param_dtype)
    rd = _dtype(train.grad_reduce_dtype)
    nmb = parallel.microbatches
    sac = parallel.remat_policy
    sharded = _shards_experts(cfg, grid)
    sharded_opt = mode != "none" and grid is not None
    pp = parallel.pp_stages
    gpp = grid.pp.world if grid is not None else 1    # the stages a grid splits over 'pp'
    if pp > 1:
        if cfg.arch_type not in PP_ARCH_TYPES:
            raise ValueError(f"pp_stages={pp} needs arch_type in {PP_ARCH_TYPES}, "
                             f"not {cfg.arch_type!r}")
        if pl_inv is not None:
            raise NotImplementedError(
                "a non-identity expert placement is not threaded through the "
                "pipeline executors yet (rebalance requires pp=1)")
        _check_stage_divisible(cfg.num_layers, pp, cfg.name)
        if parallel.pp_impl == "shardmap" and gpp > 1:
            check_pp_microbatches(max(nmb, 1), pp)
        ticks = schedule_ticks(parallel.pp_schedule, max(nmb, 1), pp)
    if gpp not in (1, pp):
        raise ValueError(f"the grid's 'pp' axis has {gpp} stages, the step pp_stages={pp}")
    fsdp = parallel.fsdp_params
    if fsdp and not {"block", "block_sc"} & set(sac.split(",")):
        refuse(f"fsdp under remat_policy={sac!r} (autograd would keep every layer's "
               f"gathered weights; take 'block' or 'block_sc')", FSDP_ITEM)
    split_axes = tp_split = pp_split = ep_split = data_split = gather = None
    if grid is not None:
        # per leaf, the grid axes splitting it (its gradient is summed over
        # the batch axes that do not), and whether 'tp' does
        tree = placements(cfg, init_params(cfg, device="meta"), grid.axis_sizes, fsdp=fsdp)
        place = leaves(tree)
        split_axes = [{a for e in pl for a in e} for pl in place]
        tp_split = tuple("tp" in ax for ax in split_axes)
        pp_split = tuple("pp" in ax for ax in split_axes)
        ep_split = tuple("ep" in ax for ax in split_axes)
        if any("data" in ax for ax in split_axes):
            data_split = tuple("data" in ax for ax in split_axes)
            gather = LayerGather(tree, grid.data, rd, cd)
    if sharded_opt:
        # 'off': the same sharded math with every leaf its own bucket
        plan, state_specs = opt_layout(cfg, grid, mode,
                                       max_bucket_bytes=0 if ov_impl == "off" else
                                       DEFAULT_BUCKET_BYTES, fsdp=fsdp)

    rows_on = {}

    def placement_rows(dev):
        """The (L, E) int64 id -> position rows on ``dev``, or None."""
        if pl_inv is None:
            return None
        if dev not in rows_on:
            rows_on[dev] = torch.as_tensor(pl_inv, dtype=torch.int64, device=dev)
        return rows_on[dev]

    def split_mb(batch: dict, n: int) -> list:
        """The ``n`` microbatches of a batch, row blocks in order (the PP and
        the accumulation paths share it, so their splits cannot diverge)."""
        if batch["tokens"].shape[0] % n:
            raise ValueError(f"batch of {batch['tokens'].shape[0]} rows does not split "
                             f"into {n} microbatches")
        return [dict(zip(batch, vals)) for vals in zip(*(t.chunk(n) for t in batch.values()))]

    def pp_loss_and_grads(params: dict, batch: dict):
        """The pipelined loss, metrics and gradients (f32, the rank's own,
        not yet summed over the ranks) of one batch."""
        n_mb = max(nmb, 1)
        mbs = split_mb(batch, n_mb)
        dev = batch["tokens"].device
        last, per = pp - 1, cfg.num_layers // pp
        stages = [grid.pp.rank] if gpp > 1 else list(range(pp))
        io = {k: v for k, v in params.items() if k != "layers"}
        io_in = tree_map(lambda p: p.detach().requires_grad_(), io)
        io_flat = leaves(io_in)
        lay = params["layers"]
        lay_flat = leaves(lay)
        g_io = [torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in io_flat]
        g_lay = [torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in lay_flat]
        ep = grid.ep if grid is not None else None
        tpg = grid.tp if grid is not None else None
        vocab = table_split(io, cfg, ep, tpg)
        rows = grid.group(BATCH_AXES) if grid is not None else None
        n_rows = rows.world if rows is not None else 1
        moe = cfg.is_moe
        ca = cfg.moe.router_aux_coef if moe else 0.0
        cz = cfg.moe.router_z_coef if moe else 0.0
        nl = max(cfg.num_layers, 1)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        # per process, summed over its stages and the microbatches: ce, aux, z
        # (then, for MoE, the counts and drops)
        sums = [zero] * 3 + ([torch.zeros(cfg.moe.num_experts, device=dev), zero] if moe else [])
        ntok = {}

        def layer_rows(s):
            return slice(None) if gpp > 1 else slice(s * per, (s + 1) * per)

        def stage_tree(s, flat):
            return unflatten(lay, [t[layer_rows(s)] for t in flat])

        def run_stage(lp, h):
            return pipeline_stage_forward(lp, h, cfg, sac=sac, ep_group=ep, tp_group=tpg,
                                          batch_group=rows, fsdp=gather)

        def forward(s, m, x):
            with torch.no_grad():
                h = embed_tokens(io, x, cfg, compute_dtype=cd, vocab=vocab) if s == 0 else x
                h, aux, z, st = run_stage(stage_tree(s, lay_flat), h)
                sums[1], sums[2] = sums[1] + aux, sums[2] + z
                if moe:
                    sums[3], sums[4] = sums[3] + st.counts, sums[4] + st.drops
                if s == last:
                    nll, n = lm_head_nll(io, h, mbs[m]["labels"], cfg, vocab)
                    if rows is not None:
                        nll, n = all_reduce_sum(torch.stack([nll, n.float()]), rows).unbind()
                    ntok[m] = torch.clamp(n, min=1)
                    sums[0] = sums[0] + nll / ntok[m]
            return h

        def backward(s, m, x, dy):
            lp_in = [t[layer_rows(s)].detach().requires_grad_() for t in lay_flat]
            inputs = lp_in + io_flat
            with torch.enable_grad():
                if s == 0:
                    h = embed_tokens(io_in, x, cfg, compute_dtype=cd, vocab=vocab)
                else:
                    h = x = x.detach().requires_grad_()
                    inputs.append(x)
                h, aux, z, _ = run_stage(unflatten(lay, lp_in), h)
                outs, cots = [], []
                if s == last:
                    nll, _ = lm_head_nll(io_in, h, mbs[m]["labels"], cfg, vocab)
                    obj = nll / ntok[m]
                else:
                    outs, cots, obj = [h], [dy], None
                if moe:
                    # the router terms, the whole microbatch's on every rank of
                    # the stage: each rank takes 1 / n_rows of them, because the
                    # backward of their sum over the batch group adds the
                    # ranks' cotangents, so each rank's probabilities get the
                    # whole term's gradient once
                    r = (ca * aux + cz * z) / nl / n_rows
                    obj = r if obj is None else obj + r
                if obj is not None:
                    outs.append(obj)
                    cots.append(None)
                gs = torch.autograd.grad(outs, inputs, grad_outputs=cots, allow_unused=True)
            sl = layer_rows(s)
            accs = [a[sl] for a in g_lay] + g_io
            for acc, g in zip(accs, gs):
                if g is not None:           # a leaf the stage does not use
                    acc.add_(g.float())
            return gs[-1] if s > 0 else None

        link = None
        if gpp > 1:
            b, sq = mbs[0]["tokens"].shape
            link = StageLink(grid, (b, sq, cfg.d_model), cd, dev)
        train_step.saved_peak = run_schedule(ticks, pp, stages, forward=forward,
                                             backward=backward, link=link,
                                             entry=lambda m: mbs[m]["tokens"])
        train_step.sent_bytes = link.sent_bytes if link is not None else 0
        grads = dict(unflatten(io, g_io), layers=unflatten(lay, g_lay))
        for g in leaves(grads):
            g.div_(n_mb)
        vec = torch.cat([torch.stack(sums[:3])] + ([sums[3], sums[4][None]] if moe else []))
        if grid is not None:
            # ce from the last stage, the rest summed over the stages (a
            # stage's router terms, counts and drops are already the whole
            # microbatch's on each of its ranks)
            vec = all_reduce_sum(vec, grid.pp)
        ce, aux, z = vec[0] / n_mb, vec[1] / n_mb, vec[2] / n_mb
        loss = ce + (ca * aux + cz * z) / nl
        train_step.router_terms = {"moe_aux": aux / nl, "moe_z": z / nl}
        metrics = {"ce": ce}
        if moe:
            # summed over every layer and microbatch; the per-layer mean makes
            # the counts sum to the whole step's routed pairs
            counts = vec[3:-1] / nl
            metrics["moe_counts"] = counts
            metrics["moe_load"] = counts / torch.clamp(counts.sum(), min=1.0)
            metrics["moe_drops"] = vec[-1]
        return loss, metrics, grads

    def train_step(state: TrainState, batch: dict):
        if pp > 1:
            loss, metrics, grads = pp_loss_and_grads(state.params, batch)
            state, om = update(state, grads)
            return state, {"loss": loss, **metrics, **om}
        mbs = split_mb(batch, nmb)
        leaf = tree_map(lambda p: p.detach().requires_grad_(), state.params)
        flat = leaves(leaf)
        loss = torch.zeros((), device=batch["tokens"].device)
        rows = placement_rows(batch["tokens"].device)
        acc = sums = None
        for mb in mbs:
            mb_loss, metrics = loss_fn(leaf, mb, cfg, sac=sac, compute_dtype=cd, ep_group=grid,
                                       placement=rows, fsdp=gather)
            gs = torch.autograd.grad(mb_loss, flat, allow_unused=True, materialize_grads=True)
            gs = [g.float() for g in gs]            # f32 gradient sums
            acc = gs if acc is None else [a.add_(g) for a, g in zip(acc, gs)]
            # on a grid mb_loss is the rank's share; metrics carry the global loss
            loss = loss + (metrics.pop("loss") if grid is not None else mb_loss.detach())
            metrics = {k: v_.detach() for k, v_ in metrics.items()}
            sums = metrics if sums is None else {k: sums[k] + metrics[k] for k in sums}
        grads = unflatten(leaf, acc)
        del leaf, flat, acc
        if nmb > 1:
            for g in leaves(grads):
                g.div_(nmb)
            loss = loss / nmb
            metrics = {"ce": sums["ce"] / nmb}
            if cfg.is_moe:
                # counts and drops are totals over the whole global batch
                metrics["moe_counts"] = sums["moe_counts"]
                metrics["moe_load"] = sums["moe_counts"] / torch.clamp(
                    sums["moe_counts"].sum(), min=1.0)
                metrics["moe_drops"] = sums["moe_drops"]
        else:
            metrics = sums
        state, om = update(state, grads)
        return state, {"loss": loss, **metrics, **om}

    def update(state: TrainState, grads: dict):
        """The optimizer tail on the rank's gradients (f32, not yet summed
        over the ranks): the paper's bf16 gradient reduction (round, sum
        over the ranks in ``grad_reduce_dtype``, update in f32), LR, clip,
        AdamW in the state's layout. Returns (state, {lr, grad_norm,
        clip_scale})."""
        for g in leaves(grads):
            g.copy_(g.to(rd))
        step = state.opt.step
        lr = warmup_cosine(step, lr_peak=train.lr_peak, lr_min=train.lr_min,
                           warmup_steps=train.warmup_steps, total_steps=train.total_steps)
        clip_on = step >= train.warmup_steps if train.clip_after_warmup_only else None
        hyper = dict(lr=lr, beta1=train.beta1, beta2=train.beta2, eps=train.eps,
                     weight_decay=train.weight_decay, grad_clip=train.grad_clip,
                     clip_enabled=clip_on, expert_norm=expert_norm(state.params))
        if sharded_opt:
            new_opt, om = overlapped_adamw_update(
                leaves(grads), state.opt, leaves(state.params), plan=plan, grid=grid,
                impl=ov_impl, state_specs=state_specs, grad_reduce_dtype=rd, **hyper)
            return TrainState(state.params, new_opt), {"lr": lr, **om}
        if grid is not None:
            _sum_gradients(grads, rd, grid)
        new_params, new_opt, om = adamw_update(
            grads, state.opt, param_dtype=pd, group=grid.ep if sharded else None,
            tp=grid.tp if grid is not None else None, tp_split=tp_split,
            pp=grid.pp if grid is not None else None, pp_split=pp_split,
            ep=grid.ep if grid is not None else None, ep_split=ep_split,
            data=grid.data if data_split else None, data_split=data_split, **hyper)
        return TrainState(new_params, new_opt), {"lr": lr, **om}

    def expert_norm(params):
        if cfg.moe is None:
            return None
        held = cfg.moe.num_experts // grid.ep.world if sharded else cfg.moe.num_experts
        mask = expert_leaf_mask(params, cfg.num_layers // gpp, held)
        return (mask, placement_rows(leaves(params)[0].device)) if any(mask) else None

    def _sum_gradients(grads, dtype, grid):
        """Sum each gradient over the axes of ``SUM_AXES`` that do not split
        its leaf, in ``dtype``, one flat buffer per set of axes: the whole
        leaves' over ('data', 'pp', 'ep'), the layer tiles' over ('data',
        'ep'), the expert slices' over 'data', a table split on 'ep' over
        ('data', 'pp') (its gradient already covers every 'ep' rank's
        tokens, ``parallel.vocab``), the fsdp tiles' (their sum
        over 'data' was the gather's reduce-scatter) over 'ep' where it
        does not split them: a layer tile's over 'ep', an expert stack's
        over none. Never over 'tp' (not in ``SUM_AXES``), and a stage's
        layers never over 'pp' (their placement uses it). The sums are
        gloo all-reduces, which may add a buffer's elements in an order
        that depends on their offset once a group has 3 ranks or more: an
        expert slice's sum is the same bits across an expert move for dp
        <= 2 alone."""
        by_axes = {}
        for g, split in zip(leaves(grads), split_axes):
            by_axes.setdefault(tuple(a for a in SUM_AXES if a not in split), []).append(g)
        for axes, gs in by_axes.items():
            group = grid.group(axes)
            if group.world == 1:
                continue
            flat = torch.cat([g.reshape(-1).to(dtype) for g in gs])
            flat = all_reduce_sum(flat, group)
            for g, part in zip(gs, flat.split([g.numel() for g in gs])):
                g.copy_(part.view_as(g))

    # the optimizer tail alone, and the overlap impl it runs, for callers
    # that drive or record the update (the card tests, chip_smoke)
    train_step.update = update
    train_step.opt_overlap_impl = ov_impl
    train_step.fsdp_gather = gather
    if pp > 1:
        train_step.loss_and_grads = pp_loss_and_grads
    return train_step


def _placement_rows(cfg: ModelConfig, placement):
    """The (L, E) inverse rows of a non-identity ``placement`` (numpy), or
    None; a placement that does not fit ``cfg`` raises."""
    if placement is None:
        return None
    if not isinstance(placement, ExpertPlacement):
        raise TypeError(f"placement must be an ExpertPlacement or None, got "
                        f"{type(placement).__name__}")
    if cfg.moe is None or (placement.num_layers, placement.num_experts) != (
            cfg.num_layers, cfg.moe.num_experts):
        want = (cfg.num_layers, cfg.moe.num_experts) if cfg.moe is not None else "no experts"
        raise ValueError(f"placement of ({placement.num_layers}, {placement.num_experts}) "
                         f"(layers, experts) for {cfg.name}: {want}")
    return None if placement.is_identity else placement.inverse_array()


def _on(dev: torch.device, params: dict, what: str) -> None:
    table = params["embed"]["table"]
    if table.device.type != dev.type:
        raise ValueError(f"{what}: params live on {table.device}, the step runs on {dev}")


def make_prefill_step(cfg: ModelConfig, *, compute_dtype: torch.dtype = torch.bfloat16,
                      into_cache: bool = False, device: DeviceLike = None, plan=None,
                      grid: Optional[ProcessGrid] = None):
    """``into_cache=False``: the prefill lowering, ``prefill_step(params,
    batch) -> last-position logits (B, V_pad)``: the forward over
    batch["tokens"] (B, S) with flash attention, under ``no_grad`` (every
    arch of ``models.model.ARCHS``: the hybrid model's Mamba-2 layers run
    the SSD kernel, Mamba-1 layers their plain scan). ``into_cache=True``: the
    serve engine's admission lowering, ``prefill_step(params, tokens, cache,
    slots, lengths) -> (last_logits, cache)`` through
    ``models.prefill_with_cache`` on the dropless config (attention-KV archs
    only). Runs on ``cuda`` unless ``device`` says otherwise; token inputs
    are moved there, params must already live there. ``plan`` and ``grid``
    (the JAX lowering's ``plan=``): serving on the plan's 'ep' x 'tp' grid
    (``serve.engine.serving_grid``): the params are this rank's tiles, the
    cache holds its kv heads, every rank takes the same tokens and returns
    the whole logits; the device is the grid's."""
    grid = serving_grid(cfg, plan, grid)
    dev = resolve_device(device if device is not None or grid is None else grid.world.device)
    if into_cache:
        scfg = dropless_cfg(cfg)

        def prefill_into_cache(params, tokens, cache, slots, lengths):
            _on(dev, params, "prefill_step")
            with torch.no_grad():
                return prefill_with_cache(params, tokens.to(dev), cache, slots, lengths, scfg,
                                          compute_dtype=compute_dtype, grid=grid)

        return prefill_into_cache

    ep, tpg = (grid.ep, grid.tp) if grid is not None else (None, None)

    def prefill_step(params, batch: dict):
        _on(dev, params, "prefill_step")
        with torch.no_grad():
            logits, _ = forward(params, {"tokens": batch["tokens"].to(dev)}, cfg, sac="",
                                compute_dtype=compute_dtype, attn_impl="flash", ep_group=ep,
                                tp_group=tpg, replicated=grid is not None)
            return logits[:, -1]

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, compute_dtype: torch.dtype = torch.bfloat16,
                    sample: bool = False, device: DeviceLike = None, plan=None,
                    grid: Optional[ProcessGrid] = None):
    """``serve_step(params, tokens, cache, index) -> (logits (B, 1, V_pad),
    cache)``: one ``decode_step``; ``index`` is a scalar (lockstep batch)
    or (B,) per-row positions. The cache is updated in place. An ssm or
    hybrid model prefills by stepping it over the prompt. With ``sample=True``
    returns the serve engine's decode function (``serve.make_decode_fn``:
    ``(params, tokens, cache, positions, seeds, temperature, top_k, top_p)
    -> (next_tokens, cache)``). Runs on ``cuda`` unless ``device`` says
    otherwise. ``plan`` and ``grid``: as in ``make_prefill_step``."""
    grid = serving_grid(cfg, plan, grid)
    dev = resolve_device(device if device is not None or grid is None else grid.world.device)
    if sample:
        decode_fn = make_decode_fn(cfg, compute_dtype=compute_dtype, grid=grid)

        def sample_step(params, tokens, cache, *args):
            _on(dev, params, "serve_step")
            with torch.no_grad():
                return decode_fn(params, tokens.to(dev), cache, *args)

        return sample_step

    def serve_step(params, tokens, cache, index):
        _on(dev, params, "serve_step")
        if torch.is_tensor(index):
            index = index.to(dev)
        with torch.no_grad():
            return decode_step(params, tokens.to(dev), cache, index, cfg,
                               compute_dtype=compute_dtype, grid=grid)

    return serve_step
