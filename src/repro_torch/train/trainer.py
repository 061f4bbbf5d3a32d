"""The training step, on one device or expert-parallel over an EP group,
and the serving lowerings: port of the JAX package's ``train/trainer.py``
(``TrainState``, ``init_state``, ``make_train_step``,
``make_prefill_step``, ``make_serve_step``).

The paper's recipe (§2.1): bf16 forward and backward on fp32 params
(cast inside the layers), gradient accumulation over microbatches in f32,
the gradient rounded to ``grad_reduce_dtype`` (bf16) as the reduction
would, warmup + cosine LR, global-norm clipping only after warmup, AdamW on
fp32 master weights. The MoE expert stacks take their grad-norm share per
(layer, expert) slice, as the JAX step does.

Expert parallelism (``ep_group``, a ``parallel.EPGroup``; the layout of the
JAX package's ``ep`` role): each rank holds its slice of the expert stacks
and a whole copy of every other leaf, and takes its rows of the batch. It
backpropagates its share of the global loss (``models.loss_fn``); the
replicated leaves' gradients, rounded to ``grad_reduce_dtype``, are summed
over the ranks in that dtype, while the expert slices' gradients arrive
whole through the collectives' backward. The grad norm counts each expert
slice and each replicated leaf once, so every rank takes the same step.

Not ported, and raising ``NotImplementedError``: pipeline stages, a
sharded optimizer state (``opt_sharding_mode`` other than 'none'), an
optimizer overlap ('ring' or 'xla'), an expert placement; under EP also the
all-to-all Stage 1 and expert-TP (``core.moe.moe_fsmoe_ep``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import (decode_step, forward, init_params, loss_fn,
                                      prefill_with_cache)
from repro_torch.core.moe import uses_ep
from repro_torch.optim import (AdamWState, adamw_init, adamw_update, expert_leaf_mask,
                               warmup_cosine)
from repro_torch.parallel.ep import EPGroup, all_reduce_sum
from repro_torch.parallel.sharding import expert_shard, replicated_leaves
from repro_torch.serve.engine import dropless_cfg, make_decode_fn
from repro_torch.tree import leaves, tree_map


class TrainState(NamedTuple):
    params: dict          # params in TrainConfig.param_dtype
    opt: AdamWState       # fp32 master + moments


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _shards_experts(cfg: ModelConfig, ep_group: Optional[EPGroup]) -> bool:
    """Whether ``ep_group`` splits this model's expert stacks."""
    return ep_group is not None and cfg.is_moe and uses_ep(cfg.moe, ep_group.world)


def init_state(cfg: ModelConfig, train: TrainConfig, *, seed: int = 0,
               device: DeviceLike = None, ep_group: Optional[EPGroup] = None) -> TrainState:
    """Random params (``init_params`` from ``seed``) and a fresh AdamW
    state, on ``cuda`` unless ``device`` says otherwise (under EP, the
    group's device). With ``ep_group``: the rank's share of the state that
    ``init_state(cfg, train, seed=seed)`` gives on one process."""
    if device is None and ep_group is not None:
        device = ep_group.device
    params = init_params(cfg, seed=seed, device=device)
    if _shards_experts(cfg, ep_group):
        # copy the rank's expert slices, so that the whole stacks are freed
        params = tree_map(lambda s, t: s.clone() if s.shape != t.shape else s,
                          expert_shard(params, ep_group.rank, ep_group.world), params)
    opt = adamw_init(params)
    pd = _dtype(train.param_dtype)
    return TrainState(tree_map(lambda p: p.to(pd), params), opt)


def make_train_step(cfg: ModelConfig, parallel: ParallelConfig, train: TrainConfig, *,
                    opt_sharding_mode: Optional[str] = None, placement=None,
                    ep_group: Optional[EPGroup] = None):
    """Build ``train_step(state, batch) -> (state, metrics)``. batch:
    {"tokens", "labels"}, each (global_batch, seq) int, or under
    ``ep_group`` the rank's rows of it (every rank the same count); labels
    < 0 are masked. The step updates the optimizer state in place and
    returns the new state; metrics are device tensors, under EP the same on
    every rank: loss, lr, ce, grad_norm, clip_scale and, for MoE,
    moe_counts (every expert), moe_load and moe_drops (with one microbatch
    also moe_aux, moe_z and ntok, as in the JAX step)."""
    if parallel.pp_stages > 1:
        raise NotImplementedError("pipeline parallelism needs a mesh; the port's "
                                  "trainer runs on one device")
    if opt_sharding_mode not in (None, "none"):
        raise NotImplementedError(f"optimizer sharding {opt_sharding_mode!r} needs a mesh")
    if parallel.opt_overlap in ("ring", "xla"):
        raise NotImplementedError(f"optimizer overlap {parallel.opt_overlap!r} needs a mesh")
    if placement is not None:
        raise NotImplementedError("expert placement is not ported")
    if (parallel.moe_dispatch is not None and cfg.moe is not None
            and cfg.moe.dispatch != parallel.moe_dispatch):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=parallel.moe_dispatch))
    cd = _dtype(train.compute_dtype)
    pd = _dtype(train.param_dtype)
    rd = _dtype(train.grad_reduce_dtype)
    nmb = parallel.microbatches
    sac = parallel.remat_policy
    sharded = _shards_experts(cfg, ep_group)

    def train_step(state: TrainState, batch: dict):
        if batch["tokens"].shape[0] % nmb:
            raise ValueError(f"batch of {batch['tokens'].shape[0]} rows does not split "
                             f"into {nmb} microbatches")
        leaf = tree_map(lambda p: p.detach().requires_grad_(), state.params)
        flat = leaves(leaf)
        mbs = [dict(zip(batch, vals)) for vals in zip(*(t.chunk(nmb) for t in batch.values()))]
        loss = torch.zeros((), device=batch["tokens"].device)
        acc = sums = None
        for mb in mbs:
            mb_loss, metrics = loss_fn(leaf, mb, cfg, sac=sac, compute_dtype=cd,
                                       ep_group=ep_group)
            gs = torch.autograd.grad(mb_loss, flat, allow_unused=True, materialize_grads=True)
            gs = [g.float() for g in gs]            # f32 gradient sums
            acc = gs if acc is None else [a.add_(g) for a, g in zip(acc, gs)]
            # under EP mb_loss is the rank's share; metrics carry the global loss
            loss = loss + (metrics.pop("loss") if ep_group is not None else mb_loss.detach())
            metrics = {k: v_.detach() for k, v_ in metrics.items()}
            sums = metrics if sums is None else {k: sums[k] + metrics[k] for k in sums}
        index = {id(p): i for i, p in enumerate(flat)}
        grads = tree_map(lambda p: acc[index[id(p)]], leaf)
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
        # the paper's bf16 gradient reduction: round, then update in f32
        for g in leaves(grads):
            g.copy_(g.to(rd))
        if ep_group is not None:
            _sum_replicated(grads, rd, ep_group)

        step = state.opt.step
        lr = warmup_cosine(step, lr_peak=train.lr_peak, lr_min=train.lr_min,
                           warmup_steps=train.warmup_steps, total_steps=train.total_steps)
        clip_on = step >= train.warmup_steps if train.clip_after_warmup_only else None
        new_params, new_opt, om = adamw_update(
            grads, state.opt, lr=lr, beta1=train.beta1, beta2=train.beta2, eps=train.eps,
            weight_decay=train.weight_decay, grad_clip=train.grad_clip,
            clip_enabled=clip_on, param_dtype=pd, expert_norm=expert_norm(state.params),
            group=ep_group if sharded else None)
        return TrainState(new_params, new_opt), {"loss": loss, "lr": lr, **metrics, **om}

    def expert_norm(params):
        if cfg.moe is None:
            return None
        held = cfg.moe.num_experts // ep_group.world if sharded else cfg.moe.num_experts
        mask = expert_leaf_mask(params, cfg.num_layers, held)
        return (mask, None) if any(mask) else None

    def _sum_replicated(grads, dtype, group):
        """Sum the replicated leaves' gradients over the ranks, in ``dtype``,
        as one flat buffer (one collective)."""
        keep = replicated_leaves(grads) if sharded else (True,) * len(leaves(grads))
        rep = [g for g, k in zip(leaves(grads), keep) if k]
        flat = torch.cat([g.reshape(-1).to(dtype) for g in rep])
        flat = all_reduce_sum(flat, group)
        for g, part in zip(rep, flat.split([g.numel() for g in rep])):
            g.copy_(part.view_as(g))

    return train_step


def _on(dev: torch.device, params: dict, what: str) -> None:
    table = params["embed"]["table"]
    if table.device.type != dev.type:
        raise ValueError(f"{what}: params live on {table.device}, the step runs on {dev}")


def make_prefill_step(cfg: ModelConfig, *, compute_dtype: torch.dtype = torch.bfloat16,
                      into_cache: bool = False, device: DeviceLike = None):
    """``into_cache=False``: the prefill lowering, ``prefill_step(params,
    batch) -> last-position logits (B, V_pad)``: the forward over
    batch["tokens"] (B, S) with flash attention (any arch; the hybrid
    model's Mamba-2 layers run the SSD kernel). ``into_cache=True``: the
    serve engine's admission lowering, ``prefill_step(params, tokens, cache,
    slots, lengths) -> (last_logits, cache)`` through
    ``models.prefill_with_cache`` on the dropless config (attention-KV archs
    only). Runs on ``cuda`` unless ``device`` says otherwise; token inputs
    are moved there, params must already live there."""
    dev = resolve_device(device)
    if into_cache:
        scfg = dropless_cfg(cfg)

        def prefill_into_cache(params, tokens, cache, slots, lengths):
            _on(dev, params, "prefill_step")
            with torch.no_grad():
                return prefill_with_cache(params, tokens.to(dev), cache, slots, lengths, scfg,
                                          compute_dtype=compute_dtype)

        return prefill_into_cache

    def prefill_step(params, batch: dict):
        _on(dev, params, "prefill_step")
        with torch.no_grad():
            logits, _ = forward(params, {"tokens": batch["tokens"].to(dev)}, cfg, sac="",
                                compute_dtype=compute_dtype, attn_impl="flash")
            return logits[:, -1]

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, compute_dtype: torch.dtype = torch.bfloat16,
                    sample: bool = False, device: DeviceLike = None):
    """``serve_step(params, tokens, cache, index) -> (logits (B, 1, V_pad),
    cache)``: one ``decode_step``; ``index`` is a scalar (lockstep batch)
    or (B,) per-row positions. The cache is updated in place. A hybrid
    model prefills by stepping it over the prompt. With ``sample=True``
    returns the serve engine's decode function (``serve.make_decode_fn``:
    ``(params, tokens, cache, positions, seeds, temperature, top_k, top_p)
    -> (next_tokens, cache)``). Runs on ``cuda`` unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    if sample:
        decode_fn = make_decode_fn(cfg, compute_dtype=compute_dtype)

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
                               compute_dtype=compute_dtype)

    return serve_step
