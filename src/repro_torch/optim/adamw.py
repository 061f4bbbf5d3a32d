"""AdamW with the paper's mixed-precision recipe (§1, §2.1): port of the JAX
package's ``optim/adamw.py``.

* bf16 weights and gradients in the forward and backward,
* fp32 master weights and fp32 (m, v) optimizer states,
* global-norm gradient clipping, optionally only after warmup,
* decoupled weight decay on every parameter.

The update math is ``adamw_leaf``, written as the JAX package writes it
(not ``torch.optim.AdamW``, whose update differs). ``adamw_update`` applies
it leaf by leaf and writes the results into the state's tensors in place
(the JAX version returns new arrays): the optimizer state of a full-width
layer stack is tens of GB, and a second copy would not fit beside it. It
walks a stacked leaf one layer at a time to bound the temporaries.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.parallel.ep import all_gather_dim, all_gather_tokens, all_reduce_sum
from repro_torch.parallel.placement import is_expert_stack
from repro_torch.tree import leaves, leaves_with_path, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32 scalar
    master: dict              # fp32 master weights (tree like params)
    m: dict                   # fp32 first moment
    v: dict                   # fp32 second moment


def adamw_init(params) -> AdamWState:
    """Step 0, fp32 master weights and zero moments. A float32 param and
    its master weight share one tensor (``Tensor.to`` to the same dtype
    does not copy), so the in-place update moves both."""
    first = leaves(params)[0]
    return AdamWState(torch.zeros((), dtype=torch.int32, device=first.device),
                      tree_map(lambda p: p.detach().to(torch.float32), params),
                      tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
                      tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def expert_leaf_mask(tree, num_layers: int, num_experts: int) -> tuple:
    """Per-leaf booleans in leaf order: True where the leaf is a routed
    expert stack, whose grad-norm share ``global_norm`` takes per (layer,
    expert) slice."""
    return tuple(is_expert_stack(path, tuple(leaf.shape), num_layers, num_experts)
                 for path, leaf in leaves_with_path(tree))


def sum_in_rank_order(s: torch.Tensor, group) -> torch.Tensor:
    """``s`` summed over ``group``, the ranks' values added in rank order:
    every element associates the same way wherever it lies in ``s`` (an
    all-reduce may add each chunk of its buffer in another order)."""
    parts = all_gather_dim(s[None], group, 0)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def expert_slice_sumsq(g: torch.Tensor, inv=None, group=None, tp=None,
                       pp=None, data=None) -> torch.Tensor:
    """Squared sum of an (L, E, ...) expert-stack gradient with a canonical
    association: per-(layer, expert) slice sums first, reordered to global
    expert ids when ``inv`` (the (L, E) id -> position map of a placement)
    is given, then one (L, E) sum. With an EP ``group`` ``g`` is the rank's
    (L, E / world, ...) slice: the slice sums of all ranks are gathered in
    rank (= expert) order first, so every expert counts once and the sum
    associates as on one device. With a 'tp' group ``tp`` ``g`` holds the
    rank's d_ff shard, and with a 'data' group ``data`` (fsdp) the rank's
    tile of a per-slice dim: the slice sums are summed over 'tp', then
    over 'data', each in rank order (``sum_in_rank_order``), so that a
    slice's sum does not depend on the position an expert placement gives
    it, at any group size (an all-reduce may associate an element by its
    offset in the buffer). With a
    'pp' group ``pp`` ``g`` holds the rank's stage of the layers: the slice
    sums of the stages are gathered in stage (= layer) order."""
    return reduce_slice_sums(torch.sum(torch.square(g.float()), dim=tuple(range(2, g.ndim))),
                             inv, group, tp, pp, data)


def reduce_slice_sums(s: torch.Tensor, inv=None, group=None, tp=None, pp=None,
                      data=None) -> torch.Tensor:
    """The total of a rank's (L, E') per-(layer, expert) slice sums ``s``
    over the groups, as ``expert_slice_sumsq`` takes it."""
    if tp is not None and tp.world > 1:
        s = sum_in_rank_order(s, tp)
    if data is not None and data.world > 1:
        s = sum_in_rank_order(s, data)
    if group is not None:
        s = all_gather_tokens(s.T.contiguous(), group).T.contiguous()
    if pp is not None and pp.world > 1:
        s = all_gather_tokens(s, pp)
    if inv is not None:
        s = torch.gather(s, 1, inv.long())
    return torch.sum(s)


def global_norm(grads, *, expert_norm=None, group=None, tp=None, tp_split=None, pp=None,
                pp_split=None, data=None, data_split=None, ep=None,
                ep_split=None) -> torch.Tensor:
    """Global L2 norm of a gradient tree. ``expert_norm``, when given, is a
    ``(mask, inv)`` pair: leaves flagged in ``mask`` contribute through
    ``expert_slice_sumsq``; ``None`` keeps the plain whole-leaf sums. With
    an EP ``group`` the flagged leaves are the rank's expert slices and
    are gathered over the group; every other leaf is the same on every
    rank and counts once. With a 'tp' group ``tp``, the leaves flagged in
    ``tp_split`` are the rank's tp shards: their squares are summed over
    'tp' (one all-reduce for the others, inside ``expert_slice_sumsq`` for
    the expert stacks); with a 'pp' group ``pp`` likewise the leaves
    flagged in ``pp_split``, the rank's stage of the layers, over 'pp';
    with a 'data' group ``data`` the leaves flagged in ``data_split``, the
    rank's fsdp tiles, over 'data'; and with an 'ep' group ``ep`` the
    leaves flagged in ``ep_split`` other than the expert stacks (a table
    split on its vocab rows), over 'ep'. An expert stack cut on its expert dim
    by 'data' no longer matches ``expert_norm``'s mask (its slices are
    not the rank's count of experts) and counts as a plain tile."""
    mask = expert_norm[0] if expert_norm is not None else ()
    inv = expert_norm[1] if expert_norm is not None else None
    n = len(leaves(grads))
    if tp is None or tp.world == 1 or not tp_split:
        tp, tp_split = None, ()
    if pp is None or pp.world == 1 or not pp_split:
        pp, pp_split = None, ()
    if data is None or data.world == 1 or not data_split:
        data, data_split = None, ()
    if ep is None or ep.world == 1 or not ep_split:
        ep, ep_split = None, ()
    expert = [i < len(mask) and mask[i] for i in range(n)]
    split = [i < len(tp_split) and tp_split[i] for i in range(n)]
    staged = [i < len(pp_split) and pp_split[i] for i in range(n)]
    tiled = [i < len(data_split) and data_split[i] for i in range(n)]
    vocab = [i < len(ep_split) and ep_split[i] for i in range(n)]
    sums = [expert_slice_sumsq(g, inv, group, tp if split[i] else None,
                               pp if staged[i] else None, data if tiled[i] else None)
            if expert[i] else torch.sum(torch.square(g.float()))
            for i, g in enumerate(leaves(grads))]
    for g_, flags in ((tp, split), (pp, staged), (data, tiled), (ep, vocab)):
        shards = [i for i, sp in enumerate(flags) if sp and not expert[i]]
        if shards:
            tot = all_reduce_sum(torch.stack([sums[i] for i in shards]), g_)
            for i, t in zip(shards, tot.unbind()):
                sums[i] = t
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_scale(gnorm, grad_clip, clip_enabled) -> torch.Tensor:
    """The global-norm clip multiplier; 1 when clipping is off
    (``grad_clip <= 0``, or ``clip_enabled`` false)."""
    if grad_clip <= 0:
        return torch.ones_like(gnorm)
    scale = torch.where(gnorm > grad_clip, grad_clip / (gnorm + 1e-12),
                        torch.ones_like(gnorm))
    if clip_enabled is not None:
        scale = torch.where(torch.as_tensor(clip_enabled, device=gnorm.device), scale,
                            torch.ones_like(gnorm))
    return scale


def adamw_leaf(g, master, m, v, *, scale, lr, bc1, bc2, beta1, beta2, eps,
               weight_decay):
    """Elementwise AdamW on one leaf (or any slice of one). Returns
    (new_master, new_m, new_v)."""
    g = g.float() * scale
    m2 = beta1 * m + (1 - beta1) * g
    v2 = beta2 * v + (1 - beta2) * torch.square(g)
    mhat = m2 / bc1
    vhat = v2 / bc2
    new_master = master - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * master)
    return new_master, m2, v2


def _slices(t: torch.Tensor) -> list:
    return list(t) if t.ndim >= 3 else [t]


def adamw_leaf_(g, master, m, v, **hyper) -> None:
    """``adamw_leaf`` written into ``master``, ``m`` and ``v`` in place, one
    slice of a stacked leaf at a time (to bound the temporaries)."""
    for gs, mas, ms, vs in zip(_slices(g), _slices(master), _slices(m), _slices(v)):
        for dst, src in zip((mas, ms, vs), adamw_leaf(gs, mas, ms, vs, **hyper)):
            dst.copy_(src)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, *, lr, beta1=0.9, beta2=0.99, eps=1e-8,
                 weight_decay=0.1, grad_clip=1.0, clip_enabled=None,
                 param_dtype=torch.float32, expert_norm=None, group=None, tp=None,
                 tp_split=None, pp=None, pp_split=None, data=None, data_split=None, ep=None,
                 ep_split=None):
    """One optimizer step; ``lr`` and ``clip_enabled`` may be tensors. The
    state's master, m and v are updated in place. ``group``: the EP group
    whose ranks hold the slices of the leaves flagged in ``expert_norm``;
    ``tp``: the 'tp' group whose ranks hold shards of the leaves flagged
    in ``tp_split``, ``pp``: the 'pp' group whose stages hold the layers
    of the leaves flagged in ``pp_split``, ``data``: the 'data' group whose
    ranks hold the fsdp tiles of the leaves flagged in ``data_split``,
    ``ep``: the 'ep' group whose ranks hold the vocab rows of the tables
    flagged in ``ep_split`` (``global_norm``). Returns (new_params in
    ``param_dtype``, new_state, metrics {grad_norm, clip_scale})."""
    step = state.step + 1
    gnorm = global_norm(grads, expert_norm=expert_norm, group=group, tp=tp, tp_split=tp_split,
                        pp=pp, pp_split=pp_split, data=data, data_split=data_split, ep=ep,
                        ep_split=ep_split)
    scale = clip_scale(gnorm, grad_clip, clip_enabled)
    t = step.to(torch.float32)
    bc1 = 1.0 - beta1 ** t
    bc2 = 1.0 - beta2 ** t
    for g, ma, m, v in zip(leaves(grads), leaves(state.master), leaves(state.m),
                           leaves(state.v)):
        adamw_leaf_(g, ma, m, v, scale=scale, lr=lr, bc1=bc1, bc2=bc2, beta1=beta1,
                    beta2=beta2, eps=eps, weight_decay=weight_decay)
    new_params = tree_map(lambda ma: ma.to(param_dtype), state.master)
    return new_params, AdamWState(step, state.master, state.m, state.v), \
        {"grad_norm": gnorm, "clip_scale": scale}
