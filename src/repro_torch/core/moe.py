"""Sparse MoE block — the paper's §3.1 five stages, port of the JAX
package's ``core/moe.py``.

* ``moe_naive``          every expert computes every token; the test oracle.
* ``_moe_dense``         route -> Stages 2 and 3, the histogram and the
                         dispatch plan (the ``dispatch_plan`` kernel) ->
                         gather into a slot pool -> grouped expert FFN ->
                         weighted combine, through the kernel wrappers of
                         ``kernels/ops.py`` (dispatch plan, grouped matmul,
                         fused SwiGLU, combine).
* ``moe_fsmoe_ep``       paper Algorithm 1 under expert parallelism over an
                         ``EPGroup`` (``torch.distributed``): route the
                         rank's tokens, all-gather tokens and routing
                         (Stage 1), Stages 2-5 on the gathered tokens with
                         the rank's slice of the experts, reduce-scatter
                         back to the rank's tokens. With a 'tp' group
                         (expert-TP) each rank holds a d_ff shard of its
                         experts and the partial outputs are summed over
                         'tp' before the reduce-scatter.
* ``_fsmoe_a2a``         the all-to-all Stage 1 (``MoEConfig.stage1 =
                         'a2a'``): each token goes only to the ranks owning
                         its K experts, in uniform-capacity send buffers
                         (the ``dispatch_plan`` kernel's uniform mode),
                         and its K expert rows come back the same way.

Expert-TP without EP (a 'tp' group and whole expert stacks split on d_ff,
the JAX package's ``moe_etp_shard_map``) is the dense path on each rank's
own tokens with its d_ff shard, the partial outputs summed over 'tp'.

Each takes an optional ``placement``, the (E,) inverse row of an expert
placement (``parallel.placement``: global expert id -> position), when the
expert stacks are stored in placed order: the routed ids are translated to
positions before the dispatch (and the naive combine), the router's output,
aux loss and histogram stay in global ids, and the stats' counts come back
in global order. Under EP rank r holds positions ``[r * EL, (r + 1) *
EL)``.

The port has one grouped-FFN backend, the kernel one: the JAX package's
'xla' (uniform capacity) and 'ragged' lowerings are XLA layouts of the same
math. Dispatch modes follow ``MoEConfig.dispatch``: 'capacity' sizes the
pool from ``capacity_factor`` (tokens past it are dropped), 'dropless' for
the worst-case routing. Both use count-aligned groups, padded to
``ops.gmm_align()`` rows so that no gmm row tile straddles two experts.
Everything stays on the device: no step of the dispatch reads a value back
to the host.

The block is differentiable end to end: the gathers into the pool and back
out of it are ``autograd.Function``s whose backward is a gather too (each
pool row belongs to one (token, k) pair, so the plan's inverse map turns
the scatter-add into a gather, and a token's rows are summed by the
combine kernel), the grouped FFN and the combine are ``autograd.Function``s
over the kernels, the combine weights carry the gradient into the router,
and the router's aux and z losses are plain PyTorch around the Stage 2
histogram kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.parallel.ep import (EPGroup, all_gather_dim, all_gather_tokens, all_reduce_sum,
                                     all_to_all_dim, all_to_all_rows, reduce_scatter_tokens,
                                     tp_copy, tp_reduce)

from .router import RouterOut, route


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ----------------------------------------------------------------------------
# params
# ----------------------------------------------------------------------------

def init_moe_block(cfg, *, num_layers: int, generator: torch.Generator,
                   device, dtype) -> dict:
    """Stacked (merged) expert weights for ``num_layers`` layers, with the
    JAX package's init scales: normal * 1/sqrt(d) in, 1/sqrt(f) out."""
    d, m = cfg.d_model, cfg.moe
    e, f = m.num_experts, m.d_ff_expert
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)

    def normal(shape, scale):
        return torch.randn((num_layers, *shape), generator=generator, device=device,
                           dtype=dtype).mul_(scale)

    p = {"router": normal((d, e), s_in), "gate": normal((e, d, f), s_in),
         "up": normal((e, d, f), s_in), "down": normal((e, f, d), s_out)}
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        p["shared"] = {"gate": normal((d, fs), s_in), "up": normal((d, fs), s_in),
                       "down": normal((fs, d), s_out)}
    return p


def _shared_expert(p, x, tp=None):
    """The shared experts, a dense SwiGLU MLP: under a 'tp' group its d_ff
    is split like a dense MLP's, the partial outputs summed over 'tp'."""
    sp = p["shared"]
    x = tp_copy(x, tp)
    h = F.silu(x @ sp["gate"].to(x.dtype)) * (x @ sp["up"].to(x.dtype))
    return tp_reduce(h @ sp["down"].to(x.dtype), tp)


# ----------------------------------------------------------------------------
# naive baseline (every expert computes every token)
# ----------------------------------------------------------------------------

def moe_naive(p, x, moe_cfg, *, aux: bool = True,
              placement=None) -> tuple[torch.Tensor, RouterOut]:
    r = route(x, p["router"], num_experts=moe_cfg.num_experts,
              top_k=moe_cfg.experts_per_token,
              forced_uniform=moe_cfg.forced_uniform_routing, aux=aux)
    gate, up, down = (p[k].to(x.dtype) for k in ("gate", "up", "down"))
    h = F.silu(torch.einsum("td,edf->etf", x, gate)) * torch.einsum("td,edf->etf", x, up)
    ys = torch.einsum("etf,efd->etd", h, down)                     # (E, T, d)
    # the stacks are in placed order; r keeps global ids
    idx = r.indices if placement is None else placement[r.indices]
    one_hot = F.one_hot(idx.long(), moe_cfg.num_experts).to(x.dtype)
    cw = (one_hot * r.weights[..., None].to(x.dtype)).sum(1)        # (T, E)
    out = torch.einsum("te,etd->td", cw, ys)
    if moe_cfg.num_shared_experts:
        out = out + _shared_expert(p, x)
    return out, r


# ----------------------------------------------------------------------------
# Stages 2+3: token counting + sort-based index generation
# ----------------------------------------------------------------------------

class DispatchPlan(NamedTuple):
    slot: torch.Tensor         # (T*K,) destination pool row (pool_rows: dropped, non-local)
    valid: torch.Tensor        # (T*K,) bool — False = dropped or non-local
    counts: torch.Tensor       # (EL,) tokens routed per local expert
    group_sizes: torch.Tensor  # (EL,) int32 aligned pool group sizes
    pool_rows: int             # static pool size
    drops: torch.Tensor        # () dropped (over-capacity) local pairs
    inv_pair: torch.Tensor     # (pool_rows,) the (token, k) pair filling each row (0: none)
    pool_valid: torch.Tensor   # (pool_rows,) bool — True = a pair fills the row


class MoeStats(NamedTuple):
    """Per-layer routing telemetry (float32, as in the JAX package)."""
    counts: torch.Tensor       # (E,) routed (t, k) pairs per expert
    drops: torch.Tensor        # () pairs dropped over capacity


def make_dispatch_plan(indices: torch.Tensor, *, num_experts: int, pool_rows: int,
                       align: int = 8, expert_offset: int = 0,
                       local_experts: int = 0, uniform_capacity: bool = False) -> DispatchPlan:
    """Stages 2 and 3: the histogram, then the index generation, in one
    kernel on the card (``ops.dispatch_plan``; ``ref.dispatch_plan_ref``,
    the JAX package's sort-based chain, on the CPU). indices: (T, K) global
    expert ids. Only the ``EL = local_experts or num_experts`` experts
    ``[expert_offset, expert_offset + EL)`` are dispatched (EP rank r:
    offset r * EL); other ids sort to the sentinel key EL and are masked.
    Each expert's group is its count rounded up to ``align`` rows; the
    groups share the pool in expert order, and pairs past the pool's end
    are dropped. ``uniform_capacity``: every group is ``pool_rows // EL``
    rows at offset ``g * pool_rows // EL`` instead (the all-to-all's send
    buffers, one group per destination rank). The plan also holds the
    inverse map, pool row -> pair."""
    EL = local_experts or num_experts
    slot, valid, counts, group_sizes, drops, inv_pair, pool_valid = ops.dispatch_plan(
        indices, EL, expert_offset, pool_rows, align, uniform_capacity)
    return DispatchPlan(slot, valid, counts, group_sizes, int(pool_rows), drops, inv_pair,
                        pool_valid)


def pool_size(tokens: int, top_k: int, num_experts: int, local_experts: int,
              capacity_factor: float, align: int = 8) -> int:
    """Static slot-pool rows of one EP shard (``local_experts`` of the
    ``num_experts``): ``capacity_factor`` times its expected share of the
    routed pairs, plus one alignment's slack per local expert."""
    expected = tokens * top_k * local_experts / num_experts
    return round_up(int(math.ceil(capacity_factor * expected)) + align * local_experts, align)


def dropless_pool_rows(tokens: int, top_k: int, local_experts: int, align: int = 8) -> int:
    """Pool rows guaranteeing zero drops for any routing: even if one local
    expert receives every pair its aligned group fits, and ``align * EL``
    absorbs the per-group alignment padding."""
    return round_up(tokens * top_k, align) + align * local_experts


def dispatch_pool_rows(tokens: int, moe_cfg, *, dropless: bool = False,
                       local_experts: int = 0) -> int:
    """Pool rows of one dispatch of ``tokens`` (gathered, under EP) tokens
    among ``EL = local_experts or E`` experts, with groups aligned to the gmm
    kernel's row tile: the dropless bound, or the capacity pool rounded up to
    a multiple of ``EL * align``."""
    K, E, align = moe_cfg.experts_per_token, moe_cfg.num_experts, ops.gmm_align()
    EL = local_experts or E
    if dropless:
        return dropless_pool_rows(tokens, K, EL, align=align)
    return round_up(pool_size(tokens, K, E, EL, moe_cfg.capacity_factor, align=align),
                    EL * align)


# ----------------------------------------------------------------------------
# Stage 4: grouped expert FFN (kernel path)
# ----------------------------------------------------------------------------

def grouped_ffn(gate_w, up_w, down_w, pool_x, group_sizes):
    """pool_x: (M, d) rows grouped by expert; w: (E, d, f) / (E, f, d)."""
    dt = pool_x.dtype
    g = ops.gmm(pool_x, gate_w.to(dt), group_sizes)
    u = ops.gmm(pool_x, up_w.to(dt), group_sizes)
    h = ops.fused_swiglu(g, u)
    return ops.gmm(h, down_w.to(dt), group_sizes)


# ----------------------------------------------------------------------------
# the gathers into the slot pool and back out of it
# ----------------------------------------------------------------------------

def pool_gather_backward(d_pool: torch.Tensor, safe_slot: torch.Tensor, valid: torch.Tensor,
                         top_k: int) -> torch.Tensor:
    """The token gradient of the gather into the pool: ``dx[t] = sum_k
    valid[t, k] * d_pool[safe_slot[t, k]]``, each pair's row gathered and a
    token's K rows summed by the combine kernel with 0/1 weights (not a
    scatter-add: each valid pool row belongs to one pair)."""
    T = valid.shape[0] // top_k
    rows = d_pool[safe_slot].reshape(T, top_k, d_pool.shape[1])
    return ops.combine(rows, valid.reshape(T, top_k).to(d_pool.dtype))


def combine_gather_backward(d_yk: torch.Tensor, inv_pair: torch.Tensor,
                            pool_valid: torch.Tensor) -> torch.Tensor:
    """The pool gradient of the gather out of the pool: ``d_pool[row] =
    d_yk[inv_pair[row]] * pool_valid[row]``, each valid row the gradient of
    the one pair that fills it, 0 for a row no pair fills."""
    return d_yk[inv_pair] * pool_valid[:, None].to(d_yk.dtype)


class _PoolGather(torch.autograd.Function):
    """pool_x = x[inv_pair // K] * pool_valid: each pool row is the token of
    the one (token, k) pair that fills it (0 for a row no pair fills).
    Backward: ``pool_gather_backward``."""

    @staticmethod
    def forward(ctx, x, inv_pair, pool_valid, safe_slot, valid, top_k):
        ctx.save_for_backward(safe_slot, valid)
        ctx.top_k = top_k
        return x[inv_pair // top_k] * pool_valid[:, None].to(x.dtype)

    @staticmethod
    def backward(ctx, d_pool):
        safe_slot, valid = ctx.saved_tensors
        dx = pool_gather_backward(d_pool, safe_slot, valid, ctx.top_k)
        return dx, None, None, None, None, None


class _CombineGather(torch.autograd.Function):
    """yk = pool_y[safe_slot] * valid: each (token, k) pair's row of the
    expert outputs (0 for a dropped or non-local pair). Backward:
    ``combine_gather_backward``."""

    @staticmethod
    def forward(ctx, pool_y, safe_slot, valid, inv_pair, pool_valid):
        ctx.save_for_backward(inv_pair, pool_valid)
        return pool_y[safe_slot] * valid[:, None].to(pool_y.dtype)

    @staticmethod
    def backward(ctx, d_yk):
        inv_pair, pool_valid = ctx.saved_tensors
        return combine_gather_backward(d_yk, inv_pair, pool_valid), None, None, None, None


# ----------------------------------------------------------------------------
# Stages 2-5 on one device
# ----------------------------------------------------------------------------

def dispatch_compute_combine(gate_w, up_w, down_w, x, r: RouterOut, moe_cfg, *,
                             expert_offset: int = 0, local_experts: int = 0,
                             dropless: bool = False, pool_rows: Optional[int] = None):
    """x: (T, d) tokens (the gathered tokens under EP); the expert weights
    are the slice of ``local_experts`` experts from ``expert_offset`` (all
    of them by default). Returns (out (T, d), plan): under EP a partial
    output, the local experts' share. ``dropless``: size the pool for the
    worst-case routing instead of by the capacity factor. ``pool_rows``:
    the capacity pool's rows (the all-to-all's inner dispatch gives its
    own), rounded up to a multiple of ``EL * align``."""
    T, d = x.shape
    K = moe_cfg.experts_per_token
    EL = local_experts or moe_cfg.num_experts
    if pool_rows is not None and not dropless:
        rows = round_up(pool_rows, EL * ops.gmm_align())
    else:
        rows = dispatch_pool_rows(T, moe_cfg, dropless=dropless, local_experts=EL)
    plan = make_dispatch_plan(r.indices, num_experts=moe_cfg.num_experts, pool_rows=rows,
                              align=ops.gmm_align(), expert_offset=expert_offset,
                              local_experts=EL)

    # dropped and non-local pairs read the last row, masked to 0
    safe_slot = torch.clamp(plan.slot, max=rows - 1)
    pool_x = _PoolGather.apply(x, plan.inv_pair, plan.pool_valid, safe_slot, plan.valid, K)

    pool_y = grouped_ffn(gate_w, up_w, down_w, pool_x, plan.group_sizes)

    # Stage 5: weighted combine
    yk = _CombineGather.apply(pool_y, safe_slot, plan.valid, plan.inv_pair,
                              plan.pool_valid).reshape(T, K, d)
    out = ops.combine(yk, r.weights.to(pool_y.dtype))
    return out, plan


def _moe_dense(p, x, moe_cfg, *, dropless: bool = False, ep_group: Optional[EPGroup] = None,
               aux: bool = True, placement=None, tp: Optional[EPGroup] = None,
               whole_pool: bool = False):
    """Route, dispatch, compute, combine. Returns (out, router_out, MoeStats).
    With ``ep_group`` (the dense fallback under EP: every rank holds every
    expert and runs its own tokens; or a pipeline stage's ('data', 'ep')
    group) the aux and z losses and the stats are those of the global
    batch. ``whole_pool`` (a pipeline stage's MoE block, with that group):
    under capacity dispatch the pairs that a one-device dispatch of the
    whole microbatch would drop are dropped (``_one_device_ids``), and the
    stats are that plan's. With a 'tp' group ``tp`` the expert stacks
    are the rank's d_ff shards (expert-TP without EP, the JAX package's
    ``moe_etp_shard_map``): every tp rank dispatches the same tokens, and
    the partial outputs are summed over 'tp'. ``aux=False``: no aux, z or
    stats (None)."""
    reduce = None
    if ep_group is not None:
        def reduce(t):
            return all_reduce_sum(t, ep_group)
    r = route(x, p["router"], num_experts=moe_cfg.num_experts,
              top_k=moe_cfg.experts_per_token,
              forced_uniform=moe_cfg.forced_uniform_routing, reduce=reduce, aux=aux)
    # the expert path is a tp region: its inputs enter through tp_copy (their
    # gradients are the shards' parts), its output leaves through tp_reduce
    idx = r.indices if placement is None else placement[r.indices]
    whole = None
    if whole_pool and ep_group is not None and not dropless:
        idx, whole = _one_device_ids(idx, moe_cfg, ep_group)
    rd = RouterOut(tp_copy(r.weights, tp), idx, r.aux_loss, r.z_loss)
    out, plan = dispatch_compute_combine(p["gate"], p["up"], p["down"], tp_copy(x, tp), rd,
                                         moe_cfg, dropless=dropless or whole is not None)
    out = tp_reduce(out, tp)
    if moe_cfg.num_shared_experts:
        out = out + _shared_expert(p, x, tp)
    if not aux:
        return out, r, None
    if whole is not None:
        # every rank made the same one-device plan: its counts and drops are
        # the whole microbatch's
        counts = whole.counts.float()
        return out, r, MoeStats(counts if placement is None else counts[placement],
                                whole.drops.float())
    counts = plan.counts if placement is None else plan.counts[placement]
    stats = MoeStats(counts.float(), plan.drops.float())
    if reduce is not None:
        tot = reduce(torch.cat([stats.counts, stats.drops[None]]))
        stats = MoeStats(tot[:-1], tot[-1])
    return out, r, stats


# ----------------------------------------------------------------------------
# fsmoe under EP: paper Algorithm 1 over a torch.distributed group
# ----------------------------------------------------------------------------

def uses_ep(moe_cfg, world: int) -> bool:
    """Whether an EP group of ``world`` ranks splits the expert stacks and
    the block runs ``moe_fsmoe_ep``: the fsmoe path with E divisible by the
    group (the JAX package's ``sparse_moe_block`` rule). Otherwise every
    rank keeps every expert and runs the dense path on its own tokens."""
    return moe_cfg.moe_impl == "fsmoe" and moe_cfg.num_experts % world == 0


def _ep_stats(plan_counts, drops, group: EPGroup, placement) -> MoeStats:
    """The stats of one EP rank's dispatch made global over its 'ep' group
    (the JAX ``_fsmoe_stats`` over 'ep'; 'data' is summed by the loss, and
    'tp' ranks ran the same dispatch): the local counts gathered in rank
    order, which is position order, then put back in global-id order; the
    drops summed."""
    counts = all_gather_tokens(plan_counts.float(), group)
    return MoeStats(counts if placement is None else counts[placement], drops)


def _one_device_ids(ids, moe_cfg, rows: Optional[EPGroup] = None, span: int = 1):
    """Routed ids (T, K) with the pairs that a one-device capacity dispatch
    of the whole microbatch drops set to E, which no expert holds, and that
    one-device plan. Without ``rows``, ``ids`` are the whole microbatch's.
    With ``rows`` (the ranks that split the microbatch, in row order),
    ``ids`` are the rank's own: the plan is made from the ids gathered over
    ``rows``, and the rank keeps the ids of its block of ``span`` ranks'
    rows (its 'ep' group's under EP, its own on the dense path)."""
    E = moe_cfg.num_experts
    full = ids if rows is None else all_gather_dim(ids, rows)
    whole = make_dispatch_plan(full, num_experts=E, align=ops.gmm_align(),
                               pool_rows=dispatch_pool_rows(full.shape[0], moe_cfg))
    keep = whole.valid.view_as(full)
    if rows is not None:
        n = ids.shape[0] * span
        lo = rows.rank // span * n
        full, keep = full[lo:lo + n], keep[lo:lo + n]
    return torch.where(keep, full, torch.full_like(full, E)), whole


def moe_fsmoe_ep(p, x, moe_cfg, group: EPGroup, *, dropless: bool = False, placement=None,
                 tp: Optional[EPGroup] = None, whole_pool: bool = False,
                 batch: Optional[EPGroup] = None, aux: bool = True, replicated: bool = False):
    """Paper Algorithm 1 under EP. x: (T, d), the rank's tokens; ``p`` holds
    the router and shared experts whole and the rank's slice of the expert
    stacks (EL = E / world experts from rank * EL). ``moe_cfg.stage1``:
    'allgather' (the paper's) or 'a2a' (``_fsmoe_a2a``). With a 'tp' group
    ``tp`` (expert-TP on top of EP, the allgather Stage 1 only) the slices
    are the rank's d_ff shards and the partial outputs are summed over 'tp'
    before the Stage 5 reduce-scatter. Returns (out (T, d), aux, z,
    MoeStats): aux and z averaged over the ranks, the stats global.

    ``whole_pool`` (a pipeline stage's MoE block; the JAX stage runs the
    one-device MoE over the whole microbatch): ``batch`` is the group of
    the ranks that split the microbatch (the stage's ('data', 'ep') group,
    in row order; default the 'ep' group). The router's aux and z and the
    stats are those of all its tokens (``route(reduce=)``, so every rank
    holds the same values), and under capacity dispatch the pairs that a
    one-device dispatch of the whole microbatch would drop are dropped
    (``_one_device_ids`` over ``batch``) and the rank dispatches the rest
    with no capacity bound. Any ``stage1`` runs the allgather here.

    ``replicated`` (serving, which passes ``aux=False``: no aux, z or
    stats, None): every rank holds the same tokens, the whole batch.
    Stage 1's gather is done already, so the rank dispatches every token to
    its experts and the partial outputs are summed over 'tp' and 'ep';
    under capacity dispatch the one-device plan of the tokens decides the
    drops, as under ``whole_pool``, unless the capacity factor is at least
    E / K (serving's ``serve.engine.dropless_cfg``), where no pair can drop
    and the rank dispatches dropless. Any ``stage1`` runs the allgather
    here too."""
    E, world = moe_cfg.num_experts, group.world
    EL, K = E // world, moe_cfg.experts_per_token
    if moe_cfg.stage1 not in ("allgather", "a2a"):
        raise ValueError(f"stage1 must be 'allgather' or 'a2a', got {moe_cfg.stage1!r}")
    if E % world or p["gate"].shape[0] != EL:
        raise ValueError(f"EP over {world} ranks needs E % world == 0 and the rank's "
                         f"{EL}-expert slice; got E={E}, stack {tuple(p['gate'].shape)}")
    if not aux and not replicated:
        raise ValueError("aux=False is for replicated rows (serving): on the ranks' own "
                         "rows the aux and z losses and the stats are reduced over the ranks")
    if replicated and (aux or whole_pool):
        raise ValueError("replicated rows are serving's: pass aux=False, and no whole_pool")
    if moe_cfg.stage1 == "a2a" and not (whole_pool or replicated):
        if dropless:
            raise ValueError(
                "dispatch='dropless' does not compose with stage1='a2a': the all-to-all send "
                "buffers are capacity-bounded by construction. Use the allgather Stage 1 "
                "(stage1='allgather') for dropless.")
        if tp is not None and tp.world > 1:
            raise NotImplementedError(
                "stage1='a2a' does not compose with expert-TP yet; use the allgather "
                "Stage 1 for ep x tp plans")
        out, aux_loss, z, stats = _fsmoe_a2a(p, x, moe_cfg, group, placement=placement)
    else:
        rows = (batch or group) if whole_pool else None
        reduce = None
        if rows is not None:
            def reduce(t):
                return all_reduce_sum(t, rows)
        # the router is replicated: each rank routes its own tokens (the aux
        # and z losses are taken on global ids inside route)
        r = route(x, p["router"], num_experts=E, top_k=K,
                  forced_uniform=moe_cfg.forced_uniform_routing, reduce=reduce, aux=aux)
        idx = r.indices if placement is None else placement[r.indices]
        # Stage 1: all-gather the tokens and their routing, in rank order (the
        # expert path is a tp region under expert-TP); serving holds them all
        w_g, x_g = tp_copy(r.weights, tp), tp_copy(x, tp)
        if not replicated:
            w_g, x_g = all_gather_tokens(w_g, group), all_gather_tokens(x_g, group)
        whole = None
        if replicated and moe_cfg.capacity_factor * K >= E:
            dropless = True         # every expert's group fits its capacity
        if (whole_pool or replicated) and not dropless:
            # the one-device plan of the whole microbatch decides the drops
            idx_g, whole = _one_device_ids(idx, moe_cfg, rows, span=world)
        else:
            idx_g = idx if replicated else all_gather_tokens(idx, group)
        # Stages 2-5 on the rank's experts; then the Stage-5 tail: the partial
        # outputs summed over 'tp' and over ranks, each rank keeping its own
        # tokens' rows (serving: all of them)
        out_partial, plan = dispatch_compute_combine(
            p["gate"], p["up"], p["down"], x_g, RouterOut(w_g, idx_g, None, None), moe_cfg,
            expert_offset=group.rank * EL, local_experts=EL,
            dropless=dropless or whole is not None)
        out = tp_reduce(out_partial, tp)
        out = all_reduce_sum(out, group) if replicated else reduce_scatter_tokens(out, group)
        aux_loss, z, stats = r.aux_loss, r.z_loss, None
        if whole_pool:
            # every rank holds the whole microbatch's aux, z and histogram;
            # the drops are the one-device plan's
            stats = MoeStats(r.counts, (whole if whole is not None else plan).drops.float())
        elif aux:
            # aux and z averaged over the ranks, the drops (each rank's own
            # experts') summed
            aux_loss, z, drops = all_reduce_sum(
                torch.stack([r.aux_loss, r.z_loss, plan.drops.float()]), group).unbind()
            aux_loss, z = aux_loss / world, z / world
            stats = _ep_stats(plan.counts, drops, group, placement)
    if moe_cfg.num_shared_experts:
        out = out + _shared_expert(p, x, tp)
    return out, aux_loss, z, stats


class _SendGather(torch.autograd.Function):
    """send[row] = src[inv_pair[row]] * pool_valid[row] for a 1-D ``src``
    of one value a pair (the routing weights): row ``row`` of the send
    buffers is the pair that fills it. Backward: ``d_src[i] =
    d_send[safe_slot[i]] * valid[i]``, a gather (each valid row belongs to
    one pair)."""

    @staticmethod
    def forward(ctx, src, inv_pair, pool_valid, safe_slot, valid):
        ctx.save_for_backward(safe_slot, valid)
        return src[inv_pair] * pool_valid.to(src.dtype)

    @staticmethod
    def backward(ctx, d_send):
        safe_slot, valid = ctx.saved_tensors
        return d_send[safe_slot] * valid.to(d_send.dtype), None, None, None, None


def _fsmoe_a2a(p, x, moe_cfg, group: EPGroup, *, placement=None):
    """The all-to-all Stage 1 (the JAX package's ``_fsmoe_a2a_body``): each
    (token, k) pair is sent only to the rank owning its expert, instead of
    every token to every rank. Route the rank's T tokens; sort the pairs
    by destination rank (``position // EL``) into ``ep`` uniform send
    groups of Cd = round_up(ceil(cf * T * K / ep), 8) rows (the
    uniform-capacity dispatch plan; pairs past Cd are dropped at the
    source); exchange the rows, their expert positions (-1 for an empty
    row) and their weights; dispatch the received rows among the EL local
    experts with K' = 1 (sentinel EL for an empty row) into a pool of
    round_up(ceil(cf * T * K), 8) rows, compute and weight them; send the
    rows back and sum each token's K rows at the source. Its traffic a
    rank and direction is ep * Cd rows of d against the allgather's (ep -
    1) * T: less only where ep > cf * K. Returns (out (T, d), aux, z,
    MoeStats): aux and z averaged over the ranks, the drops the send-side
    plus the receive-side ones summed over the ranks, the counts those of
    the received rows each rank dispatched, in global-id order."""
    E, ep = moe_cfg.num_experts, group.world
    EL, K = E // ep, moe_cfg.experts_per_token
    T, d = x.shape
    r = route(x, p["router"], num_experts=E, top_k=K,
              forced_uniform=moe_cfg.forced_uniform_routing)
    idx = r.indices if placement is None else placement[r.indices]

    # the send buffers: ep groups of Cd rows, one per destination rank
    Cd = round_up(int(math.ceil(moe_cfg.capacity_factor * T * K / ep)), 8)
    plan = make_dispatch_plan(idx // EL, num_experts=ep, pool_rows=ep * Cd,
                              uniform_capacity=True)
    safe_slot = torch.clamp(plan.slot, max=ep * Cd - 1)
    send_x = _PoolGather.apply(x, plan.inv_pair, plan.pool_valid, safe_slot, plan.valid, K)
    send_e = torch.where(plan.pool_valid, idx.reshape(-1)[plan.inv_pair],
                         torch.full_like(plan.inv_pair, -1))
    send_w = _SendGather.apply(r.weights.reshape(-1).float(), plan.inv_pair, plan.pool_valid,
                               safe_slot, plan.valid)

    recv_x = all_to_all_rows(send_x, group)
    recv_e = all_to_all_dim(send_e, group)
    recv_w = all_to_all_rows(send_w, group)

    # Stages 2-5 on the received rows, one pair each (K' = 1); an empty row
    # takes the sentinel EL, which no local expert holds
    local_e = torch.where(recv_e >= 0, recv_e - group.rank * EL, torch.full_like(recv_e, EL))
    inner_cfg = dataclasses.replace(moe_cfg, experts_per_token=1)
    inner_pool = round_up(int(math.ceil(moe_cfg.capacity_factor * T * K)), 8)
    out_rows, inner = dispatch_compute_combine(
        p["gate"], p["up"], p["down"], recv_x,
        RouterOut(recv_w[:, None], local_e[:, None], r.aux_loss, r.z_loss), inner_cfg,
        local_experts=EL, pool_rows=inner_pool)

    # back to the source ranks, each token's K rows summed there
    back = all_to_all_rows(out_rows, group)
    yk = _CombineGather.apply(back, safe_slot, plan.valid, plan.inv_pair,
                              plan.pool_valid).reshape(T, K, d)
    out = ops.combine(yk, torch.ones((T, K), dtype=back.dtype, device=back.device))

    aux, z, drops = all_reduce_sum(torch.stack([r.aux_loss, r.z_loss,
                                                (plan.drops + inner.drops).float()]),
                                   group).unbind()
    return out, aux / ep, z / ep, _ep_stats(inner.counts, drops, group, placement)


def sparse_moe_block(p, x, cfg, *, ep_group: Optional[EPGroup] = None,
                     tp_group: Optional[EPGroup] = None, aux: bool = True, placement=None,
                     whole_pool: bool = False, batch_group: Optional[EPGroup] = None,
                     replicated: bool = False):
    """x: (B, S, d) -> (out (B, S, d), aux_loss, z_loss, MoeStats). With
    ``ep_group``, x is the rank's share of the batch: the block runs
    ``moe_fsmoe_ep`` when ``uses_ep`` says so, else the dense path with
    whole expert stacks; either way aux, z and the stats are global. With
    ``tp_group`` (a 'tp' group of more than one rank) the expert stacks and
    shared experts are the rank's d_ff shards (expert-TP), every tp rank
    holding the same tokens. ``aux=False`` (serving, which discards them):
    the aux and z losses and the stats are not computed, and are None; on
    one device, or under ``ep_group`` / ``tp_group`` with ``replicated``:
    every rank holds the same tokens, the whole batch
    (``moe_fsmoe_ep(replicated=True)``; the allgather Stage 1 whatever
    ``stage1`` says). ``placement``: the (E,) inverse placement row (global
    id -> position) of stacks stored in placed order, or None.
    ``whole_pool`` (a pipeline stage): the one-device pool and router
    terms of the whole microbatch split over ``batch_group`` (default the
    'ep' group), on either path (``moe_fsmoe_ep``, ``_moe_dense``)."""
    B, S, d = x.shape
    m = cfg.moe
    xt = x.reshape(B * S, d)
    dropless = m.dispatch == "dropless"
    tp = tp_group if tp_group is not None and tp_group.world > 1 else None
    if placement is not None:
        placement = placement.long()       # the dispatch plan takes int64 ids
    if m.moe_impl == "naive":
        if ep_group is not None or tp is not None:
            raise NotImplementedError("moe_impl='naive' is the single-device oracle; "
                                      "it does not run under EP or TP")
        out, r = moe_naive(p, xt, m, aux=aux, placement=placement)
        if not aux:
            return out.reshape(B, S, d), None, None, None
        # from the router's global ids: free of the placement
        stats = MoeStats(ops.token_counts(r.indices, m.num_experts).float(),
                         torch.zeros((), device=x.device))
        return out.reshape(B, S, d), r.aux_loss, r.z_loss, stats
    if (ep_group is not None or tp is not None) and not aux and not replicated:
        raise ValueError("aux=False under EP or TP is for replicated rows (serving): on the "
                         "ranks' own rows the aux and z losses and the stats are reduced "
                         "over the ranks")
    if ep_group is not None and uses_ep(m, ep_group.world):
        out, aux, z, stats = moe_fsmoe_ep(p, xt, m, ep_group, dropless=dropless,
                                          placement=placement, tp=tp, whole_pool=whole_pool,
                                          batch=batch_group, aux=aux, replicated=replicated)
        return out.reshape(B, S, d), aux, z, stats
    if p["gate"].shape[0] != m.num_experts:
        raise ValueError(f"the dense path needs every expert; the stack holds "
                         f"{p['gate'].shape[0]} of {m.num_experts}")
    # the group whose rows the router terms and stats cover: none when every
    # rank holds the whole batch (serving)
    rows = None if replicated else (batch_group or ep_group) if whole_pool else ep_group
    out, r, stats = _moe_dense(p, xt, m, dropless=dropless, ep_group=rows, aux=aux,
                               placement=placement, tp=tp, whole_pool=whole_pool)
    return out.reshape(B, S, d), r.aux_loss, r.z_loss, stats
