"""Sparse MoE block on one device — the paper's §3.1 stages 2-5, port of the
JAX package's ``core/moe.py`` (meshless paths only).

* ``moe_naive``          every expert computes every token; the test oracle.
* ``_moe_dense``         route -> sort-based dispatch into a slot pool ->
                         grouped expert FFN -> weighted combine, through the
                         kernel wrappers of ``kernels/ops.py`` (grouped
                         matmul, fused SwiGLU, combine).

The port has one grouped-FFN backend, the kernel one: the JAX package's
'xla' (uniform capacity) and 'ragged' lowerings are XLA layouts of the same
math. Dispatch modes follow ``MoEConfig.dispatch``: 'capacity' sizes the
pool from ``capacity_factor`` (tokens past it are dropped), 'dropless' for
the worst-case routing. Both use count-aligned groups, padded to
``ops.gmm_align()`` rows so that no gmm row tile straddles two experts.
Everything stays on the device: no step of the dispatch reads a value back
to the host.

The block is differentiable end to end: the gathers into the pool and back
out of it are indexing ops (their backward scatter-adds), the grouped FFN
and the combine are ``autograd.Function``s over the kernels, the combine
weights carry the gradient into the router, and the router's aux and z
losses are plain PyTorch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .router import RouterOut, histogram, route


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


def _shared_expert(p, x):
    sp = p["shared"]
    h = F.silu(x @ sp["gate"].to(x.dtype)) * (x @ sp["up"].to(x.dtype))
    return h @ sp["down"].to(x.dtype)


# ----------------------------------------------------------------------------
# naive baseline (every expert computes every token)
# ----------------------------------------------------------------------------

def moe_naive(p, x, moe_cfg) -> tuple[torch.Tensor, RouterOut]:
    r = route(x, p["router"], num_experts=moe_cfg.num_experts,
              top_k=moe_cfg.experts_per_token,
              forced_uniform=moe_cfg.forced_uniform_routing)
    gate, up, down = (p[k].to(x.dtype) for k in ("gate", "up", "down"))
    h = F.silu(torch.einsum("td,edf->etf", x, gate)) * torch.einsum("td,edf->etf", x, up)
    ys = torch.einsum("etf,efd->etd", h, down)                     # (E, T, d)
    one_hot = F.one_hot(r.indices, moe_cfg.num_experts).to(x.dtype)
    cw = (one_hot * r.weights[..., None].to(x.dtype)).sum(1)        # (T, E)
    out = torch.einsum("te,etd->td", cw, ys)
    if moe_cfg.num_shared_experts:
        out = out + _shared_expert(p, x)
    return out, r


# ----------------------------------------------------------------------------
# Stages 2+3: token counting + sort-based index generation
# ----------------------------------------------------------------------------

class DispatchPlan(NamedTuple):
    slot: torch.Tensor         # (T*K,) destination pool row (pool_rows = dropped)
    valid: torch.Tensor        # (T*K,) bool — False = dropped
    counts: torch.Tensor       # (E,) tokens routed per expert
    group_sizes: torch.Tensor  # (E,) int32 aligned pool group sizes
    pool_rows: int             # static pool size
    drops: torch.Tensor        # () dropped (over-capacity) pairs


class MoeStats(NamedTuple):
    """Per-layer routing telemetry (float32, as in the JAX package)."""
    counts: torch.Tensor       # (E,) routed (t, k) pairs per expert
    drops: torch.Tensor        # () pairs dropped over capacity


def make_dispatch_plan(indices: torch.Tensor, *, num_experts: int, pool_rows: int,
                       align: int = 8) -> DispatchPlan:
    """Sort-based index generation (paper Stage 3). indices: (T, K) expert
    ids. Each expert's group is its count rounded up to ``align`` rows;
    the groups share the pool in expert order, and pairs past the pool's
    end are dropped."""
    T, K = indices.shape
    dev = indices.device
    E = num_experts
    key = indices.reshape(-1).long()
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]

    counts = histogram(key, E)                                  # Stage 2 histogram
    gs_aligned = (counts + align - 1) // align * align
    cum = torch.clamp(torch.cumsum(gs_aligned, 0), max=pool_rows)
    offsets = torch.cat([torch.zeros(1, dtype=cum.dtype, device=dev), cum])
    group_sizes = offsets[1:] - offsets[:-1]

    # position of each sorted element within its expert group
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(counts, 0)[:-1]])
    pos_sorted = torch.arange(T * K, device=dev) - starts[sorted_key]

    slot_sorted = offsets[sorted_key] + pos_sorted
    valid_sorted = pos_sorted < group_sizes[sorted_key]
    slot_sorted = torch.where(valid_sorted, slot_sorted, torch.full_like(slot_sorted, pool_rows))

    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    valid = torch.empty_like(valid_sorted).scatter_(0, order, valid_sorted)
    drops = T * K - valid_sorted.sum()
    return DispatchPlan(slot, valid, counts, group_sizes.to(torch.int32), int(pool_rows),
                        drops)


def pool_size(tokens: int, top_k: int, num_experts: int, capacity_factor: float,
              align: int = 8) -> int:
    """Static slot-pool rows: ``capacity_factor`` times the routed pairs,
    plus one alignment's slack per expert."""
    expected = tokens * top_k
    return round_up(int(math.ceil(capacity_factor * expected)) + align * num_experts, align)


def dropless_pool_rows(tokens: int, top_k: int, num_experts: int, align: int = 8) -> int:
    """Pool rows guaranteeing zero drops for any routing: even if one expert
    receives every pair its aligned group fits, and ``align * E`` absorbs
    the per-group alignment padding."""
    return round_up(tokens * top_k, align) + align * num_experts


def dispatch_pool_rows(tokens: int, moe_cfg, *, dropless: bool = False) -> int:
    """Pool rows of one dispatch of ``tokens`` tokens, with groups aligned
    to the gmm kernel's row tile: the dropless bound, or the capacity pool
    rounded up to a multiple of ``E * align``."""
    K, E, align = moe_cfg.experts_per_token, moe_cfg.num_experts, ops.gmm_align()
    if dropless:
        return dropless_pool_rows(tokens, K, E, align=align)
    return round_up(pool_size(tokens, K, E, moe_cfg.capacity_factor, align=align), E * align)


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
# Stages 2-5 on one device
# ----------------------------------------------------------------------------

def dispatch_compute_combine(gate_w, up_w, down_w, x, r: RouterOut, moe_cfg, *,
                             dropless: bool = False):
    """x: (T, d) tokens. Returns (out (T, d), plan). ``dropless``: size the
    pool for the worst-case routing instead of by the capacity factor."""
    T, d = x.shape
    K = moe_cfg.experts_per_token
    rows = dispatch_pool_rows(T, moe_cfg, dropless=dropless)
    plan = make_dispatch_plan(r.indices, num_experts=moe_cfg.num_experts, pool_rows=rows,
                              align=ops.gmm_align())

    # inverse map: pool row -> source token; dropped pairs land in the
    # extra row ``rows`` and are cut off (the JAX scatter's mode="drop")
    tok_flat = torch.arange(T * K, device=x.device) // K
    inv_token = torch.zeros(rows + 1, dtype=torch.int64, device=x.device)
    inv_token[plan.slot] = tok_flat
    pool_valid = torch.zeros(rows + 1, dtype=torch.bool, device=x.device)
    pool_valid[plan.slot] = plan.valid
    pool_x = x[inv_token[:rows]] * pool_valid[:rows, None].to(x.dtype)

    pool_y = grouped_ffn(gate_w, up_w, down_w, pool_x, plan.group_sizes)

    # Stage 5: weighted combine
    safe_slot = torch.clamp(plan.slot, max=rows - 1)
    yk = (pool_y[safe_slot] * plan.valid[:, None].to(pool_y.dtype)).reshape(T, K, d)
    out = ops.combine(yk, r.weights.to(pool_y.dtype))
    return out, plan


def _moe_dense(p, x, moe_cfg, *, dropless: bool = False):
    """Route, dispatch, compute, combine. Returns (out, router_out, MoeStats)."""
    r = route(x, p["router"], num_experts=moe_cfg.num_experts,
              top_k=moe_cfg.experts_per_token,
              forced_uniform=moe_cfg.forced_uniform_routing)
    out, plan = dispatch_compute_combine(p["gate"], p["up"], p["down"], x, r, moe_cfg,
                                         dropless=dropless)
    if moe_cfg.num_shared_experts:
        out = out + _shared_expert(p, x)
    stats = MoeStats(plan.counts.float(), plan.drops.float())
    return out, r, stats


def sparse_moe_block(p, x, cfg):
    """x: (B, S, d) -> (out (B, S, d), aux_loss, z_loss, MoeStats)."""
    B, S, d = x.shape
    m = cfg.moe
    xt = x.reshape(B * S, d)
    if m.moe_impl == "naive":
        out, r = moe_naive(p, xt, m)
        stats = MoeStats(histogram(r.indices, m.num_experts).float(),
                         torch.zeros((), device=x.device))
        return out.reshape(B, S, d), r.aux_loss, r.z_loss, stats
    out, r, stats = _moe_dense(p, xt, m, dropless=m.dispatch == "dropless")
    return out.reshape(B, S, d), r.aux_loss, r.z_loss, stats
