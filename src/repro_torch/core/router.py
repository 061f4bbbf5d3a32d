"""MoE router: top-k softmax routing, load-balance aux loss, router z-loss
and FUR (forced uniform routing, paper §2.3). Port of the JAX package's
``core/router.py``."""
from __future__ import annotations

from typing import NamedTuple

import torch


def histogram(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Counts of each value in [0, n) over ``ids`` (int64, (n,)). A
    scatter-add rather than ``torch.bincount``, which reads the maximum
    back to the host on CUDA."""
    flat = ids.reshape(-1).long()
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat))


class RouterOut(NamedTuple):
    weights: torch.Tensor   # (T, K) float32 combine weights
    indices: torch.Tensor   # (T, K) int64 expert ids
    aux_loss: torch.Tensor  # () load-balance loss (OLMoE-style)
    z_loss: torch.Tensor    # () router z-loss


def route(x: torch.Tensor, router_w: torch.Tensor, *, num_experts: int, top_k: int,
          forced_uniform: bool = False, reduce=None) -> RouterOut:
    """x: (T, d); router_w: (d, E). ``reduce``: a differentiable sum over
    the ranks that split the batch (EP's dense fallback); the aux and z
    losses are then those of the global batch, as the JAX package's
    auto-sharded path computes them."""
    T = x.shape[0]
    logits = (x @ router_w.to(x.dtype)).float()                 # (T, E)
    probs = torch.softmax(logits, dim=-1)

    if forced_uniform:
        # FUR: every expert receives the same number of tokens in the same
        # pattern, isolating load-imbalance effects
        t = torch.arange(T, device=x.device)[:, None]
        k = torch.arange(top_k, device=x.device)[None, :]
        indices = (t * top_k + k) % num_experts
        weights = torch.full((T, top_k), 1.0 / top_k, dtype=torch.float32,
                             device=x.device)
    else:
        weights, indices = torch.topk(probs, top_k, dim=-1)

    # load-balance auxiliary loss: E * sum_e f_e * p_e  (Switch/OLMoE form)
    lse2 = torch.square(torch.logsumexp(logits, dim=-1))
    if reduce is None:
        f = histogram(indices, num_experts).float() / (T * top_k)
        p = probs.mean(dim=0)
        z = torch.mean(lse2)
    else:
        n = torch.full((1,), float(T), device=x.device)
        tot = reduce(torch.cat([histogram(indices, num_experts).float(), probs.sum(0),
                                lse2.sum()[None], n]))
        E, n = num_experts, tot[-1]
        f, p, z = tot[:E] / (n * top_k), tot[E:2 * E] / n, tot[2 * E] / n
    aux = num_experts * torch.sum(f * p)
    return RouterOut(weights, indices, aux, z)
