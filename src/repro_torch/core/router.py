"""MoE router: top-k softmax routing, load-balance aux loss, router z-loss
and FUR (forced uniform routing, paper §2.3). Port of the JAX package's
``core/router.py``."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops


class RouterOut(NamedTuple):
    weights: torch.Tensor             # (T, K) float32 combine weights
    indices: torch.Tensor             # (T, K) int64 expert ids
    aux_loss: Optional[torch.Tensor]  # () load-balance loss (OLMoE-style)
    z_loss: Optional[torch.Tensor]    # () router z-loss
    counts: Optional[torch.Tensor] = None  # (E,) float32 routed pairs per expert


def route(x: torch.Tensor, router_w: torch.Tensor, *, num_experts: int, top_k: int,
          forced_uniform: bool = False, reduce=None, aux: bool = True) -> RouterOut:
    """x: (T, d); router_w: (d, E). ``reduce``: a differentiable sum over
    the ranks that split the batch (EP's dense fallback); the aux and z
    losses are then those of the global batch, as the JAX package's
    auto-sharded path computes them, and ``counts`` is the histogram summed
    over the ranks. ``aux=False`` (serving, which discards them): the aux
    and z losses and the histogram are not computed and are None. The
    expert histogram of the aux loss is the Stage 2 kernel
    (``ops.token_counts``)."""
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
    if not aux:
        return RouterOut(weights, indices, None, None)

    # load-balance auxiliary loss: E * sum_e f_e * p_e  (Switch/OLMoE form)
    lse2 = torch.square(torch.logsumexp(logits, dim=-1))
    counts = ops.token_counts(indices, num_experts).float()
    if reduce is None:
        f = counts / (T * top_k)
        p = probs.mean(dim=0)
        z = torch.mean(lse2)
    else:
        n = torch.full((1,), float(T), device=x.device)
        tot = reduce(torch.cat([counts, probs.sum(0), lse2.sum()[None], n]))
        E, n = num_experts, tot[-1]
        counts = tot[:E]
        f, p, z = counts / (n * top_k), tot[E:2 * E] / n, tot[2 * E] / n
    return RouterOut(weights, indices, num_experts * torch.sum(f * p), z, counts.detach())
