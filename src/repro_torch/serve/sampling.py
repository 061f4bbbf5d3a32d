"""Per-request token sampling for the serve engine. Port of the JAX
package's ``serve/sampling.py``.

Every request carries its own ``SamplingParams``; one ``sample_tokens``
call serves a batch that mixes greedy, temperature, top-k and nucleus rows.

Determinism contract: the token sampled for request *r* at absolute
position *p* depends only on (r.seed, p) and the logits — never on the slot
the request occupies or on who else is in the batch. Where the JAX package
folds the position into a PRNG key, the port seeds one ``torch.Generator``
(Philox on CUDA) per row from (seed, position). The random numbers differ
from JAX's, so the two packages agree on greedy rows only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch


@dataclass(frozen=True)
class SamplingParams:
    """Per-request knobs. ``temperature <= 0`` means greedy argmax (top-k /
    top-p are then irrelevant); ``top_k == 0`` disables top-k; ``top_p >= 1``
    disables nucleus filtering."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


def position_generator(seed: int, position: int, device) -> torch.Generator:
    """The generator of one (seed, position) pair."""
    key = ((int(seed) & 0xFFFFFFFF) << 32) | (int(position) & 0xFFFFFFFF)
    return torch.Generator(device=device).manual_seed(key)


def position_generators(seeds: Sequence[int], positions: Sequence[int], device,
                        temperature: Sequence[float]) -> list[Optional[torch.Generator]]:
    """(B,) seeds x (B,) positions -> one generator per row (None for the
    greedy rows, which draw nothing)."""
    return [position_generator(s, p, device) if t > 0 else None
            for s, p, t in zip(seeds, positions, temperature)]


def sample_tokens(logits: torch.Tensor, generators: Sequence[Optional[torch.Generator]],
                  temperature: Sequence[float], top_k: Sequence[int],
                  top_p: Sequence[float]) -> torch.Tensor:
    """Sample one token per row with per-row parameters.

    logits: (B, V), already sliced to the real vocab; generators: one per
    row (unused for greedy rows); temperature/top_k/top_p: (B,) host
    sequences. Rows with ``temperature <= 0`` take the argmax. Returns (B,)
    int64 on the logits' device.

    top-k masks everything below the k-th logit; top-p keeps the smallest
    prefix of the (temperature-scaled, top-k-filtered) distribution whose
    mass reaches p — always at least the most likely token. The draw is a
    Gumbel-max over the kept logits with noise from the row's generator.
    """
    B, V = logits.shape
    logits = logits.float()
    out = torch.argmax(logits, dim=-1)
    rows = [b for b in range(B) if temperature[b] > 0]
    if not rows:
        return out
    dev = logits.device
    sel = torch.tensor(rows, device=dev)
    temp = torch.tensor([max(float(temperature[b]), 1e-6) for b in rows], device=dev)
    k = torch.tensor([int(top_k[b]) if top_k[b] > 0 else V for b in rows], device=dev)
    p = torch.tensor([float(top_p[b]) for b in rows], device=dev)

    scaled = logits[sel] / temp[:, None]
    order = torch.argsort(-scaled, dim=-1, stable=True)             # descending
    ranks = torch.argsort(order, dim=-1)                             # rank per column
    kept = torch.where(ranks < k[:, None], scaled, torch.full_like(scaled, -torch.inf))

    sorted_kept = torch.gather(kept, 1, order)
    probs = torch.softmax(sorted_kept, dim=-1)
    cdf_before = torch.cumsum(probs, dim=-1) - probs                # exclusive cumsum
    keep_sorted = cdf_before < p[:, None]                            # >= 1 column kept
    keep = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    final = torch.where(keep, kept, torch.full_like(kept, -torch.inf))

    u = torch.stack([torch.rand(V, generator=generators[b], device=dev) for b in rows])
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    out[sel] = torch.argmax(final + gumbel, dim=-1)
    return out
