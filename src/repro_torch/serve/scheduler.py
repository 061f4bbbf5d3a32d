"""Request admission: FIFO with prefill-priority and a token budget (a copy
of the JAX package's ``serve/scheduler.py``, which is pure Python).

The engine runs one scheduler pass per step, *before* the batched decode
(prefill-priority: a newly arrived request is prefilled and joins the very
next decode step rather than waiting for the batch to drain — the
continuous-batching property). Admission is FIFO-ordered and bounded by

  * free cache slots (capacity), and
  * ``prefill_token_budget`` — max prompt tokens prefilled per engine step.
    Prefill of admitted requests runs between two decode steps, so this knob
    caps the per-token latency spike the in-flight requests see when a burst
    arrives (the analog of rtp-llm's max_context_batch_size).

A head-of-line request longer than the whole budget is admitted alone
rather than starved.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

from .sampling import SamplingParams


@dataclass
class Request:
    rid: int
    prompt: Sequence[int]
    max_new_tokens: int = 32
    sampling: SamplingParams = field(default_factory=SamplingParams)
    arrival_time: float = 0.0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


class FIFOScheduler:
    def __init__(self, prefill_token_budget: int = 2048):
        self.prefill_token_budget = prefill_token_budget
        self._queue: deque[Request] = deque()

    def submit(self, req: Request) -> None:
        self._queue.append(req)

    def __len__(self) -> int:
        return len(self._queue)

    def pop_admissible(self, free_slots: int,
                       now: Optional[float] = None) -> list[Request]:
        """Admit FIFO-head requests while slots and the token budget last.
        ``now`` (wall-clock) gates requests whose ``arrival_time`` lies in
        the future — lets benchmarks replay a recorded arrival trace."""
        admitted: list[Request] = []
        budget = self.prefill_token_budget
        while self._queue and free_slots > 0:
            head = self._queue[0]
            if now is not None and head.arrival_time > now:
                break
            if admitted and head.prompt_len > budget:
                break                      # keep for next step; no starvation
            admitted.append(self._queue.popleft())
            free_slots -= 1
            budget -= head.prompt_len
        return admitted
