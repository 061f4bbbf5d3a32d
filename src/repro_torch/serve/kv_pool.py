"""Slot-indexed KV cache pool for continuous batching. Port of the JAX
package's ``serve/kv_pool.py``.

One device-resident cache (``models.init_cache``) whose batch axis is
reinterpreted as *slots*: every leaf is (L, num_slots, ...). Slot
bookkeeping (the free list) lives on the host; slot contents need no
cleanup on eviction because the decode path masks cache entries by the
per-slot position. Sliding-window configs get window-sized ring slots.
"""
from __future__ import annotations

from collections import deque

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import init_cache


class SlotKVPool:
    """Fixed-capacity pool of cache slots over ``models.init_cache``."""

    def __init__(self, cfg, num_slots: int, max_len: int, dtype=torch.float32,
                 device: DeviceLike = None, tp: int = 1):
        if 0 < max_len < cfg.sliding_window:
            # a ring smaller than the model's window would narrow attention
            # from the second decode token on
            raise ValueError(
                f"max_len {max_len} < sliding_window {cfg.sliding_window}: "
                "ring slots must hold the model's full attention window")
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.device = resolve_device(device)
        # a serving grid's 'tp' ranks each hold their kv heads' share
        self.cache = init_cache(cfg, num_slots, max_len, device=self.device, dtype=dtype, tp=tp)
        # the deque carries the reuse order; the set makes free() O(1)
        self._free = deque(range(num_slots))
        self._free_set = set(self._free)

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        """Claim a free slot (most recently freed first, else lowest index).
        Raises when the pool is exhausted."""
        if not self._free:
            raise RuntimeError("KV pool exhausted: no free slots")
        slot = self._free.popleft()
        self._free_set.discard(slot)
        return slot

    def free(self, slot: int) -> None:
        """Return a slot; double frees and out-of-range slots raise."""
        if slot in self._free_set or not 0 <= slot < self.num_slots:
            raise ValueError(f"bad free of slot {slot}")
        self._free.appendleft(slot)
        self._free_set.add(slot)

    def slot_bytes(self) -> int:
        """Per-slot cache footprint in bytes."""
        return sum(t.numel() * t.element_size() // self.num_slots
                   for t in self.cache["kv"].values())
