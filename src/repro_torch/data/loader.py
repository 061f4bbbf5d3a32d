"""mmap-mode shard loader (paper §4): lazy, contiguous per-DP-rank reads.

Global step b consumes instances [b*GB, (b+1)*GB); DP rank r with per-rank
batch size br reads the contiguous slice [b*GB + r*br, b*GB + (r+1)*br) —
one contiguous region of (at most two) shard files.

A copy of the JAX package's ``data/loader.py``: batches are numpy int32.
"""
from __future__ import annotations

import json
import os

import numpy as np


class ShardedDataLoader:
    def __init__(self, data_dir: str, *, global_batch: int,
                 dp_rank: int = 0, dp_size: int = 1, start_step: int = 0):
        with open(os.path.join(data_dir, "meta.json")) as f:
            self.meta = json.load(f)
        if global_batch % dp_size:
            raise ValueError(f"global batch {global_batch} does not split over "
                             f"{dp_size} DP ranks")
        self.global_batch = global_batch
        self.rank_batch = global_batch // dp_size
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.start_step = start_step     # where __iter__ (re)starts
        self._mmaps = [np.load(os.path.join(data_dir, s), mmap_mode="r")
                       for s in self.meta["shards"]]
        self._sizes = np.array([m.shape[0] for m in self._mmaps])
        self._offsets = np.concatenate([[0], np.cumsum(self._sizes)])
        self.num_instances = int(self._offsets[-1])
        self.steps_per_epoch = self.num_instances // global_batch

    def _gather(self, start: int, count: int) -> np.ndarray:
        """Contiguous instance range across shard boundaries."""
        out = []
        while count > 0:
            k = int(np.searchsorted(self._offsets, start, side="right") - 1)
            local = start - int(self._offsets[k])
            take = min(count, int(self._sizes[k]) - local)
            out.append(np.asarray(self._mmaps[k][local:local + take]))
            start += take
            count -= take
        return np.concatenate(out, axis=0)

    def batch(self, step: int) -> dict:
        """(tokens, labels) for this DP rank at a global step (wraps per
        epoch). Shapes: (rank_batch, context)."""
        base = (step % self.steps_per_epoch) * self.global_batch
        start = base + self.dp_rank * self.rank_batch
        inst = self._gather(start, self.rank_batch).astype(np.int32)
        return {"tokens": inst[:, :-1], "labels": inst[:, 1:]}

    # ---- fault-tolerant resume ------------------------------------------
    # The batch sequence is a pure function of the global step, so resume
    # hygiene is just "restart the iterator at the restored step" — the
    # launcher restores a checkpoint at step k and points the loader at k+1,
    # replaying the exact batch order an uninterrupted run would have seen.
    # The loader is ONE resumable stream: ``start_step`` is a shared step
    # cursor that every iterator reads and advances on each next(), so
    # ``load_state_dict`` re-points live iterators mid-flight and
    # ``state_dict`` always names the next step to be served (a second
    # ``iter()`` continues the stream rather than restarting at 0).

    def state_dict(self) -> dict:
        """``step`` = the next global step the iterator will serve."""
        return {"step": self.start_step}

    def load_state_dict(self, state: dict) -> None:
        self.start_step = int(state["step"])

    def __iter__(self):
        while True:
            b = self.batch(self.start_step)
            self.start_step += 1
            yield b
