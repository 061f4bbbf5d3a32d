"""Reliability & fault tolerance (paper §4): port of the JAX package's
``ft/failures.py``.

* **Soft node failure** — a node keeps running but produces local NaNs;
  undetected, NaN weights contaminate checkpoints. ``NaNMonitor`` checks
  per-rank loss/grad-norm each step, identifies the offending rank, and
  raises ``NodeFailure(kind='soft')`` so the launcher can replace the node
  and relaunch from the last valid checkpoint.
* **Hard node failure** — the run dies outright (ping failure, segfault,
  OS error). ``ClusterManager`` models the paper's buffer-node scheme: a run
  is launched on ``n_active`` of ``n_active + n_buffer`` nodes; on failure
  the failed node is swapped for a buffer node and the run restarts.
* ``run_with_failure_handling`` is the launcher loop tying both to the dual
  checkpointer: fail -> swap node -> restore newest valid checkpoint ->
  continue. (One host, so nodes are simulated objects — the control flow is
  the deliverable.)

The port's optimizer updates its state in place (``optim.adamw_update``),
and float32 params share their tensors with the master weights. So the
state a loop held before its first step is gone once a step has run, and
the restart-from-the-beginning that the JAX loop does by keeping a
reference to its immutable initial state needs a real copy here: the
``fallback`` of ``run_with_failure_handling``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.tree import assign, keyed_leaves


class NodeFailure(RuntimeError):
    def __init__(self, node_id: int, kind: str):
        super().__init__(f"{kind} failure on node {node_id}")
        self.node_id = node_id
        self.kind = kind


class NaNMonitor:
    """Per-rank NaN detection on loss and gradient norms (soft failures)."""

    def __init__(self, rank_of_value: Optional[Callable[[int], int]] = None):
        self.rank_of_value = rank_of_value or (lambda i: i)

    def check(self, per_rank_losses, per_rank_grad_norms=None, step: int = -1):
        losses = np.asarray(per_rank_losses)
        bad = ~np.isfinite(losses)
        if per_rank_grad_norms is not None:
            bad |= ~np.isfinite(np.asarray(per_rank_grad_norms))
        if bad.any():
            rank = int(np.argmax(bad))
            raise NodeFailure(self.rank_of_value(rank), "soft")


@dataclass
class Node:
    node_id: int
    healthy: bool = True


@dataclass
class ClusterManager:
    """Buffer-node bookkeeping (paper: 'launching the training run with some
    extra buffer nodes and ... replacing the failed node')."""
    n_active: int
    n_buffer: int
    active: list = field(default_factory=list)
    buffers: list = field(default_factory=list)
    replaced: list = field(default_factory=list)

    def __post_init__(self):
        if not self.active:
            self.active = [Node(i) for i in range(self.n_active)]
            self.buffers = [Node(self.n_active + i)
                            for i in range(self.n_buffer)]

    def replace(self, node_id: int) -> Node:
        if not self.buffers:
            raise RuntimeError("no buffer nodes left — cannot recover")
        idx = next(i for i, n in enumerate(self.active)
                   if n.node_id == node_id)
        failed = self.active[idx]
        failed.healthy = False
        repl = self.buffers.pop(0)
        self.active[idx] = repl
        self.replaced.append((failed.node_id, repl.node_id))
        return repl


def snapshot(state) -> dict:
    """A host copy of every leaf of ``state`` (tensors and numpy arrays),
    keyed as ``tree.keyed_leaves`` keys them."""
    return {k: leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor)
            else np.array(leaf, copy=True) for k, leaf in keyed_leaves(state)}


def restore_into(state, leaves_by_key: dict):
    """Write ``leaves_by_key`` (as ``snapshot`` gives it) into the leaves of
    ``state`` in place and return ``state``. A missing key raises."""
    for k, leaf in keyed_leaves(state):
        if k not in leaves_by_key:
            raise KeyError(f"no value for leaf {k}")
        assign(leaf, leaves_by_key[k], k)
    return state


def run_with_failure_handling(train_one_step, *, state, checkpointer,
                              cluster: ClusterManager, num_steps: int,
                              monitor: Optional[NaNMonitor] = None,
                              max_relaunches: int = 8,
                              on_relaunch=None, start_step: int = 0,
                              fallback=None):
    """Launcher loop: step -> checkpoint -> on failure swap node + restore.

    ``train_one_step(state, step) -> (state, metrics)`` may raise
    NodeFailure (hard) or return NaN metrics (soft, caught by the monitor);
    it may update ``state`` in place. ``start_step`` supports resuming a run
    already restored by the caller. A relaunch restores the newest valid
    checkpoint into the live state (``checkpointer.restore``). With none yet
    it calls ``fallback(state) -> state``, which must write the state of
    ``start_step`` into the live state's leaves: a restart must not keep
    partial updates, or the replayed steps would be applied twice. Without
    a ``fallback`` the loop takes a host copy of ``state`` here, before the
    first step (``snapshot``), and writes it back (``restore_into``).

    On a dp x ep grid every rank runs this loop on its own shards of the
    state with a grid ``Checkpointer``: the steps, checkpoints and restores
    are collective, so a failure must reach every rank at the same step
    (the launcher injects it on every rank; the metrics the monitor checks
    are the same on every rank), and each rank's ``snapshot`` and
    ``fallback`` hold only its own shards.
    Returns (state, step_reached, relaunches).
    """
    monitor = monitor or NaNMonitor()
    if fallback is None:
        initial = snapshot(state)

        def fallback(live):
            return restore_into(live, initial)
    relaunches = 0
    step = start_step
    while step < num_steps:
        try:
            state, metrics = train_one_step(state, step)
            losses = metrics.get("per_rank_losses",
                                 [float(metrics.get("loss", 0.0))])
            monitor.check(losses, metrics.get("per_rank_grad_norms"),
                          step=step)
            checkpointer.maybe_save(state, getattr(state, "params", state),
                                    step)
            step += 1
        except NodeFailure as f:
            relaunches += 1
            if relaunches > max_relaunches:
                raise
            cluster.replace(f.node_id)
            restored, ck_step = checkpointer.restore(state)
            if restored is not None:
                state, step = restored, ck_step + 1  # post-step checkpoint
            else:
                state, step = fallback(state), start_step
            if on_relaunch is not None:
                state = on_relaunch(state, f, step)
    return state, step, relaunches
