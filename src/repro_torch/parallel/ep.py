"""The expert-parallel (EP) process group and its collectives: the port's
counterpart of the ``shard_map`` EP axis of the JAX package's
``core/moe.py::moe_fsmoe_ep``.

Each rank runs the same program on its share of the batch. Its loss is its
*share* of the global loss (the global loss is the sum of the shares), so
every collective's backward is its adjoint under that sum:

* ``all_gather_tokens``      (n, ...) -> (world * n, ...) in rank order
                             (``all_gather(tiled=True)``); backward: a
                             reduce-scatter (sum) of the gradient.
* ``reduce_scatter_tokens``  (world * n, ...) -> (n, ...), rank r's block of
                             the sum over ranks (``psum_scatter``); backward:
                             an all-gather.
* ``all_reduce_sum``         the sum over ranks, held by every rank
                             (``psum``); backward: the sum over ranks of the
                             gradients.
* ``all_to_all_rows``        (world * C, ...) in world row blocks, block j
                             sent to rank j; rank r receives every rank's
                             block r, in rank order (``all_to_all``, the
                             all-to-all Stage 1); backward: the same
                             exchange of the gradient.

Tensor parallelism (a 'tp' group whose ranks hold the same rows and split
the weights) takes the Megatron pair, the shard_map boundaries of the JAX
package's tp-sharded layers:

* ``tp_copy``    the identity; backward: the sum over the group of the
                 gradients (each rank's gradient is its weight shard's part);
* ``tp_reduce``  the sum over the group of the ranks' partial outputs;
                 backward: the identity (every rank holds the whole output).

The same module runs over ``nccl`` (one card per rank) or ``gloo`` (CPU
ranks, or several ranks sharing one card). PyTorch 2.11's gloo takes CUDA
tensors for these collectives in every dtype the port sends (it copies them
through host memory itself), so this module copies none of them to the
host. A collective that fails raises. A group of one rank (an axis of
size 1 of a ``parallel.ProcessGrid``) has no process group: its collectives
are the identity and call nothing.

``CollectiveTape`` keeps the outputs of the collectives a function calls
and hands them back, in order and with no communication, when the function
runs again: ``models.model.block_remat``'s 'block_sc' policy runs a
checkpointed block under one, so that its recompute does not run the
block's collectives a second time.
"""
from __future__ import annotations

import contextvars
import datetime
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

@dataclass(frozen=True)
class EPGroup:
    """One rank's view of the EP group."""
    group: Any               # torch.distributed ProcessGroup
    rank: int
    world: int
    device: torch.device
    backend: str


def init_ep_group(world: int, rank: int, *, backend: str, init_method: str,
                  device: DeviceLike = None, timeout_s: float = 600.0) -> EPGroup:
    """Join the default process group as ``rank`` of ``world`` and return the
    EP group over all of it. ``init_method``: a rendezvous URL
    (``file://...`` or ``tcp://host:port``). The rank runs on ``cuda`` unless
    ``device`` says otherwise; a bare ``cuda`` is ``cuda:rank`` under nccl
    (one card per rank) and ``cuda:0`` under gloo (ranks sharing one card).
    A collective that waits longer than ``timeout_s`` raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return EPGroup(dist.group.WORLD, rank, world, dev, backend)


# ----------------------------------------------------------------------------
# the tape of a recomputed region
# ----------------------------------------------------------------------------

class CollectiveTape:
    """The outputs of the collectives that a function's first run calls
    (``record``), handed back in the same order by its later runs
    (``replay``) instead of communicating: every rank runs the same
    collectives in the same order, so a replayed run is the first one's,
    bit for bit. Only the forward calls of a run go through it; the
    collectives of the backward, which the autograd engine runs outside
    the function, communicate.

    A checkpoint's recompute stops once it has remade every saved tensor,
    so it may replay only the first few outputs. The tape learns how many
    from the first replay of a run with the same signature (the
    collectives called and their outputs' shapes) and keeps no more than
    that from the end of a first run to its replay; a replay that reaches
    past what was kept communicates, as every rank does the same. It drops
    its outputs once a replay is done."""

    # signature of a first run -> the most outputs a replay of it took
    _replayed: dict = {}

    def __init__(self):
        self.outs: list = []
        self.sig: list = []
        self.pos = None           # None: recording; else the next output to hand back
        self.recorded = False

    def run(self, fn, *args):
        """``fn(*args)`` with this tape active: a first run under grad
        records (a run without grad keeps nothing: no recompute follows it),
        a later one replays."""
        if not self.recorded and not torch.is_grad_enabled():
            return fn(*args)
        self.pos = 0 if self.recorded else None
        token = _TAPE.set(self)
        try:
            return fn(*args)
        finally:
            _TAPE.reset(token)
            key = tuple(self.sig)
            if not self.recorded:
                self.recorded = True
                keep = CollectiveTape._replayed.get(key)
                if keep is not None:
                    del self.outs[keep:]
            else:
                CollectiveTape._replayed[key] = max(self.pos,
                                                    CollectiveTape._replayed.get(key, 0))
                self.outs = []

    def call(self, collective, *args) -> torch.Tensor:
        if self.pos is None:
            out = collective(*args)
            self.outs.append(out.detach())
            self.sig.append((collective.__name__, tuple(out.shape), out.dtype))
            return out
        out = self.outs[self.pos].detach() if self.pos < len(self.outs) else collective(*args)
        self.pos += 1
        return out


# the CollectiveTape active in this context (the recompute of a checkpoint
# runs in the autograd engine's thread, and sets it there), or None
_TAPE = contextvars.ContextVar("collective_tape", default=None)


def _taped(collective, *args) -> torch.Tensor:
    tape = _TAPE.get()
    return collective(*args) if tape is None else tape.call(collective, *args)


# ----------------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------------

def all_gather_dim(x: torch.Tensor, g: EPGroup, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``dim`` in rank order, on every
    rank; not differentiable (``all_gather_tokens`` is)."""
    if g.world == 1:
        return x
    return _taped(_all_gather, x, g, dim)


def _all_gather(x: torch.Tensor, g: EPGroup, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(g.world)]
    dist.all_gather(parts, x.contiguous(), group=g.group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, g: EPGroup) -> torch.Tensor:
    if g.world == 1:
        return x
    if x.shape[0] % g.world:
        raise ValueError(f"reduce-scatter of {x.shape[0]} rows over {g.world} ranks")
    return _taped(_reduce_scatter_rows, x, g)


def _reduce_scatter_rows(x: torch.Tensor, g: EPGroup) -> torch.Tensor:
    chunks = list(x.contiguous().chunk(g.world))
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=g.group)
    return out


def _all_reduce(x: torch.Tensor, g: EPGroup) -> torch.Tensor:
    if g.world == 1:
        return x.contiguous().clone()
    return _taped(_all_reduce_sum, x, g)


def _all_reduce_sum(x: torch.Tensor, g: EPGroup) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=g.group)
    return out


def all_to_all_dim(x: torch.Tensor, g: EPGroup) -> torch.Tensor:
    """``x``'s ``world`` row blocks exchanged: block j goes to rank j, and
    the result holds every rank's block ``rank`` in rank order; not
    differentiable (``all_to_all_rows`` is)."""
    if g.world == 1:
        return x
    if x.shape[0] % g.world:
        raise ValueError(f"all-to-all of {x.shape[0]} rows over {g.world} ranks")
    return _taped(_all_to_all, x, g)


def _all_to_all(x: torch.Tensor, g: EPGroup) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=g.group)
    return out


class _AllGatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return all_gather_dim(x, g)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter(dy, ctx.g), None


class _ReduceScatterTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _reduce_scatter(x, g)

    @staticmethod
    def backward(ctx, dy):
        return all_gather_dim(dy, ctx.g), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _all_reduce(x, g)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.g), None


class _AllToAllRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return all_to_all_dim(x, g)

    @staticmethod
    def backward(ctx, dy):
        # the exchange is its own transpose: block j of rank r came from
        # block r of rank j, and its gradient goes back there
        return all_to_all_dim(dy, ctx.g), None


class _TPCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.g), None


class _TPReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return _all_reduce(x, g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def all_gather_tokens(x: torch.Tensor, g: EPGroup) -> torch.Tensor:
    """(n, ...) on every rank -> (world * n, ...), the ranks' blocks in rank
    order. Backward: reduce-scatter (sum)."""
    return _AllGatherTokens.apply(x, g)


def reduce_scatter_tokens(x: torch.Tensor, g: EPGroup) -> torch.Tensor:
    """(world * n, ...) on every rank -> (n, ...): block ``rank`` of the sum
    over ranks. Backward: all-gather."""
    return _ReduceScatterTokens.apply(x, g)


def all_reduce_sum(x: torch.Tensor, g: EPGroup) -> torch.Tensor:
    """The sum of ``x`` over ranks, on every rank. Backward: the sum over
    ranks of the gradients (each rank's loss is its share of the total)."""
    return _AllReduceSum.apply(x, g)


def all_to_all_rows(x: torch.Tensor, g: EPGroup) -> torch.Tensor:
    """(world * C, ...) on every rank, block j for rank j -> (world * C,
    ...): block j is rank j's block ``rank``. Backward: the same exchange
    of the gradient."""
    return x if g.world == 1 else _AllToAllRows.apply(x, g)


def tp_copy(x: torch.Tensor, g) -> torch.Tensor:
    """Enter a tensor-parallel region: ``x`` as it is (every rank of the
    'tp' group ``g`` holds it whole). Backward: the gradient summed over the
    group. ``g`` None or of one rank: ``x`` itself."""
    return x if g is None or g.world == 1 else _TPCopy.apply(x, g)


def tp_reduce(x: torch.Tensor, g) -> torch.Tensor:
    """Leave a tensor-parallel region: the ranks' partial outputs summed
    over the 'tp' group ``g``. Backward: the identity. ``g`` None or of one
    rank: ``x`` itself."""
    return x if g is None or g.world == 1 else _TPReduce.apply(x, g)
