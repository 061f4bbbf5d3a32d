"""Pipeline parallelism: the gpipe and 1f1b microbatch schedules (paper
§1, PP), port of the JAX package's ``parallel/pipeline.py``.

* ``split_stages`` / ``stack_stages``: the vertical partition of a
  layer-stacked param tree into pp contiguous stage slices.
* ``gpipe_schedule`` / ``one_f_one_b_schedule`` /
  ``interleaved_1f1b_schedule``: the exact time-ordered (clock, stage,
  microbatch, F|B) tick tables, with ``validate_schedule``,
  ``bubble_fraction``, ``peak_inflight``, ``schedule_masks`` and
  ``check_pp_microbatches``: pure Python and numpy, equal to the JAX
  module's.
* ``pipeline_train_step``: the functional executor over stage functions,
  autograd in place of ``jax.vjp``.
* ``run_schedule``: the executor of the train step
  (``train.make_train_step`` with ``ParallelConfig.pp_stages > 1``), the
  counterpart of both JAX executors. A process runs the ticks of the
  stages it holds: every stage in one process (the JAX masked executor's
  role, off a 'pp' axis), or its own stage on a ``ProcessGrid`` with a
  'pp' axis (the per-stage executor, ``pipelined_loss_and_grads_per_stage``:
  only stage 0 embeds, only the last stage runs the head). A forward tick
  saves its stage's input and runs the stage without autograd; the
  backward tick recomputes the stage from that input under autograd, as
  the JAX executors recompute from the block input. Between ranks the
  activations go forward and their gradients come back through a
  ``StageLink`` over the 'pp' axis.

Bubble fractions (schedule theory): gpipe and 1f1b both (pp - 1) / (mb +
pp - 1); 1f1b keeps at most pp microbatches in flight on stage 0, where
gpipe keeps all of them.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import leaves, tree_map, unflatten

SCHEDULES = ("gpipe", "1f1b")


class Tick(NamedTuple):
    clock: int
    stage: int
    mb: int
    kind: str      # 'F' | 'B'


def _check_stage_divisible(L: int, pp: int, name: str = "") -> None:
    if pp < 1:
        raise ValueError(f"pp_stages must be >= 1, got {pp}")
    if L % pp != 0:
        who = f"config {name!r}: " if name else ""
        raise ValueError(
            f"{who}{L} layers do not divide evenly into pp_stages={pp} "
            f"pipeline stages (each stage needs L/pp whole layers)")


def split_stages(stacked_layer_params, pp: int, *, name: str = "") -> list:
    """Split a layer-stacked tree (leading dim = L) into pp subtrees
    (views)."""
    L = leaves(stacked_layer_params)[0].shape[0]
    _check_stage_divisible(L, pp, name)
    per = L // pp
    return [tree_map(lambda a: a[s * per:(s + 1) * per], stacked_layer_params)
            for s in range(pp)]


def stack_stages(stacked_layer_params, pp: int, *, name: str = ""):
    """The stage view: each (L, ...) leaf reshaped to (pp, L/pp, ...)."""
    L = leaves(stacked_layer_params)[0].shape[0]
    _check_stage_divisible(L, pp, name)
    per = L // pp
    return tree_map(lambda a: a.reshape((pp, per) + tuple(a.shape[1:])), stacked_layer_params)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def gpipe_schedule(n_mb: int, pp: int) -> List[Tick]:
    """All forwards (staggered), then all backwards (reverse-staggered)."""
    ticks = []
    for m in range(n_mb):
        for s in range(pp):
            ticks.append(Tick(m + s, s, m, "F"))
    fwd_end = (n_mb - 1) + (pp - 1) + 1
    for m in range(n_mb):
        for s in reversed(range(pp)):
            ticks.append(Tick(fwd_end + m + (pp - 1 - s), s, m, "B"))
    return sorted(ticks, key=lambda t: (t.clock, t.stage))


def one_f_one_b_schedule(n_mb: int, pp: int) -> List[Tick]:
    """PipeDream-flush (1f1b), by event-driven simulation of the policy:
    each stage keeps at most (pp - stage) microbatches in flight and prefers
    a backward over a forward once one is ready."""
    ticks = []
    ftime = {}    # (stage, mb) -> clock of completed F
    btime = {}
    fwd_next = [0] * pp
    bwd_next = [0] * pp
    clock = 0
    while sum(bwd_next) < n_mb * pp:
        for s in range(pp):
            m = bwd_next[s]
            b_ready = (m < n_mb and (s, m) in ftime and ftime[(s, m)] < clock
                       and (s == pp - 1 or
                            ((s + 1, m) in btime and btime[(s + 1, m)] < clock)))
            f = fwd_next[s]
            inflight = fwd_next[s] - bwd_next[s]
            f_ready = (f < n_mb and inflight < pp - s
                       and (s == 0 or ((s - 1, f) in ftime and ftime[(s - 1, f)] < clock)))
            if b_ready:
                ticks.append(Tick(clock, s, m, "B"))
                btime[(s, m)] = clock
                bwd_next[s] += 1
            elif f_ready:
                ticks.append(Tick(clock, s, f, "F"))
                ftime[(s, f)] = clock
                fwd_next[s] += 1
        clock += 1
        assert clock < 10 * (n_mb + pp) * 2 + 64, "1f1b scheduler stuck"
    return sorted(ticks, key=lambda t: (t.clock, t.stage))


def interleaved_1f1b_schedule(n_mb: int, pp: int, v: int) -> List[Tick]:
    """Interleaved 1f1b (Megatron): each device hosts ``v`` model chunks,
    virtual stage s on device s % pp; the same event-driven greedy over pp
    * v virtual stages. ``Tick.stage`` is the virtual stage."""
    vs = pp * v
    ticks = []
    ftime, btime = {}, {}
    fwd_next = [0] * vs
    bwd_next = [0] * vs
    clock = 0
    while sum(bwd_next) < n_mb * vs:
        busy = set()
        # backwards first, latest virtual stage first
        for s in sorted(range(vs), key=lambda x: -x):
            dev = s % pp
            if dev in busy:
                continue
            m = bwd_next[s]
            if (m < n_mb and (s, m) in ftime and ftime[(s, m)] < clock
                    and (s == vs - 1 or ((s + 1, m) in btime and btime[(s + 1, m)] < clock))):
                ticks.append(Tick(clock, s, m, "B"))
                btime[(s, m)] = clock
                bwd_next[s] += 1
                busy.add(dev)
        # then the deepest ready forwards
        for s in sorted(range(vs), key=lambda x: -x):
            dev = s % pp
            if dev in busy:
                continue
            f = fwd_next[s]
            if f < n_mb and (s == 0 or ((s - 1, f) in ftime and ftime[(s - 1, f)] < clock)):
                ticks.append(Tick(clock, s, f, "F"))
                ftime[(s, f)] = clock
                fwd_next[s] += 1
                busy.add(dev)
        clock += 1
        assert clock < 20 * (n_mb + vs) + 64, "interleaved scheduler stuck"
    return sorted(ticks, key=lambda t: (t.clock, t.stage))


def validate_schedule(ticks: Sequence[Tick], n_mb: int, pp: int, v: int = 1) -> None:
    """Dependency check: F(s,m) after F(s-1,m); B(s,m) after B(s+1,m) and
    F(s,m); one op per (device, clock). ``v`` > 1: stages are virtual,
    device = stage % pp."""
    vs = pp * v
    ftime, btime, busy = {}, {}, set()
    for t in sorted(ticks, key=lambda x: x.clock):
        dev = t.stage % pp
        assert (dev, t.clock) not in busy, "device double-booked"
        busy.add((dev, t.clock))
        if t.kind == "F":
            if t.stage > 0:
                assert ftime[(t.stage - 1, t.mb)] < t.clock, f"F dep violated at {t}"
            ftime[(t.stage, t.mb)] = t.clock
        else:
            assert ftime[(t.stage, t.mb)] < t.clock, f"B-after-F at {t}"
            if t.stage < vs - 1:
                assert btime[(t.stage + 1, t.mb)] < t.clock, f"B dep violated at {t}"
            btime[(t.stage, t.mb)] = t.clock
    assert len(ftime) == len(btime) == n_mb * vs


def bubble_fraction(n_mb: int, pp: int, schedule: str = "1f1b") -> float:
    return (pp - 1) / (n_mb + pp - 1)


def peak_inflight(ticks: Sequence[Tick], stage: int = 0) -> int:
    """Most forward activations alive at once on ``stage``."""
    alive = peak = 0
    for t in sorted(ticks, key=lambda x: x.clock):
        if t.stage != stage:
            continue
        if t.kind == "F":
            alive += 1
            peak = max(peak, alive)
        else:
            alive -= 1
    return peak


def schedule_ticks(schedule: str, n_mb: int, pp: int) -> List[Tick]:
    """The validated tick table of ``schedule`` ('gpipe' or '1f1b')."""
    if schedule not in SCHEDULES:
        raise ValueError(f"pp_schedule must be 'gpipe' or '1f1b', got {schedule!r}")
    ticks = (gpipe_schedule if schedule == "gpipe" else one_f_one_b_schedule)(n_mb, pp)
    validate_schedule(ticks, n_mb, pp)
    return ticks


def schedule_masks(schedule: str, n_mb: int, pp: int) -> dict:
    """A tick table as dense per-clock arrays: ``do_f``/``do_b`` (T, pp)
    bool and ``f_mb``/``b_mb`` (T, pp) int32, and ``ticks`` = T. Both
    schedules put at most one op per (clock, stage)."""
    ticks = schedule_ticks(schedule, n_mb, pp)
    T = max(t.clock for t in ticks) + 1
    do_f = np.zeros((T, pp), bool)
    do_b = np.zeros((T, pp), bool)
    f_mb = np.zeros((T, pp), np.int32)
    b_mb = np.zeros((T, pp), np.int32)
    for t in ticks:
        assert not (do_f[t.clock, t.stage] or do_b[t.clock, t.stage])
        if t.kind == "F":
            do_f[t.clock, t.stage] = True
            f_mb[t.clock, t.stage] = t.mb
        else:
            do_b[t.clock, t.stage] = True
            b_mb[t.clock, t.stage] = t.mb
    return {"do_f": do_f, "f_mb": f_mb, "do_b": do_b, "b_mb": b_mb, "ticks": T}


def check_pp_microbatches(n_mb: int, pp: int) -> None:
    """The per-stage executor's guardrail: microbatches must divide into
    pp_stages (balanced waves). ``pp_impl='masked'`` takes any n_mb >= 1."""
    if n_mb < 1 or n_mb % pp != 0:
        raise ValueError(
            f"pp_impl='shardmap' needs microbatches divisible by pp_stages, "
            f"got microbatches={n_mb}, pp_stages={pp}: pick microbatches = "
            f"k*{pp} (e.g. {2 * pp}) so the 1f1b/gpipe waves stay balanced "
            f"across stages, or use pp_impl='masked'")


# ---------------------------------------------------------------------------
# functional executor
# ---------------------------------------------------------------------------

def _grad_leaves(tree):
    return tree_map(lambda t: t.detach().requires_grad_(), tree)


def pipeline_train_step(stage_fwd: Callable, loss_fn: Callable, stage_params: list,
                        microbatches: list, schedule: str = "1f1b", v: int = 1):
    """Run one PP train step over ``microbatches`` in schedule order.

    stage_fwd(params_s, x) -> x_out   (one stage's forward)
    loss_fn(x_last, mb) -> scalar     (after the last stage)

    ``schedule='interleaved-1f1b'`` takes stage_params as pp * v virtual
    stages (device = stage % pp). Each forward tick records its stage's
    graph, which its backward tick pulls the cotangent through (the JAX
    executor keeps the ``jax.vjp`` closure). Returns (mean loss, per-stage
    gradient trees, each the microbatches' mean)."""
    n_mb = len(microbatches)
    if schedule == "interleaved-1f1b":
        assert len(stage_params) % v == 0
        pp = len(stage_params) // v
        ticks = interleaved_1f1b_schedule(n_mb, pp, v)
        validate_schedule(ticks, n_mb, pp, v)
        pp = pp * v
    else:
        pp = len(stage_params)
        ticks = schedule_ticks(schedule, n_mb, pp)
    params = [_grad_leaves(sp) for sp in stage_params]
    flat = [leaves(p) for p in params]
    grads = [[torch.zeros_like(t) for t in f] for f in flat]
    acts, graphs, dacts, losses = {}, {}, {}, []
    for t in ticks:
        s, m = t.stage, t.mb
        if t.kind == "F":
            if s == 0:
                acts[(0, m)] = microbatches[m]["x"]
            x = acts.pop((s, m)).detach().requires_grad_()
            y = stage_fwd(params[s], x)
            if s < pp - 1:
                acts[(s + 1, m)] = y.detach()      # the hand-off to the next stage
                graphs[(s, m)] = (x, y)
            else:
                loss = loss_fn(y, microbatches[m])
                losses.append(loss.detach())
                graphs[(s, m)] = (x, loss)
        else:
            x, out = graphs.pop((s, m))
            cot = dacts.pop((s, m), None)
            gs = torch.autograd.grad(out, flat[s] + [x], grad_outputs=cot,
                                     allow_unused=True, materialize_grads=True)
            for acc, g in zip(grads[s], gs[:-1]):
                acc.add_(g)
            if s > 0:
                dacts[(s - 1, m)] = gs[-1]         # the hand-back (reverse direction)
    loss = torch.mean(torch.stack(losses))
    return loss, [unflatten(p, [g / n_mb for g in gs]) for p, gs in zip(params, grads)]


# ---------------------------------------------------------------------------
# the train step's executor
# ---------------------------------------------------------------------------

class StageLink:
    """The hand-offs between adjacent stages of one pipeline over the 'pp'
    axis of a ``ProcessGrid``: activations go forward (``send`` to stage p
    + 1), their gradients back (to p - 1). Sends are posted non-blocking
    and a receive blocks just before the tick that consumes it, so no
    ordering of 1f1b's ticks can deadlock (every tick's inputs come from
    ticks of earlier clocks). Each message is tagged by its microbatch and
    direction.

    gloo's point-to-point ops read and write host memory only (handed a
    CUDA tensor they abort the process; ``optim.overlap._ring_all_gather``).
    Over gloo a CUDA tensor is therefore staged through a pinned host
    buffer each way: copied into it before the send, copied from it onto
    the card after the receive. Every message moves as raw bytes.
    ``sent_bytes`` counts the bytes this rank sent."""

    def __init__(self, grid, shape: tuple, dtype: torch.dtype, device: torch.device):
        self.grid, self.shape, self.dtype, self.device = grid, tuple(shape), dtype, device
        self.staged = device.type == "cuda" and grid.world.backend == "gloo"
        self.pending = []
        self.sent_bytes = 0

    def _buf(self) -> torch.Tensor:
        dev = "cpu" if self.staged else self.device
        return torch.empty(self.shape, dtype=self.dtype, device=dev, pin_memory=self.staged)

    @staticmethod
    def _tag(stage_from: int, stage_to: int, mb: int) -> int:
        return 2 * mb + (stage_to < stage_from)

    def send(self, t: torch.Tensor, stage_from: int, stage_to: int, mb: int) -> None:
        buf = self._buf()
        buf.copy_(t.detach())
        work = dist.isend(buf.reshape(-1).view(torch.uint8), self.grid.peer("pp", stage_to),
                          group=self.grid.pp.group, tag=self._tag(stage_from, stage_to, mb))
        self.pending.append((work, buf))
        self.sent_bytes += buf.numel() * buf.element_size()

    def recv(self, stage_from: int, stage_to: int, mb: int) -> torch.Tensor:
        buf = self._buf()
        dist.recv(buf.reshape(-1).view(torch.uint8), self.grid.peer("pp", stage_from),
                  group=self.grid.pp.group, tag=self._tag(stage_from, stage_to, mb))
        return buf.to(self.device) if self.staged else buf

    def close(self) -> None:
        """Wait for every posted send (their buffers live until then)."""
        for work, _ in self.pending:
            work.wait()
        self.pending = []


def run_schedule(ticks: Sequence[Tick], pp: int, stages: Sequence[int], *,
                 forward: Callable, backward: Callable, entry: Callable,
                 link: Optional[StageLink] = None) -> dict:
    """Walk the tick table ``ticks`` of ``pp`` stages, running the ticks of
    ``stages`` (the stages this process holds), in clock order.

    * ``entry(m)``: stage 0's input of microbatch m (its tokens);
    * ``forward(s, m, x) -> y``: stage s's forward on its input x, without
      autograd (the last stage's y is not used);
    * ``backward(s, m, x, dy) -> dx``: stage s recomputed from x under
      autograd and its gradients taken, ``dy`` the gradient of its output
      (None on the last stage); returns the gradient of x (unused on stage
      0).

    A forward tick saves its stage's input until the stage's backward tick
    of the same microbatch. Activations and gradients pass between stages
    of this process directly and, with ``link``, to and from the other
    stages' ranks. Returns ``{stage: the most inputs it held saved at
    once}`` (``peak_inflight`` of the table, for the 1f1b memory bound)."""
    mine = set(stages)
    last = pp - 1
    saved, box = {}, {}
    peak = {s: 0 for s in mine}

    def give(key, t, s_from, s_to, m):
        if s_to in mine:
            box[key] = t
        else:
            link.send(t, s_from, s_to, m)

    def take(key, s_from, s_to, m):
        if s_from in mine:
            return box.pop(key)
        return link.recv(s_from, s_to, m)

    for t in ticks:
        s, m = t.stage, t.mb
        if s not in mine:
            continue
        if t.kind == "F":
            x = entry(m) if s == 0 else take(("F", s, m), s - 1, s, m)
            y = forward(s, m, x)
            saved[(s, m)] = x
            peak[s] = max(peak[s], sum(1 for k in saved if k[0] == s))
            if s < last:
                give(("F", s + 1, m), y, s, s + 1, m)
        else:
            dy = None if s == last else take(("B", s, m), s + 1, s, m)
            dx = backward(s, m, saved.pop((s, m)), dy)
            if s > 0:
                give(("B", s - 1, m), dx, s, s - 1, m)
    if link is not None:
        link.close()
    return peak
