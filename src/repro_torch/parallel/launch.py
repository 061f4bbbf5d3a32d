"""Start the ranks of an EP group as processes of one host.

``spawn(fn, world, ...)`` starts ``world`` processes with the ``spawn``
start method. They meet through a ``FileStore`` in a fresh temporary
directory, so no TCP port is taken and runs side by side cannot collide.
Each rank calls ``fn(group, *args)`` with its ``EPGroup`` (or, given
``grid=(dp, ep)`` or ``(dp, ep, tp)``, its ``ProcessGrid``) and its own copy
of ``args``, and sends back the result, every tensor in it moved to the
host. The parent waits at most ``timeout_s`` in all: when a rank fails, dies or the time
runs out, it kills every rank and raises, so a collective that hangs
becomes an error, not a lost run.
"""
from __future__ import annotations

import math
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Optional

import torch

from .ep import init_ep_group
from .grid import init_grid


def _to_host(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):      # a NamedTuple
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        out = type(obj)(_to_host(v) for v in obj)
        if getattr(obj, "__dict__", None):      # a list subclass's attributes
            out.__dict__.update(_to_host(vars(obj)))
        return out
    return obj


def _rank_main(fn, rank, world, backend, device, init_method, args_path, timeout_s, grid,
               results):
    import torch.distributed as dist
    try:
        if device is not None and torch.device(device).type == "cpu":
            torch.set_num_threads(1)     # world ranks share the host's cores
        group = init_ep_group(world, rank, backend=backend, init_method=init_method,
                              device=device, **({} if timeout_s is None
                                                else {"timeout_s": timeout_s}))
        if grid is not None:
            group = init_grid(group, *grid)
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        out = _to_host(fn(group, *args))
        dist.destroy_process_group()
        # by value, as the arguments: a queue would share tensors through
        # file descriptors that die with this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        if p.pid is not None:
            p.join(5)


def spawn(fn, world: int, *, args: tuple = (), backend: str = "gloo", device=None,
          timeout_s: Optional[float] = 120.0, grid: tuple = None) -> list:
    """Run ``fn(group, *args)`` on ranks 0..world-1, one process each, and
    return their results in rank order. ``fn`` must be importable by name
    (a module-level function) and its results picklable. ``device``: as in
    ``init_ep_group`` (``cuda`` unless given). ``grid``: (dp, ep) with
    dp * ep == world, or (dp, ep, tp) with dp * ep * tp == world, to hand
    ``fn`` the rank's ``ProcessGrid``. Raises ``RuntimeError`` with
    the rank's traceback when a rank fails or exits without a result, and
    ``TimeoutError`` after ``timeout_s``; every rank is killed first.
    ``timeout_s`` is also each collective's timeout in the ranks;
    ``timeout_s=None`` sets no deadline for the run (a training run), and
    the collectives time out after ``init_ep_group``'s default."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ep_")
    init_method = "file://" + os.path.join(tmp, "store")
    # the arguments go by value through a file: the spawn start method would
    # hand every rank the same shared memory for a tensor argument (a rank
    # that updates it in place would change the others' copy), and a large
    # argument in the process object makes each start wait for the last
    # rank to read it
    args_path = os.path.join(tmp, "args.pkl")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world, backend, device, init_method, args_path,
                               timeout_s, grid, results))
             for rank in range(world)]
    deadline = time.monotonic() + (math.inf if timeout_s is None else timeout_s)
    got: dict[int, object] = {}
    try:
        with open(args_path, "wb") as f:
            pickle.dump(args, f)
        for p in procs:
            p.start()
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"EP ranks {sorted(set(range(world)) - set(got))} gave no "
                                   f"result within {timeout_s} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
                if not dead:
                    continue
                # a rank that put its result just before exiting may still be in the queue
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    raise RuntimeError(f"EP rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result") from None
            if not ok:
                raise RuntimeError(f"EP rank {rank} of {world} failed:\n{out}")
            got[rank] = pickle.loads(out)
        for p in procs:
            p.join(max(1.0, min(deadline - time.monotonic(), 60.0)))
    finally:
        _kill(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world)]
