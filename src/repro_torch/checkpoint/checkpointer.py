"""Checkpointing substrate (paper §4): port of the JAX package's
``checkpoint/checkpointer.py``.

* **Dual checkpointing** — two full-checkpoint slots (ckpt-1 / ckpt-2),
  alternating by age; a failure mid-write never destroys the only valid
  checkpoint. Writes are atomic (tmp dir + rename) and a MANIFEST with step
  + leaf checksums marks validity.
* **Persistent model-only checkpointing** — parameters only, kept at every
  interval (never rotated) so training can be tracked back to a good regime
  after divergence; restoring one reinitializes optimizer states.
* **DP-scattered model checkpointing** — model-parallel shard m is written
  by DP rank (m % DP) (``dp_scattered_writers``).
* **Model broadcasting** — only one rank loads from the filesystem and
  broadcasts (``broadcast_params``).

The files are the JAX package's: ``state.npz`` / ``model-{step:08d}.npz``
keyed by ``jax.tree_util.keystr`` strings (``tree.keyed_leaves`` builds the
same strings from the port's NamedTuples and dicts), a MANIFEST.json with
the same fields, and the same ``_checksum``. A checkpoint written by either
package restores in the other.

Where the port differs, PyTorch and the card force it:

* Save moves each leaf to the host as it writes it, one npz member at a
  time, so the host holds one leaf at a time, not the state. numpy has no
  bfloat16 and the JAX package reads no bfloat16 member back, so a bf16
  leaf is refused.
* Restore writes into the template's tensors in place (``copy_`` from the
  npz array, on the template's device and in its dtype) and returns the
  template: the optimizer state of a full-width model is tens of GB, and a
  second copy beside it would not fit the card. float32 params that share
  their tensors with the master weights (``optim.adamw_init``) go on
  sharing them; such a shared tensor is read from the file once.
* With a ``plan`` (``parallel.ResolvedPlan``) the MANIFEST carries its
  spec and layout, and ``restore`` refuses a checkpoint written under
  another layout unless ``on_plan_mismatch='reshard'``, as the JAX package
  does.

Under an expert placement (``parallel.placement``) the expert stacks are
saved in their placed order, as the JAX package saves them, and the live
``placement`` (the launcher keeps it current) rides in the MANIFEST in the
JAX format; ``restore`` sets ``restored_placement`` from it (None when the
MANIFEST has none), so that the caller runs the step in the placement the
arrays were written in. A placement changes no layout: on a grid the
files hold the same whole arrays. Model-only files have no MANIFEST, so
their expert stacks are written back in global-id order (the JAX package
writes them in placed order, with no record of the placement).

On a dp x pp x ep x tp process grid (``grid=``, the rank's
``parallel.ProcessGrid``; every rank makes the same calls) the files are
still the JAX package's: whole arrays. A rank holds a tile of each leaf
(``parallel.sharding.tile_slices`` of the ``layout=`` the caller passes,
``train.state_layout``: pipeline stages of the layer stacks over 'pp',
expert slices over 'ep', tp shards, fsdp tiles over 'data', SO/EPSO state
shards); a stage-split layer stack is one stage-agnostic (L, ...) array on disk, as the JAX
checkpointer writes it, so checkpoints move across pipeline layouts. On save, leaf by leaf, the first rank holding each distinct tile
(so one of the tp replicas of a leaf 'tp' does not split) sends it to rank 0, which assembles the leaf
on the host and writes the member: the host holds one leaf at a time. On
restore rank 0 alone reads each member once and sends every rank its tile
(paper §4, "Model Broadcasting"), which the rank writes into its live
tensors in place. The traffic goes through host tensors over the grid's
gloo process group; the other ranks wait for rank 0's writes at a barrier,
inside the group's timeout (``init_ep_group(timeout_s=)``).
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import time
import zipfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.grid import rank_coords
from repro_torch.parallel.placement import ExpertPlacement, is_expert_stack
from repro_torch.parallel.sharding import tile_slices
from repro_torch.tree import assign, keyed_leaves, leaves, leaves_with_path

CHECKSUM_BYTES = 4096


# ---------------------------------------------------------------------------
# tree <-> flat npz
# ---------------------------------------------------------------------------

def _refuse_bf16(key: str, leaf) -> None:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        raise ValueError(f"{key}: a bfloat16 leaf cannot be checkpointed (numpy has no "
                         f"bfloat16, and the JAX package reads none back); keep the "
                         f"state in float32")


def _host(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        _refuse_bf16(key, leaf)
        return leaf.detach().contiguous().cpu().numpy()
    return np.ascontiguousarray(leaf)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _write_npz(path, tree, tiles=None, order=None) -> dict:
    """``np.savez(path, **flat)`` member by member: each leaf is moved to the
    host, written and dropped. Returns {key: the leaf's first bytes}. With
    ``tiles`` (a grid's ``_Tiles``) each leaf is first gathered whole on
    rank 0, the only rank that writes (the others pass ``path=None``).
    ``order(key, array)``: the whole array to write in its place."""
    heads = {}
    with contextlib.ExitStack() as stack:
        zf = None if path is None else stack.enter_context(zipfile.ZipFile(
            _npz_path(path), mode="w", compression=zipfile.ZIP_STORED, allowZip64=True))
        for key, leaf in keyed_leaves(tree):
            arr = _host(key, leaf) if tiles is None else tiles.gather(key, leaf)
            if zf is None:
                continue
            if order is not None:
                arr = order(key, arr)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
            heads[key] = arr.reshape(-1).view(np.uint8)[:CHECKSUM_BYTES].copy()
    return heads


def save_pytree(tree, path: str):
    _write_npz(path, tree)


def _on_writer(tiles, fn):
    """``fn()`` on the rank that reads and writes the files (the only one
    without a grid); its result, or the error it raised, on every rank."""
    return fn() if tiles is None else tiles.agree(fn)


def load_pytree(template, path, tiles=None):
    """Write the npz at ``path`` into ``template``'s leaves in place and
    return ``template``. A missing key or another shape raises. With
    ``tiles`` rank 0 reads the file (the others pass ``path=None``) and
    sends each rank its tiles."""
    keys = keyed_leaves(template)

    def check():
        with np.load(_npz_path(path)) as data:
            missing = [k for k, _ in keys if k not in data.files]
        if missing:
            raise KeyError(f"{path}: no leaf {missing[0]}")
    _on_writer(tiles, check)
    shared = set()
    with contextlib.ExitStack() as stack:
        data = None if path is None else stack.enter_context(np.load(_npz_path(path)))
        for key, leaf in keys:
            if isinstance(leaf, torch.Tensor):
                ident = (leaf.data_ptr(), leaf.dtype, tuple(leaf.shape), leaf.stride())
                if ident in shared:
                    continue            # an f32 param that is its master weight
                shared.add(ident)
            if tiles is None:
                assign(leaf, data[key], key)
            else:
                tiles.scatter(key, leaf, data)
    return template


class _Tiles:
    """A grid's checkpoint traffic: which rank holds which tile of each
    leaf (``layout``: ``train.state_layout``, keyed by the files' keys),
    moved through host tensors
    between the ranks and rank 0, the one rank that writes and reads the
    files. Every rank makes the same calls in the same order."""

    def __init__(self, grid, layout: dict):
        if grid.world.backend != "gloo":
            raise NotImplementedError(
                f"checkpoints of a grid on the {grid.world.backend!r} backend: the tiles go "
                f"through host tensors over gloo (ROADMAP.md §1 item 5.9, NCCL with one card per "
                f"rank)")
        self.group, self.rank = grid.world.group, grid.world.rank
        self.sizes = grid.axis_sizes
        self.coords = [rank_coords(r, grid.sizes) for r in range(grid.world.world)]
        self.layout = layout

    def _tiles(self, key: str) -> tuple:
        shape, place = self.layout[key]
        return shape, [tile_slices(place, shape, c, self.sizes) for c in self.coords]

    def _check(self, key: str, leaf, want) -> None:
        _refuse_bf16(key, leaf)
        if tuple(leaf.shape) != tuple(want):
            raise ValueError(f"{key}: this rank holds {tuple(leaf.shape)}, the plan's layout "
                             f"gives it a tile of {tuple(want)}")

    @staticmethod
    def _shape(sl) -> tuple:
        return tuple(s.stop - s.start for s in sl)

    def agree(self, fn):
        """``fn()`` run on rank 0; its result, or the error it raised, on
        every rank."""
        out = [None]
        if self.rank == 0:
            try:
                out = [(True, fn())]
            except (OSError, KeyError, ValueError, NotImplementedError) as e:
                out = [(False, e)]
        dist.broadcast_object_list(out, src=0, group=self.group)
        ok, val = out[0]
        if not ok:
            raise val
        return val

    def gather(self, key: str, leaf):
        """The whole leaf as a numpy array on rank 0 (None elsewhere): each
        distinct tile sent once, by the first rank holding it."""
        shape, tiles = self._tiles(key)
        self._check(key, leaf, self._shape(tiles[self.rank]))
        spans = [tuple((s.start, s.stop) for s in sl) for sl in tiles]
        owner = {span: spans.index(span) for span in spans}     # tile -> first holder
        if self.rank != 0:
            if owner[spans[self.rank]] == self.rank:
                dist.send(torch.from_numpy(_host(key, leaf)), dst=0, group=self.group)
            return None
        local = _host(key, leaf)
        if len(owner) == 1:
            return local                    # every rank holds the whole leaf
        full = np.empty(shape, dtype=local.dtype)
        for r in owner.values():
            if r == 0:
                full[tiles[0]] = local
                continue
            buf = np.empty(self._shape(tiles[r]), dtype=local.dtype)
            dist.recv(torch.from_numpy(buf), src=r, group=self.group)
            full[tiles[r]] = buf
        return full

    def scatter(self, key: str, leaf, data) -> None:
        """Rank 0's member ``data[key]`` (read there only) into every rank's
        tile ``leaf``, in place."""
        shape, tiles = self._tiles(key)
        self._check(key, leaf, self._shape(tiles[self.rank]))
        if self.rank == 0:
            arr = data[key]
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"{key}: the file holds {arr.shape}, the plan's layout "
                                 f"{tuple(shape)}")
        whole = all(self._shape(sl) == tuple(shape) for sl in tiles)
        if whole:
            buf = torch.from_numpy(np.require(arr, requirements="C")).to(leaf.dtype) \
                if self.rank == 0 \
                else torch.empty(tuple(shape), dtype=leaf.dtype)
            dist.broadcast(buf, src=0, group=self.group)
        elif self.rank == 0:
            for r, sl in enumerate(tiles[1:], start=1):
                dist.send(torch.from_numpy(np.require(arr[sl], requirements="C")).to(leaf.dtype),
                          dst=r, group=self.group)
            buf = torch.from_numpy(np.require(arr[tiles[0]], requirements="C"))
        else:
            buf = torch.empty(tuple(leaf.shape), dtype=leaf.dtype)
            dist.recv(buf, src=0, group=self.group)
        assign(leaf, buf, key)


def _checksum(d: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(d):
        h.update(k.encode())
        h.update(np.ascontiguousarray(d[k]).tobytes()[:CHECKSUM_BYTES])
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# DP-scattered write assignment, model broadcasting
# ---------------------------------------------------------------------------

def dp_scattered_writers(num_model_shards: int, dp_size: int) -> dict:
    """shard m -> writing DP rank (paper: d = m % DP)."""
    return {m: m % dp_size for m in range(num_model_shards)}


def broadcast_params(params, group=None, place=None):
    """Load-once-broadcast (paper §4 'Model Broadcasting'). Without a group
    the identity. With an EP group (``parallel.EPGroup``) and ``place``,
    the placement of the whole tree whose rank's share ``params`` is
    (``param_placements`` on ('ep', world), as ``parallel.ep_shard`` cut
    it), rank 0's values of every leaf that no axis splits
    (``parallel.replicated_leaves``) are broadcast into the other ranks'
    tensors in place; the tiles (the expert slices, a table's vocab rows)
    are each rank's own and stay as they are."""
    if group is None:
        return params
    if place is None:
        raise ValueError("broadcast_params over a group needs the params' placement (place=)")
    from repro_torch.parallel.sharding import replicated_leaves
    for t, whole in zip(leaves(params), replicated_leaves(place)):
        if whole:
            dist.broadcast(t.data, src=0, group=group.group)
    return params


# ---------------------------------------------------------------------------
# Checkpointer
# ---------------------------------------------------------------------------

class Checkpointer:
    """Dual + model-only checkpointing of a state on one device or, with
    ``grid``, of each rank's tiles of it (whole arrays in the files).

    ``plan`` (a ``parallel.ResolvedPlan``): its spec and axis layout go into
    each MANIFEST, and ``restore`` refuses a checkpoint written under another
    layout unless ``on_plan_mismatch='reshard'`` (the files hold whole
    arrays, so the live layout's tiles are cut from them either way). A
    ``grid`` of more than one rank needs the ``layout`` of the state's
    tiles on it (``train.state_layout`` of the live plan), and a ``plan``
    given with it must be the grid's. ``placement``: the live
    ``ExpertPlacement`` (None: identity), which its caller keeps current
    and which goes into each MANIFEST; ``restored_placement``: the one of
    the checkpoint ``restore`` read."""

    def __init__(self, root: str, *, interval: int = 1000, model_only_interval: int = 0,
                 plan=None, on_plan_mismatch: str = "error", grid=None, layout=None):
        if on_plan_mismatch not in ("error", "reshard"):
            raise ValueError("on_plan_mismatch must be 'error' or 'reshard',"
                             f" got {on_plan_mismatch!r}")
        self.root = root
        self.interval = interval
        self.model_only_interval = model_only_interval or interval
        self.plan = plan
        self.on_plan_mismatch = on_plan_mismatch
        self.placement = None            # live ExpertPlacement or None
        self.restored_placement = None   # set by restore()
        self._tiles = None
        if grid is not None and grid.world.world > 1:
            if layout is None:
                raise ValueError("a Checkpointer on a grid needs the layout of the ranks' "
                                 "tiles (layout=train.state_layout(...))")
            want = grid.spec
            if plan is not None and plan.grid != want:
                raise ValueError(f"plan '{plan.spec()}' is a {plan.grid} grid, the ranks a "
                                 f"{grid.sizes} one")
            self._tiles = _Tiles(grid, layout)
        self._writer = self._tiles is None or self._tiles.rank == 0
        os.makedirs(root, exist_ok=True)
        self.slots = [os.path.join(root, "ckpt-1"),
                      os.path.join(root, "ckpt-2")]

    def _done(self) -> None:
        """On a grid, every rank returns once rank 0 has written."""
        if self._tiles is not None:
            dist.barrier(group=self._tiles.group)

    # ---- dual full checkpoints -------------------------------------------
    def _slot_manifest(self, slot: str):
        man = os.path.join(slot, "MANIFEST.json")
        if not os.path.exists(man):
            return None
        try:
            with open(man) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _slot_step(self, slot: str) -> int:
        m = self._slot_manifest(slot)
        if m is None:
            return -1
        try:
            return int(m["step"]) if m.get("valid") else -1
        except (KeyError, TypeError, ValueError):
            return -1

    def _oldest_slot(self) -> str:
        steps = [self._slot_step(s) for s in self.slots]
        return self.slots[int(np.argmin(steps))]

    def save(self, state, step: int, *, fail_after_write: bool = False):
        """Write a full checkpoint into the *older* of the two slots.
        ``fail_after_write`` simulates a mid-checkpoint failure (tests)."""
        slot = _on_writer(self._tiles, self._oldest_slot)
        tmp = slot + ".tmp"
        if self._writer:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        heads = _write_npz(os.path.join(tmp, "state.npz") if self._writer else None, state,
                           self._tiles)
        if self._writer:
            if not fail_after_write:   # a crash before the manifest leaves the slot invalid
                man = {"step": step, "valid": True, "time": time.time(),
                       "checksum": _checksum(heads)}
                if self.plan is not None:
                    man["plan"] = {"spec": self.plan.spec(),
                                   "layout": self.plan.layout_signature()}
                if self.placement is not None:
                    man["placement"] = self.placement.to_manifest()
                with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                    json.dump(man, f)
            if os.path.exists(slot):
                shutil.rmtree(slot)
            os.rename(tmp, slot)
        self._done()
        return slot

    def _newest(self):
        """(slot, step, MANIFEST placement) of the newest valid slot, or
        (None, -1, None), after the manifest's checks."""
        best, best_step = None, -1
        for slot in self.slots:
            s = self._slot_step(slot)
            if s > best_step:
                best, best_step = slot, s
        if best is None:
            return None, -1, None
        manifest = self._slot_manifest(best) or {}
        self._check_plan(manifest, best)
        return best, best_step, manifest.get("placement")

    def restore(self, template):
        """Restore the newest *valid* slot into ``template`` in place (on a
        grid, each rank's tiles into its own template) and set
        ``restored_placement`` from its MANIFEST. Returns (template, step)
        or (None, -1)."""
        self.restored_placement = None
        best, best_step, placement = _on_writer(self._tiles, self._newest)
        if best is None:
            return None, -1
        self.restored_placement = ExpertPlacement.from_manifest(placement)
        path = os.path.join(best, "state.npz") if self._writer else None
        return load_pytree(template, path, self._tiles), best_step

    def _check_plan(self, manifest: dict, slot: str) -> None:
        saved = manifest.get("plan")
        if saved is None or self.plan is None:
            return                       # legacy checkpoint or legacy caller
        live = {"spec": self.plan.spec(),
                "layout": self.plan.layout_signature()}
        if saved["layout"] == live["layout"]:
            return
        if self.on_plan_mismatch == "reshard":
            print(f"checkpoint {slot}: re-planning "
                  f"'{saved.get('spec')}' -> '{live['spec']}' "
                  f"(explicit on_plan_mismatch='reshard')")
            return
        raise ValueError(
            f"checkpoint {slot} was written under plan "
            f"'{saved.get('spec')}' (layout {saved['layout']}) but this run "
            f"is planned as '{live['spec']}' (layout {live['layout']}); "
            f"refusing to silently reshard — restart with the saved plan, "
            f"or pass on_plan_mismatch='reshard' to re-plan explicitly")

    # ---- persistent model-only checkpoints --------------------------------
    def save_model_only(self, params, step: int):
        """The params alone, their expert stacks in global-id order whatever
        the live placement (a model-only file has no MANIFEST to record
        one, so its expert ``g`` is always at position ``g``)."""
        path = os.path.join(self.root, f"model-{step:08d}.npz")
        _write_npz(path if self._writer else None, params, self._tiles,
                   order=self._global_order(params))
        self._done()
        return path

    def _global_order(self, params):
        """``order`` for ``_write_npz``: each whole expert stack taken from
        the live placement back to global-id order (``W[l, g] = W_live[l,
        inv[l, g]]``); None without a placement."""
        if self.placement is None:
            return None
        L, E = self.placement.num_layers, self.placement.num_experts
        inv = self.placement.inverse_array()
        paths = {k: p for (k, _), (p, _) in zip(keyed_leaves(params), leaves_with_path(params))}

        def order(key, arr):
            if not is_expert_stack(paths[key], arr.shape, L, E):
                return arr
            return np.take_along_axis(arr, inv.reshape(L, E, *(1,) * (arr.ndim - 2)), axis=1)
        return order

    def list_model_only(self):
        return sorted(f for f in os.listdir(self.root)
                      if f.startswith("model-") and f.endswith(".npz"))

    def restore_model_only(self, template, step: int):
        """Params from the model-only checkpoint at ``step``, written into
        ``template`` in place, their expert stacks in global-id order (no
        placement); the caller reinitializes optimizer states (paper:
        'training can be restarted from just the model parameters')."""
        path = os.path.join(self.root, f"model-{step:08d}.npz")
        return load_pytree(template, path if self._writer else None, self._tiles)

    # ---- hooks --------------------------------------------------------------
    def maybe_save(self, state, params, step: int):
        wrote = []
        if step > 0 and step % self.interval == 0:
            wrote.append(self.save(state, step))
        if step > 0 and step % self.model_only_interval == 0:
            wrote.append(self.save_model_only(params, step))
        return wrote
