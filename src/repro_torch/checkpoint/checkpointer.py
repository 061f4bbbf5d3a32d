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
* A MANIFEST with an expert placement raises ``NotImplementedError``
  (placement is not ported); a plan in the MANIFEST is ignored, as the JAX
  package ignores it without a live plan.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import zipfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.optim.epso import refuse_sharded_state
from repro_torch.tree import assign, keyed_leaves, leaves

CHECKSUM_BYTES = 4096


# ---------------------------------------------------------------------------
# tree <-> flat npz
# ---------------------------------------------------------------------------

def _host(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError(f"{key}: a bfloat16 leaf cannot be checkpointed (numpy has no "
                             f"bfloat16, and the JAX package reads none back); keep the "
                             f"state in float32")
        return leaf.detach().contiguous().cpu().numpy()
    return np.ascontiguousarray(leaf)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _write_npz(path: str, tree) -> dict:
    """``np.savez(path, **flat)`` member by member: each leaf is moved to the
    host, written and dropped. Returns {key: the leaf's first bytes}."""
    heads = {}
    with zipfile.ZipFile(_npz_path(path), mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in keyed_leaves(tree):
            arr = _host(key, leaf)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
            heads[key] = arr.reshape(-1).view(np.uint8)[:CHECKSUM_BYTES].copy()
    return heads


def save_pytree(tree, path: str):
    _write_npz(path, tree)


def load_pytree(template, path: str):
    """Write the npz at ``path`` into ``template``'s leaves in place and
    return ``template``. A missing key or another shape raises."""
    shared = set()
    with np.load(_npz_path(path)) as data:
        for key, leaf in keyed_leaves(template):
            if key not in data.files:
                raise KeyError(f"{path}: no leaf {key}")
            if isinstance(leaf, torch.Tensor):
                ident = (leaf.data_ptr(), leaf.dtype, tuple(leaf.shape), leaf.stride())
                if ident in shared:
                    continue            # an f32 param that is its master weight
                shared.add(ident)
            assign(leaf, data[key], key)
    return template


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


def broadcast_params(params, group=None):
    """Load-once-broadcast (paper §4 'Model Broadcasting'). Without a group
    the identity. With an EP group (``parallel.EPGroup``) rank 0's values of
    every leaf that each rank holds whole (``parallel.replicated_leaves``)
    are broadcast into the other ranks' tensors in place; the expert slices
    are each rank's own and stay as they are."""
    if group is None:
        return params
    from repro_torch.parallel.sharding import replicated_leaves
    for t, whole in zip(leaves(params), replicated_leaves(params)):
        if whole:
            dist.broadcast(t.data, src=0, group=group.group)
    return params


# ---------------------------------------------------------------------------
# Checkpointer
# ---------------------------------------------------------------------------

class Checkpointer:
    """Dual + model-only checkpointing of a state on one device."""

    def __init__(self, root: str, *, interval: int = 1000, model_only_interval: int = 0):
        self.root = root
        self.interval = interval
        self.model_only_interval = model_only_interval or interval
        os.makedirs(root, exist_ok=True)
        self.slots = [os.path.join(root, "ckpt-1"),
                      os.path.join(root, "ckpt-2")]

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
        ``fail_after_write`` simulates a mid-checkpoint failure (tests). A
        state whose optimizer is sharded (SO/EPSO) raises
        ``NotImplementedError``."""
        refuse_sharded_state(state, "Checkpointer.save")
        slot = self._oldest_slot()
        tmp = slot + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        heads = _write_npz(os.path.join(tmp, "state.npz"), state)
        if fail_after_write:      # crash before the manifest => slot invalid
            if os.path.exists(slot):
                shutil.rmtree(slot)
            os.rename(tmp, slot)
            return slot
        man = {"step": step, "valid": True, "time": time.time(),
               "checksum": _checksum(heads)}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(man, f)
        if os.path.exists(slot):
            shutil.rmtree(slot)
        os.rename(tmp, slot)
        return slot

    def restore(self, template):
        """Restore the newest *valid* slot into ``template`` in place.
        Returns (template, step) or (None, -1). A template whose optimizer
        is sharded (SO/EPSO) raises ``NotImplementedError``."""
        refuse_sharded_state(template, "Checkpointer.restore")
        best, best_step = None, -1
        for slot in self.slots:
            s = self._slot_step(slot)
            if s > best_step:
                best, best_step = slot, s
        if best is None:
            return None, -1
        if (self._slot_manifest(best) or {}).get("placement") is not None:
            raise NotImplementedError(
                f"checkpoint {best} was written under an expert placement; the port "
                f"has no expert placement yet (ROADMAP.md §1 item 5)")
        return load_pytree(template, os.path.join(best, "state.npz")), best_step

    # ---- persistent model-only checkpoints --------------------------------
    def save_model_only(self, params, step: int):
        path = os.path.join(self.root, f"model-{step:08d}.npz")
        save_pytree(params, path)
        return path

    def list_model_only(self):
        return sorted(f for f in os.listdir(self.root)
                      if f.startswith("model-") and f.endswith(".npz"))

    def restore_model_only(self, template, step: int):
        """Params from the model-only checkpoint at ``step``, written into
        ``template`` in place; the caller reinitializes optimizer states
        (paper: 'training can be restarted from just the model
        parameters')."""
        path = os.path.join(self.root, f"model-{step:08d}.npz")
        return load_pytree(template, path)

    # ---- hooks --------------------------------------------------------------
    def maybe_save(self, state, params, step: int):
        wrote = []
        if step > 0 and step % self.interval == 0:
            wrote.append(self.save(state, step))
        if step > 0 and step % self.model_only_interval == 0:
            wrote.append(self.save_model_only(params, step))
        return wrote
