"""Parameter and optimizer-state conversion from the JAX package.

``params_from_jax`` takes the JAX package's parameter pytree with its
leaves already turned into numpy arrays (``jax.tree.map(np.asarray, p)`` on
the JAX side — this package never imports JAX) and returns the port's
parameter dict: the same nested layout, leaves as tensors.
``opt_state_from_jax`` does the same for an ``AdamWState``. Tests use them
to start both packages from the same weights and optimizer state, since
JAX's PRNG is not reproduced. Under expert parallelism each rank takes its
share: ``parallel.expert_shard(params, rank, world)`` of the params and
``opt_state_shard(opt, rank, world)`` of the AdamW state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import padded_vocab
from repro_torch.optim import AdamWState
from repro_torch.parallel.sharding import expert_shard


def _tensors(node, dev, dtype):
    if isinstance(node, dict):
        return {k: _tensors(v, dev, dtype) for k, v in node.items()}
    return torch.from_numpy(np.array(node, dtype=np.float32)).to(device=dev, dtype=dtype)


def params_from_jax(tree, cfg: ModelConfig, *, device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32) -> dict:
    """Nested dict of array-likes -> nested dict of tensors on ``device`` in
    ``dtype``. Checks the embedding against ``cfg``'s padded vocab."""
    out = _tensors(tree, resolve_device(device), dtype)
    rows = out["embed"]["table"].shape[0]
    if rows != padded_vocab(cfg):
        raise ValueError(f"embedding has {rows} rows; {cfg.name} pads its vocab "
                         f"to {padded_vocab(cfg)}")
    return out


def opt_state_from_jax(opt, *, device: DeviceLike = None) -> AdamWState:
    """The JAX package's ``AdamWState`` (step, master, m, v), leaves as
    numpy arrays -> the port's, float32 on ``device``, step int32."""
    dev = resolve_device(device)
    step = torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32, device=dev)
    return AdamWState(step, *(_tensors(t, dev, torch.float32) for t in (opt.master, opt.m, opt.v)))


def opt_state_shard(opt: AdamWState, rank: int, world: int) -> AdamWState:
    """Rank ``rank``'s share of an AdamW state: its slices of the expert
    stacks in the master weights and both moments (``expert_shard``), the
    rest and the step as they are."""
    return AdamWState(opt.step, *(expert_shard(t, rank, world) for t in (opt.master, opt.m, opt.v)))
