"""Parameter conversion from the JAX package.

``params_from_jax`` takes the JAX package's parameter pytree with its
leaves already turned into numpy arrays (``jax.tree.map(np.asarray, p)`` on
the JAX side — this package never imports JAX) and returns the port's
parameter dict: the same nested layout, leaves as tensors. Tests use it to
give both packages the same weights, since JAX's PRNG is not reproduced.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import padded_vocab


def params_from_jax(tree, cfg: ModelConfig, *, device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32) -> dict:
    """Nested dict of array-likes -> nested dict of tensors on ``device`` in
    ``dtype``. Checks the embedding against ``cfg``'s padded vocab."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(device=dev, dtype=dtype)

    out = conv(tree)
    rows = out["embed"]["table"].shape[0]
    if rows != padded_vocab(cfg):
        raise ValueError(f"embedding has {rows} rows; {cfg.name} pads its vocab "
                         f"to {padded_vocab(cfg)}")
    return out
