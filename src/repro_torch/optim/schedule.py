"""LR schedule from the paper (§2.1): linear warmup for ``warmup_steps`` to
``lr_peak``, then cosine decay to ``lr_min`` over ``total_steps``. Port of
the JAX package's ``optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, lr_peak=4e-4, lr_min=4e-5, warmup_steps=2500,
                  total_steps=630_000) -> torch.Tensor:
    """``step``: an int or a scalar tensor (on any device) -> float32 lr."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = lr_peak * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = lr_min + 0.5 * (lr_peak - lr_min) * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)
