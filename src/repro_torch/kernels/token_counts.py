"""Stage-2 token counting (paper §3.1) on Hopper: launcher for
``csrc/token_counts.cu``.

Replaces the JAX package's ``kernels/moe_dispatch.py::token_counts_pallas``.
The ids are read in the dtype the router emits (int64), with no conversion
copy; no gradient.
"""
from __future__ import annotations

import torch

from ._build import check_launch, library, stream_ptr

# the kernel's bins fill the 48 KB of shared memory a block gets by default
MAX_LOCAL = 48 * 1024 // 4


def token_counts_cuda(ids: torch.Tensor, num_local: int, offset: int) -> torch.Tensor:
    """ids (F,) int64, contiguous, on a CUDA device -> (num_local,) int32
    counts of the ids in ``[offset, offset + num_local)``."""
    if ids.device.type != "cuda":
        raise ValueError(f"token_counts ids: expected a CUDA tensor, got device {ids.device}")
    if ids.dtype != torch.int64:
        raise TypeError(f"token_counts ids: the kernel takes int64, got {ids.dtype}")
    if ids.ndim != 1 or not ids.is_contiguous():
        raise ValueError(f"token_counts ids: must be 1-D and contiguous, got shape "
                         f"{tuple(ids.shape)} strides {ids.stride()}")
    if not 1 <= num_local <= MAX_LOCAL or offset < 0:
        raise ValueError(f"token_counts needs 1 <= num_local <= {MAX_LOCAL} and offset >= 0; "
                         f"got num_local={num_local} offset={offset}")
    counts = torch.empty(num_local, dtype=torch.int32, device=ids.device)
    err = library().repro_token_counts(ids.data_ptr(), ids.numel(), int(offset), int(num_local),
                                       counts.data_ptr(), stream_ptr(ids.device))
    check_launch(err, "token_counts")
    return counts
