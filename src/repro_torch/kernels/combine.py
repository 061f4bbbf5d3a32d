"""Weighted top-k combine (paper Stage 5) on Hopper: launcher for
``csrc/combine.cu``.

Replaces the JAX package's ``kernels/combine.py::combine_fwd_pallas``.
"""
from __future__ import annotations

import torch

from ._build import check_launch, check_operand, library, stream_ptr


def combine_cuda(rows: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """rows (T, K, D) bf16, weights (T, K) bf16 on a CUDA device ->
    (T, D) bf16, ``sum_k weights[t, k] * rows[t, k]`` accumulated in f32."""
    check_operand(rows, "combine rows", 3)
    check_operand(weights, "combine weights", 2)
    T, K, D = rows.shape
    if tuple(weights.shape) != (T, K):
        raise ValueError(f"combine weights {tuple(weights.shape)} != {(T, K)}")
    if D % 8:
        raise ValueError(f"combine needs D % 8 == 0, got D={D}")
    out = torch.empty((T, D), dtype=rows.dtype, device=rows.device)
    err = library().repro_combine(rows.data_ptr(), weights.data_ptr(), out.data_ptr(),
                                  T, K, D, stream_ptr(rows.device))
    check_launch(err, "combine")
    return out
