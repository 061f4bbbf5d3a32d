"""Weighted top-k combine (paper Stage 5) on Hopper: launchers for
``csrc/combine.cu``, forward and fused backward.

Replaces the JAX package's ``kernels/combine.py::combine_fwd_pallas`` and
``combine_bwd_pallas``.
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


def combine_bwd_cuda(rows: torch.Tensor, weights: torch.Tensor,
                     dout: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """rows (T, K, D), weights (T, K), dout (T, D), bf16 on a CUDA device
    -> (drows (T, K, D) bf16 = weights * dout, dw (T, K) float32 =
    ``sum_d rows * dout``), in one pass over rows and dout."""
    check_operand(rows, "combine_bwd rows", 3)
    check_operand(weights, "combine_bwd weights", 2)
    check_operand(dout, "combine_bwd dout", 2)
    T, K, D = rows.shape
    if tuple(weights.shape) != (T, K) or tuple(dout.shape) != (T, D):
        raise ValueError(f"combine_bwd shapes disagree: rows {tuple(rows.shape)}, weights "
                         f"{tuple(weights.shape)}, dout {tuple(dout.shape)}")
    lib = library()
    if D % 8 or K > lib.repro_combine_max_k():
        raise ValueError(f"combine_bwd needs D % 8 == 0 and K <= "
                         f"{lib.repro_combine_max_k()}; got D={D} K={K}")
    drows = torch.empty_like(rows)
    dw = torch.empty((T, K), dtype=torch.float32, device=rows.device)
    err = lib.repro_combine_bwd(rows.data_ptr(), weights.data_ptr(), dout.data_ptr(),
                                drows.data_ptr(), dw.data_ptr(), T, K, D,
                                stream_ptr(rows.device))
    check_launch(err, "combine_bwd")
    return drows, dw
