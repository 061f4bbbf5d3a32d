"""Fused SwiGLU on Hopper: launcher for ``csrc/swiglu.cu``.

Replaces the JAX package's ``kernels/swiglu.py::swiglu_pallas``.
"""
from __future__ import annotations

import torch

from ._build import check_launch, check_operand, library, stream_ptr


def swiglu_cuda(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """gate, up: (M, N) bf16 on a CUDA device -> silu(gate) * up, bf16."""
    check_operand(gate, "swiglu gate", 2)
    check_operand(up, "swiglu up", 2)
    if gate.shape != up.shape:
        raise ValueError(f"swiglu shapes disagree: {tuple(gate.shape)} vs {tuple(up.shape)}")
    out = torch.empty_like(gate)
    err = library().repro_swiglu(gate.data_ptr(), up.data_ptr(), out.data_ptr(),
                                 gate.numel(), stream_ptr(gate.device))
    check_launch(err, "swiglu")
    return out
