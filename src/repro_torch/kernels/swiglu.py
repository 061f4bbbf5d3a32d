"""Fused SwiGLU on Hopper: launchers for ``csrc/swiglu.cu``, forward and
backward.

Replaces the JAX package's ``kernels/swiglu.py::swiglu_pallas`` and the
plain-JAX backward of its custom VJP (``kernels/ops.py::_swiglu_bwd``).
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


def swiglu_bwd_cuda(gate: torch.Tensor, up: torch.Tensor,
                    dout: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """gate, up, dout: (M, N) bf16 on a CUDA device -> (dgate, dup) bf16,
    the gradients of ``silu(gate) * up`` computed in float32."""
    check_operand(gate, "swiglu_bwd gate", 2)
    check_operand(up, "swiglu_bwd up", 2)
    check_operand(dout, "swiglu_bwd dout", 2)
    if gate.shape != up.shape or gate.shape != dout.shape:
        raise ValueError(f"swiglu_bwd shapes disagree: {tuple(gate.shape)}, "
                         f"{tuple(up.shape)}, {tuple(dout.shape)}")
    dgate = torch.empty_like(gate)
    dup = torch.empty_like(up)
    err = library().repro_swiglu_bwd(gate.data_ptr(), up.data_ptr(), dout.data_ptr(),
                                     dgate.data_ptr(), dup.data_ptr(), gate.numel(),
                                     stream_ptr(gate.device))
    check_launch(err, "swiglu_bwd")
    return dgate, dup
