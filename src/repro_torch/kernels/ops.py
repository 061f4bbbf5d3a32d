"""Public kernel wrappers of the port (the JAX package's ``kernels/ops.py``).

* ``gmm(x, w, group_sizes)``       grouped matmul, paper Stage 4
* ``fused_swiglu(gate, up)``       silu(gate) * up
* ``combine(rows, weights)``       weighted top-k combine, paper Stage 5
* ``flash_attention(q, k, v)``     causal / sliding-window attention

Each wrapper dispatches on the device of the tensor it is given: a CPU
tensor goes to the plain PyTorch version in ``ref.py``; a CUDA tensor
launches the hand-written kernel (``csrc/``) or raises, never falling back.
``launches`` counts kernel launches per wrapper (a plain integer each,
bumped where the kernel is launched and nowhere else), so a run can show
that its main path went through the kernels.

Forward only: the serving path needs no gradient.
"""
from __future__ import annotations

import torch

from . import ref
from .combine import combine_cuda
from .flash_attention import flash_attention_cuda
from .gmm import BLOCK_M, gmm_cuda
from .swiglu import swiglu_cuda

launches = {"gmm": 0, "swiglu": 0, "combine": 0, "flash_attention": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def gmm_align() -> int:
    """Group alignment the MoE dispatch must honour: the gmm kernel's row
    tile (a tile never straddles two experts)."""
    return BLOCK_M


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def gmm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """x (M, K) rows grouped by expert, w (G, K, N), group_sizes (G,) ->
    (M, N); rows past ``sum(group_sizes)`` are zero."""
    if _on_cpu(x):
        return ref.gmm_ref(x, w, group_sizes)
    out = gmm_cuda(x, w, group_sizes)
    launches["gmm"] += 1
    return out


def fused_swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    if _on_cpu(gate):
        return ref.swiglu_ref(gate, up)
    out = swiglu_cuda(gate, up)
    launches["swiglu"] += 1
    return out


def combine(rows: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """rows (T, K, D), weights (T, K) -> (T, D)."""
    if _on_cpu(rows):
        return ref.combine_ref(rows, weights)
    out = combine_cuda(rows, weights)
    launches["combine"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, nh, hd); k/v (B, Skv, nkv, hd) -> (B, Sq, nh, hd)."""
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    launches["flash_attention"] += 1
    return out
