"""Flash attention forward on Hopper: launcher for
``csrc/flash_attention.cu``.

Replaces the JAX package's ``kernels/flash_attention.py::
flash_attention_pallas``. Takes the model's (B, S, heads, hd) layout
directly: no head folding, and GQA kv heads are indexed, not repeated.
"""
from __future__ import annotations

import math

import torch

from ._build import check_launch, check_operands, library, stream_ptr

HEAD_DIMS = (64, 112, 128)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, nh, hd), k/v (B, Skv, nkv, hd), bf16 on a CUDA device,
    hd in HEAD_DIMS, nh % nkv == 0 -> (B, Sq, nh, hd) bf16."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, nh, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS or nkv == 0 or nh % nkv:
        raise ValueError(f"flash_attention needs hd in {HEAD_DIMS} and nh % nkv == 0; "
                         f"got hd={hd} nh={nh} nkv={nkv}")
    check_operands(*((t, f"flash_attention {name}", 4, None)
                     for t, name in ((q, "q"), (k, "k"), (v, "v"))))
    out = torch.empty_like(q)
    err = library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv, nh, nkv,
        hd, int(causal), int(window), 1.0 / math.sqrt(hd), stream_ptr(q.device))
    check_launch(err, "flash_attention")
    return out
