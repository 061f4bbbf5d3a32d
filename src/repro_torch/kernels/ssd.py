"""Mamba-2 SSD intra-chunk stage on Hopper: launcher for ``csrc/ssd.cu``.

Replaces the JAX package's ``kernels/ssd.py::ssd_intra_chunk_pallas``.
Forward only, like the Pallas kernel. x, B and C are read in place
through a row stride: in ``models/ssm.py::mamba2_block`` they are column
slices of one (B, S, d_inner + 2N) activation, and no contiguous copy is
made of them (a prompt whose length is not a multiple of the chunk is
padded first, and the padded copies are contiguous).
"""
from __future__ import annotations

import math

import torch

from ._build import check_launch, library, stream_ptr

HEAD_DIMS = (32, 64)
MAX_CHUNK = 256
MAX_STATE = 64   # d_state: one 64-column tile of B and C


def _row_stride(t: torch.Tensor, name: str, inner: tuple[int, ...]) -> int:
    """The stride r between consecutive positions of ``t`` (B, C, L, *inner):
    position (b, c, l) must start at row (b*C + c)*L + l of stride r, and
    the inner dims must be contiguous."""
    if tuple(t.shape[3:]) != inner:
        raise ValueError(f"ssd_intra_chunk {name}: inner dims {tuple(t.shape[3:])} != {inner}")
    row = math.prod(inner)
    dense = [math.prod(inner[i + 1:]) for i in range(len(inner))]
    sizes, strides = tuple(t.shape[:3]), t.stride()[:3]
    r = next((st for n, st in zip(sizes[::-1], strides[::-1]) if n > 1), row)
    expect = (sizes[1] * sizes[2] * r, sizes[2] * r, r)
    if (any(n > 1 and st != e for n, st, e in zip(inner, t.stride()[3:], dense))
            or any(n > 1 and st != e for n, st, e in zip(sizes, strides, expect)) or r < row):
        raise ValueError(f"ssd_intra_chunk {name}: strides {t.stride()} do not address its "
                         f"(B, C, L) positions as rows of one stride with {inner} contiguous")
    if r % 8 or t.data_ptr() % 16:
        raise ValueError(f"ssd_intra_chunk {name}: rows must be 16-byte aligned "
                         f"(row stride {r} elements, data at {t.data_ptr()})")
    return r


def _check(t: torch.Tensor, name: str, ndim: int, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk {name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"ssd_intra_chunk {name}: the kernel takes {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"ssd_intra_chunk {name}: expected {ndim} dims, got {tuple(t.shape)}")


def ssd_intra_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                         Cm: torch.Tensor, A: torch.Tensor):
    """x (B, C, L, H, P) bf16, dt (B, C, L, H) f32, Bm/Cm (B, C, L, N) bf16,
    A (H,) f32, on a CUDA device -> (y (B, C, L, H, P), states (B, C, H, P,
    N), cdecay (B, C, H)), f32. L <= 256, P in (32, 64), N % 16 == 0 and
    N <= 64; dt
    and A contiguous; x, Bm and Cm may be row-strided views."""
    for t, name, nd, dty in ((x, "x", 5, torch.bfloat16), (dt, "dt", 4, torch.float32),
                             (Bm, "B", 4, torch.bfloat16), (Cm, "C", 4, torch.bfloat16),
                             (A, "A", 1, torch.float32)):
        _check(t, name, nd, dty)
    B, C, L, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (B, C, L, H) or tuple(Bm.shape) != (B, C, L, N)
            or tuple(Cm.shape) != (B, C, L, N) or tuple(A.shape) != (H,)):
        raise ValueError(f"ssd_intra_chunk shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}, "
                         f"A {tuple(A.shape)}")
    if P not in HEAD_DIMS or N % 16 or not 16 <= N <= MAX_STATE or not 1 <= L <= MAX_CHUNK:
        raise ValueError(f"ssd_intra_chunk needs P in {HEAD_DIMS}, N % 16 == 0 with "
                         f"16 <= N <= {MAX_STATE}, and 1 <= L <= {MAX_CHUNK}; got P={P} N={N} "
                         f"L={L}")
    if not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("ssd_intra_chunk dt and A must be contiguous")
    x_rs = _row_stride(x, "x", (H, P))
    b_rs = _row_stride(Bm, "B", (N,))
    c_rs = _row_stride(Cm, "C", (N,))
    dev = x.device
    y = torch.empty((B, C, L, H, P), dtype=torch.float32, device=dev)
    states = torch.empty((B, C, H, P, N), dtype=torch.float32, device=dev)
    cdecay = torch.empty((B, C, H), dtype=torch.float32, device=dev)
    err = library().repro_ssd_intra_chunk(
        x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(), y.data_ptr(),
        states.data_ptr(), cdecay.data_ptr(), B, C, L, H, P, N, x_rs, b_rs, c_rs,
        stream_ptr(dev))
    check_launch(err, "ssd_intra_chunk")
    return y, states, cdecay
