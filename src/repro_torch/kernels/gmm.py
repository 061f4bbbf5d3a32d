"""Grouped matmul (paper Stage 4) on Hopper: launchers for ``csrc/gmm.cu``
(forward, and the input gradient through its transposed-rhs mode) and
``csrc/tgmm.cu`` (the weight gradient).

Replaces the JAX package's ``kernels/gmm.py::gmm_pallas`` and
``tgmm_pallas``. ``BLOCK_M`` is the group alignment the dispatch honours
(``ops.gmm_align``); the gmm kernel's wgmma row tile ``TILE_M`` is
decoupled from it: each group is cut into tiles of ``TILE_M`` rows from its
own start, and the grid holds ``row_tiles(M, G)`` row tiles, a bound from
the shapes alone (the host never reads ``group_sizes``). See the source
notes in ``csrc/`` for the designs.
"""
from __future__ import annotations

import torch

from ._build import check_launch, check_operand, check_operands, library, stream_ptr

BLOCK_M = 16   # must equal repro_gmm_block_m() in csrc/gmm.cu
TILE_M = 128   # must equal repro_gmm_tile_m() in csrc/gmm.cu


def row_tiles(M: int, G: int) -> int:
    """Row tiles the gmm kernel launches for M rows in G groups: every
    group's ``ceil(size / TILE_M)`` tiles fit, since each group adds at most
    one ragged tile, and the spare tiles cover the rows past the total, which
    they zero (csrc/gmm.cu, ``launch``)."""
    return -(-M // TILE_M) + G


def gmm_cuda(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
             trans_rhs: bool = False) -> torch.Tensor:
    """lhs (M, K) bf16, rhs (G, K, N) bf16 -- or (G, N, K) with
    ``trans_rhs``, read as its transpose -- group_sizes (G,) int32 with
    ``sum <= M``, all on one CUDA device; ``M % BLOCK_M == 0`` (the
    dispatch also keeps every group size a multiple of ``BLOCK_M``; the
    kernel takes any). Returns (M, N) bf16; rows past the total are 0."""
    if lhs.ndim != 2 or rhs.ndim != 3 or group_sizes.ndim != 1:
        raise ValueError(f"gmm takes lhs (M, K), rhs (G, K, N) and group_sizes (G,); got "
                         f"{tuple(lhs.shape)}, {tuple(rhs.shape)}, {tuple(group_sizes.shape)}")
    M, K = lhs.shape
    G = rhs.shape[0]
    K2, N = (rhs.shape[2], rhs.shape[1]) if trans_rhs else (rhs.shape[1], rhs.shape[2])
    if K2 != K or group_sizes.shape[0] != G:
        raise ValueError(f"gmm shapes disagree: lhs {tuple(lhs.shape)}, rhs "
                         f"{tuple(rhs.shape)} (trans_rhs={trans_rhs}), group_sizes "
                         f"{tuple(group_sizes.shape)}")
    if M % BLOCK_M or K % 8 or N % 8 or K == 0:
        raise ValueError(f"gmm needs M % {BLOCK_M} == 0 and K, N multiples of 8 (K > 0); "
                         f"got M={M} K={K} N={N}")
    check_operands((lhs, "gmm lhs", 2, None), (rhs, "gmm rhs", 3, None),
                   (group_sizes, "gmm group_sizes", 1, torch.int32))
    lib = library()
    if lib.repro_gmm_block_m() != BLOCK_M or lib.repro_gmm_tile_m() != TILE_M:
        raise RuntimeError("csrc/gmm.cu's alignment or row tile disagrees with "
                           "kernels/gmm.py BLOCK_M / TILE_M")
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    err = lib.repro_gmm(lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
                        out.data_ptr(), M, K, N, G, int(trans_rhs), stream_ptr(lhs.device))
    check_launch(err, "gmm")
    return out


def tgmm_cuda(lhs: torch.Tensor, rhs: torch.Tensor,
              group_sizes: torch.Tensor) -> torch.Tensor:
    """lhs (M, K) bf16, rhs (M, N) bf16, group_sizes (G,) int32 with
    ``sum <= M``, all on one CUDA device, K and N multiples of 8 ->
    (G, K, N) bf16, ``out[g] = lhs_g.T @ rhs_g``; empty groups are 0."""
    check_operand(lhs, "tgmm lhs", 2)
    check_operand(rhs, "tgmm rhs", 2)
    check_operand(group_sizes, "tgmm group_sizes", 1, torch.int32)
    M, K = lhs.shape
    N = rhs.shape[1]
    G = group_sizes.shape[0]
    if rhs.shape[0] != M:
        raise ValueError(f"tgmm shapes disagree: lhs {tuple(lhs.shape)}, "
                         f"rhs {tuple(rhs.shape)}")
    if K % 8 or N % 8:
        raise ValueError(f"tgmm needs K, N multiples of 8; got K={K} N={N}")
    out = torch.empty((G, K, N), dtype=lhs.dtype, device=lhs.device)
    err = library().repro_tgmm(lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
                               out.data_ptr(), M, K, N, G, stream_ptr(lhs.device))
    check_launch(err, "tgmm")
    return out
