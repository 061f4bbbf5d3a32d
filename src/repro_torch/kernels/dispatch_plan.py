"""MoE Stages 2 and 3 (paper §3.1) on Hopper: launcher for
``csrc/dispatch_plan.cu``, the histogram, the count-aligned (or
uniform-capacity) groups, each
pair's stable rank, slot and validity, and the inverse pool map in at most
three launches and no memset.

Replaces the JAX package's ``kernels/moe_dispatch.py::token_counts_pallas``
together with the sort-based index generation of ``core/moe.py::
make_dispatch_plan`` that consumes it. The ids are read in the dtype the
router emits (int64), with no conversion copy; no gradient.
"""
from __future__ import annotations

import torch

from ._build import check_launch, library, stream_ptr

# the most local experts a plan takes (every count row fits the shared
# memory a block gets by default)
MAX_LOCAL = 1024
# plans of at most this many (token, k) pairs run as one launch of one block;
# larger ones as three launches over many blocks (on an H100 the one block
# took 0.0081 ms at 1024 pairs and 0.0171 at 4096, the three launches
# 0.0107 and 0.0116)
SINGLE_BLOCK_MAX = 2048
# the three-launch path gives each warp 32 * iters pairs, with iters at
# least 4, at most 512 warps, and at most this many ints of per-warp counts
SCRATCH_INTS = 1 << 18


def _iters(n: int, num_local: int) -> int:
    return max(4, -(-n // (32 * 512)), -(-n * num_local // (32 * SCRATCH_INTS)))


def dispatch_plan_cuda(ids: torch.Tensor, num_local: int, offset: int, pool_rows: int,
                       align: int, uniform: bool = False):
    """ids (F,) int64, contiguous, on a CUDA device -> (slot, valid, counts,
    group_sizes, drops, inv_pair, pool_valid) as ``ref.dispatch_plan_ref``
    defines them, bit for bit; ``uniform``: every group ``pool_rows //
    num_local`` rows (a flag of the same kernel)."""
    if ids.device.type != "cuda":
        raise ValueError(f"dispatch_plan ids: expected a CUDA tensor, got device {ids.device}")
    if ids.dtype != torch.int64:
        raise TypeError(f"dispatch_plan ids: the kernel takes int64, got {ids.dtype}")
    if ids.ndim != 1 or not ids.is_contiguous():
        raise ValueError(f"dispatch_plan ids: must be 1-D and contiguous, got shape "
                         f"{tuple(ids.shape)} strides {ids.stride()}")
    n = ids.numel()
    if not (1 <= num_local <= MAX_LOCAL and offset >= 0 and align >= 1 and pool_rows >= 0
            and n < 2 ** 31):
        raise ValueError(f"dispatch_plan needs 1 <= num_local <= {MAX_LOCAL}, offset >= 0, "
                         f"align >= 1, pool_rows >= 0 and fewer than 2**31 ids; got "
                         f"num_local={num_local} offset={offset} align={align} "
                         f"pool_rows={pool_rows} ids={n}")
    single = n <= SINGLE_BLOCK_MAX
    iters = 0 if single else _iters(n, num_local)
    # the three-launch scratch, in int64 words: the group offsets, then each
    # warp's row of key counts (int32)
    warps = 0 if single else -(-n // (32 * iters))
    scratch64 = 0 if single else num_local + -(-warps * num_local // 2)
    dev = ids.device
    i64 = torch.empty(n + num_local + 1 + pool_rows + scratch64, dtype=torch.int64, device=dev)
    slot, counts, drops, inv_pair, scratch = i64.split([n, num_local, 1, pool_rows, scratch64])
    flags = torch.empty(n + pool_rows, dtype=torch.bool, device=dev)
    valid, pool_valid = flags.split([n, pool_rows])
    group_sizes = torch.empty(num_local, dtype=torch.int32, device=dev)
    err = library().repro_dispatch_plan(
        ids.data_ptr(), n, int(offset), int(num_local), int(pool_rows), int(align),
        int(bool(uniform)), int(single), iters, scratch.data_ptr(), 2 * scratch64,
        slot.data_ptr(), valid.data_ptr(), counts.data_ptr(), group_sizes.data_ptr(), drops.data_ptr(), inv_pair.data_ptr(),
        pool_valid.data_ptr(), stream_ptr(dev))
    check_launch(err, "dispatch_plan")
    return slot, valid, counts, group_sizes, drops[0], inv_pair, pool_valid
