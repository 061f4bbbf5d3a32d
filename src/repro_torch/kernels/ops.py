"""Public kernel wrappers of the port (the JAX package's ``kernels/ops.py``).

* ``gmm(x, w, group_sizes)``       grouped matmul, paper Stage 4. Backward:
                                   ``dx = gmm(dy, w^T)`` (the gmm kernel in
                                   its transposed-rhs mode), ``dw = tgmm(x,
                                   dy)``; no gradient for ``group_sizes``.
* ``fused_swiglu(gate, up)``       silu(gate) * up; backward through the
                                   ``swiglu_bwd`` kernel.
* ``combine(rows, weights)``       weighted top-k combine, paper Stage 5;
                                   backward through the fused
                                   ``combine_bwd`` kernel.
* ``flash_attention(q, k, v)``     causal / sliding-window attention,
                                   forward only (it raises on a tensor that
                                   requires grad, on either device; training
                                   attention is the plain blockwise path of
                                   ``models/layers``).
* ``ssd_intra_chunk(x, dt, B, C, A)``  Mamba-2 SSD intra-chunk stage,
                                   forward only (it raises on a tensor that
                                   requires grad, on either device).
* ``token_counts(ids, num_local, offset)``  paper Stage 2: the histogram of
                                   routed expert ids over one rank's local
                                   range; integers, no gradient.
* ``dispatch_plan(ids, num_local, offset, pool_rows, align, uniform)``
                                   paper Stages 2 and 3 in one kernel: the
                                   histogram, the count-aligned (or
                                   uniform-capacity) pool groups, each pair's slot and validity
                                   and the inverse pool map; integers, no
                                   gradient.

The first three are ``torch.autograd.Function``s, as the JAX package's
are ``jax.custom_vjp``s. Their backward kernels are callable on their
own: ``gmm_transposed``, ``tgmm``, ``swiglu_bwd`` and ``combine_bwd``.
Each wrapper dispatches on the device of the
tensor it is given: a CPU tensor goes to the plain PyTorch version in
``ref.py``; a CUDA tensor launches the hand-written kernel (``csrc/``) or
raises, never falling back. ``launches`` counts kernel launches per
kernel (a plain integer each, bumped where the kernel is launched and
nowhere else), so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import torch

from . import ref
from .combine import combine_bwd_cuda, combine_cuda
from .dispatch_plan import dispatch_plan_cuda
from .flash_attention import flash_attention_cuda
from .gmm import BLOCK_M, gmm_cuda, tgmm_cuda
from .ssd import ssd_intra_chunk_cuda
from .swiglu import swiglu_bwd_cuda, swiglu_cuda
from .token_counts import token_counts_cuda

launches = {"gmm": 0, "tgmm": 0, "swiglu": 0, "swiglu_bwd": 0, "combine": 0,
            "combine_bwd": 0, "flash_attention": 0, "ssd_intra_chunk": 0, "token_counts": 0,
            "dispatch_plan": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def gmm_align() -> int:
    """Group alignment the MoE dispatch must honour: the gmm kernel's row
    tile (a tile never straddles two experts)."""
    return BLOCK_M


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


# ----------------------------------------------------------------------------
# kernel calls: plain version on the CPU, kernel on the card
# ----------------------------------------------------------------------------

def _gmm(x, w, group_sizes, trans_rhs: bool = False):
    if _on_cpu(x):
        return ref.gmm_ref(x, w.transpose(1, 2) if trans_rhs else w, group_sizes)
    out = gmm_cuda(x, w, group_sizes, trans_rhs=trans_rhs)
    launches["gmm"] += 1
    return out


def tgmm(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """x (M, K), dy (M, N) grouped as for ``gmm`` -> (G, K, N) in x's dtype,
    ``out[g] = x_g.T @ dy_g``; empty groups are zero. gmm's weight gradient."""
    if _on_cpu(x):
        return ref.tgmm_ref(x, dy, group_sizes, group_sizes.shape[0])
    out = tgmm_cuda(x, dy, group_sizes)
    launches["tgmm"] += 1
    return out


def gmm_transposed(dy: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """dy (M, N), w (G, K, N) -> (M, K), ``dy[m] @ w[g(m)].T`` without a
    transposed copy of w: gmm's input gradient."""
    return _gmm(dy, w, group_sizes, trans_rhs=True)


def _swiglu(gate, up):
    if _on_cpu(gate):
        return ref.swiglu_ref(gate, up)
    out = swiglu_cuda(gate, up)
    launches["swiglu"] += 1
    return out


def swiglu_bwd(gate: torch.Tensor, up: torch.Tensor, dout: torch.Tensor):
    """Gradients (dgate, dup) of ``silu(gate) * up``, computed in float32."""
    if _on_cpu(gate):
        return ref.swiglu_bwd_ref(gate, up, dout)
    out = swiglu_bwd_cuda(gate, up, dout)
    launches["swiglu_bwd"] += 1
    return out


def _combine(rows, weights):
    if _on_cpu(rows):
        return ref.combine_ref(rows, weights)
    out = combine_cuda(rows, weights)
    launches["combine"] += 1
    return out


def combine_bwd(rows: torch.Tensor, weights: torch.Tensor, dout: torch.Tensor):
    """Gradients (drows in rows's dtype, dw in float32) of ``combine``."""
    if _on_cpu(rows):
        return ref.combine_bwd_ref(rows, weights, dout)
    out = combine_bwd_cuda(rows, weights, dout)
    launches["combine_bwd"] += 1
    return out


# ----------------------------------------------------------------------------
# autograd
# ----------------------------------------------------------------------------

class _Gmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return _gmm(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gmm_transposed(dy, w, group_sizes).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = tgmm(x, dy, group_sizes).to(w.dtype)
        return dx, dw, None


class _Swiglu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return _swiglu(gate, up)

    @staticmethod
    def backward(ctx, dout):
        gate, up = ctx.saved_tensors
        return swiglu_bwd(gate, up, dout.contiguous())


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, weights):
        ctx.save_for_backward(rows, weights)
        return _combine(rows, weights)

    @staticmethod
    def backward(ctx, dout):
        rows, weights = ctx.saved_tensors
        drows, dw = combine_bwd(rows, weights, dout.contiguous())
        return drows, dw.to(weights.dtype)


def gmm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """x (M, K) rows grouped by expert, w (G, K, N), group_sizes (G,) ->
    (M, N); rows past ``sum(group_sizes)`` are zero."""
    return _Gmm.apply(x, w, group_sizes)


def fused_swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return _Swiglu.apply(gate, up)


def combine(rows: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """rows (T, K, D), weights (T, K) -> (T, D)."""
    return _Combine.apply(rows, weights)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, nh, hd); k/v (B, Skv, nkv, hd) -> (B, Sq, nh, hd).
    Forward only, as the JAX package's kernel is: it raises while autograd
    records and an input requires grad, on either device (on the card the
    kernel's output would carry no gradient)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward only (the JAX package has no flash backward); "
            "train through impl=\"blockwise\", or call it under torch.no_grad() or on "
            "tensors that do not require grad")
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    launches["flash_attention"] += 1
    return out


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                    A: torch.Tensor):
    """x (B, C, L, H, P), dt (B, C, L, H), Bm/Cm (B, C, L, N), A (H,) ->
    (y_diag (B, C, L, H, P), states (B, C, H, P, N), cdecay (B, C, H)), all
    float32 (see ``ref.ssd_intra_chunk_ref``). Forward only, as the JAX
    package's kernel is: it raises while autograd records and an input
    requires grad. Training takes ``models.ssm._intra_chunk`` instead (the
    JAX package's plain einsums), which ``models.ssm._ssd_chunked`` picks
    in just that case."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, Bm, Cm, A)):
        raise NotImplementedError(
            "ssd_intra_chunk is forward only (the JAX package trains Mamba-2 through "
            "its plain scan, as models.ssm._ssd_chunked does under grad); call it under "
            "torch.no_grad() or on tensors that do not require grad")
    if _on_cpu(x):
        return ref.ssd_intra_chunk_ref(x, dt, Bm, Cm, A)
    out = ssd_intra_chunk_cuda(x, dt, Bm, Cm, A)
    launches["ssd_intra_chunk"] += 1
    return out


def token_counts(ids: torch.Tensor, num_local: int, offset: int = 0) -> torch.Tensor:
    """ids: int64 expert ids of any shape -> (num_local,) int32
    counts of the ids in ``[offset, offset + num_local)`` (paper Stage 2)."""
    flat = ids.reshape(-1)
    if _on_cpu(flat):
        return ref.token_counts_ref(flat, num_local, offset)
    out = token_counts_cuda(flat, num_local, offset)
    launches["token_counts"] += 1
    return out


def dispatch_plan(ids: torch.Tensor, num_local: int, offset: int, pool_rows: int, align: int,
                  uniform: bool = False):
    """ids: int64 expert ids of the (token, k) pairs, any shape, in flat
    order -> (slot, valid, counts, group_sizes, drops, inv_pair,
    pool_valid) of the dispatch of the experts ``[offset, offset +
    num_local)`` into a pool of ``pool_rows`` rows with groups aligned to
    ``align`` rows, or with ``uniform`` groups of ``pool_rows // num_local``
    rows each (``ref.dispatch_plan_ref`` defines each). One count of
    ``launches`` per plan (one kernel launch up to
    ``dispatch_plan.SINGLE_BLOCK_MAX`` pairs, three above)."""
    flat = ids.reshape(-1)
    if _on_cpu(flat):
        return ref.dispatch_plan_ref(flat, num_local, offset, pool_rows, align, uniform)
    out = dispatch_plan_cuda(flat, num_local, offset, pool_rows, align, uniform)
    launches["dispatch_plan"] += 1
    return out
