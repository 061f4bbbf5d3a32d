"""Transformer layers: norms, RoPE, GQA attention (prefill through the
flash kernel, training through the plain blockwise path, cached
single-token decode), MLPs, embedding. Port of the JAX package's
``models/layers.py``; every function here is differentiable by autograd.

Parameters are plain dicts of tensors in the JAX package's layout (weights
stored (in, out), so ``x @ w``); every function is a plain function on
tensors. Under tensor parallelism (``tp``, a 'tp' ``EPGroup``) attention
and the MLP take the rank's shards (``parallel.sharding``: its heads' columns
of wq, wk, wv and rows of wo; its d_ff columns of gate, up and rows of
down): the input enters through ``tp_copy`` and the output projection's
partial sums leave through ``tp_reduce``. The head counts come from the
weights' widths, so the same code runs whole weights and shards. A
vocab-split table (``parallel.vocab``) is looked up and unembedded over
its group. KV caches are updated in place (the JAX package returns new
arrays): a decode step writes one position per row instead of copying the
cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG, slot_decode_attention_ref
from repro_torch.parallel import vocab as V
from repro_torch.parallel.ep import tp_copy, tp_reduce


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------

def init_norm(kind: str, d: int, *, num_layers: int, device) -> dict:
    shape = (num_layers, d) if num_layers else (d,)
    p = {"scale": torch.ones(shape, dtype=torch.float32, device=device)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return p


def apply_norm(params, x, kind: str = "rmsnorm", eps: float = 1e-6):
    """RMSNorm or LayerNorm, computed in float32 and cast back."""
    dtype = x.dtype
    x = x.float()
    if kind == "rmsnorm":
        out = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * params["scale"]
    else:
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
        out = (x - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return out.to(dtype)


# ----------------------------------------------------------------------------
# RoPE (half-split, not interleaved)
# ----------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs                 # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                          # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


# ----------------------------------------------------------------------------
# Attention (GQA, full or sliding window)
# ----------------------------------------------------------------------------

def init_attention(cfg, *, num_layers: int, generator: torch.Generator, device, dtype) -> dict:
    d, nh, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)

    def normal(shape):
        return torch.randn((num_layers, *shape), generator=generator, device=device,
                           dtype=dtype).mul_(s)

    return {"wq": normal((d, nh * hd)), "wk": normal((d, nkv * hd)),
            "wv": normal((d, nkv * hd)), "wo": normal((nh * hd, d))}


def blockwise_attention(q, k, v, *, causal: bool, window: int,
                        q_block: int = 512, kv_block: int = 512):
    """Flash-style double-blocked attention in plain PyTorch (online
    softmax), differentiated by autograd: the JAX package's
    ``_blockwise_attention``, its training attention, which no Pallas kernel
    computes. q: (B, Sq, nh, hd); k/v: (B, Skv, nkv, hd), q and k both from
    position 0. ``window`` > 0 lets each query see keys in (pos - window,
    pos]. Kv blocks that the causal or window mask hides from every query
    of a q block are skipped: they would add exact zeros.
    """
    B, Sq, nh, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    groups = nh // nkv
    scale = 1.0 / math.sqrt(hd)
    qb, kb = min(q_block, Sq), min(kv_block, Skv)
    nq, nk = -(-Sq // qb), -(-Skv // kb)
    Sq_pad, Skv_pad = nq * qb, nk * kb
    q = F.pad(q, (0, 0, 0, 0, 0, Sq_pad - Sq))
    k = F.pad(k, (0, 0, 0, 0, 0, Skv_pad - Skv))
    v = F.pad(v, (0, 0, 0, 0, 0, Skv_pad - Skv))
    qr = q.reshape(B, nq, qb, nkv, groups, hd).permute(0, 3, 4, 1, 2, 5)   # (B,nkv,g,nq,qb,hd)
    kr = k.reshape(B, nk, kb, nkv, hd).permute(0, 3, 1, 2, 4)               # (B,nkv,nk,kb,hd)
    vr = v.reshape(B, nk, kb, nkv, hd).permute(0, 3, 1, 2, 4)
    dev = q.device
    q_pos = torch.arange(Sq_pad, device=dev).reshape(nq, qb)
    kv_pos = torch.arange(Skv_pad, device=dev).reshape(nk, kb)

    outs = []
    for qi in range(nq):
        qt = qr[:, :, :, qi].float() * scale                                # (B,nkv,g,qb,hd)
        qp = q_pos[qi]
        q_lo, q_hi = qi * qb, qi * qb + qb - 1
        m = torch.full((B, nkv, groups, qb), NEG, device=dev)
        l = torch.zeros((B, nkv, groups, qb), device=dev)
        acc = torch.zeros((B, nkv, groups, qb, hd), device=dev)
        for ki in range(nk):
            if causal and ki * kb > q_hi:
                continue
            if window > 0 and q_lo - (ki * kb + kb - 1) >= window:
                continue
            kt, vt = kr[:, :, ki].float(), vr[:, :, ki].float()
            s = torch.einsum("bngqh,bnkh->bngqk", qt, kt)
            kp = kv_pos[ki]
            mask = (kp < Skv)[None, :].expand(qb, kb)
            if causal:
                mask = mask & (qp[:, None] >= kp[None, :])
            if window > 0:
                mask = mask & (qp[:, None] - kp[None, :] < window)
            s = torch.where(mask, s, torch.full_like(s, NEG))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bngqk,bnkh->bngqh", p, vt)
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    o = torch.stack(outs)                                                   # (nq,B,nkv,g,qb,hd)
    o = o.permute(1, 0, 4, 2, 3, 5).reshape(B, Sq_pad, nh, hd)
    return o[:, :Sq].to(q.dtype)


ATTN_IMPLS = ("flash", "blockwise")


def attention(params, x, cfg, *, impl: str = "flash", return_kv: bool = False, tp=None):
    """Causal self-attention over a whole sequence from position 0. x: (B,
    S, d). ``impl`` chooses as the JAX plan's ``attn_impl`` does: 'flash'
    (the forward-only kernel; serving and prefill) or 'blockwise' (plain
    PyTorch with a backward; training). ``return_kv`` also returns the
    post-RoPE (k, v), each (B, S, nkv, hd), for the cache. ``tp``: the
    'tp' group whose ranks hold head shards of the weights, or None."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attention impl must be one of {ATTN_IMPLS}, got {impl!r}")
    B, S, d = x.shape
    hd = cfg.head_dim
    nh, nkv = params["wq"].shape[-1] // hd, params["wk"].shape[-1] // hd
    x = tp_copy(x, tp)
    positions = torch.arange(S, device=x.device)[None, :]
    q = (x @ params["wq"].to(x.dtype)).reshape(B, S, nh, hd)
    k = (x @ params["wk"].to(x.dtype)).reshape(B, S, nkv, hd)
    v = (x @ params["wv"].to(x.dtype)).reshape(B, S, nkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if impl == "flash":
        o = ops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    else:
        o = blockwise_attention(q, k, v, causal=True, window=cfg.sliding_window)
    out = tp_reduce(o.to(x.dtype).reshape(B, S, nh * hd) @ params["wo"].to(x.dtype), tp)
    if return_kv:
        return out, (k, v)
    return out


# ---- decode with KV cache ----------------------------------------------------

def init_kv_cache(cfg, batch: int, max_len: int, *, num_layers: int, device,
                  dtype=torch.bfloat16, tp: int = 1) -> dict:
    """Ring-buffer cache when sliding_window > 0 (window-sized), else full.
    ``tp``: the 'tp' ranks splitting the heads; the cache holds a rank's
    ``num_kv_heads / tp`` kv heads."""
    if cfg.num_kv_heads % tp:
        raise ValueError(f"tp={tp} does not divide {cfg.num_kv_heads} kv heads")
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window > 0 else max_len
    shape = (num_layers, batch, size, cfg.num_kv_heads // tp, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(params, x, cache, index, cfg, tp=None):
    """One-token decode. x: (B, 1, d); cache: {"k", "v"} each (B, S, nkv, hd),
    written in place; index: (B,) per-row absolute positions (or a scalar).

    Sliding-window caches are rings indexed by ``position % window``; a
    write whose position falls outside a full cache is dropped. Returns
    out (B, 1, d). ``tp``: as in ``attention``; the cache then holds the
    rank's kv heads."""
    B, _, d = x.shape
    hd = cfg.head_dim
    nh, nkv = params["wq"].shape[-1] // hd, params["wk"].shape[-1] // hd
    x = tp_copy(x, tp)
    idx = torch.as_tensor(index, device=x.device).long().expand(B)
    q = (x @ params["wq"].to(x.dtype)).reshape(B, 1, nh, hd)
    k = (x @ params["wk"].to(x.dtype)).reshape(B, 1, nkv, hd)
    v = (x @ params["wv"].to(x.dtype)).reshape(B, 1, nkv, hd)
    pos = idx[:, None]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)

    ck, cv = cache["k"], cache["v"]
    size = ck.shape[1]
    ring = cfg.sliding_window > 0
    slot = idx % size if ring else idx
    # mode="drop" without a host sync: an out-of-range row rewrites the
    # value already at slot 0 (rows are distinct, so no write collides)
    keep = (slot < size)[:, None, None]
    target = torch.where(slot < size, slot, torch.zeros_like(slot))
    rows = torch.arange(B, device=x.device)
    ck[rows, target] = torch.where(keep, k[:, 0].to(ck.dtype), ck[rows, target])
    cv[rows, target] = torch.where(keep, v[:, 0].to(cv.dtype), cv[rows, target])

    o = slot_decode_attention_ref(q[:, 0], ck, cv, idx, ring=ring)
    o = o.reshape(B, 1, nh * hd).to(x.dtype)
    return tp_reduce(o @ params["wo"].to(x.dtype), tp)


# ----------------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------------

def init_mlp(d: int, d_ff: int, activation: str, *, num_layers: int,
             generator: torch.Generator, device, dtype) -> dict:
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)

    def normal(shape, scale):
        return torch.randn((num_layers, *shape), generator=generator, device=device,
                           dtype=dtype).mul_(scale)

    p = {"up": normal((d, d_ff), s_in), "down": normal((d_ff, d), s_out)}
    if activation == "swiglu":
        p["gate"] = normal((d, d_ff), s_in)
    return p


def apply_mlp(params, x, activation: str, tp=None):
    """The dense MLP; ``tp``: the 'tp' group whose ranks hold d_ff shards
    of the weights, or None."""
    x = tp_copy(x, tp)
    up = x @ params["up"].to(x.dtype)
    if activation == "swiglu":
        h = F.silu(x @ params["gate"].to(x.dtype)) * up
    else:
        h = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    return tp_reduce(h @ params["down"].to(x.dtype), tp)


# ----------------------------------------------------------------------------
# Embedding / LM head
# ----------------------------------------------------------------------------

def init_embedding(vocab: int, d: int, *, generator: torch.Generator, device,
                   dtype) -> dict:
    return {"table": torch.randn((vocab, d), generator=generator, device=device,
                                 dtype=dtype).mul_(0.02)}


def embed(params, tokens, dtype, vocab=None):
    """The rows of ``tokens`` in ``dtype``; ``vocab``: the split
    (``parallel.vocab.VocabShard``) of a table tile, or None for a whole
    table."""
    if vocab is not None:
        return V.embed(params["table"], tokens, dtype, vocab)
    return params["table"][tokens].to(dtype)


def unembed(params, x, vocab=None):
    """The logits of ``x`` over the whole padded vocab; ``vocab``: as in
    ``embed`` (a tile's columns, put together over its group)."""
    if vocab is not None:
        return V.logits(params["table"], x, vocab)
    return x @ params["table"].T.to(x.dtype)
