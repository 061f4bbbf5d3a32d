"""Mamba-2 (chunked SSD): the state-space half of the hybrid archs. Port of
the Mamba-2 part of the JAX package's ``models/ssm.py``.

The chunked SSD splits the selective scan into dense intra-chunk work (the
``ssd_intra_chunk`` kernel) and a short inter-chunk recurrence over the
chunk-final states. Both a prefill path over (B, S, d) and an O(1)-state
single-token decode step are provided; the decode step writes its cache in
place. Mamba-1 (``arch_type="ssm"``) is not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


# ----------------------------------------------------------------------------
# causal depthwise conv1d
# ----------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (C, K) depthwise; left-padded causal."""
    K, S = w.shape[1], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for j in range(K):
        out = out + xp[:, j:j + S] * w[:, j]
    return out + b


def conv_step(state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """state: (B, K-1, C) previous inputs; x_t: (B, C). Returns (new_state,
    y), both in the state's dtype (float32 in the cache)."""
    window = torch.cat([state, x_t[:, None].to(state.dtype)], dim=1)     # (B, K, C)
    y = torch.einsum("bkc,ck->bc", window, w.to(window.dtype)) + b.to(window.dtype)
    return window[:, 1:], y


# ----------------------------------------------------------------------------
# Mamba-2
# ----------------------------------------------------------------------------

def mamba2_dims(cfg):
    d = cfg.d_model
    di = cfg.ssm.expand * d
    H = di // cfg.ssm.headdim
    return d, di, H, cfg.ssm.headdim, cfg.ssm.d_state, cfg.ssm.d_conv


def init_mamba2(cfg, *, num_layers: int, generator: torch.Generator, device, dtype) -> dict:
    """Stacked (num_layers, ...) Mamba-2 mixer params with the JAX package's
    init scales, drawn from ``generator``."""
    d, di, H, P, N, K = mamba2_dims(cfg)
    conv_dim = di + 2 * N
    kw = dict(generator=generator, device=device, dtype=dtype)

    def normal(shape, scale):
        return torch.randn((num_layers, *shape), **kw).mul_(scale)

    def const(t):
        return t.to(device=device, dtype=dtype).expand(num_layers, *t.shape).clone()

    u = torch.rand((num_layers, H), generator=generator, device=device, dtype=torch.float32)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "in_proj": normal((d, 2 * di + 2 * N + H), 1.0 / math.sqrt(d)),
        "conv_w": normal((conv_dim, K), 0.5),
        "conv_b": torch.zeros((num_layers, conv_dim), device=device, dtype=dtype),
        "A_log": const(torch.log(torch.arange(1, H + 1, dtype=torch.float32))),
        "D": torch.ones((num_layers, H), device=device, dtype=dtype),
        "dt_bias": torch.log(torch.expm1(dt_init)).to(dtype),
        "norm_scale": torch.ones((num_layers, di), device=device, dtype=dtype),
        "out_proj": normal((di, d), 1.0 / math.sqrt(di)),
    }


def _ssd_chunked(x, dt, Bm, Cm, A, chunk: int, h0=None):
    """SSD scan. x: (B, S, H, P); dt: (B, S, H); Bm/Cm: (B, S, N); A: (H,)
    negative. Returns (y (B, S, H, P), final_state (B, H, P, N)), float32.

    The intra-chunk stage is ``ops.ssd_intra_chunk`` (the kernel on the
    card); the inter-chunk recurrence carries the state across the chunks
    in a loop, then every chunk's off-diagonal read-out is one product. A
    length that is not a multiple of the chunk is padded with dt = 0 steps
    (decay 1, zero input: exact), as the JAX package pads.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    S_orig = S
    if S % L:
        pad = L - S % L
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S += pad
    C = S // L
    xb = x.reshape(Bsz, C, L, H, P)
    dtb = dt.float().reshape(Bsz, C, L, H)
    Bb = Bm.reshape(Bsz, C, L, N)
    Cb = Cm.reshape(Bsz, C, L, N)
    y_diag, states, chunk_decay = ops.ssd_intra_chunk(xb, dtb, Bb, Cb, A)

    la = torch.cumsum(dtb * A, dim=2)                                  # (B,C,L,H)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    h_in = []                                                          # state entering chunk c
    for c in range(C):
        h_in.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    y_off = torch.einsum("bcin,bchpn->bcihp", Cb.float(), torch.stack(h_in, 1))
    y = (y_diag + y_off * torch.exp(la)[..., None]).reshape(Bsz, S, H, P)
    return y[:, :S_orig], h


def _gated_rmsnorm(y, z, scale, eps: float = 1e-6):
    y = y * F.silu(z.to(y.dtype))
    var = torch.mean(y * y, dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * scale


def mamba2_block(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d) via the chunked SSD. x, B and C reach the
    kernel as column slices of one activation, without a copy."""
    d, di, H, P, N, K = mamba2_dims(cfg)
    B, S, _ = x.shape
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    xBC = F.silu(causal_conv1d(xBC, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype)))
    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    xh = xs.reshape(B, S, H, P)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    y, _ = _ssd_chunked(xh, dt, Bm, Cm, A, cfg.ssm.chunk)
    y = y + p["D"][:, None] * xh.float()
    y = _gated_rmsnorm(y.reshape(B, S, di), z, p["norm_scale"]).to(x.dtype)
    return y @ p["out_proj"].to(x.dtype)


def init_mamba2_cache(cfg, batch: int, *, num_layers: int, device) -> dict:
    """Stacked (num_layers, batch, ...) decode state, float32 as in the JAX
    package: the conv window of the last K-1 inputs and the SSM state."""
    d, di, H, P, N, K = mamba2_dims(cfg)
    return {"conv": torch.zeros((num_layers, batch, K - 1, di + 2 * N), dtype=torch.float32,
                                device=device),
            "h": torch.zeros((num_layers, batch, H, P, N), dtype=torch.float32, device=device)}


def mamba2_decode_step(p: dict, x: torch.Tensor, cache: dict, cfg):
    """x: (B, 1, d) single-token step with O(1) state. ``cache`` ({"conv",
    "h"} of one layer) is written in place. Returns (out (B, 1, d), cache)."""
    d, di, H, P, N, K = mamba2_dims(cfg)
    B = x.shape[0]
    zxbcdt = x[:, 0] @ p["in_proj"].to(x.dtype)
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    conv_state, xBC = conv_step(cache["conv"], xBC, p["conv_w"].to(x.dtype),
                                p["conv_b"].to(x.dtype))
    xBC = F.silu(xBC).to(x.dtype)          # the cache's f32 must not leak
    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    xh = xs.reshape(B, H, P).float()
    dt = F.softplus(dt.float() + p["dt_bias"])                          # (B, H)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt * A)
    h = (a[..., None, None] * cache["h"]
         + dt[..., None, None] * xh[..., None] * Bm[:, None, None, :].float())
    y = torch.einsum("bhpn,bn->bhp", h, Cm.float())
    y = (y + p["D"][:, None] * xh).reshape(B, di)
    y = _gated_rmsnorm(y, z, p["norm_scale"]).to(x.dtype)
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(h)
    return (y @ p["out_proj"].to(x.dtype))[:, None], cache
