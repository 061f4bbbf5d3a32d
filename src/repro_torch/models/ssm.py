"""State-space mixers: Mamba-1 (the selective scan, ``arch_type="ssm"``)
and Mamba-2 (the chunked SSD, the state-space half of the hybrid archs).
Port of the JAX package's ``models/ssm.py``.

Both give a path over whole sequences (B, S, d), for training and prefill,
and an O(1)-state single-token decode step that writes its cache in place.

Mamba-2's chunked SSD splits the scan into dense intra-chunk work and a
short inter-chunk recurrence over the chunk-final states. Under
``no_grad`` (prefill, serving) the intra-chunk stage is the
``ssd_intra_chunk`` kernel, which is forward only, as the JAX package's is;
while autograd records it is the JAX package's own einsums
(``_intra_chunk``), the path the JAX package trains through.

Mamba-1 keeps the JAX package's selective scan: a loop over time, one
(B, d_inner, d_state) float32 state carried, its four input streams (dt,
dt x, B, C) rounded to bfloat16 first whatever the compute dtype. No
kernel: the JAX package has none either. The JAX package rematerialises
the scan's body; the port bounds the loop's memory under autograd with the
per-layer block remat of ``models.model`` alone (it checkpoints no runs of
time steps), so the backward of one layer holds that layer's per-step
states.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

# the dtype the JAX package rounds Mamba-1's scan streams to
STREAM_DTYPE = torch.bfloat16


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
# Mamba-1
# ----------------------------------------------------------------------------

def mamba1_dims(cfg):
    d = cfg.d_model
    di = cfg.ssm.expand * d
    dt_rank = max(1, d // 16)
    return d, di, dt_rank, cfg.ssm.d_state, cfg.ssm.d_conv


def init_mamba1(cfg, *, num_layers: int, generator: torch.Generator, device, dtype) -> dict:
    """Stacked (num_layers, ...) Mamba-1 mixer params with the JAX package's
    init scales, drawn from ``generator``."""
    d, di, R, ds, K = mamba1_dims(cfg)
    kw = dict(generator=generator, device=device, dtype=dtype)

    def normal(shape, scale):
        return torch.randn((num_layers, *shape), **kw).mul_(scale)

    u = torch.rand((num_layers, di), generator=generator, device=device, dtype=torch.float32)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32)).tile(di, 1)
    return {
        "in_proj": normal((d, 2 * di), 1.0 / math.sqrt(d)),
        "conv_w": normal((di, K), 0.5),
        "conv_b": torch.zeros((num_layers, di), device=device, dtype=dtype),
        "x_proj": normal((di, R + 2 * ds), 1.0 / math.sqrt(di)),
        "dt_proj": normal((R, di), R ** -0.5),
        "dt_bias": torch.log(torch.expm1(dt_init)).to(dtype),
        "A_log": a_log.to(device=device, dtype=dtype).expand(num_layers, di, ds).clone(),
        "D": torch.ones((num_layers, di), device=device, dtype=dtype),
        "out_proj": normal((di, d), 1.0 / math.sqrt(di)),
    }


def _mamba1_inner(p: dict, xc: torch.Tensor, z: torch.Tensor, cfg, h0=None):
    """The selective scan. xc: the post-conv activation (B, S, di); z: the
    gate (B, S, di). Returns (y (B, S, di) in xc's dtype, the last state
    (B, di, ds) float32).

    As the JAX package: the streams dt, dt x, B and C are rounded to
    bfloat16 and the state math is float32. The rounding is done once for
    the whole sequence (back to float32 at once: the same values as
    per step); the decay exp(dt A) and the input dt x B are formed inside
    the loop from them, so no (B, S, di, ds) tensor is made."""
    _, di, R, ds, _ = mamba1_dims(cfg)
    B = xc.shape[0]
    proj = xc @ p["x_proj"].to(xc.dtype)
    dt, Bmat, Cmat = torch.split(proj, [R, ds, ds], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].to(xc.dtype) + p["dt_bias"].to(xc.dtype))    # (B,S,di)
    A = (-torch.exp(p["A_log"])).float()                                           # (di, ds)
    dt32, x32 = dt.float(), xc.float()

    def stream(t):
        return t.float().to(STREAM_DTYPE).float().unbind(1)

    h = (torch.zeros((B, di, ds), dtype=torch.float32, device=xc.device) if h0 is None
         else h0.float())
    ys = []
    for dt_t, dtx_t, b_t, c_t in zip(stream(dt32), stream(dt32 * x32), stream(Bmat),
                                     stream(Cmat)):
        h = torch.exp(dt_t[..., None] * A) * h + dtx_t[..., None] * b_t[:, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, c_t))
    y = torch.stack(ys, 1) + p["D"] * x32
    return (y * F.silu(z.float())).to(xc.dtype), h


def mamba1_block(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    di = cfg.ssm.expand * cfg.d_model
    xpart, z = torch.split(x @ p["in_proj"].to(x.dtype), [di, di], dim=-1)
    xc = F.silu(causal_conv1d(xpart, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype)))
    y, _ = _mamba1_inner(p, xc, z, cfg)
    return y @ p["out_proj"].to(x.dtype)


def init_mamba1_cache(cfg, batch: int, *, num_layers: int, device) -> dict:
    """Stacked (num_layers, batch, ...) decode state, float32 as in the JAX
    package: the conv window of the last K-1 inputs and the SSM state."""
    d, di, _, ds, K = mamba1_dims(cfg)
    return {"conv": torch.zeros((num_layers, batch, K - 1, di), dtype=torch.float32,
                                device=device),
            "h": torch.zeros((num_layers, batch, di, ds), dtype=torch.float32, device=device)}


def mamba1_decode_step(p: dict, x: torch.Tensor, cache: dict, cfg):
    """x: (B, 1, d) single-token step with O(1) state, through the same
    ``_mamba1_inner`` from the cached state. ``cache`` ({"conv", "h"} of one
    layer) is written in place. Returns (out (B, 1, d), cache)."""
    di = cfg.ssm.expand * cfg.d_model
    xpart, z = torch.split(x[:, 0] @ p["in_proj"].to(x.dtype), [di, di], dim=-1)
    conv_state, xc = conv_step(cache["conv"], xpart, p["conv_w"].to(x.dtype),
                               p["conv_b"].to(x.dtype))
    xc = F.silu(xc).to(x.dtype)            # the cache's f32 must not leak
    y, h = _mamba1_inner(p, xc[:, None], z[:, None], cfg, h0=cache["h"])
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(h)
    return y @ p["out_proj"].to(x.dtype), cache


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


def _intra_chunk(xb, dtb, Bb, Cb, A):
    """The intra-chunk stage as the JAX package's ``_ssd_chunked`` computes
    it, in float32 and differentiable: y_diag (B, C, L, H, P), the
    chunk-final states (B, C, H, P, N) and the chunk decay (B, C, H). The
    causal mask goes into the exponent (exp(-inf) = 0: the same values as
    the JAX package's ``where`` after ``exp``), so that the gradient stays
    finite where exp of the masked, positive exponent overflows."""
    xb, Bb, Cb = xb.float(), Bb.float(), Cb.float()
    L = xb.shape[2]
    la = torch.cumsum(dtb * A, dim=2)                                  # (B,C,L,H)
    seg = la[:, :, :, None] - la[:, :, None, :]                        # (B,C,L,L,H)
    above = torch.ones((L, L), dtype=torch.bool, device=xb.device).triu(1)
    decay = torch.exp(seg.masked_fill(above[None, None, :, :, None], -math.inf))
    cb = torch.einsum("bcin,bcjn->bcij", Cb, Bb)                       # (B,C,L,L)
    dtx = dtb[..., None] * xb                                          # (B,C,L,H,P)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * decay, dtx)
    w = torch.exp(la[:, :, -1:, :] - la)                               # (B,C,L,H)
    states = torch.einsum("bcjhp,bcjn->bchpn", w[..., None] * dtx, Bb)
    return y_diag, states, torch.exp(la[:, :, -1, :])


def _ssd_chunked(x, dt, Bm, Cm, A, chunk: int, h0=None):
    """SSD scan. x: (B, S, H, P); dt: (B, S, H); Bm/Cm: (B, S, N); A: (H,)
    negative. Returns (y (B, S, H, P), final_state (B, H, P, N)), float32.

    The intra-chunk stage is ``ops.ssd_intra_chunk`` (the kernel on the
    card), or ``_intra_chunk`` while autograd records and an input requires
    grad (training); the inter-chunk recurrence carries the state across
    the chunks in a loop, then every chunk's off-diagonal read-out is one
    product. A length that is not a multiple of the chunk is padded with dt
    = 0 steps (decay 1, zero input: exact), as the JAX package pads.
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, Bm, Cm, A)):
        y_diag, states, chunk_decay = _intra_chunk(xb, dtb, Bb, Cb, A)
    else:
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
