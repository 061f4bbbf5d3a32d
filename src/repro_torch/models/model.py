"""Model builder for the serving path (``arch_type`` dense and moe): params,
KV caches, one decode step and prefill into cache slots. Port of the JAX
package's ``models/model.py``.

Parameters keep the JAX package's pytree layout — a nested dict whose
``layers`` leaves are stacked with a leading layer dim — so a JAX parameter
tree converts leaf for leaf (``repro_torch.convert``). Where the JAX model
scans over the stacked layers, the port loops over them in Python.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import moe as moe_lib
from repro_torch.device import DeviceLike, resolve_device

from . import layers as L

VOCAB_ALIGN = 256
SERVE_ARCHS = ("dense", "moe")


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // VOCAB_ALIGN) * VOCAB_ALIGN


def _check_arch(cfg: ModelConfig) -> None:
    if cfg.arch_type not in SERVE_ARCHS:
        raise NotImplementedError(
            f"the port serves arch_type {SERVE_ARCHS}, not {cfg.arch_type!r}")


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, seed: int = 0, device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random parameters made on ``device`` from a ``torch.Generator``
    seeded with ``seed``, with the JAX package's init scales (the values
    differ: JAX's PRNG is not reproduced; tests load JAX parameters through
    ``convert.params_from_jax`` instead)."""
    _check_arch(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, d, vp = cfg.num_layers, cfg.d_model, padded_vocab(cfg)
    kw = dict(generator=gen, device=dev, dtype=dtype)
    p = {"embed": L.init_embedding(vp, d, **kw),
         "final_norm": L.init_norm(cfg.norm, d, num_layers=0, device=dev)}
    if not cfg.tie_embeddings:
        p["head"] = L.init_embedding(vp, d, **kw)
    layers = {"ln1": L.init_norm(cfg.norm, d, num_layers=n, device=dev),
              "attn": L.init_attention(cfg, num_layers=n, **kw),
              "ln2": L.init_norm(cfg.norm, d, num_layers=n, device=dev)}
    if cfg.arch_type == "moe":
        layers["moe"] = moe_lib.init_moe_block(cfg, num_layers=n, **kw)
    else:
        layers["mlp"] = L.init_mlp(d, cfg.d_ff, cfg.mlp_activation, num_layers=n, **kw)
    p["layers"] = layers
    return p


def layer_params(tree, i: int):
    """Slice layer ``i`` out of a stacked-layer param (or cache) dict."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


# ----------------------------------------------------------------------------
# caches
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device: DeviceLike = None,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """Per-layer stacked KV caches: {"kv": {"k", "v"}} each
    (L, batch, S, nkv, hd), S = max_len (or the window, for ring caches)."""
    _check_arch(cfg)
    dev = resolve_device(device)
    return {"kv": L.init_kv_cache(cfg, batch, max_len, num_layers=cfg.num_layers,
                                  device=dev, dtype=dtype)}


# ----------------------------------------------------------------------------
# forward pieces
# ----------------------------------------------------------------------------

def _ffn(lp, x2, cfg):
    if cfg.arch_type == "moe":
        out, _, _, _ = moe_lib.sparse_moe_block(lp["moe"], x2, cfg)
        return out
    return L.apply_mlp(lp["mlp"], x2, cfg.mlp_activation)


def _logits(params, h, cfg):
    h = L.apply_norm(params["final_norm"], h, cfg.norm)
    head = params.get("head", params["embed"])
    return L.unembed(head, h)


def decode_step(params, tokens, cache: dict, index, cfg: ModelConfig, *,
                compute_dtype: torch.dtype = torch.bfloat16):
    """One decode step. tokens: (B, 1) int; index: scalar position or (B,)
    per-row positions (continuous batching). The cache is updated in place.
    Returns (logits (B, 1, V_pad), cache)."""
    _check_arch(cfg)
    h = L.embed(params["embed"], tokens, compute_dtype)
    kv = cache["kv"]
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        a = L.decode_attention(lp["attn"], L.apply_norm(lp["ln1"], h, cfg.norm),
                               {"k": kv["k"][i], "v": kv["v"][i]}, index, cfg)
        h = h + a
        h = h + _ffn(lp, L.apply_norm(lp["ln2"], h, cfg.norm), cfg)
    return _logits(params, h, cfg), cache


def prefill_with_cache(params, tokens, cache: dict, slots, lengths, cfg: ModelConfig, *,
                       compute_dtype: torch.dtype = torch.bfloat16):
    """Prefill right-padded prompts directly into KV-cache rows.

    tokens: (B', P) right-padded; slots: (B',) cache rows to fill; lengths:
    (B',) valid prompt lengths (1 <= length <= P). Causal masking keeps
    padded columns out of real positions; K/V of padded (or window-expired)
    positions are not written. Ring caches keep the last ``window``
    positions at ``position % window``. ``lengths`` given as Python ints
    saves a read-back from the device.

    Returns (last_logits (B', V_pad) at position length-1 of each row, cache).
    """
    _check_arch(cfg)
    dev = tokens.device
    kv = cache["kv"]
    W = kv["k"].shape[2]
    lens = lengths.tolist() if torch.is_tensor(lengths) else [int(n) for n in lengths]
    lengths = torch.as_tensor(lens, device=dev)
    slots = torch.as_tensor(slots, device=dev).long()
    # which (row, position) pairs land in the cache, and where
    b_idx, p_idx = [], []
    for b, n in enumerate(lens):
        lo = max(0, n - W)
        hi = n if cfg.sliding_window > 0 else min(n, W)
        b_idx += [b] * max(0, hi - lo)
        p_idx += range(lo, hi)
    b_idx = torch.tensor(b_idx, dtype=torch.long, device=dev)
    p_idx = torch.tensor(p_idx, dtype=torch.long, device=dev)
    rows = slots[b_idx]
    dest = p_idx % W if cfg.sliding_window > 0 else p_idx

    h = L.embed(params["embed"], tokens, compute_dtype)
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        a, (k, v) = L.attention(lp["attn"], L.apply_norm(lp["ln1"], h, cfg.norm), cfg,
                                return_kv=True)
        kv["k"][i][rows, dest] = k[b_idx, p_idx].to(kv["k"].dtype)
        kv["v"][i][rows, dest] = v[b_idx, p_idx].to(kv["v"].dtype)
        h = h + a
        h = h + _ffn(lp, L.apply_norm(lp["ln2"], h, cfg.norm), cfg)

    last = h[torch.arange(len(lens), device=dev), lengths - 1]             # (B', d)
    return _logits(params, last, cfg), cache
