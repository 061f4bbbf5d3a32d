"""Model builder (``arch_type`` dense, moe, ssm and hybrid): params, the
training forward and loss (with selective activation checkpointing), caches,
one decode step and prefill into cache slots. Port of the JAX package's
``models/model.py``.

Parameters keep the JAX package's pytree layout — a nested dict whose
``layers`` leaves are stacked with a leading layer dim — so a JAX parameter
tree converts leaf for leaf (``repro_torch.convert``). Where the JAX model
scans over the stacked layers, the port loops over them in Python.

The ssm stack (Mamba-1, falcon-mamba) is ``layers`` of ``{"ln", "mixer"}``.
The hybrid (Zamba2) stack is ``groups`` of ``shared_attn_every`` Mamba-2
layers (params stacked (n_group, every, ...)), each group followed by one
application of the ``shared`` attention+MLP block, then the ``rem``
remaining Mamba-2 layers. Both train and serve. The mixer follows
``cfg.ssm.variant`` ('mamba1' or 'mamba2'), as in the JAX package. Under
``no_grad`` the Mamba-2 layers run the SSD kernel; in training they take
the JAX package's plain intra-chunk math (``models.ssm``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import moe as moe_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.ep import CollectiveTape, all_reduce_sum
from repro_torch.parallel.grid import BATCH_AXES, as_grid
from repro_torch.parallel.vocab import nll as vocab_nll, vocab_shard
from repro_torch.tree import leaves, tree_map

from . import layers as L
from . import ssm as S

VOCAB_ALIGN = 256
ARCHS = ("dense", "moe", "ssm", "hybrid")
KV_ARCHS = ("dense", "moe")      # attention-KV archs: prefill into cache slots


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // VOCAB_ALIGN) * VOCAB_ALIGN


def _check_arch(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ARCHS:
        raise NotImplementedError(
            f"the port runs arch_type {ARCHS}, not {cfg.arch_type!r} (ROADMAP.md §1 item 6, "
            f"the rest of the zoo)")


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, seed: int = 0, device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> dict:
    """Random parameters made on ``device`` from a ``torch.Generator``
    seeded with ``seed``, with the JAX package's init scales (the values
    differ: JAX's PRNG is not reproduced; tests load JAX parameters through
    ``convert.params_from_jax`` instead). ``device="meta"`` gives the shapes
    alone, as ``jax.eval_shape`` does."""
    _check_arch(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(seed)
    n, d, vp = cfg.num_layers, cfg.d_model, padded_vocab(cfg)
    kw = dict(generator=gen, device=dev, dtype=dtype)
    p = {"embed": L.init_embedding(vp, d, **kw),
         "final_norm": L.init_norm(cfg.norm, d, num_layers=0, device=dev)}
    if not cfg.tie_embeddings:
        p["head"] = L.init_embedding(vp, d, **kw)
    if cfg.arch_type == "hybrid":
        return _init_hybrid(p, cfg, kw)
    if cfg.arch_type == "ssm":
        p["layers"] = _init_ssm_layers(cfg, n, kw)
        return p
    layers = {"ln1": L.init_norm(cfg.norm, d, num_layers=n, device=dev),
              "attn": L.init_attention(cfg, num_layers=n, **kw),
              "ln2": L.init_norm(cfg.norm, d, num_layers=n, device=dev)}
    if cfg.arch_type == "moe":
        layers["moe"] = moe_lib.init_moe_block(cfg, num_layers=n, **kw)
    else:
        layers["mlp"] = L.init_mlp(d, cfg.d_ff, cfg.mlp_activation, num_layers=n, **kw)
    p["layers"] = layers
    return p


def hybrid_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_group, every, rem): groups of ``every`` Mamba-2 layers, each
    followed by the shared block, then ``rem`` Mamba-2 layers."""
    every = cfg.shared_attn_every
    n_group = cfg.num_layers // every
    return n_group, every, cfg.num_layers - n_group * every


def _mamba1(cfg) -> bool:
    return cfg.ssm.variant == "mamba1"


def _init_ssm_layers(cfg, n: int, kw: dict) -> dict:
    mixer = S.init_mamba1 if _mamba1(cfg) else S.init_mamba2
    return {"ln": L.init_norm(cfg.norm, cfg.d_model, num_layers=n, device=kw["device"]),
            "mixer": mixer(cfg, num_layers=n, **kw)}


def _init_hybrid(p: dict, cfg: ModelConfig, kw: dict) -> dict:
    n_group, every, rem = hybrid_layout(cfg)
    d = cfg.d_model
    p["groups"] = tree_map(lambda t: t.reshape(n_group, every, *t.shape[1:]),
                           _init_ssm_layers(cfg, n_group * every, kw))
    if rem:
        p["rem"] = _init_ssm_layers(cfg, rem, kw)
    shared = {"ln1": L.init_norm(cfg.norm, d, num_layers=1, device=kw["device"]),
              "attn": L.init_attention(cfg, num_layers=1, **kw),
              "ln2": L.init_norm(cfg.norm, d, num_layers=1, device=kw["device"]),
              "mlp": L.init_mlp(d, cfg.d_ff, cfg.mlp_activation, num_layers=1, **kw)}
    p["shared"] = tree_map(lambda t: t[0], shared)
    return p


def unstack_layers(tree, n: int) -> list:
    """The ``n`` per-layer dicts of a stacked-layer param dict, as views cut
    with ``torch.unbind``: in training its backward stacks the layers'
    gradients once, where slicing each layer would build a zero-padded
    full-size gradient per layer and leaf."""
    if isinstance(tree, dict):
        cols = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: c[i] for k, c in cols.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


# ----------------------------------------------------------------------------
# caches
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device: DeviceLike = None,
               dtype: torch.dtype = torch.bfloat16, tp: int = 1) -> dict:
    """Per-layer stacked KV caches: {"kv": {"k", "v"}} each
    (L, batch, S, nkv, hd), S = max_len (or the window, for ring caches).
    ssm: {"ssm": the mixers' state {"conv", "h"} stacked over the layers}.
    Hybrid: {"groups": Mamba-2 state {"conv", "h"} stacked flat over the
    n_group * every grouped layers, "shared_kv": one KV cache per
    application of the shared block (n_group, ...), and "rem" when there
    are remaining layers}; the SSM state is float32 whatever ``dtype``.
    ``tp``: the 'tp' ranks of a serving grid (``decode_step(grid=)``): a
    rank's cache holds its ``num_kv_heads / tp`` kv heads (dense and moe
    archs)."""
    _check_arch(cfg)
    if tp > 1 and cfg.arch_type not in KV_ARCHS:
        raise NotImplementedError(f"a tp-split cache for arch_type {cfg.arch_type!r}")
    dev = resolve_device(device)
    if cfg.arch_type == "ssm":
        mk = S.init_mamba1_cache if _mamba1(cfg) else S.init_mamba2_cache
        return {"ssm": mk(cfg, batch, num_layers=cfg.num_layers, device=dev)}
    if cfg.arch_type == "hybrid":
        n_group, every, rem = hybrid_layout(cfg)
        c = {"groups": S.init_mamba2_cache(cfg, batch, num_layers=n_group * every, device=dev),
             "shared_kv": L.init_kv_cache(cfg, batch, max_len, num_layers=n_group, device=dev,
                                          dtype=dtype)}
        if rem:
            c["rem"] = S.init_mamba2_cache(cfg, batch, num_layers=rem, device=dev)
        return c
    return {"kv": L.init_kv_cache(cfg, batch, max_len, num_layers=cfg.num_layers,
                                  device=dev, dtype=dtype, tp=tp)}


# ----------------------------------------------------------------------------
# forward pieces
# ----------------------------------------------------------------------------

def _ffn(lp, x2, cfg, grid=None):
    """The serving FFN; on a ``grid`` every rank holds the whole batch."""
    ep, tp = (grid.ep, grid.tp) if grid is not None else (None, None)
    if cfg.arch_type == "moe":
        # serving discards the router's aux and z losses and the stats
        out, _, _, _ = moe_lib.sparse_moe_block(lp["moe"], x2, cfg, aux=False, ep_group=ep,
                                                tp_group=tp, replicated=grid is not None)
        return out
    return L.apply_mlp(lp["mlp"], x2, cfg.mlp_activation, tp=tp)


def table_split(params, cfg: ModelConfig, ep_group=None, tp_group=None,
                replicated: bool = False):
    """The split of the params' embedding and head tables
    (``parallel.vocab.VocabShard``; both tables, or the one tied table,
    share it), or None when they are whole. ``ep_group`` / ``tp_group``:
    the rank's 'ep' and 'tp' groups; ``replicated``: every rank holds the
    whole batch (serving)."""
    return vocab_shard(params["embed"]["table"], padded_vocab(cfg), ep=ep_group, tp=tp_group,
                       replicated=replicated)


def _head(params, h, cfg):
    return L.apply_norm(params["final_norm"], h, cfg.norm), params.get("head", params["embed"])


def _logits(params, h, cfg, vocab=None):
    h, head = _head(params, h, cfg)
    return L.unembed(head, h, vocab)


def _nll(params, h, labels, cfg, vocab=None):
    """``masked_nll`` of ``_logits``; over a vocab-split table the
    vocab-parallel NLL, which never puts the logits together."""
    h, head = _head(params, h, cfg)
    if vocab is None:
        return masked_nll(L.unembed(head, h), labels, cfg)
    return vocab_nll(head["table"], h, labels, cfg.vocab_size, vocab)


def _ssm_block(lp, h, cfg, sac: str):
    mixer = S.mamba1_block if _mamba1(cfg) else S.mamba2_block
    fn = _sac(lambda q, x: mixer(q, x, cfg), "ssm", sac)
    return h + fn(lp["mixer"], L.apply_norm(lp["ln"], h, cfg.norm))


def _ssm_decode(lp, h, cache, i: int, cfg):
    """One SSM layer's decode step on row ``i`` of a stacked cache."""
    step = S.mamba1_decode_step if _mamba1(cfg) else S.mamba2_decode_step
    c = {"conv": cache["conv"][i], "h": cache["h"][i]}
    y, _ = step(lp["mixer"], L.apply_norm(lp["ln"], h, cfg.norm), c, cfg)
    return h + y


def _hybrid_layers(params, cfg) -> tuple[list, list]:
    """The per-layer param dicts: a list of ``every`` per group, and the
    remaining layers'."""
    n_group, every, rem = hybrid_layout(cfg)
    groups = [unstack_layers(gp, every) for gp in unstack_layers(params["groups"], n_group)]
    return groups, unstack_layers(params["rem"], rem) if rem else []


def _hybrid_decode(params, h, cache, index, cfg):
    sp = params["shared"]
    kv = cache["shared_kv"]
    groups, rem = _hybrid_layers(params, cfg)
    for g, layers in enumerate(groups):
        for j, lp in enumerate(layers):
            h = _ssm_decode(lp, h, cache["groups"], g * len(layers) + j, cfg)
        h = h + L.decode_attention(sp["attn"], L.apply_norm(sp["ln1"], h, cfg.norm),
                                   {"k": kv["k"][g], "v": kv["v"][g]}, index, cfg)
        h = h + L.apply_mlp(sp["mlp"], L.apply_norm(sp["ln2"], h, cfg.norm),
                            cfg.mlp_activation)
    for i, lp in enumerate(rem):
        h = _ssm_decode(lp, h, cache["rem"], i, cfg)
    return h


def decode_step(params, tokens, cache: dict, index, cfg: ModelConfig, *,
                compute_dtype: torch.dtype = torch.bfloat16, grid=None):
    """One decode step. tokens: (B, 1) int; index: scalar position or (B,)
    per-row positions (continuous batching). The cache is updated in place.
    Returns (logits (B, 1, V_pad), cache). ssm and hybrid: the SSM layers
    step their state, the shared block attends over its group's KV cache;
    no kernel of the port runs (the JAX package's decode step is plain
    too). ``grid``: a serving grid, 'ep' and 'tp' axes only, checked by
    ``serve.engine.serving_grid`` (dense and moe archs): every rank takes
    the same tokens with its tiles of the params and a cache of its kv
    heads (``init_cache(tp=)``), attention runs on its heads and the MoE on
    its experts' d_ff shards, and every rank gets the whole logits (its
    columns of a vocab-split table's, gathered over the table's axis)."""
    _check_arch(cfg)
    tp = grid.tp if grid is not None else None
    vocab = table_split(params, cfg, grid.ep, tp, replicated=True) if grid is not None else None
    h = L.embed(params["embed"], tokens, compute_dtype, vocab)
    if cfg.arch_type == "hybrid":
        return _logits(params, _hybrid_decode(params, h, cache, index, cfg), cfg), cache
    if cfg.arch_type == "ssm":
        for i, lp in enumerate(unstack_layers(params["layers"], cfg.num_layers)):
            h = _ssm_decode(lp, h, cache["ssm"], i, cfg)
        return _logits(params, h, cfg), cache
    kv = cache["kv"]
    for i, lp in enumerate(unstack_layers(params["layers"], cfg.num_layers)):
        a = L.decode_attention(lp["attn"], L.apply_norm(lp["ln1"], h, cfg.norm),
                               {"k": kv["k"][i], "v": kv["v"][i]}, index, cfg, tp=tp)
        h = h + a
        h = h + _ffn(lp, L.apply_norm(lp["ln2"], h, cfg.norm), cfg, grid)
    return _logits(params, h, cfg, vocab), cache


def prefill_with_cache(params, tokens, cache: dict, slots, lengths, cfg: ModelConfig, *,
                       compute_dtype: torch.dtype = torch.bfloat16, grid=None):
    """Prefill right-padded prompts directly into KV-cache rows.

    tokens: (B', P) right-padded; slots: (B',) cache rows to fill; lengths:
    (B',) valid prompt lengths (1 <= length <= P). Causal masking keeps
    padded columns out of real positions; K/V of padded (or window-expired)
    positions are not written. Ring caches keep the last ``window``
    positions at ``position % window``. ``lengths`` given as Python ints
    saves a read-back from the device.

    Returns (last_logits (B', V_pad) at position length-1 of each row, cache).
    Attention-KV archs only (dense, moe), as in the JAX package; an ssm or
    hybrid model prefills by stepping ``decode_step`` over the prompt.
    ``grid``: as in ``decode_step``.
    """
    if cfg.arch_type not in KV_ARCHS:
        raise NotImplementedError(
            f"prefill_with_cache supports attention-KV archs {KV_ARCHS}, not "
            f"{cfg.arch_type!r}; step decode_step over the prompt instead")
    tp = grid.tp if grid is not None else None
    vocab = table_split(params, cfg, grid.ep, tp, replicated=True) if grid is not None else None
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

    h = L.embed(params["embed"], tokens, compute_dtype, vocab)
    for i, lp in enumerate(unstack_layers(params["layers"], cfg.num_layers)):
        a, (k, v) = L.attention(lp["attn"], L.apply_norm(lp["ln1"], h, cfg.norm), cfg,
                                return_kv=True, tp=tp)
        kv["k"][i][rows, dest] = k[b_idx, p_idx].to(kv["k"].dtype)
        kv["v"][i][rows, dest] = v[b_idx, p_idx].to(kv["v"].dtype)
        h = h + a
        h = h + _ffn(lp, L.apply_norm(lp["ln2"], h, cfg.norm), cfg, grid)

    last = h[torch.arange(len(lens), device=dev), lengths - 1]             # (B', d)
    return _logits(params, last, cfg, vocab), cache


# ----------------------------------------------------------------------------
# SAC wrappers (selective activation checkpointing, paper §1)
# ----------------------------------------------------------------------------

def _remat(fn):
    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return wrapped


def _sac(fn, name: str, policy: str):
    """Checkpoint ``fn`` when its module is selected by the SAC policy (a
    comma-separated set, e.g. 'attn,moe'): only its inputs are saved, its
    insides are recomputed in the backward."""
    selected = set(policy.split(",")) if policy else set()
    return _remat(fn) if name in selected else fn


def _remat_sc(fn):
    def wrapped(*args):
        tape = CollectiveTape()
        return checkpoint(lambda *a: tape.run(fn, *a), *args, use_reentrant=False)
    return wrapped


def block_remat(fn, sac: str):
    """Whole-block remat: 'block' saves only the block's inputs; under EP
    and TP the recompute runs the block's collectives again, on every rank
    in the same order. 'block_sc' (the JAX package's: also save the
    collectives' outputs, ``attn_proj_out`` and ``moe_out`` there) runs the
    block under a ``parallel.ep.CollectiveTape``: the first run keeps the
    output of every collective it calls, and the recompute takes them from
    the tape instead of communicating, so no forward collective of the
    block runs twice. Its math is 'block''s, bit for bit; it holds, from
    the forward to the backward, the outputs of the collectives that the
    recompute replays (the tape learns which from the first backward). (The port's
    collectives are ``autograd.Function``s over ``torch.distributed``,
    which a selective-checkpoint policy over aten ops does not see.)"""
    modes = set(sac.split(",")) if sac else set()
    if "block_sc" in modes:
        return _remat_sc(fn)
    return _remat(fn) if "block" in modes else fn


# ----------------------------------------------------------------------------
# training forward
# ----------------------------------------------------------------------------

def _dense_block(lp, h, cfg, sac: str, attn_impl: str = "blockwise", tp=None):
    attn = _sac(lambda q, x: L.attention(q, x, cfg, impl=attn_impl, tp=tp), "attn", sac)
    mlp = _sac(lambda q, x: L.apply_mlp(q, x, cfg.mlp_activation, tp=tp), "mlp", sac)
    h = h + attn(lp["attn"], L.apply_norm(lp["ln1"], h, cfg.norm))
    return h + mlp(lp["mlp"], L.apply_norm(lp["ln2"], h, cfg.norm))


def _moe_block(lp, h, cfg, sac: str, attn_impl: str = "blockwise", ep_group=None,
               placement=None, tp=None, whole_pool: bool = False, batch_group=None,
               replicated: bool = False):
    attn = _sac(lambda q, x: L.attention(q, x, cfg, impl=attn_impl, tp=tp), "attn", sac)
    moe = _sac(lambda q, x: moe_lib.sparse_moe_block(q, x, cfg, ep_group=ep_group, tp_group=tp,
                                                     placement=placement, whole_pool=whole_pool,
                                                     batch_group=batch_group,
                                                     aux=not replicated,
                                                     replicated=replicated),
               "moe", sac)
    h = h + attn(lp["attn"], L.apply_norm(lp["ln1"], h, cfg.norm))
    mo, aux, z, stats = moe(lp["moe"], L.apply_norm(lp["ln2"], h, cfg.norm))
    return h + mo, aux, z, stats


def forward(params, batch: dict, cfg: ModelConfig, *, sac: str = "block",
            compute_dtype: torch.dtype = torch.bfloat16, attn_impl: str = "blockwise",
            ep_group=None, placement=None, tp_group=None, replicated: bool = False,
            fsdp=None):
    """The forward over whole sequences. batch["tokens"]: (B, S) int; under
    an EP group (``parallel.EPGroup``) the rank's rows, with the rank's
    share of the params (``parallel.ep_shard``); the MoE blocks then
    communicate and their aux and stats are global. Under a 'tp' group
    ``tp_group`` (dense and moe archs) the params are the rank's shards
    (``parallel.sharding.rank_shard``): attention, the MLPs and the expert
    stacks run on them, every tp rank holding the same rows.
    Returns (logits (B, S, V_pad), aux) with aux = {"moe_aux", "moe_z"}
    summed over layers and, for MoE, "moe_stats" (routing telemetry summed
    over layers), as the JAX package's ``_scan_layers_aux``. ``attn_impl``
    as in ``layers.attention``: 'blockwise' (training; the default) or
    'flash' (the forward-only kernel; prefill). ``placement``: the (L, E)
    inverse expert-placement rows (global id -> position, one row a layer;
    ``parallel.placement``) of MoE stacks stored in placed order, or None.
    ``replicated`` (serving on a grid): every rank holds the whole batch,
    not its rows (``sparse_moe_block(replicated=True)``), and the MoE
    blocks take no router terms or stats (aux holds zeros and no
    "moe_stats"). ssm and hybrid: each SSM layer under block remat, its
    mixer under the 'ssm' SAC name; the hybrid model's shared block after
    each group takes ``sac`` but no block remat, as in the JAX package.
    ``fsdp``: a ``parallel.fsdp.LayerGather`` over the rank's 'data'
    group; the layer params are the rank's 'data' tiles, and each block
    (dense, moe, or an SSM layer of ``layers``, ``groups`` or ``rem``)
    gathers its layer's inside the function that block remat checkpoints,
    so the recompute gathers again and no gathered weight is saved. The
    hybrid's shared block is gathered once, before the groups, in float32
    (its uses cast it to the compute dtype, the bits the gather moved), so
    that its applications' cotangents add in float32 as without fsdp; it
    stays whole until its backward has run. Every leaf fsdp splits is cast
    to the compute dtype where a layer uses it, so a gather in that dtype
    gives the layer the bits of its whole weight: the attention and MLP
    projections (``layers``), the expert stacks and router (``core.moe``),
    and the SSM mixers' ``in_proj``, ``conv_w``, ``x_proj``, ``dt_proj``
    and ``out_proj`` (``ssm.mamba1_block``, ``_mamba1_inner``,
    ``mamba2_block``). A vocab-split embedding and head (``table_split``:
    the tables' vocab rows on the 'tp' or 'ep' group) are looked up and
    unembedded over their group, and the logits are the whole vocab's."""
    vocab = table_split(params, cfg, ep_group, tp_group, replicated)
    h, aux = _trunk(params, batch["tokens"], cfg, vocab, sac=sac, compute_dtype=compute_dtype,
                    attn_impl=attn_impl, ep_group=ep_group, placement=placement,
                    tp_group=tp_group, replicated=replicated, fsdp=fsdp)
    return _logits(params, h, cfg, vocab), aux


def _trunk(params, tokens, cfg: ModelConfig, vocab, *, sac, compute_dtype, attn_impl,
           ep_group, placement, tp_group, replicated, fsdp):
    """``forward`` up to the final norm: (h, aux)."""
    _check_arch(cfg)
    gather = fsdp if fsdp is not None else (lambda lp, part="layers", out_dtype=None: lp)
    h = L.embed(params["embed"], tokens, compute_dtype, vocab)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    aux = {"moe_aux": zero, "moe_z": zero}

    def ssm(part):
        return block_remat(lambda lp, x: _ssm_block(gather(lp, part), x, cfg, sac), sac)

    if cfg.arch_type == "ssm":
        block = ssm("layers")
        for lp in unstack_layers(params["layers"], cfg.num_layers):
            h = block(lp, h)
        return h, aux
    if cfg.arch_type == "hybrid":
        groups, rem = _hybrid_layers(params, cfg)
        grouped, last = ssm("groups"), ssm("rem")
        shared = gather(params["shared"], "shared", torch.float32)
        for layers in groups:
            for lp in layers:
                h = grouped(lp, h)
            h = _dense_block(shared, h, cfg, sac, attn_impl)
        for lp in rem:
            h = last(lp, h)
        return h, aux
    layers = unstack_layers(params["layers"], cfg.num_layers)
    if cfg.arch_type == "moe":
        block = block_remat(lambda lp, x, pl: _moe_block(gather(lp), x, cfg, sac, attn_impl,
                                                          ep_group, pl, tp_group,
                                                          replicated=replicated), sac)
        counts = torch.zeros(cfg.moe.num_experts, dtype=torch.float32, device=h.device)
        drops = zero
        for i, lp in enumerate(layers):
            h, a, z, st = block(lp, h, None if placement is None else placement[i])
            if replicated:
                continue
            aux["moe_aux"] = aux["moe_aux"] + a
            aux["moe_z"] = aux["moe_z"] + z
            counts, drops = counts + st.counts, drops + st.drops
        if not replicated:
            aux["moe_stats"] = moe_lib.MoeStats(counts, drops)
    else:
        block = block_remat(lambda lp, x: _dense_block(gather(lp), x, cfg, sac, attn_impl,
                                                       tp_group), sac)
        for lp in layers:
            h = block(lp, h)
    return h, aux


# ----------------------------------------------------------------------------
# pipeline-stage pieces (the PP train step; parallel/pipeline.py)
# ----------------------------------------------------------------------------

PP_ARCH_TYPES = ("dense", "moe", "ssm")   # uniform stacked 'layers'


def embed_tokens(params, tokens, cfg: ModelConfig, *,
                 compute_dtype: torch.dtype = torch.bfloat16, vocab=None):
    """Stage 0's input: the token embedding, as ``forward`` computes it.
    ``vocab``: the tables' split (``table_split`` over the stage's 'ep' and
    'tp' groups), or None."""
    return L.embed(params["embed"], tokens, compute_dtype, vocab)


def pipeline_stage_forward(stage_lp, h, cfg: ModelConfig, *, sac: str = "", ep_group=None,
                           tp_group=None, batch_group=None, fsdp=None):
    """Apply one pipeline stage's (L/pp, ...)-stacked layer slice to ``h``,
    with the block functions (and block remat) ``forward`` uses, so that
    running the pp stage slices back to back is the sequential model.
    Returns (h, moe_aux, moe_z, MoeStats), the router terms and stats
    summed over the stage's layers (a dense or ssm stage: zeros and
    empty counts).

    ``ep_group`` / ``tp_group``: the stage's 'ep' and 'tp' groups of a
    ``ProcessGrid``, as in ``forward``; ``batch_group``: its ('data',
    'ep') group, the ranks that split the microbatch. A MoE stage
    dispatches with the one-device pool of the whole microbatch and takes
    its router terms and stats over all its tokens (``whole_pool``), as the
    JAX stage routes each microbatch with single-device geometry (``c_align
    = 1``), never the EP shard_map's: the drops, aux, z and counts are the
    one-device step's, the same on every rank of the stage, with any
    ``stage1``. ``fsdp`` (every arch of ``PP_ARCH_TYPES``): a
    ``parallel.fsdp.LayerGather`` over the stage's 'data' group;
    ``stage_lp`` holds the rank's 'data' tiles of the stage's layers, and
    each block (dense, moe or ssm) gathers its layer's inside the function
    block remat checkpoints, as in ``forward``. The PP step
    runs a stage three times a microbatch (the F tick without autograd, the
    B tick's forward, its recompute), so a layer is gathered three times and
    reduce-scattered once a microbatch."""
    at = cfg.arch_type
    if at not in PP_ARCH_TYPES:
        raise ValueError(
            f"pipeline parallelism supports arch_type in {PP_ARCH_TYPES}, "
            f"not {at!r} (non-uniform layer stacks)")
    gather = fsdp if fsdp is not None else (lambda lp: lp)
    n = leaves(stage_lp)[0].shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    layers = unstack_layers(stage_lp, n)
    if at == "ssm":
        block = block_remat(lambda lp, x: _ssm_block(gather(lp), x, cfg, sac), sac)
    elif at == "dense":
        block = block_remat(lambda lp, x: _dense_block(gather(lp), x, cfg, sac, "blockwise",
                                                       tp_group), sac)
    if at != "moe":
        for lp in layers:
            h = block(lp, h)
        return h, zero, zero, moe_lib.MoeStats(torch.zeros(0, device=h.device), zero)
    block = block_remat(lambda lp, x: _moe_block(gather(lp), x, cfg, sac, "blockwise", ep_group,
                                                 None, tp_group, whole_pool=True,
                                                 batch_group=batch_group), sac)
    aux, z, drops = zero, zero, zero
    counts = torch.zeros(cfg.moe.num_experts, dtype=torch.float32, device=h.device)
    for lp in layers:
        h, a, zz, st = block(lp, h)
        aux, z = aux + a, z + zz
        counts, drops = counts + st.counts, drops + st.drops
    return h, aux, z, moe_lib.MoeStats(counts, drops)


def lm_head_nll(params, h, labels, cfg: ModelConfig, vocab=None):
    """The last stage's tail: final norm, unembed and the summed next-token
    NLL of the rank's rows with the count of their unmasked labels
    (``masked_nll``), the ops ``forward`` and ``loss_fn`` apply after the
    layer stack. ``vocab``: as in ``embed_tokens`` (the vocab-parallel
    NLL)."""
    return _nll(params, h, labels, cfg, vocab)


def lm_head_ce(params, h, labels, cfg: ModelConfig, vocab=None):
    """The last stage's tail as the masked CE (``masked_ce``)."""
    nll, n = lm_head_nll(params, h, labels, cfg, vocab)
    return nll / torch.clamp(n, min=1)


def masked_nll(logits, labels, cfg: ModelConfig):
    """Summed next-token NLL over padded-vocab logits and the count of
    unmasked labels (labels < 0 are masked)."""
    vp = padded_vocab(cfg)
    logits = logits.float()
    if vp != cfg.vocab_size:     # mask padded vocab columns out of the lse
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e9)
    mask = labels >= 0
    safe = torch.clamp(labels, min=0)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    nll = torch.where(mask, lse - ll, torch.zeros_like(lse))
    return nll.sum(), mask.sum()


def masked_ce(logits, labels, cfg: ModelConfig):
    """Masked next-token CE over padded-vocab logits (labels < 0 are
    masked). Returns (ce, ntok)."""
    nll, n = masked_nll(logits, labels, cfg)
    ntok = torch.clamp(n, min=1)
    return nll / ntok, ntok


def loss_fn(params, batch: dict, cfg: ModelConfig, *, sac: str = "block",
            compute_dtype: torch.dtype = torch.bfloat16, ep_group=None, placement=None,
            fsdp=None):
    """Next-token cross entropy plus the MoE aux and z losses (each
    averaged over layers, times its coefficient). Returns (loss, metrics):
    ce, moe_aux, moe_z, ntok and, for MoE, moe_counts (per-layer mean of
    the routed pairs per expert), moe_load (its share) and moe_drops
    (summed over layers). ssm and hybrid models have no router terms.

    ``ep_group``: an ``EPGroup`` or a ``ProcessGrid`` (``parallel.grid``;
    an ``EPGroup`` is the dp = 1 grid). On a grid the batch is the rank's
    rows and the first value is the rank's *share* of the global loss (its
    NLL sum over the token count of the ranks splitting the batch, plus the
    router terms over their number): over ('data', 'ep') the shares sum to
    the global loss, whose gradient the ranks' gradients sum to. The tp
    ranks of one (data, ep) coordinate hold the same rows and the same
    share, each its gradient for its shards (``models.layers``). The MoE
    blocks' collectives run over the rank's 'ep' group, whose aux and z are
    their mean over its ranks; the metrics are global (the MoE terms also
    summed over 'data'), the same on every rank, and carry the global loss
    as "loss". ``placement`` and ``fsdp``: as in ``forward``; the metrics
    stay in global expert ids. A vocab-split head takes the vocab-parallel
    NLL (``parallel.vocab.nll``), which never puts the logits together."""
    grid = as_grid(ep_group)
    ep, tp = (grid.ep, grid.tp) if grid is not None else (None, None)
    vocab = table_split(params, cfg, ep, tp)
    h, aux = _trunk(params, batch["tokens"], cfg, vocab, sac=sac, compute_dtype=compute_dtype,
                    attn_impl="blockwise", ep_group=ep, placement=placement, tp_group=tp,
                    replicated=False, fsdp=fsdp)
    nll, n = _nll(params, h, batch["labels"], cfg, vocab)
    nl = max(cfg.num_layers, 1)
    router = []
    if cfg.is_moe:
        router = [cfg.moe.router_aux_coef * aux["moe_aux"] / cfg.num_layers,
                  cfg.moe.router_z_coef * aux["moe_z"] / cfg.num_layers]
    if grid is None:
        ntok = torch.clamp(n, min=1)
        ce = nll / ntok
        total = ce
        for term in router:
            total = total + term
    else:
        rows = grid.group(BATCH_AXES)
        tot = all_reduce_sum(torch.stack([nll.detach(), n.float()]), rows)
        ntok = torch.clamp(tot[1], min=1)
        ce = tot[0] / ntok
        total = nll / ntok
        for term in router:
            total = total + term / rows.world
    moe_aux, moe_z = aux["moe_aux"].detach(), aux["moe_z"].detach()
    st = aux.get("moe_stats")
    if grid is not None and grid.data.world > 1 and cfg.is_moe:
        # each 'ep' group's terms cover its replica's rows: mean (aux, z)
        # and sum (counts, drops) over the replicas
        dp = grid.data.world
        vec = all_reduce_sum(torch.cat([torch.stack([moe_aux / dp, moe_z / dp]),
                                        st.counts.detach(), st.drops.detach()[None]]),
                             grid.data)
        moe_aux, moe_z = vec[0], vec[1]
        st = type(st)(vec[2:-1], vec[-1])
    metrics = {"ce": ce, "moe_aux": moe_aux / nl, "moe_z": moe_z / nl, "ntok": ntok}
    if st is not None:
        counts = st.counts / nl
        metrics["moe_counts"] = counts
        metrics["moe_load"] = counts / torch.clamp(counts.sum(), min=1.0)
        metrics["moe_drops"] = st.drops
    if grid is not None:
        metrics["loss"] = ce
        if cfg.is_moe:
            metrics["loss"] = (ce + cfg.moe.router_aux_coef * moe_aux / cfg.num_layers
                               + cfg.moe.router_z_coef * moe_z / cfg.num_layers)
    return total, metrics
