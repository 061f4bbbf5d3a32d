"""Plain PyTorch versions of the port's kernels, forward and backward.

They define the semantics the CUDA kernels in ``csrc/`` implement, run on
the CPU (where every wrapper in ``ops.py`` uses them) and are what
``chip_smoke.py`` holds each kernel against on the card. Like the Pallas
kernels of the JAX package they accumulate in float32 and return the
input dtype.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def gmm_ref(lhs: torch.Tensor, rhs: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """Grouped matmul. lhs: (M, K) rows grouped by expert; rhs: (G, K, N);
    group_sizes: (G,) with sum <= M. Row m of group g is ``lhs[m] @ rhs[g]``;
    rows past ``sum(group_sizes)`` are zero."""
    M = lhs.shape[0]
    out = torch.zeros((M, rhs.shape[2]), dtype=lhs.dtype, device=lhs.device)
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        if size > 0:
            out[start:start + size] = (lhs[start:start + size].float()
                                       @ rhs[g].float()).to(lhs.dtype)
        start += size
    return out


def tgmm_ref(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
             num_groups: int) -> torch.Tensor:
    """Transposed grouped matmul (the grouped matmul's weight gradient).
    lhs: (M, K), rhs: (M, N), rows grouped as in ``gmm_ref`` ->
    (num_groups, K, N) with ``out[g] = lhs[rows of g].T @ rhs[rows of g]``,
    accumulated in float32, in lhs's dtype. A group with no rows is zero;
    rows past ``sum(group_sizes)`` are never read."""
    K, N = lhs.shape[1], rhs.shape[1]
    out = torch.zeros((num_groups, K, N), dtype=lhs.dtype, device=lhs.device)
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        if size > 0:
            out[g] = (lhs[start:start + size].float().T
                      @ rhs[start:start + size].float()).to(lhs.dtype)
        start += size
    return out


def swiglu_ref(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` in float32, cast to the input dtype."""
    g = gate.float()
    return (g * torch.sigmoid(g) * up.float()).to(gate.dtype)


def swiglu_bwd_ref(gate: torch.Tensor, up: torch.Tensor,
                   dout: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward of ``silu(gate) * up`` in float32 (the JAX package's
    ``ops.py`` custom VJP): ``dgate = dout * up * dsilu``, ``dup = dout *
    silu``, with ``dsilu = sig * (1 + gate * (1 - sig))``; each cast to its
    input's dtype."""
    g = gate.float()
    sig = torch.sigmoid(g)
    silu = g * sig
    dsilu = sig * (1 + g * (1 - sig))
    d = dout.float()
    return (d * up.float() * dsilu).to(gate.dtype), (d * silu).to(up.dtype)


def token_counts_ref(ids: torch.Tensor, num_local: int, offset: int) -> torch.Tensor:
    """Stage-2 histogram: (num_local,) int32 counts of the flat ids in
    ``[offset, offset + num_local)``; other ids count nowhere. Each id is
    compared with every local expert and the matches summed, the one-hot
    reduction the Pallas kernel does per tile."""
    local = ids.reshape(-1).long() - offset
    bins = torch.arange(num_local, device=ids.device)
    return (local[:, None] == bins[None, :]).sum(0, dtype=torch.int32)


def dispatch_plan_ref(ids: torch.Tensor, num_local: int, offset: int, pool_rows: int,
                      align: int, uniform: bool = False):
    """MoE Stages 2 and 3: the histogram, then sort-based index generation,
    and the inverse map of the slot pool. ``ids``: the (F,) flat expert ids
    of the (token, k) pairs in flat order. Only ids in ``[offset, offset +
    num_local)`` are dispatched; the others sort to the sentinel key
    ``num_local`` and are masked. Each local expert's group is its count
    rounded up to ``align`` rows; the groups share the pool in expert order
    (the running sum clamped at ``pool_rows``), and a pair whose stable rank
    among its expert's pairs reaches its group's size is dropped. With
    ``uniform`` every group is ``pool_rows // num_local`` rows at offset
    ``k * pool_rows // num_local`` whatever its count (``align`` unused):
    the JAX package's ``uniform_capacity``. Returns

    * ``slot`` (F,) int64: the pair's pool row, ``pool_rows`` if dropped or
      non-local; ``valid`` (F,) bool;
    * ``counts`` (num_local,) int64; ``group_sizes`` (num_local,) int32;
      ``drops`` () int64: local pairs that are not valid;
    * ``inv_pair`` (pool_rows,) int64: the pair that fills each row, 0 for a
      row no pair fills; ``pool_valid`` (pool_rows,) bool: the filled rows.
    """
    EL, F, dev = num_local, ids.numel(), ids.device
    counts = token_counts_ref(ids, EL, offset).long()
    local = ids.reshape(-1).long() - offset
    key = torch.where((local >= 0) & (local < EL), local, EL)      # non-local -> sentinel
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]

    if uniform:
        offsets = torch.arange(EL + 1, dtype=torch.int64, device=dev) * (pool_rows // EL)
    else:
        gs_aligned = (counts + align - 1) // align * align
        cum = torch.clamp(torch.cumsum(gs_aligned, 0), max=pool_rows)
        offsets = torch.cat([torch.zeros(1, dtype=cum.dtype, device=dev), cum])
    group_sizes = offsets[1:] - offsets[:-1]

    # position of each sorted pair within its expert group. The sentinel
    # group starts at sum(counts), the last entry of ``starts``
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(counts, 0)])
    pos_sorted = torch.arange(F, device=dev) - starts[sorted_key]

    safe_key = torch.clamp(sorted_key, max=EL - 1)
    slot_sorted = offsets[safe_key] + pos_sorted
    valid_sorted = (sorted_key < EL) & (pos_sorted < group_sizes[safe_key])
    slot_sorted = torch.where(valid_sorted, slot_sorted, torch.full_like(slot_sorted, pool_rows))

    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    valid = torch.empty_like(valid_sorted).scatter_(0, order, valid_sorted)
    drops = counts.sum() - valid_sorted.sum()

    # inverse map: pool row -> pair; the dropped and non-local pairs land in
    # the extra row ``pool_rows``, which is cut off
    inv_pair = torch.zeros(pool_rows + 1, dtype=torch.int64, device=dev)
    inv_pair[slot] = torch.arange(F, device=dev)
    pool_valid = torch.zeros(pool_rows + 1, dtype=torch.bool, device=dev)
    pool_valid[slot] = valid
    return (slot, valid, counts, group_sizes.to(torch.int32), drops, inv_pair[:pool_rows],
            pool_valid[:pool_rows])


def combine_ref(rows: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """rows (T, K, D), weights (T, K) -> (T, D):
    ``out[t] = sum_k weights[t, k] * rows[t, k]``, accumulated in float32."""
    return torch.einsum("tkd,tk->td", rows.float(),
                        weights.float()).to(rows.dtype)


def combine_bwd_ref(rows: torch.Tensor, weights: torch.Tensor,
                    dout: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward of ``combine_ref`` (the paper's fused backward): ``drows[t,
    k] = weights[t, k] * dout[t]`` in rows's dtype and ``dw[t, k] =
    sum_d rows[t, k, d] * dout[t, d]`` in float32 (the kernel's output; the
    autograd wrapper casts it to the weights' dtype)."""
    d = dout.float()
    drows = (weights.float()[..., None] * d[:, None, :]).to(rows.dtype)
    dw = torch.einsum("tkd,td->tk", rows.float(), d)
    return drows, dw


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Dense softmax attention. q: (B, Sq, nh, hd); k/v: (B, Skv, nkv, hd)
    with nh % nkv == 0 (query head h reads kv head ``h // (nh // nkv)``).
    Scale 1/sqrt(hd); causal (``q >= k``) and window (``q - k < window``)
    masks set scores to -1e30."""
    B, Sq, nh, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    groups = nh // nkv
    qf = q.float().reshape(B, Sq, nkv, groups, hd)
    s = torch.einsum("bqngh,bknh->bngqk", qf, k.float()) / math.sqrt(hd)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= qp - kp < window
    s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngqk,bknh->bqngh", p, v.float())
    return o.reshape(B, Sq, nh, hd).to(q.dtype)


def slot_decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, positions: torch.Tensor,
                              *, ring: bool = False) -> torch.Tensor:
    """Single-token cached GQA attention with per-row positions (the serve
    engine's decode step).

    q: (B, nh, hd) post-RoPE queries; k_cache/v_cache: (B, S, nkv, hd);
    positions: (B,) absolute position of the current token per row. With
    ``ring`` the cache is a sliding-window ring where position p lives at
    slot ``p % S``; otherwise slot s holds position s. Entries past a row's
    position (or outside its window) are masked. Returns (B, nh, hd) in the
    dtype of q, computed in float32.
    """
    B, nh, hd = q.shape
    S, nkv = k_cache.shape[1], k_cache.shape[2]
    groups = nh // nkv
    idx = positions.to(torch.int64)
    slots = torch.arange(S, device=q.device)[None, :]
    if ring:
        sl = (idx % S)[:, None]
        wrap = torch.where(slots <= sl, slots, slots - S)
        abs_pos = idx[:, None] - sl + wrap
    else:
        abs_pos = slots.expand(B, S)
    valid = (abs_pos >= 0) & (abs_pos <= idx[:, None])

    qf = q.reshape(B, nkv, groups, hd).float() / math.sqrt(hd)
    s = torch.einsum("bngh,bsnh->bngs", qf, k_cache.float())
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngs,bsnh->bngh", p, v_cache.float())
    return o.reshape(B, nh, hd).to(q.dtype)


def ssd_intra_chunk_ref(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                        Cm: torch.Tensor, A: torch.Tensor):
    """Mamba-2 SSD intra-chunk stage, per (batch, chunk, head), in float32
    whatever the input dtype (the JAX package's ``_ssd_chunked`` intra-chunk
    part). x (B, C, L, H, P); dt (B, C, L, H); Bm/Cm (B, C, L, N); A (H,)
    negative. ``la = cumsum(dt * A)`` along the chunk; returns y_diag (B, C,
    L, H, P) ``= ((C B^T) o tril(exp(la_i - la_j))) (dt x)``, states (B, C,
    H, P, N) ``= (exp(la_L - la) dt x)^T B`` and cdecay (B, C, H) ``=
    exp(la_L)``. Above the diagonal the decay is selected away, never
    multiplied by a 0/1 mask: its exponent is positive there and may be inf."""
    x, dt, Bm, Cm = x.float(), dt.float(), Bm.float(), Cm.float()
    L = x.shape[2]
    la = torch.cumsum(dt * A.float(), dim=2)                           # (B,C,L,H)
    seg = la[:, :, :, None] - la[:, :, None, :]                        # (B,C,L,L,H)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", Cm, Bm)                       # (B,C,L,L)
    dtx = dt[..., None] * x                                            # (B,C,L,H,P)
    y = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * decay, dtx)
    w = torch.exp(la[:, :, -1:, :] - la)                               # (B,C,L,H)
    states = torch.einsum("bcjhp,bcjn->bchpn", w[..., None] * dtx, Bm)
    return y, states, torch.exp(la[:, :, -1, :])
