#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: the quickest proof that the port builds, is right, serves and trains.

    python3 chip_smoke.py                      # all phases, one card

Phases, each printing JSON lines:

  device     the card (nvidia-smi name and power limit) and the time to
             build the CUDA kernels from ``src/repro_torch/csrc``;
  kernels    each kernel against its plain PyTorch version on the card, at
             the serving and training paths' shapes, with its time, the
             plain version's, one PyTorch library call's where there is
             one, and its bound;
  reference  a small MoE model served through the CUDA kernels agrees with
             the same model run on the CPU through the plain versions;
  train_reference  one training step of a small MoE model on the card
             (bf16, through the kernels) agrees with the same step on the
             CPU (float32, plain versions) in loss and gradient norm;
  serve      full-width, full-depth Mula-7B-A1B in bf16 (random weights
             from seed 0) serves 16 requests on 8 slots; asserts the
             results and that every kernel of the path was launched the
             expected number of times;
  train      full-width Mula-7B-A1B cut to 4 of its 16 layers (random
             weights from seed 0, fp32 params and AdamW state, bf16
             compute) takes 6 steps on one fixed batch of 2 x 2 x 2048
             tokens; asserts finite metrics, a falling loss, clip_scale
             <= 1 and the exact launch count of every kernel of the path.

The last three lines are the card's name and power limit as nvidia-smi
prints them, one JSON object listing the kernels, and
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. It needs the repository's ``src/`` beside
it and a CUDA device; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

MULA = "mula-7b-a1b"
DEV = "cuda"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, args: tuple, iters: int = 20, replays: int = 3) -> float:
    """Device time per call of ``fn(*args)`` with its inputs cold in L2:
    the inputs are cloned until the copies exceed twice the 50 MB L2, the
    calls cycle through the copies, ``max(iters, copies)`` of them are
    captured in one CUDA graph, and the replays are timed by CUDA events,
    so the host's launch cost is not in the number."""
    import torch
    set_bytes = sum(a.numel() * a.element_size() for a in args)
    copies = max(1, min(512, -(-100_000_000 // set_bytes)))
    sets = [args] + [tuple(a.clone() for a in args) for _ in range(copies - 1)]
    n = max(iters, copies)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*sets[i % copies])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays)


def time_ms(fn, args: tuple, iters: int = 10, warmup: int = 2) -> float:
    """Time per call of ``fn(*args)`` called eagerly back to back, by CUDA
    events (includes the host's launch cost where the host is the slower
    side, and leaves the inputs warm in L2)."""
    import torch
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    """Least time for the work on the card: the larger of bytes over the
    memory rate and operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------------
# kernels against their plain versions
# ----------------------------------------------------------------------------

def _routing_groups(T: int, m, gen, experts: int = 0):
    """Group sizes of one MoE dispatch of T tokens with random top-k
    routing over the first ``experts`` experts (all if 0), the pool sized
    from the MoE config ``m`` as the model sizes it."""
    import torch
    from repro_torch.core import moe
    from repro_torch.kernels import ops
    idx = torch.rand((T, experts or m.num_experts), generator=gen, device=DEV).topk(
        m.experts_per_token, dim=-1).indices
    rows = moe.dispatch_pool_rows(T, m)
    plan = moe.make_dispatch_plan(idx, num_experts=m.num_experts, pool_rows=rows,
                                  align=ops.gmm_align())
    return plan.group_sizes, rows


def _grouped_mm_yardstick(call, args, plain, rows_of=None, what="torch._grouped_mm"):
    """One ``torch._grouped_mm`` call on the same inputs, where the
    installed PyTorch has it and accepts the form: (``call`` or None,
    note). It is checked against the plain version, on the rows below the
    total where ``rows_of`` (a function of the output) cuts them (it leaves
    the rest undefined)."""
    import torch
    if not hasattr(torch, "_grouped_mm"):
        return None, "torch._grouped_mm not in this PyTorch"
    try:
        y = call(*args)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:
        return None, f"{what} refused: " + str(e).splitlines()[0]
    y, plain = (rows_of(y), rows_of(plain)) if rows_of else (y, plain)
    err = float((y.float() - plain).abs().max())
    return call, f"{what}, max|err| vs plain {err:.4g}"


def _offs(gs):
    import torch
    return torch.cumsum(gs, 0, dtype=torch.int32)


def kernel_cases(cfg) -> list[dict]:
    """The serving path's kernel calls: one dict per (kernel, shape) with
    its inputs (``args``), the wrapper, the plain version, the library
    yardstick (or None), the bytes and operations the call needs, the peak
    rate of those operations and the tolerance."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.serve.engine import dropless_cfg

    gen = torch.Generator(device=DEV).manual_seed(0)
    bf = torch.bfloat16
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    E, K = cfg.moe.num_experts, cfg.moe.experts_per_token

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=DEV, dtype=bf).mul_(scale)

    def gmm_plain(x, w, gs):
        return ref.gmm_ref(x.float(), w.float(), gs)

    cases = []
    w_gate = randn(E, d, f, scale=d ** -0.5)
    w_down = randn(E, f, d, scale=f ** -0.5)
    for phase, T in (("decode", 8), ("prefill512", 512)):
        gs, rows = _routing_groups(T, dropless_cfg(cfg).moe, gen)
        total = int(gs.sum())
        active = int((gs > 0).sum())
        for proj, w in (("gate", w_gate), ("down", w_down)):
            kin, nout = w.shape[1], w.shape[2]
            x = randn(rows, kin)
            lib, note = _grouped_mm_yardstick(
                lambda x, w, gs: torch._grouped_mm(x, w, offs=_offs(gs)), (x, w, gs),
                gmm_plain(x, w, gs), rows_of=lambda y, n=total: y[:n])
            cases.append(dict(
                kernel="gmm", case=f"{phase} {proj} M={rows} K={kin} N={nout} rows={total}",
                args=(x, w, gs), fn=ops.gmm, plain=gmm_plain, library=lib, library_note=note,
                bytes=2 * (total * kin + active * kin * nout + rows * nout),
                flops=2.0 * total * kin * nout, peak=BF16_TENSOR_FLOPS, tol="rel"))
        cases.append(dict(
            kernel="swiglu", case=f"{phase} M={rows} N={f}", args=(randn(rows, f), randn(rows, f)),
            fn=ops.fused_swiglu, plain=lambda g, u: ref.swiglu_ref(g.float(), u.float()),
            library=lambda g, u: F.silu(g) * u,
            bytes=3 * 2 * rows * f, flops=5.0 * rows * f, peak=FP32_FLOPS, tol="1ulp"))
        wts = torch.softmax(torch.randn((T, K), generator=gen, device=DEV), -1).to(bf)
        cases.append(dict(
            kernel="combine", case=f"{phase} T={T} K={K} D={d}", args=(randn(T, K, d), wts),
            fn=ops.combine, plain=lambda r, w: ref.combine_ref(r.float(), w.float()),
            library=lambda r, w: torch.einsum("tkd,tk->td", r, w),
            bytes=2 * (T * K * d + T * K + T * d), flops=2.0 * T * K * d, peak=FP32_FLOPS,
            tol="rel"))

    cases += train_kernel_cases(cfg, gen, randn)

    nh, hd = cfg.num_heads, cfg.head_dim
    for S, nkv, window in ((512, nh, 0), (500, nh, 0), (1000, nh // 4, 256)):
        qp = torch.arange(S, device=DEV)[:, None]
        kp = torch.arange(S, device=DEV)[None, :]
        mask = qp >= kp
        if window:
            mask &= qp - kp < window
        lib = None
        if nkv == nh and window == 0:
            def lib(q, k, v):
                return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                      v.transpose(1, 2), is_causal=True)
        cases.append(dict(
            kernel="flash_attention",
            case=f"B=1 Sq={S} Skv={S} nh={nh} nkv={nkv} hd={hd} causal window={window}",
            args=(randn(1, S, nh, hd), randn(1, S, nkv, hd), randn(1, S, nkv, hd)),
            fn=lambda q, k, v, w=window: ops.flash_attention(q, k, v, causal=True, window=w),
            plain=lambda q, k, v, w=window: ref.flash_attention_ref(
                q.float(), k.float(), v.float(), causal=True, window=w),
            library=lib,
            bytes=2 * (2 * S * nh * hd + 2 * S * nkv * hd),
            flops=4.0 * int(mask.sum()) * nh * hd, peak=BF16_TENSOR_FLOPS, tol="rel"))
    return cases


TRAIN_TOKENS = 2 * 2048          # tokens per microbatch of the train phase


def train_kernel_cases(cfg, gen, randn) -> list[dict]:
    """The training step's kernel calls at its shapes: 4096 tokens per
    microbatch, the capacity pool of ``dispatch_pool_rows(4096)`` rows (the
    model's own capacity factor, so some pairs are dropped as in training),
    gmm forward and its transposed-rhs input gradient for both weight
    shapes, tgmm for both (and with empty groups), the combine and SwiGLU
    backward kernels."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    E, K, T = m.num_experts, m.experts_per_token, TRAIN_TOKENS
    w_gate = randn(E, d, f, scale=d ** -0.5)
    w_down = randn(E, f, d, scale=f ** -0.5)
    cases = []
    gs, rows = _routing_groups(T, m, gen)
    total, active = int(gs.sum()), int((gs > 0).sum())
    for proj, w in (("gate", w_gate), ("down", w_down)):
        kin, nout = w.shape[1], w.shape[2]
        x = randn(rows, kin)
        plain = ref.gmm_ref(x.float(), w.float(), gs)
        lib, note = _grouped_mm_yardstick(
            lambda x, w, gs: torch._grouped_mm(x, w, offs=_offs(gs)), (x, w, gs), plain,
            rows_of=lambda y, n=total: y[:n])
        cases.append(dict(
            kernel="gmm", case=f"train {proj} M={rows} K={kin} N={nout} rows={total}",
            args=(x, w, gs), fn=ops.gmm, plain=lambda x, w, gs: ref.gmm_ref(x.float(),
                                                                          w.float(), gs),
            library=lib, library_note=note,
            bytes=2 * (total * kin + active * kin * nout + rows * nout),
            flops=2.0 * total * kin * nout, peak=BF16_TENSOR_FLOPS, tol="rel"))
        # dx = dy @ w^T: dy has the projection's output width
        dy = randn(rows, nout)
        plain = ref.gmm_ref(dy.float(), w.float().transpose(1, 2), gs)
        lib, note = _grouped_mm_yardstick(
            lambda dy, w, gs: torch._grouped_mm(dy, w.transpose(1, 2), offs=_offs(gs)),
            (dy, w, gs), plain, rows_of=lambda y, n=total: y[:n],
            what="torch._grouped_mm(dy, w.transpose(1, 2))")
        cases.append(dict(
            kernel="gmm", case=f"train dx {proj} (transposed rhs) M={rows} K={nout} N={kin} "
                               f"rows={total}",
            args=(dy, w, gs), fn=lambda dy, w, gs: ops.gmm_transposed(dy, w, gs),
            plain=lambda dy, w, gs: ref.gmm_ref(dy.float(), w.float().transpose(1, 2), gs),
            library=lib, library_note=note,
            bytes=2 * (total * nout + active * kin * nout + rows * kin),
            flops=2.0 * total * kin * nout, peak=BF16_TENSOR_FLOPS, tol="rel"))
    # dW[g] = x_g^T dy_g for both projections, and with 8 of 64 experts empty
    groups = [("gate", gs, total, rows, d, f), ("down", gs, total, rows, f, d)]
    gs_e, rows_e = _routing_groups(T, m, gen, experts=E - 8)
    groups.append(("gate, 8 groups empty", gs_e, int(gs_e.sum()), rows_e, d, f))
    for proj, g_s, tot, M, kin, nout in groups:
        x, dy = randn(M, kin), randn(M, nout)
        plain = ref.tgmm_ref(x.float(), dy.float(), g_s, E)
        lib, note = _grouped_mm_yardstick(
            lambda x, dy, g_s: torch._grouped_mm(x.t(), dy, offs=_offs(g_s)), (x, dy, g_s),
            plain, what="torch._grouped_mm(x.t(), dy, offs) (2-D x 2-D)")
        cases.append(dict(
            kernel="tgmm", case=f"train {proj} M={M} K={kin} N={nout} rows={tot}",
            args=(x, dy, g_s), fn=ops.tgmm,
            plain=lambda x, dy, g_s: ref.tgmm_ref(x.float(), dy.float(), g_s, E),
            library=lib, library_note=note,
            bytes=2 * (tot * kin + tot * nout + E * kin * nout),
            flops=2.0 * tot * kin * nout, peak=BF16_TENSOR_FLOPS, tol="rel"))
    wts = torch.softmax(torch.randn((T, K), generator=gen, device=DEV), -1).to(torch.bfloat16)
    cases.append(dict(
        kernel="combine", case=f"train T={T} K={K} D={d}", args=(randn(T, K, d), wts),
        fn=ops.combine, plain=lambda r, w: ref.combine_ref(r.float(), w.float()),
        library=lambda r, w: torch.einsum("tkd,tk->td", r, w),
        bytes=2 * (T * K * d + T * K + T * d), flops=2.0 * T * K * d, peak=FP32_FLOPS,
        tol="rel"))
    cases.append(dict(
        kernel="combine_bwd", case=f"train T={T} K={K} D={d}",
        args=(randn(T, K, d), wts, randn(T, d)), fn=ops.combine_bwd,
        plain=lambda r, w, g: ref.combine_bwd_ref(r.float(), w.float(), g.float()),
        library=lambda r, w, g: (w[..., None] * g[:, None, :],
                                 torch.einsum("tkd,td->tk", r, g)),
        library_note="2 PyTorch calls: w[..., None] * dout[:, None, :] and "
                     "einsum('tkd,td->tk', rows, dout)",
        bytes=2 * (2 * T * K * d + T * K + T * d) + 4 * T * K, flops=3.0 * T * K * d,
        peak=FP32_FLOPS, tol="rel"))
    g, u, dh = randn(rows, f, scale=3.0), randn(rows, f), randn(rows, f)
    cases.append(dict(
        kernel="swiglu", case=f"train M={rows} N={f}", args=(g, u),
        fn=ops.fused_swiglu, plain=lambda g, u: ref.swiglu_ref(g.float(), u.float()),
        library=lambda g, u: F.silu(g) * u,
        bytes=3 * 2 * rows * f, flops=5.0 * rows * f, peak=FP32_FLOPS, tol="1ulp"))
    cases.append(dict(
        kernel="swiglu_bwd", case=f"train M={rows} N={f}", args=(g, u, dh),
        fn=ops.swiglu_bwd,
        plain=lambda g, u, d: ref.swiglu_bwd_ref(g.float(), u.float(), d.float()),
        library=lambda g, u, d: (torch.ops.aten.silu_backward(d * u, g), d * F.silu(g)),
        library_note="4 PyTorch calls: aten.silu_backward(dout * up, gate) and "
                     "dout * silu(gate)",
        bytes=5 * 2 * rows * f, flops=12.0 * rows * f, peak=FP32_FLOPS, tol="rel"))
    return cases


def _ulp_check(out, plain) -> tuple[float, float]:
    """Largest error, absolute and in units of the bf16 ulp of the plain value."""
    import torch
    _, expo = torch.frexp(plain)                     # plain = m * 2**expo, |m| in [.5, 1)
    ulp = torch.ldexp(torch.ones_like(plain), expo - 8)
    ulp = torch.where(plain == 0, torch.full_like(ulp, 2.0 ** -133), ulp)
    err = (out.float() - plain).abs()
    return float(err.max()), float((err / ulp).max())


def phase_kernels(cfg) -> list[dict]:
    """Each kernel against its plain version on the same inputs, then its
    device time (CUDA graph, inputs cold in L2), its eager time, the plain
    version's time and the library call's (CUDA graph, cold)."""
    import torch
    results = []
    for c in kernel_cases(cfg):
        args = c["args"]
        outs = c["fn"](*args)
        plains = c["plain"](*args)
        torch.cuda.synchronize()
        if torch.is_tensor(outs):
            outs, plains = (outs,), (plains,)
        errs, tols = [], []
        for out, plain in zip(outs, plains):
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"{c['kernel']} {c['case']}: non-finite output")
            if c["tol"] == "1ulp":
                err, ulps = _ulp_check(out, plain)
                ok = ulps <= 1.0
                tol_txt = f"<= 1 bf16 ulp of the plain value (got {ulps:.3f} ulp)"
            else:
                err = float((out.float() - plain).abs().max())
                tol = 1e-2 * float(plain.abs().max())
                ok, tol_txt = err <= tol, f"<= 1e-2 * max|plain| = {tol:.4g}"
            if not ok:
                raise AssertionError(f"{c['kernel']} {c['case']}: max|err| {err} not {tol_txt}")
            errs.append(err)
            tols.append(tol_txt)
        err, tol_txt = max(errs), "; ".join(tols)
        del outs, plains
        b_ms, b_by = bound_ms(c["bytes"], c["flops"], c["peak"])
        row = {"kernel": c["kernel"], "case": c["case"], "max_abs_err": err,
               "tolerance": tol_txt, "ms": graph_ms(c["fn"], args),
               "eager_ms": time_ms(c["fn"], args),
               "plain_ms": time_ms(c["plain"], args, iters=3, warmup=1),
               "library_ms": graph_ms(c["library"], args) if c["library"] else None,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": c["bytes"], "flops": c["flops"]}
        if c.get("library_note"):
            row["library_note"] = c["library_note"]
        emit("kernels", **row)
        results.append(row)
    return results


# ----------------------------------------------------------------------------
# small model: CUDA kernels against the CPU plain path
# ----------------------------------------------------------------------------

def phase_reference() -> dict:
    """Reduced Mula-7B-A1B (2 layers, d_model 256, 64 experts top-8) with
    forced uniform routing, so bf16 noise cannot flip an expert choice:
    prefill + 4 decode steps on the card (bf16, through the kernels) and on
    the CPU (float32, plain versions) from the same bf16 weights."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import decode_step, init_cache, init_params, prefill_with_cache
    from repro_torch.serve.engine import dropless_cfg

    cfg = reduced(get_config(MULA), d_model=256, max_experts=64)
    cfg = dropless_cfg(dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, forced_uniform_routing=True)))
    p_gpu = init_params(cfg, seed=0, device=DEV, dtype=torch.bfloat16)

    def to_cpu(t):
        return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.float().cpu()

    p_cpu = to_cpu(p_gpu)
    gen = torch.Generator().manual_seed(0)
    P, lengths, slots = 64, [50, 64], [1, 0]
    toks = torch.randint(0, cfg.vocab_size, (2, P), generator=gen)
    c_gpu = init_cache(cfg, 2, 128, device=DEV, dtype=torch.bfloat16)
    c_cpu = init_cache(cfg, 2, 128, device="cpu", dtype=torch.float32)
    lg, c_gpu = prefill_with_cache(p_gpu, toks.to(DEV), c_gpu, slots, lengths, cfg)
    lc, c_cpu = prefill_with_cache(p_cpu, toks, c_cpu, slots, lengths, cfg,
                                   compute_dtype=torch.float32)
    errs = [float((lg.float().cpu() - lc).abs().max() / lc.abs().max())]
    agree, total = 0, 0
    row_of = [slots.index(r) for r in range(2)]            # cache row -> prompt
    nxt = lg[row_of, : cfg.vocab_size].argmax(-1).cpu()
    pos = torch.tensor([lengths[b] for b in row_of])
    for _ in range(4):
        tok = nxt[:, None]
        lg, c_gpu = decode_step(p_gpu, tok.to(DEV), c_gpu, pos.to(DEV), cfg)
        lc, c_cpu = decode_step(p_cpu, tok.cpu(), c_cpu, pos, cfg, compute_dtype=torch.float32)
        errs.append(float((lg.float().cpu() - lc).abs().max() / lc.abs().max()))
        g_tok = lg[:, 0, : cfg.vocab_size].argmax(-1).cpu()
        agree += int((g_tok == lc[:, 0, : cfg.vocab_size].argmax(-1)).sum())
        total += g_tok.numel()
        nxt = g_tok
        pos = pos + 1
    worst = max(errs)
    tol = 3e-2
    kv_err = float((c_gpu["kv"]["k"].float().cpu() - c_cpu["kv"]["k"]).abs().max())
    row = {"config": cfg.name, "rel_logit_err": errs, "tolerance": tol,
           "greedy_agreement": f"{agree}/{total}", "cache_k_max_abs_err": kv_err}
    emit("reference", **row)
    if not worst <= tol:
        raise AssertionError(f"reference: logits differ by {worst} of max|ref| > {tol}")
    return row


# ----------------------------------------------------------------------------
# training: a small model on the card against the CPU, then full width
# ----------------------------------------------------------------------------

def _fixed_batch(vocab: int, batch: int, seq: int, device) -> dict:
    """One batch of next-token pairs from a seeded ``torch.Generator``."""
    import torch
    toks = torch.randint(0, vocab, (batch, seq + 1), generator=torch.Generator().manual_seed(0))
    return {"tokens": toks[:, :-1].to(device), "labels": toks[:, 1:].to(device)}


def phase_train_reference() -> dict:
    """Reduced Mula-7B-A1B (2 layers, d_model 256, 64 experts top-8,
    forced uniform routing so bf16 noise cannot flip an expert choice,
    dropless) takes one training step (2 microbatches of 2 x 128 tokens)
    from the same fp32 weights and AdamW state on the card (bf16 compute
    and gradient reduction, through the kernels) and on the CPU (float32,
    plain versions). Loss and gradient norm must agree; the worst per-leaf
    gradient difference (one loss_fn backward on each side) is reported."""
    import dataclasses

    import torch
    from repro_torch.configs import ParallelConfig, TrainConfig, get_config, reduced
    from repro_torch.models import loss_fn
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainState, init_state, make_train_step
    from repro_torch.tree import leaves_with_path, tree_map

    cfg = reduced(get_config(MULA), d_model=256, max_experts=64)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, forced_uniform_routing=True, dispatch="dropless"))
    par = ParallelConfig(microbatches=2)
    t_gpu = TrainConfig(seq_len=128, global_batch=4, warmup_steps=2, total_steps=100)
    t_cpu = dataclasses.replace(t_gpu, compute_dtype="float32", grad_reduce_dtype="float32")
    s_gpu = init_state(cfg, t_gpu, seed=0, device=DEV)
    p_cpu = tree_map(lambda p: p.detach().cpu().clone(), s_gpu.params)
    s_cpu = TrainState(p_cpu, adamw_init(p_cpu))
    b_gpu = _fixed_batch(cfg.vocab_size, 4, 128, DEV)
    b_cpu = {k: v.cpu() for k, v in b_gpu.items()}

    grads = {}
    for side, params, batch, dt in (("gpu", s_gpu.params, b_gpu, torch.bfloat16),
                                    ("cpu", p_cpu, b_cpu, torch.float32)):
        tree = tree_map(lambda p: p.detach().requires_grad_(), params)
        paths, flat = zip(*leaves_with_path(tree))
        loss, _ = loss_fn(tree, batch, cfg, compute_dtype=dt)
        grads[side] = dict(zip(paths, (g.float().cpu() for g in torch.autograd.grad(loss, flat))))
    leaf_err = {k: float((grads["gpu"][k] - g).abs().max() / g.abs().max().clamp_min(1e-30))
                for k, g in grads["cpu"].items()}
    worst = max(leaf_err, key=leaf_err.get)

    _, m_gpu = make_train_step(cfg, par, t_gpu)(s_gpu, b_gpu)
    _, m_cpu = make_train_step(cfg, par, t_cpu)(s_cpu, b_cpu)
    tol = {"loss": 1e-2, "grad_norm": 3e-2}
    rel = {k: abs(float(m_gpu[k]) - float(m_cpu[k])) / abs(float(m_cpu[k])) for k in tol}
    row = {"config": cfg.name, "microbatches": par.microbatches, "tokens": 4 * 128,
           "loss_gpu": float(m_gpu["loss"]), "loss_cpu": float(m_cpu["loss"]),
           "grad_norm_gpu": float(m_gpu["grad_norm"]), "grad_norm_cpu": float(m_cpu["grad_norm"]),
           "rel_err": rel, "tolerance": tol,
           "worst_leaf": worst, "worst_leaf_rel_grad_err": leaf_err[worst],
           "leaf_rel_grad_err": leaf_err}
    emit("train_reference", **row)
    bad = {k: v for k, v in rel.items() if not v <= tol[k]}
    if bad:
        raise AssertionError(f"train_reference: relative errors {bad} above {tol}")
    return row


TRAIN_STEPS = 6


def expected_train_launches(num_layers: int, microbatches: int, steps: int) -> dict:
    """Launches per training run under block remat. Per layer and
    microbatch: forward gmm x3, SwiGLU, combine; the backward recomputes
    that forward, then gmm x3 for dx (transposed rhs), tgmm x3 for dW, one
    swiglu_bwd and one combine_bwd. Attention is the plain blockwise path."""
    n = num_layers * microbatches * steps
    return {"gmm": 9 * n, "tgmm": 3 * n, "swiglu": 2 * n, "swiglu_bwd": n,
            "combine": 2 * n, "combine_bwd": n, "flash_attention": 0}


def phase_train() -> dict:
    import dataclasses

    import torch
    from repro_torch.configs import ParallelConfig, TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config(MULA), num_layers=4)
    train = TrainConfig(seq_len=2048, global_batch=4, warmup_steps=2, total_steps=100)
    par = ParallelConfig(microbatches=2, remat_policy="block")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, train, seed=0, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(state.params))
    # fp32 params share their storage with the master weights: count it once
    state_bytes = sum(t.numel() * t.element_size() for t in {
        t.data_ptr(): t for tree in (state.params, state.opt.master, state.opt.m, state.opt.v)
        for t in leaves(tree)}.values())
    batch = _fixed_batch(cfg.vocab_size, train.global_batch, train.seq_len, DEV)
    step = make_train_step(cfg, par, train)

    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")
    history = []
    ops.reset_launches()
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"step": i, **{k: float(m[k]) for k in keys}, "step_ms": ms}
        history.append(rec)
        emit("train_step", **rec)
    launches = dict(ops.launches)
    peak_mem = torch.cuda.max_memory_allocated()
    expect = expected_train_launches(cfg.num_layers, par.microbatches, TRAIN_STEPS)
    counts = m["moe_counts"].float()

    bad = [r for r in history if not all(math.isfinite(r[k]) for k in keys)]
    if bad:
        raise AssertionError(f"train: non-finite metrics {bad}")
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError(f"train: loss did not fall: {[r['loss'] for r in history]}")
    if not all(r["clip_scale"] <= 1.0 for r in history):
        raise AssertionError("train: clip_scale above 1")
    if launches != expect:
        raise AssertionError(f"train: kernel launches {launches} != expected {expect}")
    tokens = train.global_batch * train.seq_len
    if float(counts.sum()) != tokens * cfg.moe.experts_per_token:
        raise AssertionError(f"train: moe_counts sum {float(counts.sum())} != routed pairs")

    profile = _profile_window(lambda: step(state, batch))
    step_ms = statistics.median(r["step_ms"] for r in history[1:])
    row = {"model": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "state_bytes": state_bytes, "param_init_s": init_s,
           "global_batch": train.global_batch, "seq_len": train.seq_len,
           "microbatches": par.microbatches, "remat_policy": par.remat_policy,
           "steps": TRAIN_STEPS, "losses": [r["loss"] for r in history],
           "step_ms_median": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
           "max_memory_allocated_bytes": peak_mem, "launches": launches,
           "expected_launches": expect, "moe_load_max": float((counts / counts.sum()).max()),
           "profile_step": profile}
    emit("train", **row)
    return row


# ----------------------------------------------------------------------------
# full-width serving
# ----------------------------------------------------------------------------

def phase_serve() -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serve import SamplingParams, ServeEngine
    from repro_torch.tree import leaves

    cfg = get_config(MULA)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=DEV, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))

    prefill_ms: dict[int, list[float]] = {}
    decode_ms: list[float] = []
    engine = ServeEngine(
        params, cfg, num_slots=8, max_len=2048, cache_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16, device=DEV,
        on_prefill=lambda b, s: prefill_ms.setdefault(b, []).append(s * 1e3),
        on_decode=lambda s: decode_ms.append(s * 1e3))

    rng = np.random.default_rng(0)
    lengths = rng.integers(32, 1001, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist() for n in lengths]
    sps = [SamplingParams(seed=i) if i % 2 == 0 else
           SamplingParams(temperature=0.8, top_p=0.95, seed=i) for i in range(16)]

    # warm-up request (first cuBLAS / allocator use), not counted
    engine.submit(prompts[0][:40], 4, sps[0])
    engine.run()
    prefill_ms.clear()
    decode_ms.clear()
    p0, d0 = engine.prefills, engine.decode_steps

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rids = [engine.submit(p, 64, sp) for p, sp in zip(prompts, sps)]
    ops.reset_launches()
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    prefills, steps = engine.prefills - p0, engine.decode_steps - d0
    decode_med = statistics.median(decode_ms)
    prefill_med = {str(b): statistics.median(v) for b, v in sorted(prefill_ms.items())}
    prefill_n = {str(b): len(v) for b, v in sorted(prefill_ms.items())}
    peak_mem = torch.cuda.max_memory_allocated()

    for rid in rids:
        toks = results[rid].tokens
        if len(toks) != 64 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {rid}: {len(toks)} tokens, ids in range: "
                                 f"{all(0 <= t < cfg.vocab_size for t in toks)}")
    expect = {"gmm": 3 * cfg.num_layers * (prefills + steps),
              "swiglu": cfg.num_layers * (prefills + steps),
              "combine": cfg.num_layers * (prefills + steps),
              "flash_attention": cfg.num_layers * prefills,
              "tgmm": 0, "swiglu_bwd": 0, "combine_bwd": 0}
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != expected {expect}")

    # a greedy request served alone twice gives the same tokens
    alone = []
    for _ in range(2):
        rid = engine.submit(prompts[0], 64, sps[0])
        alone.append(engine.run()[rid].tokens)
    if alone[0] != alone[1]:
        raise AssertionError("a greedy request served alone twice gave different tokens")
    profiles = _profile_serving(engine, prompts)

    n_tok = sum(len(results[r].tokens) for r in rids)
    row = {"model": cfg.name, "params": n_params, "param_init_s": init_s,
           "requests": len(rids), "prompt_lengths": [int(n) for n in lengths],
           "new_tokens_each": 64, "prefills": prefills, "decode_steps": steps,
           "wall_s": wall, "tokens_per_s": n_tok / wall,
           "decode_step_ms_median": decode_med, "prefill_ms_median_by_bucket": prefill_med,
           "prefills_by_bucket": prefill_n, "max_memory_allocated_bytes": peak_mem,
           "launches": launches, "expected_launches": expect,
           "alone_twice_identical": True, **profiles}
    emit("serve", **row)
    return row


def _profile_window(run) -> dict:
    """torch.profiler over ``run()``: the host's wall time, the device's
    busy time (sum of its kernel and copy times; one stream, so they do not
    overlap), the idle share, and the ten device kernels that took longest."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    busy = sum(sum(v) for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if by_name else None,
            "device_idle_share": 1 - busy / wall_ms if by_name else None,
            "top_device_kernels": [{"name": n[:100], "ms": sum(v), "calls": len(v)}
                                   for n, v in top]}


def _profile_serving(engine, prompts) -> dict:
    """Where the serve time goes: one prefill in the 1024 bucket, and three
    decode steps of a full 8-slot batch (after the main run, not counted
    in its launches)."""
    from repro_torch.serve import SamplingParams
    engine.submit(prompts[0][:1000], 1, SamplingParams())
    prefill = _profile_window(engine.step)
    for i in range(8):
        engine.submit(prompts[i][:256], 8, SamplingParams(seed=i))
    engine.step()                                   # 8 prefills + first decode

    def three_steps():
        for _ in range(3):
            engine.step()

    decode = _profile_window(three_steps)
    engine.run()
    return {"profile_prefill_1024": prefill, "profile_decode_3_steps": decode}


# ----------------------------------------------------------------------------

SOURCES = {"gmm": "src/repro_torch/csrc/gmm.cu",
           "tgmm": "src/repro_torch/csrc/tgmm.cu",
           "swiglu": "src/repro_torch/csrc/swiglu.cu",
           "swiglu_bwd": "src/repro_torch/csrc/swiglu.cu",
           "combine": "src/repro_torch/csrc/combine.cu",
           "combine_bwd": "src/repro_torch/csrc/combine.cu",
           "flash_attention": "src/repro_torch/csrc/flash_attention.cu"}
REPLACES = {"gmm": "src/repro/kernels/gmm.py:40",
            "tgmm": "src/repro/kernels/gmm.py:98",
            "swiglu": "src/repro/kernels/swiglu.py:21",
            "swiglu_bwd": "src/repro/kernels/ops.py:253",
            "combine": "src/repro/kernels/combine.py:26",
            "combine_bwd": "src/repro/kernels/combine.py:58",
            "flash_attention": "src/repro/kernels/flash_attention.py:67"}
# the case whose numbers head the summary line: the training path's for the
# kernels it runs, the 512-token prefill for flash (serving only)
HEADLINE = {"gmm": "train gate", "tgmm": "train gate M", "swiglu": "train",
            "swiglu_bwd": "train", "combine": "train", "combine_bwd": "train",
            "flash_attention": "Sq=512 "}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    log = _build.library_path().parent / "build.log"
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device_name=torch.cuda.get_device_name(0), device_count=torch.cuda.device_count(),
         kernel_build_s=build_s, ptxas=[ln.strip() for ln in log.read_text().splitlines()
                                        if "registers" in ln or "spill" in ln]
         if log.exists() else "library was already built")

    kernel_rows = phase_kernels(get_config(MULA))
    phase_reference()
    phase_train_reference()
    serve = phase_serve()
    train = phase_train()

    summary = []
    for name in SOURCES:
        rows = [r for r in kernel_rows if r["kernel"] == name]
        head = next((r for r in rows if HEADLINE[name] in r["case"]), rows[0])
        by_path = {"serve": serve["launches"][name], "train": train["launches"][name]}
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": by_path["train"] or by_path["serve"],
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "case": head["case"],
            "cases": [{k: r[k] for k in ("case", "ms", "plain_ms", "library_ms", "bound_ms",
                                         "bound_by", "max_abs_err")} for r in rows]})
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
