#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: the quickest proof that the port builds, is right and serves.

    python3 chip_smoke.py                      # all phases, one card

Phases, each printing one JSON line:

  device     the card (nvidia-smi name and power limit) and the time to
             build the CUDA kernels from ``src/repro_torch/csrc``;
  kernels    each kernel against its plain PyTorch version on the card, at
             the serving path's shapes, with its time, the plain version's,
             one PyTorch library call's where there is one, and its bound;
  reference  a small MoE model served through the CUDA kernels agrees with
             the same model run on the CPU through the plain versions;
  serve      full-width, full-depth Mula-7B-A1B in bf16 (random weights
             from seed 0) serves 16 requests on 8 slots; asserts the
             results and that every kernel of the path was launched the
             expected number of times.

The last three lines are the card's name and power limit as nvidia-smi
prints them, one JSON object listing the kernels, and
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. It needs the repository's ``src/`` beside
it and a CUDA device; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
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

def _routing_groups(T: int, cfg, gen):
    """Group sizes of one MoE dispatch of T tokens with random top-k
    routing, sized as the serve path sizes its pool."""
    import torch
    from repro_torch.core import moe
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import dropless_cfg
    m = dropless_cfg(cfg).moe
    idx = torch.rand((T, m.num_experts), generator=gen, device=DEV).topk(
        m.experts_per_token, dim=-1).indices
    rows = moe.dispatch_pool_rows(T, m)
    plan = moe.make_dispatch_plan(idx, num_experts=m.num_experts, pool_rows=rows,
                                  align=ops.gmm_align())
    return plan.group_sizes, rows


def _grouped_mm_yardstick(x, w, gs, plain):
    """torch._grouped_mm on the same inputs, where the installed PyTorch has
    it: (callable of (x, w, gs) or None, note). It is checked against the
    plain version on the rows below the total (it leaves the rest undefined)."""
    import torch
    if not hasattr(torch, "_grouped_mm"):
        return None, "torch._grouped_mm not in this PyTorch"

    def call(x, w, gs):
        return torch._grouped_mm(x, w, offs=torch.cumsum(gs, 0, dtype=torch.int32))

    try:
        y = call(x, w, gs)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:
        return None, "torch._grouped_mm refused: " + str(e).splitlines()[0]
    total = int(gs.sum())
    err = float((y[:total].float() - plain[:total]).abs().max())
    return call, f"torch._grouped_mm, max|err| vs plain {err:.4g} on rows < total"


def kernel_cases(cfg) -> list[dict]:
    """The serving path's kernel calls: one dict per (kernel, shape) with
    its inputs (``args``), the wrapper, the plain version, the library
    yardstick (or None), the bytes and operations the call needs, the peak
    rate of those operations and the tolerance."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

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
        gs, rows = _routing_groups(T, cfg, gen)
        total = int(gs.sum())
        active = int((gs > 0).sum())
        for proj, w in (("gate", w_gate), ("down", w_down)):
            kin, nout = w.shape[1], w.shape[2]
            x = randn(rows, kin)
            lib, note = _grouped_mm_yardstick(x, w, gs, gmm_plain(x, w, gs))
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
        out = c["fn"](*args)
        plain = c["plain"](*args)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"{c['kernel']} {c['case']}: non-finite output")
        if c["tol"] == "1ulp":
            err, ulps = _ulp_check(out, plain)
            ok, tol_txt = ulps <= 1.0, f"<= 1 bf16 ulp of the plain value (got {ulps:.3f} ulp)"
        else:
            err = float((out.float() - plain).abs().max())
            tol = 1e-2 * float(plain.abs().max())
            ok, tol_txt = err <= tol, f"<= 1e-2 * max|plain| = {tol:.4g}"
        if not ok:
            raise AssertionError(f"{c['kernel']} {c['case']}: max|err| {err} not {tol_txt}")
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
# full-width serving
# ----------------------------------------------------------------------------

def phase_serve() -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serve import SamplingParams, ServeEngine

    cfg = get_config(MULA)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=DEV, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))

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
              "flash_attention": cfg.num_layers * prefills}
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


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ----------------------------------------------------------------------------

SOURCES = {"gmm": "src/repro_torch/csrc/gmm.cu",
           "swiglu": "src/repro_torch/csrc/swiglu.cu",
           "combine": "src/repro_torch/csrc/combine.cu",
           "flash_attention": "src/repro_torch/csrc/flash_attention.cu"}
REPLACES = {"gmm": "src/repro/kernels/gmm.py:40",
            "swiglu": "src/repro/kernels/swiglu.py:21",
            "combine": "src/repro/kernels/combine.py:26",
            "flash_attention": "src/repro/kernels/flash_attention.py:67"}
# the case whose numbers head the summary line: the one the path runs most
HEADLINE = {"gmm": "decode gate", "swiglu": "decode", "combine": "decode",
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
    serve = phase_serve()

    summary = []
    for name in SOURCES:
        rows = [r for r in kernel_rows if r["kernel"] == name]
        head = next((r for r in rows if HEADLINE[name] in r["case"]), rows[0])
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": serve["launches"][name],
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
