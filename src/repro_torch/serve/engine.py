"""Continuous-batching serve engine. Port of the JAX package's
``serve/engine.py``.

One ``ServeEngine`` owns a model's params, a ``SlotKVPool`` and a
``FIFOScheduler``, and advances the request population one token per
``step()``:

  admit    scheduler pass (FIFO + prefill priority, token-budgeted) claims a
           free cache slot per admitted request;
  prefill  the prompt (right-padded to a power-of-two bucket) runs through
           ``models.prefill_with_cache``; K/V land in the claimed slot and
           the first generated token is sampled from the last-position
           logits;
  decode   one ``decode_step`` over the full slot batch with a (B,)
           per-slot position vector;
  evict    EOS / max-token rows free their slot for the next admission.

Request bookkeeping (positions, generated tokens, free slots) is host-side
Python; the cache and the per-step token batch live on the device. A
decode step reads back one (B,) token vector; each prefill reads back its
first token.

On a plan (``plan=``, a ``parallel.plan.ResolvedPlan`` with 'ep' and 'tp'
axes, and ``grid=``, this rank's ``parallel.ProcessGrid``; the JAX
engine's ``plan=``) every rank runs an engine over the same requests with
its tiles of the params (``convert.params_for_rank``): attention on its
heads with a cache of its kv heads, the MoE on its experts' d_ff shards
(``core.moe.moe_fsmoe_ep(replicated=True)``, dispatched as on one device),
the whole logits and the same sampling on every rank. Each step checks
that every rank drew the same tokens.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import decode_step, prefill_with_cache
from repro_torch.parallel.ep import all_gather_dim

from .kv_pool import SlotKVPool
from .sampling import SamplingParams, position_generators, sample_tokens
from .scheduler import FIFOScheduler, Request


def dropless_cfg(cfg: ModelConfig) -> ModelConfig:
    """Serving must be batching-transparent: with a capacity-limited MoE
    (cf < E/K) whether a token's expert contribution is dropped depends on
    the other rows of the batch. Raise the capacity factor to the dropless
    bound; a ``dispatch='dropless'`` config is already transparent."""
    if not cfg.is_moe:
        return cfg
    m = cfg.moe
    if m.dispatch == "dropless":
        return cfg
    need = m.num_experts / max(m.experts_per_token, 1)
    if m.capacity_factor >= need:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(m, capacity_factor=float(need)))


def serving_grid(cfg: ModelConfig, plan=None, grid=None):
    """The grid a serving call runs on (None: one device), checked: ``plan``
    a ``ResolvedPlan`` that serving runs (``resolve(serving=True)``: 'ep'
    and 'tp' axes, an attention-KV arch), ``grid`` this rank's
    ``ProcessGrid`` of the plan's sizes (needed when the plan spans more
    than one rank)."""
    if plan is None:
        if grid is not None:
            raise ValueError("serving on a grid needs its plan (plan=)")
        return None
    plan.plan.resolve(cfg, serving=True)
    if plan.world == 1 and grid is None:
        return None
    want = {"data": plan.plan.dp, "pp": plan.plan.pp, "ep": plan.plan.ep, "tp": plan.plan.tp}
    if grid is None or grid.sizes != want:
        raise ValueError(f"plan '{plan.spec()}' serves on a grid of {want}, got "
                         f"{None if grid is None else grid.sizes}")
    return grid


def make_decode_fn(cfg: ModelConfig, *, compute_dtype=torch.float32, grid=None):
    """The engine's decode function: one token for every slot, sampled with
    per-slot params. tokens (B, 1) on the device; positions, seeds and the
    sampling params are (B,) host sequences. Returns (next (B,), cache).
    ``grid``: the serving grid (``serving_grid``), as in
    ``models.decode_step``."""
    cfg = dropless_cfg(cfg)
    vocab = cfg.vocab_size

    def decode_fn(params, tokens, cache, positions, seeds, temperature, top_k, top_p):
        pos = torch.tensor(positions, dtype=torch.long, device=tokens.device)
        logits, cache = decode_step(params, tokens, cache, pos, cfg,
                                    compute_dtype=compute_dtype, grid=grid)
        gens = position_generators(seeds, positions, tokens.device, temperature)
        nxt = sample_tokens(logits[:, 0, :vocab], gens, temperature, top_k, top_p)
        return nxt, cache

    return decode_fn


def make_prefill_fn(cfg: ModelConfig, *, compute_dtype=torch.float32, grid=None):
    """The engine's prefill function: write prompt K/V into cache rows and
    sample the first token from the last-position logits (keyed on position
    length - 1, so a single-request replay matches). ``grid``: as in
    ``make_decode_fn``."""
    cfg = dropless_cfg(cfg)
    vocab = cfg.vocab_size

    def prefill_fn(params, tokens, cache, slots, lengths, seeds, temperature, top_k, top_p):
        last, cache = prefill_with_cache(params, tokens, cache, slots, lengths, cfg,
                                         compute_dtype=compute_dtype, grid=grid)
        gens = position_generators(seeds, [n - 1 for n in lengths], tokens.device,
                                   temperature)
        first = sample_tokens(last[:, :vocab], gens, temperature, top_k, top_p)
        return first, cache

    return prefill_fn


@dataclass
class GenResult:
    rid: int
    prompt_len: int
    tokens: list[int]
    finish_reason: str                   # 'eos' | 'length'
    arrival_time: float = 0.0
    token_times: list[float] = field(default_factory=list)


@dataclass
class _SlotState:
    req: Request
    slot: int
    pos: int                             # position the next token is fed at
    tokens: list[int] = field(default_factory=list)
    token_times: list[float] = field(default_factory=list)


def _bucket(n: int, floor: int) -> int:
    """Next power of two >= max(n, floor): prompts of nearby lengths share
    one prefill shape."""
    b = floor
    while b < n:
        b *= 2
    return b


class ServeEngine:
    """See module docstring. ``num_slots`` bounds concurrent requests;
    ``max_len`` sizes full caches (ring configs are O(window)).
    ``eos_id=None`` disables EOS termination. ``device``: the params'
    device, ``cuda`` by default (pass ``"cpu"`` for the plain path).
    ``on_prefill(bucket, seconds)`` / ``on_decode(seconds)``, when given,
    receive the host time of each prefill / decode call (measured after a
    read-back of its tokens, so it covers the device work). ``plan`` and
    ``grid``: serving on a plan (module docstring, ``serving_grid``); the
    device is then the grid's unless ``device`` says otherwise."""

    def __init__(self, params, cfg: ModelConfig, *, num_slots: int = 8,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 scheduler: Optional[FIFOScheduler] = None,
                 cache_dtype=torch.float32, compute_dtype=torch.float32,
                 prefill_bucket: int = 8, device: DeviceLike = None,
                 on_prefill=None, on_decode=None, plan=None, grid=None):
        if cfg.arch_type not in ("dense", "moe"):
            raise NotImplementedError(
                f"ServeEngine drives attention-KV archs (dense, moe); got {cfg.arch_type!r}")
        self.grid = serving_grid(cfg, plan, grid)
        self.plan = plan
        if device is None and self.grid is not None:
            device = self.grid.world.device
        self.device = resolve_device(device)
        emb = params["embed"]["table"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.eos_id = eos_id
        tp = self.grid.tp.world if self.grid is not None else 1
        self.pool = SlotKVPool(cfg, num_slots, max_len, cache_dtype, device=self.device, tp=tp)
        self.scheduler = scheduler or FIFOScheduler()
        self.prefill_bucket = prefill_bucket
        self._decode = make_decode_fn(cfg, compute_dtype=compute_dtype, grid=self.grid)
        self._prefill = make_prefill_fn(cfg, compute_dtype=compute_dtype, grid=self.grid)
        self._on_prefill = on_prefill
        self._on_decode = on_decode
        self._slots: dict[int, _SlotState] = {}
        self._results: dict[int, GenResult] = {}
        self._next_rid = 0
        self.steps = 0
        self.prefills = 0
        self.decode_steps = 0
        self.tokens_generated = 0

    # ---- request intake -----------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               sampling: Optional[SamplingParams] = None,
               arrival_time: float = 0.0) -> int:
        sampling = sampling if sampling is not None else SamplingParams()
        if len(prompt) == 0:
            raise ValueError("empty prompt: the first token is sampled from "
                             "the last prompt position, so one is required")
        if self.cfg.sliding_window <= 0 and len(prompt) + max_new_tokens > self.pool.max_len:
            raise ValueError(
                f"prompt+generation ({len(prompt)}+{max_new_tokens}) "
                f"exceeds cache max_len {self.pool.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        self.scheduler.submit(Request(rid, list(prompt), max_new_tokens, sampling,
                                      arrival_time))
        return rid

    # ---- one engine step ----------------------------------------------------
    def step(self, now: Optional[float] = None) -> list[GenResult]:
        """Admit + prefill newcomers, then decode one token for every
        in-flight request. Returns the requests that finished this step."""
        finished: list[GenResult] = []

        # admissions prefill one request per call (B' = 1)
        for req in self.scheduler.pop_admissible(self.pool.num_free, now):
            slot = self.pool.alloc()
            n = req.prompt_len
            P = _bucket(n, self.prefill_bucket)
            toks = torch.zeros((1, P), dtype=torch.long)
            toks[0, :n] = torch.as_tensor(req.prompt, dtype=torch.long)
            sp = req.sampling
            t0 = time.perf_counter()
            first, self.pool.cache = self._prefill(
                self.params, toks.to(self.device), self.pool.cache, [slot], [n],
                [sp.seed], [sp.temperature], [sp.top_k], [sp.top_p])
            first = int(self._agreed(first)[0])        # read-back
            if self._on_prefill is not None:
                self._on_prefill(P, time.perf_counter() - t0)
            self.prefills += 1
            st = _SlotState(req=req, slot=slot, pos=n)
            self._slots[slot] = st
            self._emit(st, first, finished)

        if self._slots:
            B = self.pool.num_slots
            tokens = torch.zeros((B, 1), dtype=torch.long)
            positions, seeds = [0] * B, [0] * B
            temperature, top_k, top_p = [0.0] * B, [0] * B, [1.0] * B
            for slot, st in self._slots.items():
                sp = st.req.sampling
                tokens[slot, 0] = st.tokens[-1]
                positions[slot] = st.pos
                seeds[slot] = sp.seed
                temperature[slot] = sp.temperature
                top_k[slot] = sp.top_k
                top_p[slot] = sp.top_p
            t0 = time.perf_counter()
            nxt, self.pool.cache = self._decode(
                self.params, tokens.to(self.device), self.pool.cache, positions, seeds,
                temperature, top_k, top_p)
            nxt = self._agreed(nxt).tolist()           # the one read-back per step
            if self._on_decode is not None:
                self._on_decode(time.perf_counter() - t0)
            self.decode_steps += 1
            for slot, st in list(self._slots.items()):
                st.pos += 1
                self._emit(st, int(nxt[slot]), finished)

        self.steps += 1
        return finished

    def _agreed(self, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens``, checked equal on every rank of the grid."""
        if self.grid is not None and self.grid.world.world > 1:
            seen = all_gather_dim(tokens[None], self.grid.world)
            if not bool((seen == tokens).all()):
                raise RuntimeError(f"the ranks sampled different tokens: {seen.tolist()}")
        return tokens

    def _emit(self, st: _SlotState, token: int, finished: list[GenResult]) -> None:
        """Append one generated token; finish/evict on EOS or length."""
        if self.eos_id is not None and token == self.eos_id:
            self._finish(st, "eos", finished)
            return
        st.tokens.append(token)
        st.token_times.append(time.perf_counter())
        self.tokens_generated += 1
        if len(st.tokens) >= st.req.max_new_tokens:
            self._finish(st, "length", finished)

    def _finish(self, st: _SlotState, reason: str, finished: list[GenResult]) -> None:
        res = GenResult(st.req.rid, st.req.prompt_len, st.tokens, reason,
                        arrival_time=st.req.arrival_time, token_times=st.token_times)
        self._results[st.req.rid] = res
        finished.append(res)
        del self._slots[st.slot]
        self.pool.free(st.slot)

    # ---- drive to completion -------------------------------------------------
    @property
    def active(self) -> int:
        return len(self._slots)

    @property
    def results(self) -> dict[int, GenResult]:
        """Finished requests so far, keyed by rid."""
        return self._results

    def run(self) -> dict[int, GenResult]:
        """Step until the queue and all slots drain."""
        while len(self.scheduler) or self._slots:
            self.step()
        return self._results
