"""End-to-end training launcher, on one device or on a dp x pp x ep x tp grid of
ranks: port of the JAX package's ``launch/train.py``.

Wires together the data pipeline (tokenize/shuffle/shard + mmap loader),
the model, AdamW (with SO/EPSO state sharding on a grid), block remat, dual
+ model-only checkpointing, and the paper §4 failure-handling loop (NaN
monitor + buffer-node ClusterManager) as the main loop. It writes what the
JAX launcher writes (``data/``, ``ckpt/``, ``history.json``,
``summary.json``), in the same formats: a run of either package resumes
from the other's checkpoints, whatever plan wrote them (the files hold
whole arrays).

A ``--parallel`` plan (``parallel.ParallelPlan``; or the legacy ``--mesh``)
of more than one rank runs on the port's ('data', 'pp', 'ep', 'tp') grid:
the launching process prepares the data, then starts one process a rank
(``parallel.spawn``, gloo; on the card the ranks share it), each running
``_rank_main`` on its rows of every batch (the pp and tp ranks of one
(data, ep) coordinate on the same rows, each with its pipeline stage of
the layers and its shards of attention, the MLPs and the expert stacks);
rank 0 writes the outputs. A pp axis pipelines each step over
``--microbatches`` (by default 2 * pp where that divides a rank's rows,
else pp, as the JAX launcher picks) in the ``--pp-schedule`` order;
``--pp-impl`` 'shardmap' and 'masked' both run the port's one per-stage
executor (``parallel.pipeline``), 'shardmap' with pp dividing the
microbatches.

Usage (on the card; ``--device cpu`` runs the plain PyTorch path):
  PYTHONPATH=src python -m repro_torch.launch.train --arch mula-7b-a1b \
      --scale smoke --steps 100 --batch 8 --seq 128 --out runs/mula7b \
      --compute-dtype bfloat16
  PYTHONPATH=src python -m repro_torch.launch.train --arch mula-1b \
      --scale full --steps 6 --batch 4 --seq 2048 --ckpt-interval 3 \
      --compute-dtype bfloat16 --out runs/mula1b
  PYTHONPATH=src python -m repro_torch.launch.train --arch mula-7b-a1b \
      --parallel dp=2,ep=2 --opt-shard epso --steps 20 --batch 4 --seq 32 \
      --d-model 64 --device cpu --out runs/grid       # 4 CPU ranks
  PYTHONPATH=src python -m repro_torch.launch.train --arch mula-7b-a1b \
      --parallel dp=1,ep=2,tp=2 --opt-shard epso --steps 12 --batch 4 \
      --seq 32 --d-model 64 --device cpu --out runs/tp  # expert-TP, 4 ranks
  PYTHONPATH=src python -m repro_torch.launch.train --arch mula-7b-a1b \
      --parallel dp=2,ep=2,rebalance=4:1.1 --opt-shard epso --steps 12 \
      --batch 4 --seq 32 --d-model 64 --device cpu --out runs/reb
  PYTHONPATH=src python -m repro_torch.launch.train --arch mula-7b-a1b \
      --parallel pp=2,ep=2 --opt-shard epso --pp-schedule 1f1b --steps 12 \
      --batch 4 --seq 32 --d-model 64 --device cpu --out runs/pp   # 2 stages

Expert rebalancing (``parallel.placement``): a plan's ``rebalance=N:thr``
token (or ``--rebalance N:thr``, which overrides it and needs
``--parallel``) sums each step's global ``moe_counts`` over N-step windows
and, at a window's end, re-places the experts when the max/mean EP rank
load exceeds ``thr`` and the greedy placement lowers it;
``--rebalance-force-at STEP`` forces a proposal after that step. A move
takes the expert stacks and their optimizer states across the 'ep' ranks
(``apply_placement``), rebuilds the step in the new placement and writes
it into the next checkpoints' MANIFEST; a resumed run, or a relaunch,
takes the placement of the checkpoint it restored. With ``fsdp`` in the
plan the same move takes the expert stacks' 'data' tiles
(``--parallel dp=2,ep=2,fsdp,rebalance=2:1.0``); fsdp also trains the
ssm and hybrid archs (``--parallel dp=2,fsdp``). Every rank runs the
same controller on the same global counts, so every rank takes the same
decision.

``compute_dtype`` is ``TrainConfig.compute_dtype``; its default here is the
float32 the JAX launcher fixes. The MoE kernels on the card take bf16, so
an MoE model on the card runs with ``bfloat16``.

Not ported, and raising ``NotImplementedError`` with the ``ROADMAP.md``
item that ports them: plans with a pod axis (§1 item 5.12), ``fsdp``
under a remat policy without 'block' or 'block_sc' (§1 item 5.1e), tp for
the ssm and hybrid archs (§1 item 5.10), ``kernel_tiles`` and ``tiles=``
(§1 item 7), and the vlm and audio archs (§1 item 6). The embedding and
head tables follow the plan as in JAX: split on their vocab rows over
'tp', or over 'ep' without 'tp' (``parallel.sharding``); no flag asks for
it. A pp axis refuses the hybrid arch and
rebalancing, as the JAX step and plan do. The ssm (Mamba-1) and hybrid (Zamba2) archs train on
tokens-only batches, as the JAX launcher feeds them; a plan with ``ep=``
refuses them, as the JAX plan does (they have no experts).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ParallelConfig, TrainConfig, get_config, reduced
from repro_torch.data import ByteTokenizer, ShardedDataLoader, preprocess_corpus
from repro_torch.device import resolve_device
from repro_torch.ft import (ClusterManager, NaNMonitor, NodeFailure, restore_into,
                            run_with_failure_handling)
from repro_torch.models.model import ARCHS, init_params, padded_vocab
from repro_torch.optim.overlap import resolve_opt_overlap
from repro_torch.parallel import ParallelPlan, ResolvedPlan, spawn
from repro_torch.parallel.pipeline import check_pp_microbatches
from repro_torch.parallel.placement import ExpertPlacement, RebalanceController, apply_placement
from repro_torch.parallel.plan import refuse
from repro_torch.train import init_state, make_train_step, state_layout
from repro_torch.tree import keyed_leaves, leaves


class RunResult(list):
    """History list (one dict per executed step, in step order) plus
    fault-tolerance bookkeeping from the launcher loop."""
    relaunches: int = 0
    replaced: list = ()


def synthetic_corpus(n_files: int = 4, docs_per_file: int = 64,
                     seed: int = 0):
    """Procedural text corpus: Zipf-ish word soup with structure, so the
    loss curve has signal (byte-level models learn digraph statistics)."""
    rng = np.random.default_rng(seed)
    words = ["the", "model", "expert", "router", "token", "aurora", "tile",
             "pipeline", "gradient", "optimizer", "state", "shard", "mixture",
             "attention", "scan", "chunk", "loss", "batch", "step", "node"]
    probs = 1.0 / np.arange(1, len(words) + 1)
    probs /= probs.sum()
    files = []
    for _ in range(n_files):
        docs = []
        for _ in range(docs_per_file):
            n = int(rng.integers(30, 120))
            docs.append(" ".join(rng.choice(words, size=n, p=probs)) + ".")
        files.append(docs)
    return files


def prepare_data(out_dir: str, *, context: int, seed: int = 0,
                 n_files: int = 4, docs_per_file: int = 256):
    data_dir = os.path.join(out_dir, "data")
    if not os.path.exists(os.path.join(data_dir, "meta.json")):
        preprocess_corpus(synthetic_corpus(n_files, docs_per_file, seed),
                          data_dir, context=context, seed=seed)
    return data_dir


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v else None


def _check_supported(cfg, *, kernel_tiles) -> None:
    if kernel_tiles is not None:
        refuse("kernel tile selection (--kernel-tiles)", "item 7, autotuning")
    if cfg.arch_type not in ARCHS:
        refuse(f"arch_type {cfg.arch_type!r}", "item 6, the rest of the zoo")


def _batch_mover(batch: int, seq: int, dev: torch.device):
    """numpy batch -> int64 tensors on ``dev``. On the card through pinned
    host buffers, copied with ``non_blocking``. Reusing the buffers is safe:
    the next batch is written only after the step's metrics reached the
    host, which orders after this copy on the stream."""
    if dev.type != "cuda":
        return lambda b: {k: torch.from_numpy(a).long() for k, a in b.items()}
    pinned = {k: torch.empty((batch, seq), dtype=torch.int64, pin_memory=True)
              for k in ("tokens", "labels")}

    def move(b: dict) -> dict:
        out = {}
        for k, a in b.items():
            pinned[k].copy_(torch.from_numpy(a))
            out[k] = pinned[k].to(dev, non_blocking=True)
        return out

    return move


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Everything a rank of a run needs, resolved once by ``prepare_run`` in
    the launching process (and pickled to the ranks)."""
    cfg: object                 # ModelConfig
    train: TrainConfig
    par: ParallelConfig
    plan: Optional[ResolvedPlan]
    mesh: Optional[str]         # the legacy --mesh spec, as given
    opt_overlap: str            # resolved: 'off' | 'ring' | 'xla'
    out: str
    ckpt_interval: int
    log_every: int
    n_buffer: int
    max_relaunches: int
    inject_hard_at: Optional[int]
    inject_soft_at: Optional[int]
    device: torch.device
    rebalance_force_at: Optional[int] = None

    @property
    def world(self) -> int:
        return self.plan.world if self.plan is not None else 1

    @property
    def batch_ranks(self) -> int:
        """The ranks that split each batch's rows (dp x ep)."""
        return self.plan.batch_ranks if self.plan is not None else 1


def prepare_run(arch: str, *, scale: str = "smoke", steps: int = 100, batch: int = 8,
                seq: int = 128, out: str = "runs/default", lr: float = 1e-3,
                moe_impl: str = None, fur: bool = False, ckpt_interval: int = 50,
                microbatches: int = 1, sac: str = "block", seed: int = 0,
                log_every: int = 10, d_model: int = 256, layers: int = 2,
                d_ff: int = 0, moe_dff: int = 0, mesh: str = None,
                parallel: str = None,
                opt_shard: str = None, opt_overlap: str = None,
                pp_schedule: str = None,
                pp_impl: str = None, moe_dispatch: str = None,
                kernel_tiles: str = None,
                rebalance: str = None, rebalance_force_at: int = None,
                n_buffer: int = 2,
                inject_hard_at: int = None, inject_soft_at: int = None,
                max_relaunches: int = 8, device=None,
                compute_dtype: str = "float32") -> RunSpec:
    """The JAX launcher's ``run`` keywords, checked and resolved before any
    work: the model config, the ParallelPlan (``parallel``, or the legacy
    ``mesh``; ``opt_shard``, ``opt_overlap`` and ``moe_dispatch`` override
    the spec), the train and parallel configs and the overlap the step will
    run. Two more keywords: ``device`` (``cuda`` unless given) and
    ``compute_dtype``. Raises ``ValueError`` on inconsistent arguments and
    ``NotImplementedError`` naming its ``ROADMAP.md`` item for what the
    port does not run."""
    # opt_shard: None = not passed (the --parallel spec's opt= applies); an
    # explicit value, the default 'none' included, overrides the spec
    if opt_shard not in (None, "none") and not (mesh or parallel):
        raise ValueError(f"--opt-shard {opt_shard} needs --parallel (or the "
                         f"legacy --mesh): optimizer-state sharding is a "
                         f"placement over mesh axes")
    if mesh and parallel:
        raise ValueError("--mesh and --parallel are mutually exclusive "
                         "(--mesh is the legacy spelling of --parallel)")
    cfg = get_config(arch)
    if scale == "smoke":
        cfg = reduced(cfg, layers=layers, d_model=d_model,
                      vocab=ByteTokenizer.VOCAB)
    else:
        cfg = dataclasses.replace(cfg, vocab_size=ByteTokenizer.VOCAB)
    if d_ff:
        cfg = dataclasses.replace(cfg, d_ff=d_ff)
    if cfg.moe is not None and (moe_impl or fur or moe_dff):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, moe_impl=moe_impl or cfg.moe.moe_impl,
            forced_uniform_routing=fur,
            d_ff_expert=moe_dff or cfg.moe.d_ff_expert))
    # ---- the ParallelPlan: --parallel spec, or the legacy --mesh shim ----
    if parallel:
        pplan = ParallelPlan.parse(parallel)
        if opt_shard is not None:               # CLI flag overrides the spec
            pplan = dataclasses.replace(pplan, opt_shard=opt_shard)
        if pp_schedule is not None:
            pplan = dataclasses.replace(pplan, pp_schedule=pp_schedule)
    elif mesh:
        pplan = ParallelPlan.from_legacy(mesh, cfg=cfg, opt_shard=opt_shard or "none",
                                         pp_schedule=pp_schedule or "1f1b")
    else:
        pplan = None
    _check_supported(cfg, kernel_tiles=kernel_tiles)
    if pplan is not None and pp_impl is not None:
        pplan = dataclasses.replace(pplan, pp_impl=pp_impl)
    if rebalance is not None:               # the flag overrides the spec's token
        if pplan is None:
            raise ValueError("--rebalance needs --parallel (or --mesh): rebalancing "
                             "re-places experts over the EP axis")
        pplan = dataclasses.replace(pplan, rebalance=rebalance)
    if pplan is not None:
        if opt_overlap is not None:
            pplan = dataclasses.replace(pplan, opt_overlap=opt_overlap)
        if moe_dispatch is not None:
            pplan = dataclasses.replace(pplan, moe_dispatch=moe_dispatch)
        cfg = pplan.apply_to_model(cfg)
        opt_shard = pplan.opt_shard
        if microbatches == 1 and pplan.microbatches > 1:
            microbatches = pplan.microbatches   # spec-supplied mb=
        if pplan.pp > 1 and microbatches == 1:
            # the JAX launcher's default, on a rank's rows: 2 * pp if that
            # divides them, else pp (an explicit count is kept as it is)
            rows = batch // (pplan.dp * pplan.ep)
            for cand in (2 * pplan.pp, pplan.pp):
                if rows % cand == 0:
                    microbatches = cand
                    print(f"pp={pplan.pp}: pipeline microbatches defaulted to {microbatches}")
                    break
        pplan = dataclasses.replace(pplan, microbatches=microbatches)
    else:
        if moe_dispatch is not None and cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, dispatch=moe_dispatch))
        opt_shard = opt_shard or "none"
    plan = pplan.resolve(cfg, global_batch=batch) if pplan is not None else None
    world = plan.batch_ranks if plan is not None else 1
    if (batch // world) % microbatches:
        raise ValueError(f"a rank's {batch // world} of the batch's {batch} rows do not split "
                         f"into {microbatches} microbatches")
    dev = resolve_device(device)

    train = TrainConfig(param_dtype="float32", compute_dtype=compute_dtype,
                        grad_reduce_dtype="float32", lr_peak=lr,
                        lr_min=lr / 10, warmup_steps=max(steps // 20, 5),
                        total_steps=steps, seq_len=seq, global_batch=batch,
                        seed=seed)
    if plan is not None:
        par = plan.parallel_config(remat_policy=sac)
        if par.pp_stages > 1 and par.pp_impl == "shardmap":
            check_pp_microbatches(par.microbatches, par.pp_stages)
    else:
        par = ParallelConfig(microbatches=microbatches, remat_policy=sac,
                             optimizer_sharding=opt_shard, opt_overlap=opt_overlap,
                             moe_dispatch=moe_dispatch)
    # resolved up front so the header and summary record what the step runs
    ov_impl = resolve_opt_overlap(par.opt_overlap, opt_shard,
                                  plan.axis_sizes if plan is not None else None)

    inject_hard_at = inject_hard_at if inject_hard_at is not None \
        else _env_int("REPRO_INJECT_HARD_AT")
    inject_soft_at = inject_soft_at if inject_soft_at is not None \
        else _env_int("REPRO_INJECT_SOFT_AT")
    # failure-injection demos checkpoint often enough that the injected
    # failure has something newer than step 0 to restore; explicit intervals
    # on ordinary runs are honored as-is
    if (inject_hard_at is not None or inject_soft_at is not None) \
            and ckpt_interval >= steps:
        ckpt_interval = max(1, steps // 4)
        print(f"injection requested: ckpt interval clamped to {ckpt_interval}")
    return RunSpec(cfg=cfg, train=train, par=par, plan=plan, mesh=mesh, opt_overlap=ov_impl,
                   out=out, ckpt_interval=ckpt_interval, log_every=log_every,
                   n_buffer=n_buffer, max_relaunches=max_relaunches,
                   inject_hard_at=inject_hard_at, inject_soft_at=inject_soft_at, device=dev,
                   rebalance_force_at=rebalance_force_at)


def run(arch: str, **kw) -> RunResult:
    """Train ``arch`` for ``steps`` steps, resuming from ``out/ckpt`` when it
    holds a valid checkpoint: the JAX launcher's ``run`` (keywords:
    ``prepare_run``). A plan of more than one rank trains on its dp x ep
    grid, one process a rank; the result is rank 0's."""
    return launch_ranks(prepare_run(arch, **kw))[0]


def launch_ranks(spec: RunSpec, rank_fn=None) -> list:
    """Prepare the data once, then run ``rank_fn(grid, spec)`` (default
    ``_rank_main``) on every rank of the plan: in this process for one rank
    (``grid`` None), else one process a rank over gloo
    (``parallel.spawn(..., grid=(dp, ep[, tp]))``, no deadline: a collective that
    hangs raises after the group's timeout). The ranks' results, in rank
    order."""
    rank_fn = rank_fn or _rank_main
    os.makedirs(spec.out, exist_ok=True)
    prepare_data(spec.out, context=spec.train.seq_len, seed=spec.train.seed)
    if spec.world == 1:
        return [rank_fn(None, spec)]
    return spawn(rank_fn, spec.world, args=(spec,), backend="gloo", device=spec.device,
                 timeout_s=None, grid=spec.plan.grid)


def _rank_main(grid, spec: RunSpec) -> RunResult:
    """One rank of a run (the whole run without a ``grid``): the state's
    shards on this rank, its rows of every global batch (the rank at (d, e)
    of w = dp x ep takes rows [r B / w, (r + 1) B / w) with r = d * ep + e,
    whatever its tp coordinate), the failure-handling loop with grid
    checkpoints. Every rank takes the same steps, failures and restores;
    rank 0 prints and writes ``history.json`` and ``summary.json``.

    The state restored on a relaunch is written into the live tensors,
    since the optimizer updates them in place. With no checkpoint yet, a
    fresh run's fallback rebuilds the initial state deterministically
    (``init_state`` from ``seed``) into them; a resumed run's fallback is
    the checkpoint it resumed from, which the newest valid slot always
    holds or supersedes, so its fallback only raises if both slots were
    lost."""
    cfg, train, steps, mode = spec.cfg, spec.train, spec.train.total_steps, \
        spec.par.optimizer_sharding
    fsdp = spec.par.fsdp_params
    rank = grid.world.rank if grid is not None else 0
    lead = rank == 0
    dev = grid.world.device if grid is not None else spec.device
    loader = ShardedDataLoader(os.path.join(spec.out, "data"), global_batch=train.global_batch)
    b = grid.coords["data"] * grid.sizes["ep"] + grid.coords["ep"] if grid is not None else 0
    rows = slice(b * train.global_batch // spec.batch_ranks,
                 (b + 1) * train.global_batch // spec.batch_ranks)

    def fresh_state():
        return init_state(cfg, train, seed=train.seed, device=dev, grid=grid,
                          opt_sharding_mode=mode, fsdp=fsdp)

    state = fresh_state()
    layout = state_layout(cfg, grid.axis_sizes, mode, fsdp=fsdp) if grid is not None else None
    ckpt = Checkpointer(os.path.join(spec.out, "ckpt"), interval=spec.ckpt_interval,
                        plan=spec.plan, grid=grid, layout=layout)
    cluster = ClusterManager(n_active=max(2, spec.world), n_buffer=spec.n_buffer)

    # the live plan, on which the expert placement rides (``ResolvedPlan.
    # placement``), and the step built for it: a move swaps both
    def build_step(plan):
        return make_train_step(cfg, spec.par, train, opt_sharding_mode=mode, grid=grid,
                               placement=plan.placement if plan is not None else None)

    live = {"plan": spec.plan, "step_fn": build_step(spec.plan)}
    reb = spec.plan.plan.rebalance_params() if spec.plan is not None else None
    controller = None
    if (reb is not None or spec.rebalance_force_at is not None) and cfg.moe is not None:
        interval, threshold = reb if reb is not None else (steps + 1, 1.0)
        controller = RebalanceController(
            num_layers=cfg.num_layers, num_experts=cfg.moe.num_experts,
            ep=spec.plan.plan.ep if spec.plan is not None else 1, interval=interval,
            threshold=threshold)

    def identity():
        return ExpertPlacement.identity(cfg.num_layers, cfg.moe.num_experts)

    def live_placement():
        plan = live["plan"]
        return plan.placement if plan is not None and plan.placement is not None \
            else identity()

    def set_placement(placement, state=None, *, prev=None):
        """Swap the live placement on the live plan: move the state from
        ``prev`` when given; the step, the checkpointer's MANIFEST
        placement and the controller's follow the plan."""
        if live["plan"] is None:
            raise ValueError("the checkpoint was written under an expert placement, which "
                             "lives on a parallel plan: resume it under the plan it was "
                             "written with (--parallel)")
        if prev is not None:
            state, _ = apply_placement(state, prev, placement, grid=grid, layout=layout)
        live["plan"] = live["plan"].with_placement(
            None if placement.is_identity else placement)
        live["step_fn"] = build_step(live["plan"])
        ckpt.placement = live["plan"].placement
        if controller is not None:
            controller.placement = live_placement()
        return state

    # resume if a valid checkpoint exists (written into the live state)
    restored, ck_step = ckpt.restore(state)
    start = 0
    if restored is not None:
        state, start = restored, ck_step + 1   # ckpt holds post-step state
        if lead:
            print(f"resumed from step {start}")
        if ckpt.restored_placement is not None:
            # the arrays on disk are in placed order: adopt the placement
            # without moving anything
            set_placement(ckpt.restored_placement)
            if lead:
                print("resumed expert placement (non-identity) from the manifest")
    # the loop consumes the loader's iterator; point it at the first step to
    # run so a resumed run replays the exact batch sequence an uninterrupted
    # one would have seen (never batch 0 again)
    loader.load_state_dict({"step": start})
    batches = iter(loader)
    to_device = _batch_mover(rows.stop - rows.start, train.seq_len, dev)

    def fallback(live):
        if start:
            raise RuntimeError(f"no valid checkpoint left in {ckpt.root}: the run resumed "
                               f"from step {start} and cannot restart from there")
        return restore_into(live, dict(keyed_leaves(fresh_state())))

    if lead:
        nparams = sum(t.numel() for t in leaves(init_params(cfg, device="meta")))
        plan = spec.plan.spec() if spec.plan is not None else "single"
        pp = spec.par.pp_stages
        print(f"arch={cfg.name} params={nparams/1e6:.1f}M "
              f"vocab={padded_vocab(cfg)} plan={plan} opt_shard={mode} "
              f"opt_overlap={spec.opt_overlap} pp={pp}"
              + (f":{spec.par.pp_schedule}:{spec.par.pp_impl}" if pp > 1 else ""))
        print(f"device={dev} compute_dtype={train.compute_dtype}"
              + (f" ranks={spec.world}" if grid is not None else ""))

    injected = {"hard": False, "soft": False}
    history = {}          # keyed by step: replays after restore overwrite
    t0 = time.time()

    def train_one_step(state, step):
        # every rank takes the same step: an injected failure reaches all
        if step == spec.inject_hard_at and not injected["hard"]:
            injected["hard"] = True
            if lead:
                print(f"  !! injected HARD failure on node 0 @ step {step}")
            raise NodeFailure(cluster.active[0].node_id, "hard")
        b = next(batches)
        state, metrics = live["step_fn"](state, to_device({k: a[rows] for k, a in b.items()}))
        # one host sync per step: every fetched metric (and the MoE
        # telemetry) travels in one float64 tensor, which holds each float32
        # value exactly
        names = ["loss", "lr", "grad_norm"] + (["moe_drops"] if "moe_drops" in metrics else [])
        parts = [torch.stack([torch.as_tensor(metrics[k], device=dev).reshape(())
                              .to(torch.float64) for k in names])]
        if "moe_load" in metrics:
            parts.append(metrics["moe_load"].reshape(-1).to(torch.float64))
        counted = controller is not None and "moe_counts" in metrics
        if counted:
            parts.append(metrics["moe_counts"].reshape(-1).to(torch.float64))
        vals = torch.cat(parts).cpu().numpy()
        will_log = lead and (step % spec.log_every == 0 or step == steps - 1)
        loss, lr_v, gnorm = (float(v) for v in vals[:3])
        per_rank = [loss]
        if step == spec.inject_soft_at and not injected["soft"]:
            injected["soft"] = True
            if lead:
                print(f"  !! injected SOFT failure (NaN) on node 1 @ step {step}")
            per_rank = [loss, float("nan")]
        history[step] = {"step": step, "loss": loss, "lr": lr_v, "grad_norm": gnorm}
        moe_line = ""
        if "moe_drops" in metrics:     # per-expert routing telemetry
            drops = float(vals[3])
            load = vals[4:4 + metrics["moe_load"].numel()]
            history[step]["moe_drops"] = drops
            history[step]["moe_load_max"] = float(load.max()) if load.size \
                else 0.0
            moe_line = (f" drops {drops:.0f} "
                        f"load_max {history[step]['moe_load_max']:.3f}")
        if counted:
            # the windowed controller on this step's global counts (the same
            # on every rank, so every rank takes the same decision); a move
            # leaves this step's updated state in the new placement, which
            # the next checkpoint records
            imb = controller.observe(vals[-cfg.moe.num_experts:])
            history[step]["moe_imbalance"] = imb
            moe_line += f" imb {imb:.2f}"
            force = step == spec.rebalance_force_at
            if controller.window_full() or force:
                prev = live_placement()
                new = controller.propose(force=force)
                if new is not None:
                    state = set_placement(new, state, prev=prev)
                    history[step]["rebalanced"] = True
                    if lead:
                        print(f"step {step:5d} rebalanced expert placement (imbalance "
                              f"{imb:.2f}, ep={controller.ep}, event "
                              f"#{controller.rebalances})")
        if will_log:
            dt = time.time() - t0
            print(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"lr {lr_v:.2e}{moe_line} ({dt:.1f}s)")
        return state, {"loss": loss, "per_rank_losses": per_rank,
                       "per_rank_grad_norms": [gnorm]}

    def on_relaunch(state, failure, step):
        # rewind the batch stream to the restore point: the iterator re-reads
        # the shared step cursor on every next(), so this re-points it
        loader.load_state_dict({"step": step})
        if cfg.moe is not None:
            # the restored arrays are in the placement of the checkpoint's
            # MANIFEST (identity without one, or from the fallback), which
            # may be older than the live one: take it without moving
            target = ckpt.restored_placement or identity()
            if target != live_placement():
                set_placement(target)
        if controller is not None:
            controller.reset_window()        # the replayed steps count once
        return state

    state, end_step, relaunches = run_with_failure_handling(
        train_one_step, state=state, checkpointer=ckpt, cluster=cluster,
        num_steps=steps, monitor=NaNMonitor(), start_step=start,
        max_relaunches=spec.max_relaunches, on_relaunch=on_relaunch, fallback=fallback)

    result = RunResult(history[s] for s in sorted(history))
    result.relaunches = relaunches
    result.replaced = list(cluster.replaced)
    if not lead:
        return result
    with open(os.path.join(spec.out, "history.json"), "w") as f:
        json.dump(list(result), f)
    summary = {"arch": cfg.name, "steps": end_step, "mesh": spec.mesh,
               "parallel": str(spec.plan.plan) if spec.plan is not None else None,
               "opt_shard": mode, "opt_overlap": spec.opt_overlap,
               "pp_stages": spec.par.pp_stages,
               "moe_dispatch": cfg.moe.dispatch if cfg.moe is not None
               else None,
               "pp_schedule": spec.par.pp_schedule if spec.par.pp_stages > 1 else None,
               "pp_impl": spec.par.pp_impl if spec.par.pp_stages > 1 else None,
               "relaunches": relaunches,
               "replaced": result.replaced,
               "rebalance": spec.plan.plan.rebalance if spec.plan is not None else None,
               "rebalances": controller.rebalances if controller is not None else 0,
               "final_imbalance": next((history[s]["moe_imbalance"]
                                        for s in sorted(history, reverse=True)
                                        if "moe_imbalance" in history[s]), None),
               "final_loss": result[-1]["loss"] if result else None}
    with open(os.path.join(spec.out, "summary.json"), "w") as f:
        json.dump(summary, f)
    if relaunches:
        print(f"completed with {relaunches} relaunch(es); node swaps: "
              f"{result.replaced}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mula-1b")
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="runs/default")
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, "naive", "dense_capacity", "fsmoe"])
    ap.add_argument("--fur", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--sac", default="block")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda ('cpu' runs the plain PyTorch path)")
    ap.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="forward/backward dtype (TrainConfig.compute_dtype); the MoE "
                         "kernels on the card take bfloat16")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=["capacity", "dropless"],
                    help="MoE token dispatch: 'capacity' or 'dropless' (overrides "
                         "MoEConfig.dispatch)")
    ap.add_argument("--parallel", default=None,
                    help="declarative ParallelPlan spec, e.g. 'dp=2,ep=2', 'dp=4,opt=so' or "
                         "'dp=2,pp=2,ep=2'; the port runs the axes dp, pp, ep and tp (one "
                         "process a rank over gloo) and the options opt=, overlap=, moe=, "
                         "schedule=, impl=, rebalance=, mb=")
    ap.add_argument("--mesh", default=None,
                    help="LEGACY device mesh: '4,2' = (data, model), '2,2,2' = (data, pp, "
                         "model), translated to a ParallelPlan (MoE: model axis -> ep when "
                         "divisible, else tp). Prefer --parallel")
    ap.add_argument("--opt-shard", default=None, choices=["none", "so", "epso"],
                    help="optimizer-state sharding (paper §3.2); overrides a --parallel "
                         "spec's opt= option")
    ap.add_argument("--opt-overlap", default=None, choices=["auto", "off", "ring", "xla"],
                    help="bucketed optimizer collectives (optim/overlap): 'auto' runs the "
                         "ring for epso on a grid; overrides a --parallel spec's overlap=")
    ap.add_argument("--rebalance", default=None,
                    help="live EP rebalancing policy 'N:threshold' (or 'off'): every N steps, "
                         "re-place the experts when the max/mean EP rank load exceeds the "
                         "threshold; overrides a --parallel spec's rebalance= and needs "
                         "--parallel")
    ap.add_argument("--rebalance-force-at", type=int, default=None,
                    help="force one rebalance proposal after this step")
    ap.add_argument("--pp-schedule", default=None, choices=["gpipe", "1f1b"],
                    help="microbatch schedule over the plan's pp axis (paper: Mula-100B/220B "
                         "train 1f1b); overrides a --parallel spec's schedule=")
    ap.add_argument("--pp-impl", default=None, choices=["shardmap", "masked"],
                    help="both run the port's per-stage executor; 'shardmap' needs pp to "
                         "divide the microbatches, 'masked' takes any count")
    # the JAX launcher's option that the port does not run yet: it raises
    # NotImplementedError naming its ROADMAP.md item
    ap.add_argument("--kernel-tiles", default=None)
    ap.add_argument("--log-every", type=int, default=10,
                    help="print the step line (loss/gnorm/lr + MoE routing "
                         "telemetry: drops, max expert load) every N steps")
    ap.add_argument("--n-buffer", type=int, default=2,
                    help="buffer nodes for hard-failure replacement")
    ap.add_argument("--inject-hard-at", type=int, default=None,
                    help="inject one hard node failure at this step "
                         "(also REPRO_INJECT_HARD_AT)")
    ap.add_argument("--inject-soft-at", type=int, default=None,
                    help="inject one soft (NaN) failure at this step "
                         "(also REPRO_INJECT_SOFT_AT)")
    args = ap.parse_args(argv)
    run(args.arch, scale=args.scale, steps=args.steps, batch=args.batch,
        seq=args.seq, out=args.out, lr=args.lr, moe_impl=args.moe_impl,
        fur=args.fur, microbatches=args.microbatches, sac=args.sac,
        d_model=args.d_model, layers=args.layers, seed=args.seed,
        ckpt_interval=args.ckpt_interval, mesh=args.mesh,
        parallel=args.parallel,
        opt_shard=args.opt_shard, opt_overlap=args.opt_overlap,
        pp_schedule=args.pp_schedule,
        pp_impl=args.pp_impl, moe_dispatch=args.moe_dispatch,
        kernel_tiles=args.kernel_tiles,
        rebalance=args.rebalance,
        rebalance_force_at=args.rebalance_force_at,
        log_every=args.log_every, n_buffer=args.n_buffer,
        inject_hard_at=args.inject_hard_at,
        inject_soft_at=args.inject_soft_at,
        device=args.device, compute_dtype=args.compute_dtype)


if __name__ == "__main__":
    main()
