#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: the quickest proof that the port builds, is right, serves and trains.

    python3 chip_smoke.py                      # all phases, one card
    python3 chip_smoke.py --compare PARENT     # serve, train and epso_train's
                                               # four runs of the checkout at
                                               # PARENT and of this one, in
                                               # turns (parent, this, this,
                                               # parent)

Phases, each printing JSON lines:

  device     the card (nvidia-smi name and power limit) and the time to
             build the CUDA kernels from ``src/repro_torch/csrc``;
  kernels    each kernel against its plain PyTorch version on the card, at
             the serving, training, hybrid, expert-parallel, epso_train,
             a2a_train and grid_serve (gmm at the expert-TP decode shape)
             paths' shapes (the dispatch plan also in its
             uniform-capacity mode),
             with its time, the plain version's, one PyTorch library call's
             where there is one, and its bound (the MoE dispatch plan also
             with the host's time to enqueue it and the plain chain, and
             its one-block and three-launch paths); the pool gathers'
             backward (gathers and a combine) against the scatter-adds it
             replaced;
  reference  a small MoE model served through the CUDA kernels agrees with
             the same model run on the CPU through the plain versions;
  train_reference  one training step of a small MoE model on the card
             (bf16, through the kernels) agrees with the same step on the
             CPU (float32, plain versions) in loss and gradient norm;
  serve      full-width, full-depth Mula-7B-A1B in bf16 (random weights
             from seed 0) serves 16 requests on 8 slots; asserts the
             results and that every kernel of the path was launched the
             expected number of times; a ``serve_launches`` line gives the
             device launches per decode step and layer;
  train      full-width Mula-7B-A1B cut to 4 of its 16 layers (random
             weights from seed 0, fp32 params and AdamW state, bf16
             compute) takes 6 steps on one fixed batch of 2 x 2 x 2048
             tokens; asserts finite metrics, a falling loss, clip_scale
             <= 1 and the exact launch count of every kernel of the path;
  hybrid_reference  a small hybrid (Mamba-2) model's prefill step and
             stepped decode on the card (bf16, through the kernels) agree
             with the CPU (float32, plain versions);
  hybrid_serve  full-width, full-depth Zamba2-7B in bf16 (random weights
             from seed 0): make_prefill_step over (2, 4096) and (1, 1000)
             batches; 8 prompts of 128 tokens stepped through
             make_serve_step, then 64 greedy tokens; the forward prefill
             against the stepped decode at the last prompt position, also
             for the first 7 and 20 Mamba-2 layers of the same weights
             (a ``hybrid_depth`` line); exact launch counts (81 SSD and 13
             flash launches per prefill, none per decode step); one
             profiled prefill and decode step;
  hybrid_train_reference  a small hybrid model's three train steps on the
             card and on the CPU, both float32 (the same plain chunked-SSD
             math), in loss and grad norm, no port kernel launched;
  hybrid_train  full-width Zamba2-7B cut to 13 layers (2 groups of 6
             Mamba-2 layers and 1 remaining; random weights from seed 0,
             fp32 state, bf16 compute, block remat) takes 6 steps on one
             fixed batch of 2 x 4096 tokens in 2 microbatches through the
             plain chunked SSD: finite metrics, a falling loss, clip_scale
             <= 1, no port kernel launched; one profiled step and the
             device time per step of the SSD and of the shared attention;
  ssm_serve  falcon-mamba-7b (Mamba-1) whole in bf16: the prefill lowering
             over (2, 1024); 2 prompts of 128 tokens stepped through the
             serve step, then 32 greedy tokens each; the forward against
             the stepped decode at 64 and 16 layers; the device launches of
             one decode step; no port kernel launched;
  ssm_train  falcon-mamba-7b at full width cut to 2 layers takes 4 steps of
             2 x 2048 tokens: finite metrics, a falling loss, clip_scale
             <= 1, no port kernel; one step profiled on the device alone
             (busy time, idle share, device launches);
  launcher_ssm  reduced Zamba2-7B and falcon-mamba-7b through the launcher:
             6 steps with a checkpoint at step 3, then a resumed run whose
             steps 4-5 are bit-identical;
  grid_session  the multi-rank phases' 4 processes, started once and
             sharing the card over gloo; in turn, each on the world or on a
             grid cut from it: ep_reference, ep_train, epso_train (with the
             phases its ranks run) and the multi-rank launcher runs of
             launcher_grid_dense, _ft (its clean run), _tp, _rebalance,
             _fsdp and _fsdp_pp; prints each job's seconds on every rank;
  ep_reference  expert parallelism (EP) on 4 ranks, processes that share
             the card over gloo: a small MoE block's output and input
             gradient against the same block in one process on the card, and
             one EP training step against the single-process CPU float32
             step from the same state, in loss and gradient norm;
  ep_train   full-width Mula-7B-A1B cut to 2 of its 16 layers, EP = 4 (16
             experts per rank, one 2048-token sequence per rank), 3 steps
             on one fixed batch; asserts on every rank finite
             metrics, a falling loss, clip_scale <= 1, the same metrics as the
             other ranks, the global routed-pair count and the exact launch
             count of every kernel. The four ranks time-share one card and
             gloo carries their collectives through host memory: the step
             time is no EP speed;
  epso_train the paper's sharded optimizer: full-width Mula-7B-A1B cut to
             2 of its 16 layers on a dp = 2 x ep = 2 grid of 4 ranks sharing
             the card over gloo (32 experts and one 2048-token row a rank,
             4096 gathered tokens per MoE call), 3 steps from
             init_state(seed 0) in each of ('none', 'off'), ('so', 'off'), ('epso', 'ring')
             and ('epso', 'xla'); asserts on every rank and in every mode
             finite metrics, a falling loss, clip_scale <= 1, the same metrics
             as rank 0, replicated params equal on every rank and expert
             slices on both 'data' replicas, step 0's loss identical in every
             mode and later ones within 1 % of 'none''s, the measured state
             bytes per rank exactly ``state_bytes_per_device`` and the exact
             launch count of every kernel; prints step ms and peak memory per
             rank and mode, the update plan's buckets and the host ms of the
             collectives (no speed: the ranks time-share one card);
  a2a_train  inside epso_train's ranks: the same grid in 'epso'/'ring'
             with the all-to-all Stage 1 (``stage1='a2a'``, the dispatch
             plan's uniform-capacity mode for the send buffers) against an
             allgather run, both at capacity factor 2.5 (at the config's
             1.25 both drop pairs) and peak lr 1e-4, 3 steps each: no
             drops, the same
             metrics on every rank, losses within 2e-3 relative, the exact
             launch count (two dispatch plans a layer and forward); prints
             both Stage 1s' bytes (computed) and step ms;
  tp_train   inside epso_train's ranks, on grids re-cut from the same 4
             processes: ep = 2 x tp = 2 in 'none' and 'epso'/'ring', ep = 1
             x tp = 4 (expert-TP) in 'epso'/'ring', 3 dropless steps each on
             the same fixed batch (the tp ranks of one (data, ep) share its
             rows), without the router's aux and z terms (their EP form
             depends on how the batch is split) at peak lr 1e-4: the same
             loss, grad norm and counts on every rank, losses within 2e-3
             of the same run on the 2 x 2 grid, the state bytes the EPSO
             plan gives a rank, the exact launch count; prints peak memory
             and step ms a rank. On ep = 2 x tp = 2 'none' the run also
             takes the 'block_sc' remat policy: its losses bit for bit
             'block''s, and rank 0's profiled step fewer ``gloo:*`` events
             by the forward collectives 'block''s recompute runs again (4 a
             layer: attention's tp all-reduce and the Stage 1's three
             all-gathers);
  placement_train  inside epso_train's ranks: the same grid in
             'epso'/'ring' with dropless dispatch, 5 steps from
             init_state(seed 0) unplaced; then the state after step 2 (kept
             on the host) has its expert stacks and their master, m and v
             moved to a fixed placement (seed 0) that sends half of every
             rank's experts to the other EP rank
             (``parallel.placement.apply_placement``) and takes steps 3-4
             again; asserts every moved (layer, expert) slice equal to the
             slice its global id held before the move, by exact sums of
             the bits taken on each rank before and after it (no gather),
             no drops, the routed pairs conserved, the state bytes exact
             after the move, steps 3-4 within 2e-3 of the unplaced losses,
             the exact launch count; prints the move's ms and the bytes a
             rank sent (computed from the shapes), the rank imbalance of
             steps 0-2's counts under both placements;
  pp_train   inside epso_train's ranks, the 4 processes re-cut into dp = 1
             x pp = 2 x ep = 2: full-width Mula-7B-A1B at 4 of its 16
             layers (2 a stage, 32 experts a rank), 'epso'/'ring',
             dropless, with the router's aux and z terms (a stage takes
             them over the whole microbatch), peak lr 1e-4, 4 one-row
             microbatches of 512 tokens a batch rank, 4 steps of 1f1b then
             2 of gpipe: every rank the same loss, grad norm and counts, no
             drops, the state bytes the EPSO plan gives a rank, the
             saved-input peak of each schedule, the bytes handed between
             the stages (through pinned host buffers), the exact launch
             count of a stage; then the same model, rows and microbatches
             on one rank in the parent, the grid's losses within 2e-3
             relative of it; prints peak memory, state bytes, step ms and
             launches a rank;
  grid_serve inside epso_train's ranks, the 4 processes re-cut into ep = 2
             x tp = 2: full-width, full-depth Mula-7B-A1B in bf16 served on
             the plan (``ServeEngine(plan=, grid=)``; 32 experts, expert
             d_ff 512 and 8 heads a rank, each rank building its tiles one
             leaf and layer at a time from seeds), the admission prefill
             and one decode step through the lowerings, then 6 greedy
             requests over 4 slots: every rank the same tokens, the exact
             launch count of a rank; in the parent the same weights whole
             on one rank, whose prefill and decode logits the grid's must
             match within 5e-2 of max|logits|; prints the greedy tokens'
             agreement with the one-rank engine, step ms and peak memory;
  fsdp_train inside epso_train's ranks, the 4 processes re-cut into a
             ('data', 4) grid: full-width Mula-7B-A1B at 2 of its 16 layers,
             one 2048-token row a rank, block remat, 3 steps of FSDP
             (ZeRO-3: each rank holds its 'data' tile of every layer
             weight, and its master, m and v are those tiles; each layer is
             gathered inside its remat block, again in the recompute, and
             its gradients reduce-scattered onto the tiles) in 'none', and
             as its reference 'so' without fsdp on the same grid and rows:
             finite metrics, a falling loss, clip_scale <= 1, rank 0's
             metrics on every rank, step 0's loss bit for bit the 'so'
             run's and later ones within 1e-3 (the ce too), the grad norms
             within 1e-5 while the params are step 0's (the gradient's
             scale) and within 2e-3 after an update, the state bytes and
             param elements a rank, the gathers and reduce-scatters of each step
             and of rank 0's profiled step, the exact launch count; prints
             peak memory a rank of both runs, step ms and the bytes
             gathered a step;
  fsdp_ep_train inside epso_train's ranks, on their dp = 2 x ep = 2 grid:
             the same model and rows, 3 steps of FSDP in 'epso'/'ring' (each
             rank its 'data' tile of every layer weight, of an expert stack
             its tile of its 'ep' slice, and the EPSO shards of those tiles;
             the MoE block gets the rank's whole 'ep' slice, gathered over
             'data' inside the remat block) from init_state(seed 0), held to
             epso_train's own 'epso'/'ring' run: step 0's loss bit for bit,
             the grad norms within 1e-5 while the params are step 0's and
             2e-3 after an update, the losses and ce within 1e-3; rank 0's
             metrics on every rank, the state bytes (3,137,107,968) and
             param elements (321,529,856) a rank, the gathers and
             reduce-scatters of each step, the exact launch count; prints
             peak memory a rank beside epso_train's, step ms and the bytes
             gathered a step;
  fsdp_tp_train inside epso_train's ranks, the 4 processes re-cut into
             ('data', 2) x ('tp', 2): the same widths in the expert-TP EP =
             1 form (64 experts, expert d_ff 512 a rank), dropless, router
             terms on, one 2048-token row a 'data' rank that its tp ranks
             share; 2 steps of FSDP in 'epso'/'ring' (each rank its 'data'
             tile of its tp shard of every layer weight) beside the same
             grid's 'epso'/'ring' run without fsdp, from init_state(seed 0),
             no warmup (step 1 after an update):
             held as fsdp_ep_train is, plus no drops and every routed pair
             counted; the state bytes (3,137,107,968) and param elements
             (313,141,248) a rank; prints peak memory a rank of both runs,
             step ms and the bytes gathered a step;
  fsdp_pp_train inside epso_train's ranks, the 4 processes re-cut into
             ('data', 2) x ('pp', 2): the same widths at 2 layers, one a
             stage (64 experts a rank), 'epso'/'ring', dropless, router
             terms on, peak lr 1e-4, 4 one-row microbatches of 512 tokens a
             'data' rank, 2 steps of 1f1b with FSDP beside the same grid's
             run without fsdp: held as fsdp_tp_train is; 3 gathers and 1
             reduce-scatter a layer and microbatch of a stage, the
             saved-input peak and the bytes handed to the neighbour stage
             as pp_train's; the state bytes (3,756,822,528) and param
             elements (416,356,352) a rank; the exact launch count of a
             stage;
  launcher_dense  full-width Mula-1B at 4 of its 16 layers (d_model 2048,
             d_ff 8192, the byte vocab padded to 512; random weights from
             seed 0, fp32 state, bf16 compute) trained by the launcher
             (``repro_torch.launch.train.run``'s ``launch_ranks(prepare_run(
             ...))``, the spec cut to that depth) on the synthetic corpus for 6
             steps of 4 x 2048 tokens with a checkpoint at step 3, then the
             same call again, which resumes from it and trains steps 4 and 5:
             asserts their losses and grad norms bit-identical to the first
             run's, a falling loss and finite metrics; step ms, tokens/s,
             peak memory, checkpoint GB, save and restore ms, the host's RSS
             peak, free disk before the save, one profiled step. Needs ~6
             GB of free disk in ``build/`` (deleted at the end);
  launcher_ft  a 2-layer, d_model 512 Mula-7B-A1B through the MoE kernels
             (bf16) trained by the launcher for 18 steps, once clean and once
             with a hard failure injected at step 7 and a soft (NaN) one at
             step 12: two relaunches and node swaps, both checkpoint slots
             valid at steps 10 and 15, a history bit-identical to the clean
             run's and the exact launch count of every kernel of the path;
  launcher_grid_dense  launcher_dense's run (its checkpoint at step 4) at
             2 of Mula-1B's 16 layers through the multi-rank
             launcher, ``parallel='dp=4'``, ``opt_shard='so'``: four ranks
             share the card over gloo, one 2048-token row each, then the
             same call resumes from step 4; beside it the same run on one
             rank at the same depth. Asserts resumed step 5
             bit-identical, losses finite, falling and within 1 % of
             the one-rank run's, the checkpoint's members (whole arrays)
             those of the one-rank run, the MANIFEST's plan layout, and
             each rank's state bytes exactly ``state_bytes_per_device``;
  launcher_grid_ft  launcher_ft's runs on a dp = 2 x ep = 2 grid under
             EPSO, the clean one in the session (the exact launch count of
             every kernel), the faulty one through ``python -m
             repro_torch.launch.train`` in a fresh process: two relaunches
             with the node swaps, valid slots at steps 10 and 15, the clean
             run's history bit for bit; losses finite, falling, within
             0.1 % of launcher_ft's for steps 0-2 and 5 % after, both runs'
             MoE drops side by side;
  launcher_grid_tp  launcher_ft's run on ``parallel='dp=1,ep=2,tp=2'``
             under EPSO, clean and with a hard failure at step 7: one
             relaunch, a bit-identical history, the plan's layout in the
             MANIFEST, exact launches, losses within 2e-3 of launcher_ft's
             at the steps where neither run drops pairs;
  launcher_grid_rebalance  launcher_grid_ft's run with live EP
             rebalancing (``rebalance=2:1.0``, a forced proposal after step
             3), clean and with a hard failure after the step-5 checkpoint:
             at least one event before step 9, the faulty run's history
             (rank imbalances and events included) bit-identical to the
             clean one's on every rank, the same placement in both last
             MANIFESTs, finite losses, the exact launch count;
  launcher_grid_fsdp  launcher_ft's shapes on ``--parallel
             dp=2,ep=2,fsdp --opt-shard epso``, 18 steps that checkpoint
             every 5, then the same run, which resumes steps 16-17 from the
             last (both in the session): the resumed steps bit-identical, the
             checkpoint whole arrays, the fsdp layout in the MANIFEST, the
             state bytes a rank, the exact launch count, step 0's loss bit
             for bit launcher_grid_ft's clean run's and later ones within
             2e-3 of it; save and restore ms, the checkpoint's bytes;
  launcher_grid_fsdp_pp  the same on ``--parallel dp=2,pp=2,fsdp
             --opt-shard epso`` (one layer a stage, 2 microbatches): the
             resumed steps bit-identical, the checkpoint whole arrays, the
             fsdp layout in the MANIFEST, the state bytes a rank, a stage's
             exact launch count, the losses within 2e-3 of launcher_ft's at
             the steps where neither run drops pairs; save and restore ms;
  launcher_grid_pp  launcher_ft's run on ``--parallel pp=2,ep=2
             --opt-shard epso`` through the launcher's command line
             (``launch.train.main(argv)``, in this process so that each
             rank runs under the launcher probe) with a hard failure at
             step 7: one relaunch on every rank, the replayed step's loss
             and grad norm bit-identical to its first attempt's, the plan's
             layout in the MANIFEST, finite falling losses, every rank's
             exact launch count; then the one-rank launcher resumes steps
             16-17 from its last checkpoint;
  launches   the device launches of one dispatch plan at each kernel case's
             shape (at most 3) and of one MoE block at a decode step, each
             captured in a CUDA graph and counted there.

Every grid phase with an 'ep' or 'tp' axis (ep_train, epso_train and the
phases its ranks run on such grids, grid_serve and the launcher runs on
them) also prints the embedding and head table elements a rank holds,
split on their vocab rows over 'tp', else 'ep' (``parallel.vocab``), held
to the figure the shapes give.

The last three lines are the card's name and power limit as nvidia-smi
prints them, one JSON object listing the kernels, and
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. It needs the repository's ``src/`` beside
it and a CUDA device; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import resource
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

MULA = "mula-7b-a1b"
ZAMBA = "zamba2-7b"
DEV = "cuda"
# EP_STEPS, EP_LAYERS, EPSO_STEPS, TP_STEPS, GRID_DENSE_LAYERS and
# HYBRID_DEPTHS are cut to what the smoke's time limit leaves room for beside
# pp_train, launcher_grid_pp and fsdp_train
EP_RANKS, EP_SEQ, EP_STEPS, EP_LAYERS = 4, 2048, 3, 2
# epso_train: the sharded optimizer on a dp x ep grid of ranks sharing the card
EPSO_DP, EPSO_EP, EPSO_LAYERS, EPSO_STEPS = 2, 2, 2, 3
EPSO_RUNS = (("none", "off"), ("so", "off"), ("epso", "ring"), ("epso", "xla"))
# per-rank fp32 master + m + v bytes of full-width Mula-7B-A1B at 2 layers on
# the 2 x 2 grid (optim.epso.state_bytes_per_device; every leaf divides; the
# tables' vocab rows on 'ep')
EPSO_STATE_BYTES = {"none": 6_477_176_832, "so": 3_238_588_416, "epso": 3_137_107_968}
# a2a_train (inside epso_train's ranks): the all-to-all Stage 1 in
# 'epso'/'ring', EPSO_STEPS steps, losses within A2A_LOSS_TOL of an allgather
# run at the same capacity factor A2A_CF and peak lr CMP_LR. Not the config's
# 1.25: there the routing concentrates after step 1 and both runs drop pairs
# (measured on the H100: the a2a 1,560-4,048 a step from step 2, the allgather
# 1,546 at step 5). At 2.5 neither can drop whatever the routing: a send group
# holds Cd = 20,480 >= T * K = 16,384 rows, the inner pool 40,960 >= 2 *
# 16,384 + 32 * 127 (its alignment slack), the allgather pool 45,056 >=
# 32,768 + 32 * 127. The peak lr of both comparisons (a2a, tp) is CMP_LR, not
# epso_train's 4e-4: its steps clip the gradient to a fifth, and two runs'
# bf16 difference at equal params (1.35e-5 of the loss) grew to 6.0e-3 by
# step 5 (measured on the H100)
A2A_CF, CMP_LR, A2A_LOSS_TOL = 2.5, 1e-4, 2e-3
# tp_train (inside epso_train's ranks, on grids re-cut from the same 4
# processes): (dp, ep, tp) and the (mode, overlap) runs on it, dropless,
# without the router's aux and z terms, TP_STEPS steps each, losses within
# TP_LOSS_TOL of the same run on the spawn's 2 x 2 grid (its 'epso'/'ring').
# The aux and z losses are the mean of the ranks' (the reference's EP
# semantics), so a grid that splits the batch otherwise has other ones: with
# them the step-0 loss of ep = 2 x tp = 2 'none' was 5.4e-4 off the 2 x 2
# run's, 3.8e-3 by step 3 (measured on the H100)
TP_GRIDS = (((1, 2, 2), (("none", "off"), ("epso", "ring"))), ((1, 1, 4), (("epso", "ring"),)))
TP_STEPS, TP_LOSS_TOL = 3, 2e-3
# placement_train (inside epso_train's ranks): 'epso'/'ring', dropless, a move
# of the expert stacks and their states after step PLACEMENT_MOVE_AFTER to a
# placement from seed PLACEMENT_SEED; steps after the move within
# PLACEMENT_LOSS_TOL of the unplaced run's (top 8: the sum over ranks
# reassociates; the size of 'so' against 'none''s drift over 6 steps); 5
# steps, not 6, for the smoke's time limit: the two after the move are the
# placed forward and, at step 4, the first update made under the placement
PLACEMENT_STEPS, PLACEMENT_MOVE_AFTER, PLACEMENT_SEED, PLACEMENT_LOSS_TOL = 5, 2, 0, 2e-3
# fsdp_train (inside epso_train's ranks, the 4 processes re-cut as a ('data',
# FSDP_DP) grid): FSDP (ZeRO-3) 'none' and, as its reference, 'so' without
# fsdp (its math is 'none''s; a whole-params 'none' run of 4 ranks does not
# fit the card), EPSO_STEPS steps each on the rank's row, block remat; the
# per-rank fp32 state bytes and param elements of full-width Mula-7B-A1B at 2
# layers on ('data', 4) (``state_bytes_per_device`` of the fsdp placements,
# the JAX package's: tests/test_torch_fsdp.py); losses and ce after step 0
# within FSDP_LOSS_TOL relative of the 'so' run's (step 0's loss bit for bit);
# the grad norm of each step whose params are still step 0's (every earlier
# step's lr was 0) within FSDP_NORM_TOL of 'so''s, which a reduce-scatter that
# averages for a sum, or a norm without the 'data' sum, misses by 2x or more;
# the grad norms after an update within FSDP_NORM_TOL_UPDATED (bf16 rounding
# moves them: step 2's grad norm under 'so' and 'epso' was 2.3e-4 and 1.1e-3
# off 'none''s on the 2 x 2 grid, measured on the H100)
FSDP_DP = 4
FSDP_STATE_BYTES = {"fsdp": 4_996_325_376, "so": 3_137_107_968}
FSDP_PARAM_ELEMS = 416_360_448
FSDP_LOSS_TOL, FSDP_NORM_TOL, FSDP_NORM_TOL_UPDATED = 1e-3, 1e-5, 2e-3
# fsdp_ep_train (inside epso_train's ranks, on their EPSO_DP x EPSO_EP grid):
# FSDP in 'epso'/'ring', EPSO_STEPS steps from init_state(seed 0) on the
# rank's row, held to epso_train's own 'epso'/'ring' history at the
# fsdp_train tolerances; the per-rank fp32 state bytes and param elements of
# full-width Mula-7B-A1B at 2 layers on 2 x 2 with fsdp (the JAX package's:
# tests/test_torch_fsdp_ep.py)
FSDP_EP_RUN = ("epso", "ring")
FSDP_EP_STATE_BYTES, FSDP_EP_PARAM_ELEMS = 3_137_107_968, 321_529_856
# fsdp_tp_train (inside epso_train's ranks, the 4 processes re-cut as
# FSDP_TP_GRID (dp, ep, tp)): full-width Mula-7B-A1B at EPSO_LAYERS layers in
# the expert-TP EP = 1 form, dropless, router terms on, one EP_SEQ-token row a
# 'data' rank; FSDP in 'epso'/'ring' beside the same grid's run without fsdp,
# EPSO_STEPS steps each, held at the fsdp_train tolerances; the per-rank fp32
# state bytes and param elements with fsdp (tests/test_torch_fsdp_grid.py)
FSDP_TP_GRID = (2, 1, 2)
FSDP_TP_STATE_BYTES, FSDP_TP_PARAM_ELEMS = 3_137_107_968, 313_141_248
# fsdp_pp_train (inside epso_train's ranks, re-cut as ('data', FSDP_PP_DP) x
# ('pp', FSDP_PP_STAGES)): full-width Mula-7B-A1B at EPSO_LAYERS layers, one
# a stage, 'epso'/'ring', dropless, router terms on, peak lr CMP_LR,
# FSDP_PP_MB one-row microbatches of PP_SEQ tokens a 'data' rank, 1f1b; FSDP
# beside the same grid's run without fsdp, FSDP_GRID_STEPS steps each, held
# at the fsdp_train tolerances; the per-rank fp32 state bytes and param
# elements with fsdp (tests/test_torch_fsdp_grid.py). 2 microbatches, cut
# from PP_MB = 4 for the smoke's time limit: the fsdp step gathers each layer
# three times a microbatch, 10.1 GB through gloo at 4 (20.96-27.70 s a step,
# measured on the H100, 4 ranks sharing it)
FSDP_PP_DP, FSDP_PP_STAGES, FSDP_PP_MB = 2, 2, 2
FSDP_PP_STATE_BYTES, FSDP_PP_PARAM_ELEMS = 3_756_822_528, 416_356_352
# fsdp_tp_train and fsdp_pp_train take FSDP_GRID_STEPS steps with no warmup
# (the lr at its peak from step 0): step 0 on the initial params, step 1
# after an update, the two kinds of step the fsdp_train tolerances hold.
# Cut from 3 steps for the smoke's time limit: fsdp_pp_train's fsdp step
# gathers 10,069,475,328 B through gloo and took 18.9-19.7 s (measured on the
# H100, 4 ranks sharing it)
FSDP_GRID_STEPS = 2
# the multi-rank phases' processes, started once (grid_session): ep_reference,
# ep_train, epso_train with the phases its ranks run, and the multi-rank
# launcher runs of LAUNCHER_GRID_RUNS, in turn; the session's time limit
SESSION_RANKS, SESSION_TIMEOUT_S = 4, 900
# the launcher phases' runs (``repro_torch.launch.train.run`` keywords) and
# their directory, git-ignored, inside the checkout
LAUNCH_DIR = ROOT / "build" / "launcher"
DENSE_ARCH, FT_ARCH = "mula-1b", MULA
# lr 1e-4: the launcher's default 1e-3 (sized for the reduced models) after
# its 5-step warmup sent full-width Mula-1B's loss from 5.98 to 12.51 by step
# 4 (grad norm 57, unclipped in warmup); the paper's 4e-4 follows a
# 2,500-step warmup
DENSE_RUN = dict(scale="full", steps=6, batch=4, seq=2048, ckpt_interval=3, lr=1e-4,
                 compute_dtype="bfloat16", log_every=1)
# launcher_dense runs DENSE_LAYERS of Mula-1B's 16 layers (the smoke's time
# limit: at full depth its 17.2 GB checkpoint's save and restore took ~58 s of
# the phase's ~85 s on the H100)
DENSE_LAYERS = 4
FT_RUN = dict(scale="smoke", d_model=512, layers=2, steps=18, batch=4, seq=256,
              ckpt_interval=5, compute_dtype="bfloat16", log_every=100)
FT_INJECT = dict(inject_hard_at=7, inject_soft_at=12)
# the multi-rank launcher: the same runs on a grid of 4 ranks sharing the card
# the checkpoint at step 4, so that the resumed run takes one step (the
# smoke's time limit); fewer steps would not do: full-depth Mula-1B's loss
# falls below step 0's only at step 5
GRID_DENSE_RUN = dict(DENSE_RUN, ckpt_interval=4, parallel="dp=4", opt_shard="so")
# launcher_grid_dense runs GRID_DENSE_LAYERS of Mula-1B's 16 layers (the
# smoke's time limit: the save and restore of its gathered tiles
# through gloo took ~75 s of its ~250 s at full depth; 4 layers took
# 107 s of a 1,237 s smoke on a slow host), against a one-rank run of the
# same depth
GRID_DENSE_LAYERS = 2
GRID_FT_DP, GRID_FT_EP = 2, 2
GRID_FT_RUN = dict(FT_RUN, parallel=f"dp={GRID_FT_DP},ep={GRID_FT_EP}", opt_shard="epso")
# one MoE call of launcher_grid_ft on one rank: its ep group's rows, gathered
GRID_FT_TOKENS = GRID_FT_EP * FT_RUN["batch"] // (GRID_FT_DP * GRID_FT_EP) * FT_RUN["seq"]
GRID_DENSE_LAYOUT = {"axes": [["data", 4]], "opt_shard": "so", "fsdp": False}
# launcher_grid_rebalance: GRID_FT_RUN with a rebalance policy (every 2 steps
# when the rank imbalance exceeds 1.0, and a forced proposal after step 3),
# clean and with a hard failure after the step-5 checkpoint, which the
# windows of 2 steps end at, so that the replay sees the clean run's windows
GRID_REB_RUN = dict(GRID_FT_RUN, parallel=f"dp={GRID_FT_DP},ep={GRID_FT_EP},rebalance=2:1.0",
                    rebalance_force_at=3)
GRID_REB_INJECT = dict(inject_hard_at=7)
# launcher_grid_tp: launcher_ft's run on an ep = 2 x tp = 2 grid under EPSO,
# clean and with a hard failure at step 7 (a relaunch from step 5); losses
# within GRID_TP_LOSS_TOL of launcher_ft's at the steps where neither drops
GRID_TP_RUN = dict(FT_RUN, parallel="dp=1,ep=2,tp=2", opt_shard="epso")
GRID_TP_INJECT = dict(inject_hard_at=7)
GRID_TP_LOSS_TOL = 2e-3
GRID_TP_LAYOUT = {"axes": [["ep", 2], ["tp", 2]], "opt_shard": "epso", "fsdp": False}
# pp_train (inside epso_train's ranks, the 4 processes re-cut as dp = 1 x pp =
# 2 x ep = 2): full-width Mula-7B-A1B at PP_LAYERS of its 16 layers (the train
# cell's depth), 'epso'/'ring', dropless, with router terms, PP_MB
# microbatches of one PP_SEQ-token row a batch rank, one step per schedule of
# PP_SCHEDULES (1f1b, then gpipe on the same state), peak lr CMP_LR; losses
# within PP_LOSS_TOL relative of a one-rank run of the same model, rows and
# microbatches
PP_DP, PP_STAGES, PP_EP, PP_LAYERS, PP_MB, PP_SEQ = 1, 2, 2, 4, 4, 512
PP_SCHEDULES = ("1f1b",) * 4 + ("gpipe",) * 2
PP_LOSS_TOL = 2e-3
# grid_serve (inside epso_train's ranks, the 4 processes re-cut as ep = 2 x
# tp = 2): full-width Mula-7B-A1B at GRID_SERVE_LAYERS layers, bf16, greedy
# requests of GRID_SERVE_PROMPTS tokens over GRID_SERVE_SLOTS slots, each
# GRID_SERVE_NEW tokens; the lowerings' prefill (the first prompt) and first
# decode logits within GRID_SERVE_TOL of max|logits| of one rank's
GRID_SERVE_EP, GRID_SERVE_TP, GRID_SERVE_LAYERS = 2, 2, 16
GRID_SERVE_PROMPTS = (37, 120, 64, 250, 90, 17)
GRID_SERVE_SLOTS, GRID_SERVE_NEW, GRID_SERVE_MAX_LEN = 4, 16, 512
GRID_SERVE_TOL = 5e-2
# tp_train's 'block_sc' run saves, a layer and microbatch, the forward
# collectives 'block''s recompute runs again (it stops at the block's last
# saved activation, the combine's inputs): attention's tp all-reduce and the
# Stage 1's three all-gathers
BLOCK_SC_SAVED_PER_LAYER = 1 + 3
# launcher_grid_pp: launcher_ft's run on pp = 2 x ep = 2 under EPSO through
# ``python -m repro_torch.launch.train``, with a hard failure at step 7 (a
# relaunch from the step-5 checkpoint); its plan's layout in the MANIFEST
GRID_PP_RUN = dict(FT_RUN, parallel="pp=2,ep=2", opt_shard="epso")
GRID_PP_INJECT = 7
GRID_PP_LAYOUT = {"axes": [["pp", 2], ["ep", 2]], "opt_shard": "epso", "fsdp": False}
# launcher_grid_fsdp: launcher_grid_ft's clean run with fsdp (the same steps
# and schedule), checkpoints every 5 steps, then the same run again, which
# resumes steps 16-17 from the last (both in the session's processes);
# losses after step 0 within GRID_FSDP_LOSS_TOL of launcher_grid_ft's clean
# run where both drop as many pairs
GRID_FSDP_RUN = dict(GRID_FT_RUN, parallel=f"dp={GRID_FT_DP},ep={GRID_FT_EP},fsdp")
GRID_FSDP_LAYOUT = {"axes": [["data", 2], ["ep", 2]], "opt_shard": "epso", "fsdp": True}
GRID_FSDP_LOSS_TOL = 2e-3
# launcher_grid_fsdp_pp: launcher_ft's run on dp = 2 x pp = 2 with fsdp under
# EPSO (one layer a stage; the launcher's default 2 microbatches), run and
# resumed as launcher_grid_fsdp; losses within GRID_FSDP_LOSS_TOL of
# launcher_ft's at the steps where neither run drops pairs
GRID_FSDP_PP_RUN = dict(FT_RUN, parallel="dp=2,pp=2,fsdp", opt_shard="epso")
GRID_FSDP_PP_LAYOUT = {"axes": [["data", 2], ["pp", 2]], "opt_shard": "epso", "fsdp": True}
# fsdp_placement_train (inside epso_train's ranks, on its EPSO_DP x EPSO_EP
# grid): fsdp_ep_train's model and rows, dropless, FSDP 'epso'/'ring' from
# init_state(seed 0); the state after step FSDP_PLACEMENT_MOVE_AFTER kept on
# the host, the next step taken unplaced, then the kept state written back,
# moved to placement_train's placement (``placement_row``) and that step
# taken again under it: its loss within PLACEMENT_LOSS_TOL of the unplaced
# one's (top 8: the sum over the EP ranks reassociates). The move follows
# step 0 (its lr is 0, its moments are not), not step 1: the job took 48.9
# s with one more step (measured on the H100)
FSDP_PLACEMENT_MOVE_AFTER = 0
# fsdp_hybrid_train (a session job, its processes re-cut as ('data',
# FSDP_DP)): full-width Zamba2-7B at FSDP_HYBRID_LAYERS layers (one group of
# 6 Mamba-2 layers, the shared block, one remaining layer), one
# FSDP_HYBRID_SEQ-token row a rank, block remat, FSDP_GRID_STEPS steps
# without warmup at peak lr CMP_LR of FSDP 'so' beside 'so' without fsdp
# (whole params under 'none' on 4 ranks may not fit the card); the state
# bytes and param elements a rank tests/test_torch_fsdp_ssm.py's figures.
# Not the config's 4e-4: Adam's first step on one fixed row took the loss
# from 11.08 to 0.30, where the two runs' bf16 gradient sums (grouped
# otherwise by the gathers' reduce-scatters than by the SO buckets; under
# pp the fsdp run rounds each microbatch's) parted the losses by 5.4e-4 of
# it, and falcon-mamba's by 2.17e-3 (measured on the H100)
FSDP_HYBRID_LAYERS, FSDP_HYBRID_SEQ = 7, 2048
FSDP_HYBRID_STATE_BYTES, FSDP_HYBRID_PARAM_ELEMS = 2_942_262_288, 417_325_104
# fsdp_ssm_pp_train (a session job, re-cut as ('data', FSDP_PP_DP) x ('pp',
# FSDP_PP_STAGES)): full-width falcon-mamba-7b at FSDP_SSM_PP_LAYERS layers,
# one a stage, FSDP_SSM_PP_MB one-row microbatches of FSDP_SSM_PP_SEQ tokens
# a batch rank (Mamba-1 is host-bound: ssm_train took 14.0 s a step at 8
# layers of 2 x 2048 tokens; the job took 42.9 s at 512 tokens, measured on
# the H100), 1f1b, FSDP_GRID_STEPS steps without warmup at peak lr CMP_LR of FSDP
# 'so' beside 'so' without fsdp; the state bytes and param elements a rank
# tests/test_torch_fsdp_ssm.py's figures
FSDP_SSM_PP_LAYERS, FSDP_SSM_PP_MB, FSDP_SSM_PP_SEQ = 2, 2, 256
FSDP_SSM_PP_STATE_BYTES, FSDP_SSM_PP_PARAM_ELEMS = 3_827_957_760, 585_416_704
# launcher_grid_fsdp_rebalance: launcher_grid_rebalance's runs (GRID_REB_RUN,
# clean and with GRID_REB_INJECT) with fsdp
GRID_FSDP_REB_RUN = dict(GRID_REB_RUN, parallel=f"dp={GRID_FT_DP},ep={GRID_FT_EP},fsdp,"
                                               f"rebalance=2:1.0")


T_START = time.perf_counter()
PHASE_S: dict = {}          # seconds from the start at which each phase line was printed


def emit(phase: str, **fields) -> None:
    PHASE_S.setdefault(phase, time.perf_counter() - T_START)
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


def host_us(fn, args: tuple, calls: int = 20, rounds: int = 5) -> float:
    """Host time to enqueue one call of ``fn(*args)`` (the wrapper's checks,
    any tensor-map encoding and the launch): the median over ``rounds`` of
    ``calls`` back-to-back calls that do not wait for the device, each round
    synchronised after (the host's clock is shared and noisy)."""
    import torch
    fn(*args)
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    """Least time for the work on the card: the larger of bytes over the
    memory rate and operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------------
# kernels against their plain versions
# ----------------------------------------------------------------------------

def _routing_groups(T: int, m, gen, experts: int = 0, offset: int = 0, local: int = 0,
                    dropless: bool = False):
    """Group sizes of one MoE dispatch of T tokens with random top-k
    routing over the first ``experts`` experts (all if 0), the pool sized
    from the MoE config ``m`` as the model sizes it (``dropless``: the
    dropless pool); with ``local``, one EP rank's dispatch of the experts
    ``[offset, offset + local)``."""
    import torch
    from repro_torch.core import moe
    from repro_torch.kernels import ops
    idx = torch.rand((T, experts or m.num_experts), generator=gen, device=DEV).topk(
        m.experts_per_token, dim=-1).indices
    rows = moe.dispatch_pool_rows(T, m, local_experts=local, dropless=dropless)
    plan = moe.make_dispatch_plan(idx, num_experts=m.num_experts, pool_rows=rows,
                                  align=ops.gmm_align(), expert_offset=offset,
                                  local_experts=local)
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

    # grid_serve: rank (1, 1) of ep = 2 x tp = 2 at a decode step of its slots:
    # its 32 experts' d_ff shards, K = d, N = f / tp, the dropless pool
    els, fs = E // GRID_SERVE_EP, f // GRID_SERVE_TP
    gs, rows = _routing_groups(GRID_SERVE_SLOTS, cfg.moe, gen, offset=els, local=els,
                               dropless=True)
    total, active = int(gs.sum()), int((gs > 0).sum())
    w, x = randn(els, d, fs, scale=d ** -0.5), randn(rows, d)
    lib, note = _grouped_mm_yardstick(
        lambda x, w, gs: torch._grouped_mm(x, w, offs=_offs(gs)), (x, w, gs),
        gmm_plain(x, w, gs), rows_of=lambda y, n=total: y[:n])
    cases.append(dict(
        kernel="gmm", case=f"ETP decode gate M={rows} K={d} N={fs} rows={total}",
        args=(x, w, gs), fn=ops.gmm, plain=gmm_plain, library=lib, library_note=note,
        bytes=2 * (total * d + active * d * fs + rows * fs), flops=2.0 * total * d * fs,
        peak=BF16_TENSOR_FLOPS, tol="rel"))

    cases += train_kernel_cases(cfg, gen, randn)
    EL = E // EP_RANKS
    cases += train_kernel_cases(cfg, gen, randn, tokens=EP_RANKS * EP_SEQ,
                                offset=(EP_RANKS - 1) * EL, local=EL)
    # epso_train: rank (d, 1) of the 2 x 2 grid, 32 experts from offset 32
    ELG = E // EPSO_EP
    cases += train_kernel_cases(cfg, gen, randn, tokens=EPSO_EP * EP_SEQ, offset=ELG,
                                local=ELG, path="epso")
    cases += train_kernel_cases(launcher_ft_cfg(), gen, randn,
                                tokens=FT_RUN["batch"] * FT_RUN["seq"], path="launcher_ft",
                                empty=2)
    # launcher_grid_ft: rank (d, 1) of the 2 x 2 grid, 2 experts from offset 2
    ftl = launcher_ft_cfg().moe.num_experts // GRID_FT_EP
    cases += train_kernel_cases(launcher_ft_cfg(), gen, randn, tokens=GRID_FT_TOKENS,
                                offset=ftl, local=ftl, path="launcher_grid_ft", empty=1)

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
    return (cases + edge_kernel_cases(cfg, gen, randn) + hybrid_kernel_cases(gen)
            + token_counts_cases(cfg, gen) + dispatch_plan_cases(cfg, gen))


def edge_kernel_cases(cfg, gen, randn) -> list[dict]:
    """The edges of the gmm and flash kernels' tiling, at the model's
    widths: gmm in both modes with group sizes that are not multiples of its
    128-row tile (16, 48, 80, 144, empty groups between them) and a total
    below M, and with one group holding every row; the rows past the total
    must come out exactly 0 though the output's memory held NaN before the
    call. Flash at hd 64, with Sq = 37 (shorter than one tile), MQA (nkv =
    1), and B = 2 with a ragged S, so that a batch boundary falls inside a
    tile (one case with 128-row query tiles)."""
    import torch
    from repro_torch.kernels import ops, ref

    d, f = cfg.d_model, cfg.moe.d_ff_expert
    cases = []
    for name, sizes, M in (("ragged", [16, 0, 48, 80, 0, 144, 0], 400),
                           ("one group", [0, 1024, 0], 1024)):
        G, total = len(sizes), sum(sizes)
        gs = torch.tensor(sizes, dtype=torch.int32, device=DEV)
        w = randn(G, d, f, scale=d ** -0.5)
        active = sum(1 for n in sizes if n)
        for mode in ("fwd", "dx"):
            x = randn(M, d if mode == "fwd" else f)
            nout = f if mode == "fwd" else d
            if mode == "fwd":
                fn = ops.gmm
                plain = lambda x, w, gs: ref.gmm_ref(x.float(), w.float(), gs)  # noqa: E731
            else:
                fn = ops.gmm_transposed
                plain = lambda x, w, gs: ref.gmm_ref(  # noqa: E731
                    x.float(), w.float().transpose(1, 2), gs)
            cases.append(dict(
                kernel="gmm", case=f"edge {mode} {name} sizes={sizes} M={M} K={x.shape[1]} "
                                   f"N={nout}",
                args=(x, w, gs), fn=fn, plain=plain, library=None,
                library_note="edge case: no yardstick timed",
                zero_rows_from=total, out_shape=(M, nout),
                bytes=2 * (total * x.shape[1] + active * d * f + M * nout),
                flops=2.0 * total * d * f, peak=BF16_TENSOR_FLOPS, tol="rel"))
    nh = cfg.num_heads
    for B, S, heads, nkv, hd in ((1, 37, nh, nh, 128), (1, 512, nh, 1, 128),
                                 (2, 500, nh, 4, 64), (2, 1000, 32, 32, 112)):
        qp = torch.arange(S, device=DEV)[:, None]
        pairs = int((qp >= torch.arange(S, device=DEV)[None, :]).sum())
        cases.append(dict(
            kernel="flash_attention",
            case=f"edge B={B} Sq={S} Skv={S} nh={heads} nkv={nkv} hd={hd} causal",
            args=(randn(B, S, heads, hd), randn(B, S, nkv, hd), randn(B, S, nkv, hd)),
            fn=lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
            plain=lambda q, k, v: ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                                          causal=True),
            library=None, library_note="edge case: no yardstick timed",
            bytes=2 * B * (2 * S * heads * hd + 2 * S * nkv * hd),
            flops=4.0 * B * pairs * heads * hd, peak=BF16_TENSOR_FLOPS, tol="rel"))
    return cases


def hybrid_kernel_cases(gen) -> list[dict]:
    """The hybrid prefill's kernel calls at full-width Zamba2-7B: the SSD
    intra-chunk stage of one Mamba-2 layer for a 4096-token prompt (x, B
    and C read in place from one (1, 4096, 7296) activation, as
    ``mamba2_block`` hands them over) and for a 1000-token prompt (padded to
    1024 by ``_ssd_chunked``, so contiguous), and the shared block's flash
    attention at head dim 112 over 4096 tokens."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models.ssm import mamba2_dims

    cfg = get_config(ZAMBA)
    _, di, H, P, N, _ = mamba2_dims(cfg)
    L = cfg.ssm.chunk
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=DEV)   # -exp(A_log) at init
    cases = []
    for S in (4096, 1000):
        xbc = torch.randn((1, S, di + 2 * N), generator=gen, device=DEV).bfloat16()
        dt = F.softplus(torch.randn((1, S, H), generator=gen, device=DEV) - 3.0)
        x, Bm, Cm = xbc[..., :di].reshape(1, S, H, P), xbc[..., di:di + N], xbc[..., di + N:]
        pad = -S % L
        if pad:                                   # as _ssd_chunked pads: dt = 0 steps
            x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in (x, dt, Bm, Cm))
        C = (S + pad) // L
        args = (x.reshape(1, C, L, H, P), dt.reshape(1, C, L, H), Bm.reshape(1, C, L, N),
                Cm.reshape(1, C, L, N), A)
        pairs = C * H * L * (L + 1) // 2          # causal (i, j) pairs over every (c, h)
        cases.append(dict(
            kernel="ssd_intra_chunk",
            case=f"S={S} B=1 C={C} L={L} H={H} P={P} N={N}" + (" padded" if pad else ""),
            args=args, fn=ops.ssd_intra_chunk, plain=ref.ssd_intra_chunk_ref, library=None,
            library_note="none: no single PyTorch call computes it",
            bytes=2 * C * L * H * P + 4 * C * L * H + 2 * 2 * C * L * N + 4 * H
            + 4 * (C * L * H * P + C * H * P * N + C * H),
            flops=2.0 * pairs * (N + P) + 2.0 * C * H * L * P * N,
            peak=BF16_TENSOR_FLOPS, tol="rel"))
    S, nh, hd = 4096, cfg.num_heads, cfg.head_dim
    q, k, v = (torch.randn((1, S, nh, hd), generator=gen, device=DEV).bfloat16()
               for _ in range(3))
    cases.append(dict(
        kernel="flash_attention", case=f"B=1 Sq={S} Skv={S} nh={nh} nkv={nh} hd={hd} causal",
        args=(q, k, v), fn=lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
        plain=lambda q, k, v: ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                                      causal=True),
        library=lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True),
        bytes=2 * 4 * S * nh * hd, flops=4.0 * (S * (S + 1) // 2) * nh * hd,
        peak=BF16_TENSOR_FLOPS, tol="rel"))
    return cases


def token_counts_cases(cfg, gen) -> list[dict]:
    """The Stage 2 histogram at the paths' shapes, int64 ids from top-8
    routing as the router emits them: a decode step (8 tokens, all 64
    experts local), a 1000-token prefill, launcher_ft's (1024 tokens, all
    4 experts) and launcher_grid_ft's (512 gathered tokens, 2 local experts
    from offset 2) ids, epso_train's gathered ids (2
    ranks x 2048 tokens x 8, 32 local experts from offset 32), and EP's
    gathered ids (4 ranks x
    2048 tokens x 8 = 65,536 ids) counted for ranks 1 and 3 (16 local
    experts from offsets 16 and 48), plus every id one expert (all the
    atomics on one bin). Exact equality. The yardstick is the port's former
    Stage 2, one ``scatter_add_`` into zeros on the masked, shifted ids."""
    import torch
    from repro_torch.kernels import ops, ref

    E, K = cfg.moe.num_experts, cfg.moe.experts_per_token

    def routed(T):
        return torch.rand((T, E), generator=gen, device=DEV).topk(K, dim=-1).indices.reshape(-1)

    ep = routed(EP_RANKS * EP_SEQ)
    epso = routed(EPSO_EP * EP_SEQ)
    ft = launcher_ft_cfg().moe
    ft_T = FT_RUN["batch"] * FT_RUN["seq"]
    ft_ids = torch.rand((ft_T, ft.num_experts), generator=gen, device=DEV).topk(
        ft.experts_per_token, dim=-1).indices.reshape(-1)
    ftl = ft.num_experts // GRID_FT_EP
    grid_ids = torch.rand((GRID_FT_TOKENS, ft.num_experts), generator=gen, device=DEV).topk(
        ft.experts_per_token, dim=-1).indices.reshape(-1)
    cases = []
    for name, ids, el, off in ((f"launcher_ft T={ft_T}", ft_ids, ft.num_experts, 0),
                               (f"launcher_grid_ft F={grid_ids.numel()} EL={ftl} offset={ftl}",
                                grid_ids, ftl, ftl),
                               (f"epso F={epso.numel()} EL={E // EPSO_EP} offset={E // EPSO_EP}",
                                epso, E // EPSO_EP, E // EPSO_EP),
                               ("decode T=8", routed(8), E, 0),
                               ("prefill T=1000", routed(1000), E, 0),
                               (f"EP F={ep.numel()} EL={E // EP_RANKS} offset=16", ep,
                                E // EP_RANKS, 16),
                               (f"EP F={ep.numel()} EL={E // EP_RANKS} offset=48", ep,
                                E // EP_RANKS, 48),
                               (f"one expert F={ep.numel()} EL={E // EP_RANKS} offset=16",
                                torch.full_like(ep, 21), E // EP_RANKS, 16)):
        local = ids - off
        key = torch.where((local >= 0) & (local < el), local, el)
        cases.append(dict(
            kernel="token_counts", case=f"{name} (int64 ids)", args=(ids,),
            fn=lambda i, el=el, off=off: ops.token_counts(i, el, off),
            plain=lambda i, el=el, off=off: ref.token_counts_ref(i, el, off),
            library=lambda k, one, el=el: torch.zeros(el + 1, dtype=torch.int32,
                                                      device=DEV).scatter_add_(0, k, one),
            library_args=(key, torch.ones_like(key, dtype=torch.int32)),
            library_note="torch.zeros(EL + 1).scatter_add_ on the precomputed masked, "
                         "shifted ids (the port's former Stage 2 histogram)",
            bytes=8 * ids.numel() + 4 * el, flops=0.0, peak=BF16_TENSOR_FLOPS, tol="exact"))
    return cases


def dispatch_plan_cases(cfg, gen) -> list[dict]:
    """MoE Stages 2 and 3 at the paths' shapes, int64 ids from top-8 routing
    as the router emits them, in the pools the model sizes: a decode step (8
    tokens, 64 pairs) and prefills of 128, 512 and 1000 tokens in serving's
    dropless pool, a train microbatch (4096 tokens, 32,768 pairs) in the
    capacity pool, EP's gathered ids (65,536 pairs) for ranks 1 and 3
    (16 local experts from offsets 16 and 48), epso_train's (32,768
    pairs, 32 local experts from offset 32), launcher_ft's (2048 pairs, 4
    experts) and launcher_grid_ft's (1024 pairs, 2 local experts from
    offset 2). Exact equality of every
    output; the host's time to enqueue the plan and the plain chain (the
    sort-based index generation the kernel replaces); the kernel's one-block
    and three-launch paths timed on the same inputs (``variants``: the
    wrapper picks by ``SINGLE_BLOCK_MAX``). No single PyTorch call computes
    the plan."""
    import torch
    from repro_torch.core import moe
    from repro_torch.kernels import dispatch_plan as dp
    from repro_torch.kernels import ops, ref
    from repro_torch.serve.engine import dropless_cfg

    m = cfg.moe
    E, K, align = m.num_experts, m.experts_per_token, ops.gmm_align()
    EL = E // EP_RANKS

    def routed(T):
        return torch.rand((T, E), generator=gen, device=DEV).topk(K, dim=-1).indices

    def forced(single, el, off, rows, uniform=False):
        def call(i):
            saved = dp.SINGLE_BLOCK_MAX
            dp.SINGLE_BLOCK_MAX = 1 << 31 if single else 0
            try:
                return ops.dispatch_plan(i, el, off, rows, align, uniform)
            finally:
                dp.SINGLE_BLOCK_MAX = saved
        return call

    ep = routed(EP_RANKS * EP_SEQ)
    serve_m = dropless_cfg(cfg).moe
    shapes = [(f"decode T={T}" if T == 8 else f"prefill T={T}", routed(T), E, 0,
               moe.dispatch_pool_rows(T, serve_m)) for T in (8, 128, 512, 1000)]
    shapes += [(f"train F={TRAIN_TOKENS * K}", routed(TRAIN_TOKENS), E, 0,
                moe.dispatch_pool_rows(TRAIN_TOKENS, m))]
    shapes += [(f"EP F={ep.numel()} offset={off}", ep, EL, off,
                moe.dispatch_pool_rows(EP_RANKS * EP_SEQ, m, local_experts=EL))
               for off in (16, 48)]
    ELG = E // EPSO_EP
    shapes += [(f"epso F={EPSO_EP * EP_SEQ * K} offset={ELG}", routed(EPSO_EP * EP_SEQ), ELG,
                ELG, moe.dispatch_pool_rows(EPSO_EP * EP_SEQ, m, local_experts=ELG))]
    ft = launcher_ft_cfg().moe
    ft_T = FT_RUN["batch"] * FT_RUN["seq"]
    shapes += [(f"launcher_ft F={ft_T * ft.experts_per_token}",
                torch.rand((ft_T, ft.num_experts), generator=gen, device=DEV).topk(
                    ft.experts_per_token, dim=-1).indices, ft.num_experts, 0,
                moe.dispatch_pool_rows(ft_T, ft))]
    ftl = ft.num_experts // GRID_FT_EP
    shapes += [(f"launcher_grid_ft F={GRID_FT_TOKENS * ft.experts_per_token} offset={ftl}",
                torch.rand((GRID_FT_TOKENS, ft.num_experts), generator=gen, device=DEV).topk(
                    ft.experts_per_token, dim=-1).indices, ftl, ftl,
                moe.dispatch_pool_rows(GRID_FT_TOKENS, ft, local_experts=ftl))]
    shapes = [s + (False,) for s in shapes]
    # the all-to-all Stage 1 of epso_train's a2a mode (one EP_SEQ-token row a
    # rank, EPSO_EP ranks): the outer plan routes a rank's pairs to their
    # destination ranks in uniform groups of Cd rows; the inner plan takes
    # the EPSO_EP * Cd received rows, one pair each, among the rank's ELG
    # experts (an empty row holds the sentinel ELG)
    Cd = moe.round_up(math.ceil(A2A_CF * EP_SEQ * K / EPSO_EP), 8)
    shapes += [(f"a2a outer F={EP_SEQ * K} ep={EPSO_EP} Cd={Cd} uniform",
                routed(EP_SEQ) // ELG, EPSO_EP, 0, EPSO_EP * Cd, True)]
    fill = torch.rand((EPSO_EP * Cd,), generator=gen, device=DEV) < 0.8
    inner = torch.where(fill, torch.randint(0, ELG, (EPSO_EP * Cd,), generator=gen, device=DEV),
                        torch.full((EPSO_EP * Cd,), ELG, device=DEV))
    shapes += [(f"a2a inner F={EPSO_EP * Cd} K'=1", inner[:, None], ELG, 0,
                moe.round_up(moe.round_up(math.ceil(A2A_CF * EP_SEQ * K), 8), ELG * align),
                False)]
    cases = []
    for name, ids, el, off, rows, uni in shapes:
        F = ids.numel()
        cases.append(dict(
            kernel="dispatch_plan", case=f"{name} EL={el} pool={rows} (int64 ids)", args=(ids,),
            fn=lambda i, el=el, off=off, rows=rows, uni=uni: ops.dispatch_plan(
                i, el, off, rows, align, uni),
            plain=lambda i, el=el, off=off, rows=rows, uni=uni: ref.dispatch_plan_ref(
                i.reshape(-1), el, off, rows, align, uni),
            library=None, library_note="none: no single PyTorch call computes the plan",
            plain_host=True, variants={"one_block": forced(True, el, off, rows, uni),
                                       "three_launches": forced(False, el, off, rows, uni)},
            bytes=8 * F + 9 * F + 12 * el + 8 + 9 * rows, flops=0.0, peak=BF16_TENSOR_FLOPS,
            tol="exact"))
    return cases


TRAIN_TOKENS = 2 * 2048          # tokens per microbatch of the train phase


def train_kernel_cases(cfg, gen, randn, *, tokens: int = TRAIN_TOKENS, offset: int = 0,
                       local: int = 0, path: str = "", empty: int = 8) -> list[dict]:
    """The training step's kernel calls at its shapes: 4096 tokens per
    microbatch, the capacity pool of ``dispatch_pool_rows(4096)`` rows (the
    model's own capacity factor, so some pairs are dropped as in training),
    gmm forward and its transposed-rhs input gradient for both weight
    shapes, tgmm for both (and with empty groups), the combine and SwiGLU
    backward kernels. With ``local``, the same calls at ep_train's (or
    epso_train's) shapes: one EP rank's ``local`` experts from ``offset``
    among ``tokens`` gathered tokens (cases named "ep ..." or ``path``). ``path`` names the cases
    otherwise; ``empty``: how many of the model's last experts the tgmm case
    with empty groups leaves without rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    K, T = m.experts_per_token, tokens
    E = local or m.num_experts                 # the experts this dispatch holds
    path = path or ("ep" if local else "train")
    w_gate = randn(E, d, f, scale=d ** -0.5)
    w_down = randn(E, f, d, scale=f ** -0.5)
    cases = []
    gs, rows = _routing_groups(T, m, gen, offset=offset, local=local)
    total, active = int(gs.sum()), int((gs > 0).sum())
    for proj, w in (("gate", w_gate), ("down", w_down)):
        kin, nout = w.shape[1], w.shape[2]
        x = randn(rows, kin)
        plain = ref.gmm_ref(x.float(), w.float(), gs)
        lib, note = _grouped_mm_yardstick(
            lambda x, w, gs: torch._grouped_mm(x, w, offs=_offs(gs)), (x, w, gs), plain,
            rows_of=lambda y, n=total: y[:n])
        cases.append(dict(
            kernel="gmm", case=f"{path} {proj} M={rows} K={kin} N={nout} rows={total}",
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
            kernel="gmm", case=f"{path} dx {proj} (transposed rhs) M={rows} K={nout} N={kin} "
                               f"rows={total}",
            args=(dy, w, gs), fn=lambda dy, w, gs: ops.gmm_transposed(dy, w, gs),
            plain=lambda dy, w, gs: ref.gmm_ref(dy.float(), w.float().transpose(1, 2), gs),
            library=lib, library_note=note,
            bytes=2 * (total * nout + active * kin * nout + rows * kin),
            flops=2.0 * total * kin * nout, peak=BF16_TENSOR_FLOPS, tol="rel"))
    # dW[g] = x_g^T dy_g for both projections, and with the last ``empty``
    # experts of the model (the last groups of this dispatch) empty
    groups = [("gate", gs, total, rows, d, f), ("down", gs, total, rows, f, d)]
    gs_e, rows_e = _routing_groups(T, m, gen, experts=m.num_experts - empty, offset=offset,
                                   local=local)
    groups.append((f"gate, {empty} groups empty", gs_e, int(gs_e.sum()), rows_e, d, f))
    for proj, g_s, tot, M, kin, nout in groups:
        x, dy = randn(M, kin), randn(M, nout)
        plain = ref.tgmm_ref(x.float(), dy.float(), g_s, E)
        lib, note = _grouped_mm_yardstick(
            lambda x, dy, g_s: torch._grouped_mm(x.t(), dy, offs=_offs(g_s)), (x, dy, g_s),
            plain, what="torch._grouped_mm(x.t(), dy, offs) (2-D x 2-D)")
        cases.append(dict(
            kernel="tgmm", case=f"{path} {proj} M={M} K={kin} N={nout} rows={tot}",
            args=(x, dy, g_s), fn=ops.tgmm,
            plain=lambda x, dy, g_s: ref.tgmm_ref(x.float(), dy.float(), g_s, E),
            library=lib, library_note=note,
            bytes=2 * (tot * kin + tot * nout + E * kin * nout),
            flops=2.0 * tot * kin * nout, peak=BF16_TENSOR_FLOPS, tol="rel"))
    wts = torch.softmax(torch.randn((T, K), generator=gen, device=DEV), -1).to(torch.bfloat16)
    cases.append(dict(
        kernel="combine", case=f"{path} T={T} K={K} D={d}", args=(randn(T, K, d), wts),
        fn=ops.combine, plain=lambda r, w: ref.combine_ref(r.float(), w.float()),
        library=lambda r, w: torch.einsum("tkd,tk->td", r, w),
        bytes=2 * (T * K * d + T * K + T * d), flops=2.0 * T * K * d, peak=FP32_FLOPS,
        tol="rel"))
    cases.append(dict(
        kernel="combine_bwd", case=f"{path} T={T} K={K} D={d}",
        args=(randn(T, K, d), wts, randn(T, d)), fn=ops.combine_bwd,
        plain=lambda r, w, g: ref.combine_bwd_ref(r.float(), w.float(), g.float()),
        library=lambda r, w, g: (w[..., None] * g[:, None, :],
                                 torch.einsum("tkd,td->tk", r, g)),
        library_note="2 PyTorch calls: w[..., None] * dout[:, None, :] and "
                     "einsum('tkd,td->tk', rows, dout)",
        bytes=2 * (2 * T * K * d + T * K + T * d) + 4 * T * K, flops=3.0 * T * K * d,
        peak=FP32_FLOPS, tol="rel"))
    cases.append(_pool_gathers_bwd_case(m, d, T, gen, randn, path, offset, local))
    g, u, dh = randn(rows, f, scale=3.0), randn(rows, f), randn(rows, f)
    cases.append(dict(
        kernel="swiglu", case=f"{path} M={rows} N={f}", args=(g, u),
        fn=ops.fused_swiglu, plain=lambda g, u: ref.swiglu_ref(g.float(), u.float()),
        library=lambda g, u: F.silu(g) * u,
        bytes=3 * 2 * rows * f, flops=5.0 * rows * f, peak=FP32_FLOPS, tol="1ulp"))
    cases.append(dict(
        kernel="swiglu_bwd", case=f"{path} M={rows} N={f}", args=(g, u, dh),
        fn=ops.swiglu_bwd,
        plain=lambda g, u, d: ref.swiglu_bwd_ref(g.float(), u.float(), d.float()),
        library=lambda g, u, d: (torch.ops.aten.silu_backward(d * u, g), d * F.silu(g)),
        library_note="4 PyTorch calls: aten.silu_backward(dout * up, gate) and "
                     "dout * silu(gate)",
        bytes=5 * 2 * rows * f, flops=12.0 * rows * f, peak=FP32_FLOPS, tol="rel"))
    return cases


def _pool_gathers_bwd_case(m, d, T, gen, randn, path, offset, local) -> dict:
    """The backward of the gathers into the slot pool and out of it (plain
    PyTorch around one combine launch: ``moe.pool_gather_backward`` and
    ``combine_gather_backward``) for one dispatch of T tokens, against the
    indexing ops' backward it replaced (the yardstick: two
    ``index_put_(accumulate=True)``, a sort-based scatter-add, in bf16) and
    the same scatter-adds in float32 (the plain version)."""
    import torch
    from repro_torch.core import moe
    from repro_torch.kernels import ops

    K = m.experts_per_token
    ids = torch.rand((T, m.num_experts), generator=gen, device=DEV).topk(K, dim=-1).indices
    rows = moe.dispatch_pool_rows(T, m, local_experts=local)
    plan = moe.make_dispatch_plan(ids, num_experts=m.num_experts, pool_rows=rows,
                                  align=ops.gmm_align(), expert_offset=offset,
                                  local_experts=local)
    safe = torch.clamp(plan.slot, max=rows - 1)
    inv_token = plan.inv_pair // K

    def gathers(d_pool, d_yk):
        return (moe.pool_gather_backward(d_pool, safe, plan.valid, K),
                moe.combine_gather_backward(d_yk, plan.inv_pair, plan.pool_valid))

    def scatters(d_pool, d_yk):
        dx = torch.zeros((T, d), dtype=d_pool.dtype, device=DEV).index_put_(
            (inv_token,), d_pool * plan.pool_valid[:, None].to(d_pool.dtype), accumulate=True)
        dp = torch.zeros((rows, d), dtype=d_yk.dtype, device=DEV).index_put_(
            (safe,), d_yk * plan.valid[:, None].to(d_yk.dtype), accumulate=True)
        return dx, dp

    pairs = int(plan.valid.sum())
    return dict(
        kernel="pool_gathers_bwd", case=f"{path} T={T} K={K} D={d} pool={rows} pairs={pairs}",
        args=(randn(rows, d), randn(T * K, d)), fn=gathers,
        plain=lambda dp, dy: scatters(dp.float(), dy.float()), library=scatters,
        library_note="the indexing ops' backward it replaced: 2 index_put_(accumulate=True) "
                     "and their masks, bf16",
        bytes=2 * (2 * pairs * d + T * d + rows * d) + 8 * (T * K + rows) + T * K + rows,
        flops=2.0 * pairs * d, peak=FP32_FLOPS, tol="rel")


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
    device time (CUDA graph, inputs cold in L2), its eager time, the host's
    time to enqueue one call, the plain version's time and the library
    call's (CUDA graph, cold)."""
    import torch
    results = []
    for c in kernel_cases(cfg):
        args = c["args"]
        if "zero_rows_from" in c:   # the output's memory holds NaN before the call
            dirty = torch.full(c["out_shape"], float("nan"), dtype=torch.bfloat16, device=DEV)
            del dirty
        outs = c["fn"](*args)
        plains = c["plain"](*args)
        torch.cuda.synchronize()
        if "zero_rows_from" in c and not bool((outs[c["zero_rows_from"]:] == 0).all()):
            raise AssertionError(f"{c['kernel']} {c['case']}: rows past the total not 0")
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
            elif c["tol"] == "exact":
                err = float((out.long() - plain.long()).abs().max())
                ok, tol_txt = out.dtype == plain.dtype and err == 0, "exact equality"
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
               "eager_ms": time_ms(c["fn"], args), "host_us": host_us(c["fn"], args),
               "plain_ms": time_ms(c["plain"], args, iters=3, warmup=1),
               "library_ms": (graph_ms(c["library"], c.get("library_args", args))
                              if c["library"] else None),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": c["bytes"], "flops": c["flops"]}
        if c.get("library_note"):
            row["library_note"] = c["library_note"]
        if c.get("plain_host"):
            row["plain_host_us"] = host_us(c["plain"], args, calls=5, rounds=3)
        if c.get("variants"):
            plains = c["plain"](*args)
            for name, fn in c["variants"].items():
                if not all(torch.equal(a, b) for a, b in zip(fn(*args), plains)):
                    raise AssertionError(f"{c['kernel']} {c['case']}: {name} differs")
            row["variant_ms"] = {name: graph_ms(fn, args) for name, fn in c["variants"].items()}
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

def _fixed_batch(vocab: int, batch: int, seq: int, device, seed: int = 0) -> dict:
    """One batch of next-token pairs from a seeded ``torch.Generator``."""
    import torch
    toks = torch.randint(0, vocab, (batch, seq + 1),
                         generator=torch.Generator().manual_seed(seed))
    return {"tokens": toks[:, :-1].to(device), "labels": toks[:, 1:].to(device)}


def _state_bytes(state) -> int:
    """fp32 params share their storage with the master weights: counted once."""
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for t in {
        t.data_ptr(): t for tree in (state.params, state.opt.master, state.opt.m, state.opt.v)
        for t in leaves(tree)}.values())


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
    """Launches per training run (per rank under EP) under block remat. Per
    layer and microbatch: forward token_counts (the router's aux histogram),
    dispatch_plan, gmm x3, SwiGLU, combine; the backward recomputes that
    forward, then gmm x3 for dx (transposed rhs), tgmm x3 for dW, one
    swiglu_bwd, one combine_bwd and one combine (the token gather's
    backward, which sums each token's pool rows). Attention is the plain
    blockwise path."""
    n = num_layers * microbatches * steps
    return {"gmm": 9 * n, "tgmm": 3 * n, "swiglu": 2 * n, "swiglu_bwd": n,
            "combine": 3 * n, "combine_bwd": n, "flash_attention": 0, "ssd_intra_chunk": 0,
            "token_counts": 2 * n, "dispatch_plan": 2 * n}


def expected_pp_launches(num_layers: int, microbatches: int, steps: int,
                         whole_pool: bool = False) -> dict:
    """``expected_train_launches`` of one pipeline stage of ``num_layers``
    layers: the forward tick runs each layer's forward once more, without
    autograd, before the backward tick's forward, remat recompute and
    backward (three forwards in all). ``whole_pool`` (capacity dispatch
    under EP): each forward also makes the one-device dispatch plan of the
    gathered tokens."""
    n = num_layers * microbatches * steps
    out = expected_train_launches(num_layers, microbatches, steps)
    for k, extra in (("gmm", 3), ("swiglu", 1), ("combine", 1), ("token_counts", 1),
                     ("dispatch_plan", 1 + 3 * whole_pool)):
        out[k] += extra * n
    return out


def expected_a2a_launches(num_layers: int, microbatches: int, steps: int) -> dict:
    """``expected_train_launches`` under the all-to-all Stage 1: per layer
    and microbatch two dispatch plans a forward (the uniform outer plan
    into the send buffers, the inner plan of the received rows) and two
    combines a forward (the inner K' = 1 weighting, the sum of a token's K
    rows at the source), each with its combine_bwd; the backward gathers
    of the send buffers and of the inner pool each sum with one combine."""
    n = num_layers * microbatches * steps
    return {"gmm": 9 * n, "tgmm": 3 * n, "swiglu": 2 * n, "swiglu_bwd": n,
            "combine": 6 * n, "combine_bwd": 2 * n, "flash_attention": 0, "ssd_intra_chunk": 0,
            "token_counts": 2 * n, "dispatch_plan": 4 * n}


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
    state_bytes = _state_bytes(state)
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
              "dispatch_plan": cfg.num_layers * (prefills + steps), "token_counts": 0,
              "flash_attention": cfg.num_layers * prefills,
              "tgmm": 0, "swiglu_bwd": 0, "combine_bwd": 0, "ssd_intra_chunk": 0}
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
    decode_events = profiles["profile_decode_3_steps"]["device_events"]
    emit("serve_launches", decode_steps=3, layers=cfg.num_layers,
         device_events_decode_window=decode_events,
         device_launches_per_step_per_layer=decode_events / (3 * cfg.num_layers))

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


# the CUDA kernels of csrc/ by function name, for the profiles' totals
PORT_KERNELS = ("gmm_kernel", "tgmm_kernel", "swiglu_kernel", "swiglu_bwd_kernel",
                "combine_kernel", "combine_bwd_kernel", "flash_fwd_kernel",
                "ssd_intra_chunk_kernel", "token_counts_kernel", "plan_single_kernel",
                "plan_count_kernel", "plan_scan_kernel", "plan_rank_kernel")


def _kernel_kind(name: str) -> str:
    """A device event's kind, from its name: the port's own kernels, GEMMs
    in float32 (SIMT / FFMA: no tensor cores) or on tensor cores (cuBLAS's
    ``nvjet`` kernels among them), PyTorch's elementwise, reduction and
    indexing kernels, copies and fills."""
    if any(f"::{k}(" in name or f"::{k}<" in name for k in PORT_KERNELS):
        return "port_kernels"
    low = name.lower()
    if any(w in low for w in ("gemm", "xmma", "cutlass", "wgmma", "nvjet")):
        return "gemm_f32" if any(w in low for w in ("sgemm", "ffma", "f32f32_f32f32")) \
            else "gemm_tensor_core"
    for kind, words in (("index", ("index", "gather", "scatter")),
                        ("elementwise", ("elementwise",)), ("reduce", ("reduce",)),
                        ("copy_fill", ("memcpy", "memset", "copy", "fill"))):
        if any(w in low for w in words):
            return kind
    return "other"


def _profile_window(run, host_prefixes: tuple = (), cpu: bool = True) -> dict:
    """torch.profiler over ``run()``: the host's wall time, the device's
    busy time (sum of its kernel and copy times; one stream, so they do not
    overlap), the idle share, the ten device kernels that took longest,
    the device time by kind of kernel (``_kernel_kind``, with each kind's
    longest kernel by name) and the total time
    and calls of each of the port's own kernels;
    with ``host_prefixes``, also the host events whose names start with one
    of them, summed by name (the collectives under EP). The spans gloo
    records on the device timeline for its collectives on CUDA tensors are
    listed apart (``gloo_device_spans``), not counted as busy. ``cpu=False``
    records the device alone and reads the raw records (a window of
    hundreds of thousands of small launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list[float]] = {}
    host: dict[str, list[float]] = {}
    gloo_on_device: dict[str, list[float]] = {}
    if cpu:
        events = [(e.name, e.device_type, e.time_range.elapsed_us() / 1e3)
                  for e in prof.events()]
    else:       # the raw records: building the event tree takes minutes at this size
        events = [(e.name(), e.device_type(), e.duration_ns() / 1e6)
                  for e in prof.profiler.kineto_results.events()]
    for name, device_type, ms in events:
        if device_type == DeviceType.CUDA and name.startswith("gloo:"):
            # gloo's CUDA work records its collective's span on the device
            # timeline: a wait, not a kernel; kept out of the busy time
            gloo_on_device.setdefault(name, []).append(ms)
        elif device_type == DeviceType.CUDA:
            by_name.setdefault(name, []).append(ms)
        elif host_prefixes and name.startswith(host_prefixes):
            host.setdefault(name, []).append(ms)
    busy = sum(sum(v) for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]
    port: dict[str, dict] = {}
    kinds: dict[str, dict] = {}
    for n, v in by_name.items():
        e = kinds.setdefault(_kernel_kind(n), {"ms": 0.0, "calls": 0, "top": ("", 0.0)})
        e["ms"] += sum(v)
        e["calls"] += len(v)
        e["top"] = max(e["top"], (n[:80], sum(v)), key=lambda t: t[1])
        for k in PORT_KERNELS:
            if f"::{k}(" in n or f"::{k}<" in n:
                e = port.setdefault(k, {"ms": 0.0, "calls": 0})
                e["ms"] += sum(v)
                e["calls"] += len(v)
    out = {"wall_ms": wall_ms,
           "device_busy_ms": busy if by_name else None,
           "device_events": sum(len(v) for v in by_name.values()),
           "device_idle_share": 1 - busy / wall_ms if by_name else None,
           "top_device_kernels": [{"name": n[:100], "ms": sum(v), "calls": len(v)}
                                  for n, v in top],
           "device_ms_by_kind": dict(sorted(kinds.items(), key=lambda kv: -kv[1]["ms"])),
           "port_kernels": port}
    if host_prefixes:
        out["host_events"] = {n: {"ms": sum(v), "calls": len(v)} for n, v in host.items()}
    if gloo_on_device:
        out["gloo_device_spans"] = {n: {"ms": sum(v), "calls": len(v)}
                                    for n, v in gloo_on_device.items()}
    return out


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
# hybrid (Mamba-2) serving: a small model against the CPU, then full width
# ----------------------------------------------------------------------------

def _hybrid_small_cfg():
    """Reduced Zamba2-7B with 2 groups of 3 Mamba-2 layers and 1 remaining
    layer (d_model 256, 4 heads of 64, SSM heads of 32, d_state 16, chunk
    16): ``reduced`` alone keeps a shared block every 2 layers."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(ZAMBA), layers=7), shared_attn_every=3)


def phase_hybrid_reference() -> dict:
    """The reduced hybrid model from the same bf16 weights on the card (bf16,
    through the kernels) and on the CPU (float32, plain versions): the
    prefill step's last logits over 2 prompts of 45 tokens (not a multiple
    of the chunk), then the prompts stepped through the serve step, as a
    recurrent arch prefills, and 4 greedy steps fed the CPU's tokens."""
    import torch
    from repro_torch.models import init_cache, init_params
    from repro_torch.train import make_prefill_step, make_serve_step

    cfg = _hybrid_small_cfg()
    p_gpu = init_params(cfg, seed=0, device=DEV, dtype=torch.bfloat16)

    def to_cpu(t):
        return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.float().cpu()

    p_cpu = to_cpu(p_gpu)
    P, new = 45, 4
    toks = torch.randint(0, cfg.vocab_size, (2, P), generator=torch.Generator().manual_seed(0))
    sides = {"gpu": (p_gpu, DEV, torch.bfloat16), "cpu": (p_cpu, "cpu", torch.float32)}
    last = {k: make_prefill_step(cfg, compute_dtype=dt, device=dev)(p, {"tokens": toks})
            .float().cpu() for k, (p, dev, dt) in sides.items()}
    errs = [float((last["gpu"] - last["cpu"]).abs().max() / last["cpu"].abs().max())]
    steps = {k: make_serve_step(cfg, compute_dtype=dt, device=dev)
             for k, (p, dev, dt) in sides.items()}
    caches = {k: init_cache(cfg, 2, P + new, device=dev, dtype=dt)
              for k, (p, dev, dt) in sides.items()}
    logits = {}
    for t in range(P):
        for k, (p, _, _) in sides.items():
            logits[k], caches[k] = steps[k](p, toks[:, t:t + 1], caches[k], t)
    agree, total = 0, 0
    for i in range(new + 1):
        lg, lc = logits["gpu"][:, 0].float().cpu(), logits["cpu"][:, 0]
        errs.append(float((lg - lc).abs().max() / lc.abs().max()))
        g_tok, c_tok = lg[:, :cfg.vocab_size].argmax(-1), lc[:, :cfg.vocab_size].argmax(-1)
        agree += int((g_tok == c_tok).sum())
        total += g_tok.numel()
        if i == new:
            break
        for k, (p, _, _) in sides.items():
            logits[k], caches[k] = steps[k](p, c_tok[:, None], caches[k], P + i)
    h_err = float((caches["gpu"]["groups"]["h"].cpu() - caches["cpu"]["groups"]["h"]).abs().max()
                  / caches["cpu"]["groups"]["h"].abs().max())
    tol = 3e-2
    row = {"config": cfg.name, "layers": cfg.num_layers, "shared_attn_every": 3,
           "prompt": P, "rel_logit_err": errs, "tolerance": tol,
           "greedy_agreement": f"{agree}/{total}", "ssm_state_rel_err": h_err}
    emit("hybrid_reference", **row)
    if not max(errs) <= tol:
        raise AssertionError(f"hybrid_reference: logits differ by {max(errs)} of max|ref| > {tol}")
    return row


HYBRID_PROMPTS, HYBRID_PROMPT_LEN, HYBRID_NEW = 8, 128, 64
# The forward prefill against the stepped decode at full depth, both bf16 on
# the card: the two paths round on their own (other GEMM shapes, so other
# bf16 roundings of dt, x, B, C) through 81 Mamba-2 layers and 13 shared
# blocks. hybrid_reference holds each path to the f32 CPU path within 3e-2
# over 7 layers and 2 shared blocks; 94 blocks stack ~10x as many roundings,
# so ~3x the error of two such paths, ~0.1. 0.25 leaves room above that and
# stays far below the O(1) that a wrong state carry or chunk boundary
# gives. Near-ties of random-weight logits can swap a top-1, so the decode's
# top-1 token must be among the forward's top 5; exact agreement is reported.
IDENTITY_TOL = 0.25
IDENTITY_TOPK = 5


HYBRID_DEPTHS = (7, 20)       # and all 81: the full model's own comparison


def _identity_by_depth(params, cfg, prompts, prefill, serve) -> dict:
    """The forward prefill against the stepped decode (relative to
    max|logit|) for the first d Mamba-2 layers of the loaded weights, d in
    ``HYBRID_DEPTHS``: the groups cut to d // every and the next d % every
    layers as the remainder, views of the same tensors. bf16 rounding grows
    the gap smoothly with depth; a fault in the state carry jumps."""
    import dataclasses

    import torch
    from repro_torch.models import init_cache
    from repro_torch.models.model import hybrid_layout
    from repro_torch.train import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_map

    out = {}
    _, every, _ = hybrid_layout(cfg)
    B, P = prompts.shape
    for d in HYBRID_DEPTHS:
        n_g, r = divmod(d, every)
        cut = dataclasses.replace(cfg, num_layers=d)
        p = {k: v for k, v in params.items() if k not in ("groups", "rem")}
        p["groups"] = tree_map(lambda t, n=n_g: t[:n], params["groups"])
        if r:
            p["rem"] = tree_map(lambda t, n=n_g, r=r: t[n, :r], params["groups"])
        fwd = make_prefill_step(cut, device=DEV)(p, {"tokens": prompts}).float()
        step = make_serve_step(cut, device=DEV)
        cache = init_cache(cut, B, P, device=DEV, dtype=torch.bfloat16)
        for t in range(P):
            logits, cache = step(p, prompts[:, t:t + 1], cache, t)
        dec = logits[:, 0].float()
        out[str(d)] = float((fwd - dec).abs().max() / fwd.abs().max())
    return out


def expected_hybrid_launches(prefills: int) -> dict:
    """Per prefill call of full-depth Zamba2-7B: one SSD intra-chunk launch
    per Mamba-2 layer and one flash launch per application of the shared
    block; a decode step launches none of the port's kernels."""
    from repro_torch.kernels import ops
    out = dict.fromkeys(ops.launches, 0)
    out.update(ssd_intra_chunk=81 * prefills, flash_attention=13 * prefills)
    return out


def phase_hybrid_serve() -> dict:
    """Full-width, full-depth Zamba2-7B in bf16 (random weights from seed
    0): (a) make_prefill_step over a (2, 4096) and a (1, 1000) batch; (b)
    8 prompts of 128 tokens stepped through make_serve_step, then 64
    greedy tokens; (c) the forward prefill of the same prompts against the
    stepped decode at position 127; (d) exact launch counts; (e) one
    profiled prefill and one profiled decode step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_cache, init_params, padded_vocab
    from repro_torch.train import make_prefill_step, make_serve_step
    from repro_torch.tree import leaves

    cfg = get_config(ZAMBA)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=DEV, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    prefill = make_prefill_step(cfg, device=DEV)
    serve = make_serve_step(cfg, device=DEV)
    gen = torch.Generator().manual_seed(0)
    batches = {"2x4096": torch.randint(0, cfg.vocab_size, (2, 4096), generator=gen),
               "1x1000": torch.randint(0, cfg.vocab_size, (1, 1000), generator=gen)}
    prompts = torch.randint(0, cfg.vocab_size, (HYBRID_PROMPTS, HYBRID_PROMPT_LEN),
                            generator=gen)
    for b in batches.values():                     # warm-up (first cuBLAS use), not counted
        prefill(params, {"tokens": b})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    n_prefill = 0
    prefill_ms, per_call = {}, None
    for name, b in batches.items():
        times = []
        for _ in range(3):
            before = dict(ops.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = prefill(params, {"tokens": b})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            n_prefill += 1
            per_call = {k: ops.launches[k] - before[k] for k in before}
            if per_call != expected_hybrid_launches(1):
                raise AssertionError(f"hybrid prefill {name}: launches {per_call}")
            if not torch.isfinite(last.float()).all() or tuple(last.shape) != (
                    b.shape[0], padded_vocab(cfg)):
                raise AssertionError(f"hybrid prefill {name}: bad logits {tuple(last.shape)}")
        prefill_ms[name] = times
    prefill_peak = torch.cuda.max_memory_allocated()

    # (b) step the prompts, then generate greedily
    torch.cuda.reset_peak_memory_stats()
    B, P = HYBRID_PROMPTS, HYBRID_PROMPT_LEN
    cache = init_cache(cfg, B, P + HYBRID_NEW, device=DEV, dtype=torch.bfloat16)
    step_ms, gen_tokens = [], []
    before = dict(ops.launches)
    for t in range(P):
        logits, cache = serve(params, prompts[:, t:t + 1], cache, t)
    stepped_last = logits[:, 0].float()
    if {k: ops.launches[k] - before[k] for k in before} != expected_hybrid_launches(0):
        raise AssertionError(f"hybrid decode launched kernels: {ops.launches}")
    tok = stepped_last[:, :cfg.vocab_size].argmax(-1)[:, None]
    torch.cuda.synchronize()
    t_gen = time.perf_counter()
    for i in range(HYBRID_NEW):
        gen_tokens.append(tok[:, 0])
        t0 = time.perf_counter()
        logits, cache = serve(params, tok, cache, P + i)
        tok = logits[:, 0, :cfg.vocab_size].argmax(-1)[:, None]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    gen_s = time.perf_counter() - t_gen
    decode_peak = torch.cuda.max_memory_allocated()
    out = torch.stack(gen_tokens, 1).cpu()
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError("hybrid decode: token ids out of range")

    # (c) the forward prefill of the same prompts against the stepped decode
    fwd_last = prefill(params, {"tokens": prompts}).float()
    n_prefill += 1
    rel = float((fwd_last - stepped_last).abs().max() / fwd_last.abs().max())
    top1_fwd = fwd_last[:, :cfg.vocab_size].argmax(-1)
    top1_dec = stepped_last[:, :cfg.vocab_size].argmax(-1)
    topk_fwd = fwd_last[:, :cfg.vocab_size].topk(IDENTITY_TOPK, -1).indices
    in_topk = bool((topk_fwd == top1_dec[:, None]).any(-1).all())
    launches = dict(ops.launches)
    expect = expected_hybrid_launches(n_prefill)
    if launches != expect:
        raise AssertionError(f"hybrid: kernel launches {launches} != expected {expect}")
    depth = _identity_by_depth(params, cfg, prompts, prefill, serve)
    depth[str(cfg.num_layers)] = rel
    emit("hybrid_depth", mamba_layers=list(depth), identity_rel_logit_err=depth,
         note="forward prefill against stepped decode at the last prompt position, the "
              "first d Mamba-2 layers of the same weights (bf16 on the card)")

    # (e) where the time goes
    profile_prefill = _profile_window(lambda: prefill(params, {"tokens": batches["2x4096"]}))
    profile_decode = _profile_window(lambda: serve(params, tok, cache, P + HYBRID_NEW - 1))

    pf = {k: statistics.median(v) for k, v in prefill_ms.items()}
    row = {"model": cfg.name, "params": n_params, "param_init_s": init_s,
           "prefill_ms": prefill_ms, "prefill_ms_median": pf,
           "prefill_tokens_per_s": {k: batches[k].numel() / pf[k] * 1e3 for k in pf},
           "prefill_max_memory_allocated_bytes": prefill_peak,
           "prompts": B, "prompt_len": P, "new_tokens_each": HYBRID_NEW,
           "decode_step_ms_median": statistics.median(step_ms),
           "output_tokens_per_s": B * HYBRID_NEW / gen_s,
           "decode_max_memory_allocated_bytes": decode_peak,
           "identity_rel_logit_err": rel, "identity_tolerance": IDENTITY_TOL,
           "identity_rel_logit_err_by_depth": depth,
           "identity_top1_agreement": f"{int((top1_fwd == top1_dec).sum())}/{B}",
           f"identity_decode_top1_in_forward_top{IDENTITY_TOPK}": in_topk,
           "launches": launches, "expected_launches": expect,
           "launches_per_prefill": per_call,
           "profile_prefill_2x4096": profile_prefill, "profile_decode_step_8": profile_decode}
    emit("hybrid_serve", **row)
    if not rel <= IDENTITY_TOL or not in_topk:
        raise AssertionError(f"hybrid: forward vs stepped decode rel err {rel} (tol "
                             f"{IDENTITY_TOL}), decode top-1 in forward top-{IDENTITY_TOPK}: "
                             f"{in_topk}")
    return row


# ----------------------------------------------------------------------------
# the state-space models train: Zamba2 (hybrid) through the plain chunked SSD;
# falcon-mamba (Mamba-1) is served and trained through its time loop
# ----------------------------------------------------------------------------

FALCON = "falcon-mamba-7b"
# hybrid_train: Zamba2-7B at full width, 2 groups of 6 Mamba-2 layers and 1
# remaining (the 81 layers' fp32 state and gradients, ~108 GB, exceed 80 GB)
HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_STEPS = 13, 6
HYBRID_TRAIN_SEQ, HYBRID_TRAIN_BATCH, HYBRID_TRAIN_MB = 4096, 2, 2
HYBRID_REF_SEQ, HYBRID_REF_STEPS = 200, 3          # 200: not a multiple of the chunk
# one train step on the card (float32) against the CPU: the same plain
# float32 math, summed in another order; three AdamW steps
HYBRID_REF_TOL = 1e-3
# ssm_serve: falcon-mamba-7b whole; prefill (2, 1024); 2 prompts of 128
# tokens stepped through the serve step, then 32 greedy tokens each
SSM_SERVE_ROWS, SSM_PREFILL_LEN, SSM_PROMPT_LEN, SSM_NEW = 2, 1024, 128, 32
SSM_DEPTHS = (16,)            # and all 64: the forward against the stepped decode
# ssm_train: falcon-mamba-7b at full width, 2 of 64 layers (64 need ~116 GB;
# 8, then 4, until the smoke's time limit pressed: the phase is host-bound,
# its time goes with the layer count, ~6 s a layer and step)
SSM_TRAIN_LAYERS, SSM_TRAIN_SEQ, SSM_TRAIN_BATCH, SSM_TRAIN_STEPS = 2, 2048, 2, 4
# launcher_ssm: both archs reduced, through the launcher as launcher_dense runs
LAUNCHER_SSM_RUNS = {
    ZAMBA: dict(scale="smoke", d_model=512, layers=5, steps=6, batch=4, seq=256,
                ckpt_interval=3, compute_dtype="bfloat16", log_every=100),
    FALCON: dict(scale="smoke", d_model=512, layers=2, steps=6, batch=4, seq=256,
                 ckpt_interval=3, compute_dtype="bfloat16", log_every=100)}


def _no_launches() -> dict:
    from repro_torch.kernels import ops
    return dict.fromkeys(ops.launches, 0)


def phase_hybrid_train_reference() -> dict:
    """The reduced hybrid model (``_hybrid_small_cfg``: 2 groups of 3 Mamba-2
    layers and 1 remaining) takes ``HYBRID_REF_STEPS`` make_train_step steps
    (2 microbatches of 2 x 200 tokens, 200 not a multiple of the 16-token
    chunk) from the same fp32 weights and AdamW state on the card and on the
    CPU, both in float32: the card runs the same plain chunked-SSD math as
    the CPU (the SSD kernel is forward only) and launches no port kernel.
    Loss and grad norm must agree within ``HYBRID_REF_TOL`` relative at
    every step; the params' worst leaf after the steps is reported."""
    from repro_torch.configs import ParallelConfig, TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainState, init_state, make_train_step
    from repro_torch.tree import leaves_with_path, tree_map

    cfg = _hybrid_small_cfg()
    train = TrainConfig(seq_len=HYBRID_REF_SEQ, global_batch=4, warmup_steps=1, total_steps=10,
                        lr_peak=1e-3, lr_min=1e-4, compute_dtype="float32",
                        grad_reduce_dtype="float32")
    par = ParallelConfig(microbatches=2)
    s_gpu = init_state(cfg, train, seed=0, device=DEV)
    p_cpu = tree_map(lambda p: p.detach().cpu().clone(), s_gpu.params)
    sides = {"gpu": [s_gpu, make_train_step(cfg, par, train)],
             "cpu": [TrainState(p_cpu, adamw_init(p_cpu)), make_train_step(cfg, par, train)]}
    keys = ("loss", "grad_norm", "clip_scale")
    hist = {"gpu": [], "cpu": []}
    ops.reset_launches()
    for i in range(HYBRID_REF_STEPS):
        for side, (state, step) in sides.items():
            batch = _fixed_batch(cfg.vocab_size, 4, HYBRID_REF_SEQ,
                                 DEV if side == "gpu" else "cpu", seed=i)
            state, m = step(state, batch)
            sides[side][0] = state
            hist[side].append({k: float(m[k]) for k in keys})
    launches = dict(ops.launches)
    rel = [{k: abs(g[k] - c[k]) / abs(c[k]) for k in ("loss", "grad_norm")}
           for g, c in zip(hist["gpu"], hist["cpu"])]
    cpu_leaves = dict(leaves_with_path(sides["cpu"][0].params))
    leaf_err = {k: float((t.detach().float().cpu() - cpu_leaves[k]).abs().max()
                         / cpu_leaves[k].abs().max().clamp_min(1e-30))
                for k, t in leaves_with_path(sides["gpu"][0].params)}
    worst = max(leaf_err, key=leaf_err.get)
    row = {"config": cfg.name, "layers": cfg.num_layers, "shared_attn_every": 3,
           "seq_len": HYBRID_REF_SEQ, "microbatches": par.microbatches,
           "steps": HYBRID_REF_STEPS, "gpu": hist["gpu"], "cpu": hist["cpu"], "rel_err": rel,
           "tolerance": HYBRID_REF_TOL, "worst_param_leaf": worst,
           "worst_param_leaf_rel_err": leaf_err[worst], "launches": launches}
    emit("hybrid_train_reference", **row)
    if launches != _no_launches():
        raise AssertionError(f"hybrid_train_reference: training launched kernels {launches}")
    bad = [r for r in rel if not max(r.values()) <= HYBRID_REF_TOL]
    if bad:
        raise AssertionError(f"hybrid_train_reference: relative errors {rel} above "
                             f"{HYBRID_REF_TOL}")
    if not all(math.isfinite(v) for h in hist["gpu"] for v in h.values()):
        raise AssertionError(f"hybrid_train_reference: metrics {hist['gpu']} not finite")
    return row


def _hybrid_train_split(cfg, params, mb_rows: int) -> dict:
    """Device time of the pieces a hybrid train step runs, each profiled
    alone at the step's shapes (one microbatch of ``mb_rows`` rows): one
    Mamba-2 layer's chunked SSD (the plain intra-chunk einsums and the
    inter-chunk loop) forward, and forward + backward; one application of
    the shared block's attention (projections and plain blockwise
    attention) forward + backward. Per step, under block remat, each SSD
    runs forward twice and backward once per layer and microbatch; the
    shared block (no block remat) forward and backward once per
    application and microbatch."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models.model import hybrid_layout

    d, di, H, P, N, _ = S.mamba2_dims(cfg)
    T = HYBRID_TRAIN_SEQ
    gen = torch.Generator(device=DEV).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype).requires_grad_()

    x, Bm, Cm = rand(mb_rows, T, H, P), rand(mb_rows, T, N), rand(mb_rows, T, N)
    dt = torch.nn.functional.softplus(rand(mb_rows, T, H, dtype=torch.float32).detach() - 4.0)
    dt.requires_grad_()
    A = (-torch.exp(params["groups"]["mixer"]["A_log"][0, 0].detach().float())).requires_grad_()
    gy = torch.randn((mb_rows, T, H, P), generator=gen, device=DEV)

    def ssd_fwd():
        S._ssd_chunked(x, dt, Bm, Cm, A, cfg.ssm.chunk)

    def ssd_fwd_bwd():
        y, _ = S._ssd_chunked(x, dt, Bm, Cm, A, cfg.ssm.chunk)
        torch.autograd.grad(y, (x, dt, Bm, Cm, A), gy)

    h = rand(mb_rows, T, d)
    attn_p = {k: v.detach().requires_grad_() for k, v in params["shared"]["attn"].items()}
    gh = torch.randn((mb_rows, T, d), generator=gen, device=DEV).bfloat16()

    def attn_fwd_bwd():
        out = L.attention(attn_p, h, cfg, impl="blockwise")
        torch.autograd.grad(out, [h, *attn_p.values()], gh)

    ssd_fwd_bwd()
    attn_fwd_bwd()                         # warm-up: cuBLAS plans, the allocator
    windows = {"ssd_fwd": _profile_window(ssd_fwd), "ssd_fwd_bwd": _profile_window(ssd_fwd_bwd),
               "shared_attention_fwd_bwd": _profile_window(attn_fwd_bwd)}
    n_group, _, _ = hybrid_layout(cfg)
    mbs = HYBRID_TRAIN_MB
    per_step = {"ssd": cfg.num_layers * mbs, "shared_attention": n_group * mbs}

    def by_kind(*ws, scale):
        out = {}
        for w in ws:
            for k, v in w["device_ms_by_kind"].items():
                out[k] = out.get(k, 0.0) + v["ms"] * scale
        return out

    ssd = by_kind(windows["ssd_fwd"], windows["ssd_fwd_bwd"], scale=per_step["ssd"])
    attn = by_kind(windows["shared_attention_fwd_bwd"], scale=per_step["shared_attention"])
    return {"windows": {k: {f: w[f] for f in ("wall_ms", "device_busy_ms", "device_events",
                                               "device_ms_by_kind")}
                        for k, w in windows.items()},
            "calls_per_step": per_step,
            "ssd_ms_per_step_by_kind": ssd, "ssd_ms_per_step": sum(ssd.values()),
            "shared_attention_ms_per_step_by_kind": attn,
            "shared_attention_ms_per_step": sum(attn.values())}


def phase_hybrid_train() -> dict:
    """Zamba2-7B at full width cut to HYBRID_TRAIN_LAYERS layers (2 groups
    of 6 Mamba-2 layers, each followed by the shared block, and 1 remaining
    layer; random weights from seed 0, fp32 params and AdamW state, bf16
    compute, block remat) takes 6 steps on one fixed batch of 2 x 4096
    tokens in 2 microbatches (16 chunks of 256 per row). Asserts finite
    metrics, a falling loss, clip_scale <= 1 and that no port kernel is
    launched (training takes the plain intra-chunk einsums; attention the
    plain blockwise path). One profiled step, and the SSD's and the shared
    attention's device time per step (``_hybrid_train_split``)."""
    import dataclasses

    import torch
    from repro_torch.configs import ParallelConfig, TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import hybrid_layout
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config(ZAMBA), num_layers=HYBRID_TRAIN_LAYERS)
    train = TrainConfig(seq_len=HYBRID_TRAIN_SEQ, global_batch=HYBRID_TRAIN_BATCH,
                        warmup_steps=2, total_steps=100)
    par = ParallelConfig(microbatches=HYBRID_TRAIN_MB, remat_policy="block")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, train, seed=0, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(state.params))
    batch = _fixed_batch(cfg.vocab_size, HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ, DEV)
    step = make_train_step(cfg, par, train)
    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr")
    history = []
    ops.reset_launches()
    for i in range(HYBRID_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        rec = {"step": i, **{k: float(m[k]) for k in keys},
               "step_ms": (time.perf_counter() - t0) * 1e3}
        history.append(rec)
        emit("hybrid_train_step", **rec)
    launches = dict(ops.launches)
    peak_mem = torch.cuda.max_memory_allocated()
    if any(not all(math.isfinite(r[k]) for k in keys) for r in history):
        raise AssertionError(f"hybrid_train: non-finite metrics {history}")
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError(f"hybrid_train: loss did not fall: {[r['loss'] for r in history]}")
    if not all(r["clip_scale"] <= 1.0 for r in history):
        raise AssertionError("hybrid_train: clip_scale above 1")
    if launches != _no_launches():
        raise AssertionError(f"hybrid_train: training launched kernels {launches}")

    profile = _profile_window(lambda: step(state, batch))
    split = _hybrid_train_split(cfg, state.params, HYBRID_TRAIN_BATCH // HYBRID_TRAIN_MB)
    busy = profile["device_busy_ms"] or 0.0
    split["rest_ms_per_step"] = busy - split["ssd_ms_per_step"] - split[
        "shared_attention_ms_per_step"]
    step_ms = statistics.median(r["step_ms"] for r in history[1:])
    tokens = HYBRID_TRAIN_BATCH * HYBRID_TRAIN_SEQ
    row = {"model": cfg.name, "layers": cfg.num_layers, "layout": hybrid_layout(cfg),
           "params": n_params, "state_bytes": _state_bytes(state), "param_init_s": init_s,
           "global_batch": HYBRID_TRAIN_BATCH, "seq_len": HYBRID_TRAIN_SEQ,
           "microbatches": par.microbatches, "remat_policy": par.remat_policy,
           "chunk": cfg.ssm.chunk, "steps": HYBRID_TRAIN_STEPS,
           "losses": [r["loss"] for r in history], "step_ms_median": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3, "max_memory_allocated_bytes": peak_mem,
           "launches": launches, "profile_step": profile, "busy_split": split}
    emit("hybrid_train", **row)
    return row


def _ssm_cut(params, cfg, d: int):
    """The first ``d`` layers of an ssm model's params (views) and config."""
    import dataclasses

    from repro_torch.tree import tree_map
    p = {k: v for k, v in params.items() if k != "layers"}
    p["layers"] = tree_map(lambda t: t[:d], params["layers"])
    return p, dataclasses.replace(cfg, num_layers=d)


def _ssm_identity(params, cfg, prompts) -> dict:
    """The forward's last logits (the prefill lowering) against the same
    prompts stepped through the serve step, relative to max|logit|, with
    the stepped decode's top-1 among the forward's top ``IDENTITY_TOPK``."""
    import torch
    from repro_torch.models import init_cache
    from repro_torch.train import make_prefill_step, make_serve_step
    B, P = prompts.shape
    fwd = make_prefill_step(cfg, device=DEV)(params, {"tokens": prompts}).float()
    step = make_serve_step(cfg, device=DEV)
    cache = init_cache(cfg, B, P, device=DEV, dtype=torch.bfloat16)
    for t in range(P):
        logits, cache = step(params, prompts[:, t:t + 1], cache, t)
    dec = logits[:, 0].float()
    v = cfg.vocab_size
    top = fwd[:, :v].topk(IDENTITY_TOPK, -1).indices
    return {"rel_logit_err": float((fwd - dec).abs().max() / fwd.abs().max()),
            "top1_agreement": int((fwd[:, :v].argmax(-1) == dec[:, :v].argmax(-1)).sum()),
            "decode_top1_in_forward_topk": bool((top == dec[:, :v].argmax(-1)[:, None])
                                                .any(-1).all()),
            "stepped_last_logits": dec, "cache": cache}


def phase_ssm_serve() -> dict:
    """falcon-mamba-7b (Mamba-1) whole, in bf16 (random weights from seed
    0): (a) the prefill lowering over a (2, 1024) batch; (b) 2 prompts of
    128 tokens stepped through the serve step (a recurrent arch prefills
    so), then 32 greedy tokens each, with each step timed; (c) the forward's
    last logits against the stepped decode at 64 layers and at the first 16
    (views of the same weights), within ``IDENTITY_TOL`` of max|logit| and
    the decode's top-1 among the forward's top 5 (the argument of the
    hybrid phase: two bf16 paths, each rounding on its own); (d) no port
    kernel launched; (e) the device launches of one decode step (a CUDA
    graph) and one profiled decode step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, padded_vocab
    from repro_torch.train import make_prefill_step, make_serve_step
    from repro_torch.tree import leaves

    cfg = get_config(FALCON)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=DEV, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    prefill = make_prefill_step(cfg, device=DEV)
    serve = make_serve_step(cfg, device=DEV)
    gen = torch.Generator().manual_seed(0)
    long = torch.randint(0, cfg.vocab_size, (SSM_SERVE_ROWS, SSM_PREFILL_LEN), generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (SSM_SERVE_ROWS, SSM_PROMPT_LEN),
                            generator=gen).to(DEV)
    prefill(params, {"tokens": long[:, :16]})          # warm-up (first cuBLAS use)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    prefill_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        last = prefill(params, {"tokens": long})
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    if not torch.isfinite(last.float()).all() or tuple(last.shape) != (
            SSM_SERVE_ROWS, padded_vocab(cfg)):
        raise AssertionError(f"ssm_serve: prefill logits {tuple(last.shape)} not finite")
    prefill_peak = torch.cuda.max_memory_allocated()

    torch.cuda.reset_peak_memory_stats()
    ident = {str(cfg.num_layers): _ssm_identity(params, cfg, prompts)}
    cache = ident[str(cfg.num_layers)].pop("cache")
    logits = ident[str(cfg.num_layers)].pop("stepped_last_logits")
    tok = logits[:, :cfg.vocab_size].argmax(-1)[:, None]
    step_ms, out = [], []
    for i in range(SSM_NEW):
        out.append(tok[:, 0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = serve(params, tok, cache, SSM_PROMPT_LEN + i)
        tok = lg[:, 0, :cfg.vocab_size].argmax(-1)[:, None]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    decode_peak = torch.cuda.max_memory_allocated()
    launches = dict(ops.launches)
    toks = torch.stack(out, 1).cpu()
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError("ssm_serve: token ids out of range")
    for d in SSM_DEPTHS:
        r = _ssm_identity(*_ssm_cut(params, cfg, d), prompts)
        ident[str(d)] = {k: v for k, v in r.items() if k not in ("cache", "stepped_last_logits")}
    try:
        decode_launches = graph_launches(
            lambda: serve(params, tok, cache, SSM_PROMPT_LEN + SSM_NEW))
    except Exception as e:                 # a capture that fails is reported, not fatal
        decode_launches = f"graph capture failed: {e!r}"[:300]
    profile_decode = _profile_window(lambda: serve(params, tok, cache, SSM_PROMPT_LEN + SSM_NEW))
    pf = statistics.median(prefill_ms)
    row = {"model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "params": n_params, "param_init_s": init_s,
           "prefill_shape": [SSM_SERVE_ROWS, SSM_PREFILL_LEN], "prefill_ms": prefill_ms,
           "prefill_tokens_per_s": SSM_SERVE_ROWS * SSM_PREFILL_LEN / pf * 1e3,
           "prefill_max_memory_allocated_bytes": prefill_peak,
           "prompt_len": SSM_PROMPT_LEN, "new_tokens_each": SSM_NEW,
           "decode_step_ms": step_ms, "decode_step_ms_median": statistics.median(step_ms),
           "decode_tokens_per_s": SSM_SERVE_ROWS / statistics.median(step_ms) * 1e3,
           "decode_max_memory_allocated_bytes": decode_peak,
           "identity_by_depth": ident, "identity_tolerance": IDENTITY_TOL,
           "decode_step_device_launches": decode_launches, "launches": launches,
           "profile_decode_step": profile_decode}
    emit("ssm_serve", **row)
    if launches != _no_launches():
        raise AssertionError(f"ssm_serve: the Mamba-1 path launched kernels {launches}")
    bad = {d: r for d, r in ident.items()
           if not (r["rel_logit_err"] <= IDENTITY_TOL and r["decode_top1_in_forward_topk"])}
    if bad:
        raise AssertionError(f"ssm_serve: forward against stepped decode {bad} (tol "
                             f"{IDENTITY_TOL}, top-1 in top-{IDENTITY_TOPK})")
    return row


def phase_ssm_train() -> dict:
    """falcon-mamba-7b at full width cut to SSM_TRAIN_LAYERS layers (random
    weights from seed 0, fp32 params and AdamW state, bf16 compute, block
    remat) takes 4 steps on one fixed batch of 2 x 2048 tokens. Asserts
    finite metrics, a falling loss, clip_scale <= 1 and that no port kernel
    is launched. One step profiled on the device alone: its busy time, idle
    share and device launches (the time loop's small kernels)."""
    import dataclasses

    import torch
    from repro_torch.configs import ParallelConfig, TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config(FALCON), num_layers=SSM_TRAIN_LAYERS)
    train = TrainConfig(seq_len=SSM_TRAIN_SEQ, global_batch=SSM_TRAIN_BATCH, warmup_steps=2,
                        total_steps=100)
    par = ParallelConfig(microbatches=1, remat_policy="block")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, train, seed=0, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(state.params))
    batch = _fixed_batch(cfg.vocab_size, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, DEV)
    step = make_train_step(cfg, par, train)
    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr")
    history = []
    ops.reset_launches()
    for i in range(SSM_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        rec = {"step": i, **{k: float(m[k]) for k in keys},
               "step_ms": (time.perf_counter() - t0) * 1e3}
        history.append(rec)
        emit("ssm_train_step", **rec)
    launches = dict(ops.launches)
    peak_mem = torch.cuda.max_memory_allocated()
    if any(not all(math.isfinite(r[k]) for k in keys) for r in history):
        raise AssertionError(f"ssm_train: non-finite metrics {history}")
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError(f"ssm_train: loss did not fall: {[r['loss'] for r in history]}")
    if not all(r["clip_scale"] <= 1.0 for r in history):
        raise AssertionError("ssm_train: clip_scale above 1")
    if launches != _no_launches():
        raise AssertionError(f"ssm_train: training launched kernels {launches}")
    t0 = time.perf_counter()
    profile = _profile_window(lambda: step(state, batch), cpu=False)
    profile_s = time.perf_counter() - t0
    step_ms = statistics.median(r["step_ms"] for r in history[1:])
    row = {"model": cfg.name, "layers": cfg.num_layers, "params": n_params,
           "state_bytes": _state_bytes(state), "param_init_s": init_s,
           "global_batch": SSM_TRAIN_BATCH, "seq_len": SSM_TRAIN_SEQ,
           "remat_policy": par.remat_policy, "steps": SSM_TRAIN_STEPS,
           "losses": [r["loss"] for r in history], "step_ms_median": step_ms,
           "tokens_per_s": SSM_TRAIN_BATCH * SSM_TRAIN_SEQ / step_ms * 1e3,
           "max_memory_allocated_bytes": peak_mem, "launches": launches,
           "device_launches_per_step": profile["device_events"],
           "device_launches_per_layer_and_time_step": profile["device_events"]
           / (SSM_TRAIN_LAYERS * SSM_TRAIN_SEQ),
           "profile_step_device_only": profile, "profile_s": profile_s}
    emit("ssm_train", **row)
    return row


def phase_launcher_ssm() -> dict:
    """Reduced Zamba2-7B (5 layers: 2 groups of 2 Mamba-2 layers and 1
    remaining, d_model 512) and reduced falcon-mamba-7b (2 layers, d_model
    512) through the launcher in bf16, as launcher_dense runs: 6 steps with
    a checkpoint after step 3, then the same call again, which resumes and
    trains steps 4 and 5; they must agree bit for bit with the first run's.
    Losses finite and falling; no port kernel launched."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run

    rows = {}
    for arch, kw in LAUNCHER_SSM_RUNS.items():
        out = LAUNCH_DIR / arch
        shutil.rmtree(out, ignore_errors=True)
        try:
            with _launcher_probe() as rec:
                ops.reset_launches()
                t0 = time.perf_counter()
                first = run(arch, out=str(out), **kw)
                second = run(arch, out=str(out), **kw)
                wall = time.perf_counter() - t0
                launches = dict(ops.launches)
        finally:
            shutil.rmtree(out, ignore_errors=True)
        keys = ("loss", "grad_norm", "lr")
        resumed = {h["step"]: {k: h[k] for k in keys} for h in second}
        straight = {h["step"]: {k: h[k] for k in keys} for h in first[4:]}
        rows[arch] = {"run": kw, "losses": [h["loss"] for h in first], "resumed_steps": resumed,
                      "step_ms": rec["step_ms"], "save_ms": rec["save_ms"],
                      "restore_ms": rec["restore_ms"], "wall_s": wall, "launches": launches}
        where = f"launcher_ssm {arch}"
        if [h["step"] for h in first] != list(range(6)) or sorted(resumed) != [4, 5]:
            raise AssertionError(f"{where}: steps {[h['step'] for h in first]} then "
                                 f"{sorted(resumed)}, not 0-5 then 4-5")
        if resumed != straight:
            raise AssertionError(f"{where}: resumed steps {resumed} differ from {straight}")
        if not (_finite(first) and first[-1]["loss"] < first[0]["loss"]):
            raise AssertionError(f"{where}: losses {rows[arch]['losses']} not finite and "
                                 f"falling")
        if launches != _no_launches():
            raise AssertionError(f"{where}: training launched kernels {launches}")
    emit("launcher_ssm", **rows)
    return rows


# ----------------------------------------------------------------------------
# expert parallelism: EP_RANKS processes share the card over gloo
# ----------------------------------------------------------------------------

def _ep_small_cfg():
    """Reduced Mula-7B-A1B (2 layers, d_model 256) with 16 experts top-8,
    dropless, forced uniform routing: bf16 noise cannot flip an expert
    choice, and with 128 * 8 routed pairs per rank a multiple of 16 each
    rank's local routing is the single-process routing of its tokens."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config(MULA), d_model=256, max_experts=16)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, forced_uniform_routing=True, dispatch="dropless"))


def _ep_block_inputs(cfg, device):
    """Layer 0's MoE params of ``init_params(seed 0)`` in bf16, and x and a
    cotangent (EP_RANKS, 128, d) from a seeded generator."""
    import torch
    from repro_torch.models import init_params
    moe = init_params(cfg, seed=0, device=device, dtype=torch.bfloat16)["layers"]["moe"]
    p = {k: v[0] for k, v in moe.items()}
    gen = torch.Generator().manual_seed(1)
    x, ct = (torch.randn((EP_RANKS, 128, cfg.d_model), generator=gen).bfloat16().to(device)
             for _ in range(2))
    return p, x, ct


def _ep_block_grad(p, x, ct, cfg, group=None):
    """The block's output and the gradient of sum(out * ct) w.r.t. x."""
    import torch
    from repro_torch.core.moe import sparse_moe_block
    x = x.detach().requires_grad_()
    out, _, _, _ = sparse_moe_block(p, x, cfg, ep_group=group)
    gx, = torch.autograd.grad((out.float() * ct.float()).sum(), [x])
    return out.detach(), gx


def _ep_reference_rank(group, t_cfg):
    """One rank of ep_reference: its rows of the small block's output and
    input gradient, then one EP training step from init_state(seed 0)."""
    import torch
    from repro_torch.configs import ParallelConfig
    from repro_torch.kernels import ops
    from repro_torch.parallel import ep_shard
    from repro_torch.train import init_state, make_train_step
    cfg = _ep_small_cfg()
    p, x, ct = _ep_block_inputs(cfg, group.device)
    p = ep_shard({"moe": p}, group.rank, group.world)["moe"]
    r = group.rank
    out, gx = _ep_block_grad(p, x[r:r + 1], ct[r:r + 1], cfg, group)
    state = init_state(cfg, t_cfg, seed=0, ep_group=group)
    batch = _fixed_batch(cfg.vocab_size, t_cfg.global_batch, t_cfg.seq_len, group.device)
    n = t_cfg.global_batch // group.world
    ops.reset_launches()
    _, m = make_train_step(cfg, ParallelConfig(microbatches=1), t_cfg, ep_group=group)(
        state, {k: v[r * n:(r + 1) * n] for k, v in batch.items()})
    torch.cuda.synchronize()
    return {"out": out, "gx": gx, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "launches": dict(ops.launches)}


def ep_reference_prep() -> dict:
    """ep_reference's side in this process: the small MoE block's output
    and input gradient on the card, one step of the CPU float32 path from
    init_state(seed 0) with EP_RANKS microbatches, and the ranks' job."""
    import dataclasses

    import torch
    from repro_torch.configs import ParallelConfig, TrainConfig
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainState, init_state, make_train_step
    from repro_torch.tree import tree_map

    cfg = _ep_small_cfg()
    p, x, ct = _ep_block_inputs(cfg, DEV)
    out_ref, gx_ref = _ep_block_grad(p, x, ct, cfg)
    t_gpu = TrainConfig(seq_len=128, global_batch=EP_RANKS, warmup_steps=2, total_steps=100)
    t_cpu = dataclasses.replace(t_gpu, compute_dtype="float32", grad_reduce_dtype="float32")
    params = tree_map(lambda t: t.detach().cpu(), init_state(cfg, t_gpu, seed=0, device=DEV).params)
    batch = _fixed_batch(cfg.vocab_size, t_gpu.global_batch, t_gpu.seq_len, "cpu")
    _, m_cpu = make_train_step(cfg, ParallelConfig(microbatches=EP_RANKS), t_cpu)(
        TrainState(params, adamw_init(params)), batch)
    del p
    torch.cuda.empty_cache()
    return {"out": out_ref.cpu(), "gx": gx_ref.cpu(),
            "m_cpu": {k: float(m_cpu[k]) for k in ("loss", "grad_norm")},
            "job": ("ep_reference", _ep_reference_rank, (t_gpu,), None)}


def phase_ep_reference(ranks, wall: float, ref: dict) -> dict:
    """EP_RANKS ranks on the card over gloo (the session's job, ``ranks``;
    ``ref`` from ``ep_reference_prep``): (a) the small MoE block's
    output and input gradient, bf16 through the kernels, against the same
    block in this process on the card (rel 3e-2 of max|ref|: each rank's
    partial output is rounded to bf16 and the partials are summed in bf16,
    where one process rounds once after an f32 combine); (b) one EP
    training step (bf16 compute and gradient reduction) against one step
    of the CPU float32 path from the same init_state(seed 0), with
    EP_RANKS microbatches so that each is one rank's rows (the tolerances
    of train_reference: loss rel 1e-2, grad_norm rel 3e-2)."""
    import torch

    cfg = _ep_small_cfg()
    out_ref, gx_ref, m_cpu = ref["out"], ref["gx"], ref["m_cpu"]

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    out_err = rel(torch.cat([r["out"] for r in ranks]), out_ref)
    gx_err = rel(torch.cat([r["gx"] for r in ranks]), gx_ref)
    step_rel = {k: abs(ranks[0][k] - m_cpu[k]) / abs(m_cpu[k])
                for k in ("loss", "grad_norm")}
    tol = {"block": 3e-2, "loss": 1e-2, "grad_norm": 3e-2}
    expect = expected_train_launches(cfg.num_layers, 1, 1)
    row = {"config": cfg.name, "ranks": EP_RANKS, "backend": "gloo", "experts_per_rank":
           cfg.moe.num_experts // EP_RANKS, "block_out_rel_err": out_err,
           "block_grad_x_rel_err": gx_err, "loss_ep": [r["loss"] for r in ranks],
           "loss_cpu": m_cpu["loss"], "grad_norm_ep": [r["grad_norm"] for r in ranks],
           "grad_norm_cpu": m_cpu["grad_norm"], "step_rel_err": step_rel,
           "tolerance": tol, "launches_per_rank": [r["launches"] for r in ranks],
           "expected_launches": expect, "wall_s": wall}
    emit("ep_reference", **row)
    if not (out_err <= tol["block"] and gx_err <= tol["block"]):
        raise AssertionError(f"ep_reference: EP block differs: out {out_err}, grad x {gx_err}")
    bad = {k: v for k, v in step_rel.items() if not v <= tol[k]}
    if bad:
        raise AssertionError(f"ep_reference: EP step differs from the CPU step: {bad}")
    if any(r["launches"] != expect for r in ranks):
        raise AssertionError(f"ep_reference: launches {row['launches_per_rank']} != {expect}")
    if len({(r["loss"], r["grad_norm"]) for r in ranks}) != 1:
        raise AssertionError("ep_reference: ranks disagree on the step's metrics")
    return row


def _ep_train_rank(group, steps):
    """One rank of ep_train: its share of init_state(seed 0) and its row
    of the fixed batch; ``steps`` steps; what the parent asserts."""
    import dataclasses

    import torch
    from repro_torch.configs import ParallelConfig, TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import replicated_leaves
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.trainer import placements
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config(MULA), num_layers=EP_LAYERS)
    train = TrainConfig(seq_len=EP_SEQ, global_batch=EP_RANKS, warmup_steps=2, total_steps=100)
    par = ParallelConfig(microbatches=1, remat_policy="block")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, train, seed=0, ep_group=group)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = _fixed_batch(cfg.vocab_size, train.global_batch, train.seq_len, group.device)
    r = group.rank
    mine = {k: v[r:r + 1] for k, v in batch.items()}
    step = make_train_step(cfg, par, train, ep_group=group)
    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")
    history, counts = [], None
    ops.reset_launches()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, mine)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        history.append({**{k: float(m[k]) for k in keys}, "step_ms": ms})
        counts = m["moe_counts"]
    launches = dict(ops.launches)
    # one more step, profiled on rank 0 (every rank must take it: lockstep)
    profile = None
    if r == 0:
        profile = _profile_window(lambda: step(state, mine), host_prefixes=("gloo:", "c10d::"))
    else:
        step(state, mine)
        torch.cuda.synchronize()
    place = placements(cfg, init_params(cfg, device="meta"), {"ep": group.world})
    rep = [t for t, k in zip(leaves(state.params), replicated_leaves(place)) if k]
    return {"history": history, "moe_counts": counts, "launches": launches, "profile": profile,
            "peak_bytes": torch.cuda.max_memory_allocated(), "init_s": init_s,
            "params_held": sum(t.numel() for t in leaves(state.params)),
            "table_elems": table_elems(state.params),
            "replicated_checksum": float(sum(t.double().sum() for t in rep)),
            "backend": group.backend, "device": str(group.device)}


def phase_ep_train(ranks, wall: float) -> dict:
    """Full-width Mula-7B-A1B, EP_LAYERS of its 16 layers, EP_RANKS ranks on the
    card over gloo, EP_STEPS steps on the fixed batch (one sequence of
    EP_SEQ tokens per rank, EP_RANKS * EP_SEQ gathered tokens per MoE
    call, the config's own capacity dispatch), microbatches 1, block
    remat: the session's job ``ranks`` (``_ep_train_rank``)."""
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(MULA)
    expect = expected_train_launches(EP_LAYERS, 1, EP_STEPS)
    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")
    routed = EP_RANKS * EP_SEQ * cfg.moe.experts_per_token
    for i, r in enumerate(ranks):
        h = r["history"]
        if not all(math.isfinite(s[k]) for s in h for k in keys):
            raise AssertionError(f"ep_train rank {i}: non-finite metrics {h}")
        if not h[-1]["loss"] < h[0]["loss"]:
            raise AssertionError(f"ep_train rank {i}: loss did not fall: {[s['loss'] for s in h]}")
        if not all(s["clip_scale"] <= 1.0 for s in h):
            raise AssertionError(f"ep_train rank {i}: clip_scale above 1")
        if [{k: s[k] for k in keys} for s in h] != [{k: s[k] for k in keys}
                                                   for s in ranks[0]["history"]]:
            raise AssertionError(f"ep_train: rank {i}'s metrics differ from rank 0's")
        if not torch.equal(r["moe_counts"], ranks[0]["moe_counts"]) or float(
                r["moe_counts"].sum()) != routed:
            raise AssertionError(f"ep_train rank {i}: moe_counts sum "
                                 f"{float(r['moe_counts'].sum())} != {routed} routed pairs")
        if r["replicated_checksum"] != ranks[0]["replicated_checksum"]:
            raise AssertionError(f"ep_train rank {i}: replicated params differ from rank 0's")
        if r["launches"] != expect:
            raise AssertionError(f"ep_train rank {i}: launches {r['launches']} != {expect}")
    step_ms = [statistics.median(s["step_ms"] for s in r["history"][1:]) for r in ranks]
    row = {"model": cfg.name, "layers": EP_LAYERS, "ranks": EP_RANKS,
           "backend": ranks[0]["backend"],
           "device": ranks[0]["device"], "experts_per_rank": cfg.moe.num_experts // EP_RANKS,
           "seq_per_rank": 1, "seq_len": EP_SEQ, "gathered_tokens_per_moe_call":
           EP_RANKS * EP_SEQ, "dispatch": cfg.moe.dispatch, "steps": EP_STEPS,
           "losses": [s["loss"] for s in ranks[0]["history"]],
           "clip_scales": [s["clip_scale"] for s in ranks[0]["history"]],
           "step_ms_by_rank": [[s["step_ms"] for s in r["history"]] for r in ranks],
           "step_ms_median_by_rank": step_ms,
           "peak_bytes_by_rank": [r["peak_bytes"] for r in ranks],
           "params_held_by_rank": [r["params_held"] for r in ranks],
           **table_row("ep_train", [r["table_elems"] for r in ranks], cfg, {"ep": EP_RANKS}),
           "init_s_by_rank": [r["init_s"] for r in ranks],
           "launches_per_rank": ranks[0]["launches"], "expected_launches": expect, "wall_s": wall,
           "profile_step_rank0": ranks[0]["profile"],
           "note": "4 ranks time-share one card; gloo carries the collectives through host "
                   "memory itself (the port host-stages none of them): the step time is "
                   "not an EP speed"}
    emit("ep_train", **row)
    return row


# ----------------------------------------------------------------------------
# the sharded optimizer (SO / EPSO) on a dp x ep grid
# ----------------------------------------------------------------------------

def table_elems(params) -> int:
    """The embedding and head table elements a rank holds: its vocab rows
    of a split table (``parallel.vocab``)."""
    from repro_torch.parallel.sharding import is_table_path
    from repro_torch.tree import leaves_with_path
    return sum(t.numel() for path, t in leaves_with_path(params) if is_table_path(path))


def table_row(phase: str, got: list, cfg, sizes: dict) -> dict:
    """Each rank's table elements (``got``, rank order) against the shapes'
    figure: 2 (1 tied) x V_pad x d_model over the size of the grid axis
    that splits the tables, 'tp', else 'ep', where it divides V_pad
    (``parallel.sharding.vocab_axis``; ``sizes`` the grid's axes); raises
    where a rank differs. The fields a phase line prints."""
    from repro_torch.models.model import padded_vocab
    from repro_torch.parallel.sharding import vocab_axis
    vp = padded_vocab(cfg)
    whole = (1 if cfg.tie_embeddings else 2) * vp * cfg.d_model
    axis = vocab_axis(sizes, vp)
    want = whole // (sizes[axis] if axis else 1)
    if any(n != want for n in got):
        raise AssertionError(f"{phase}: table elements a rank {got}, expected {want} "
                             f"(the tables split over {axis!r})")
    return {"table_elems_per_rank": got[0], "table_elems_expected": want,
            "table_elems_whole": whole, "table_split_axis": axis}


def _checksums(tree) -> dict:
    """Per leaf, its float64 sum and sum of squares: equal leaves on two
    ranks give equal pairs."""
    from repro_torch.tree import leaves_with_path
    return {path: (float(t.double().sum()), float(t.double().square().sum()))
            for path, t in leaves_with_path(tree)}


def _epso_train_rank(grid, steps):
    """One rank of epso_train: for each (mode, overlap) of EPSO_RUNS its
    share of init_state(seed 0) on the grid, its row of the fixed batch,
    ``steps`` steps, the last profiled on rank 0; what the parent asserts
    and prints."""
    import dataclasses

    import torch
    from repro_torch.configs import ParallelConfig, TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.optim.epso import DEFAULT_BUCKET_BYTES, state_bytes_per_device
    from repro_torch.parallel.sharding import param_placements
    from repro_torch.train import init_state, make_train_step, opt_layout
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config(MULA), num_layers=EPSO_LAYERS)
    world, r = grid.world.world, grid.world.rank
    train = TrainConfig(seq_len=EP_SEQ, global_batch=world, warmup_steps=2, total_steps=100)
    batch = _fixed_batch(cfg.vocab_size, train.global_batch, train.seq_len, grid.world.device)
    mine = {k: v[r:r + 1] for k, v in batch.items()}
    shapes = init_params(cfg, device="meta")
    sizes = grid.axis_sizes
    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")
    out = {}
    for mode, overlap in EPSO_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = init_state(cfg, train, seed=0, grid=grid, opt_sharding_mode=mode)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        par = ParallelConfig(microbatches=1, remat_policy="block", opt_overlap=overlap)
        step = make_train_step(cfg, par, train, opt_sharding_mode=mode, grid=grid)
        held = sum(t.numel() * 4 for tree in (state.opt.master, state.opt.m, state.opt.v)
                   for t in leaves(tree))
        plan = None
        if mode != "none":
            p, _ = opt_layout(cfg, grid, mode, max_bucket_bytes=0 if overlap == "off"
                              else DEFAULT_BUCKET_BYTES)
            gathered = [b for b in p.buckets if b.axes]
            plan = {"buckets": len(p.buckets), "gathered_buckets": len(gathered),
                    "gathered_elems": sum(b.elems for b in gathered),
                    "gathered_bytes_f32": 4 * sum(b.elems for b in gathered),
                    "largest_bucket_elems": max(b.elems for b in p.buckets),
                    "axes": list(p.axes)}
        history, profile = [], None
        ops.reset_launches()
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == steps - 1 and r == 0:
                # the last step profiled on rank 0 (the others wait in lockstep)
                box = {}
                profile = _profile_window(lambda: box.update(r=step(state, mine)),
                                          host_prefixes=("gloo:", "c10d::"))
                state, m = box.pop("r")
            else:
                state, m = step(state, mine)
            torch.cuda.synchronize()
            history.append({**{k: float(m[k]) for k in keys},
                            "step_ms": (time.perf_counter() - t0) * 1e3})
        launches = dict(ops.launches)
        sums = _checksums(state.params)
        out[f"{mode}/{overlap}"] = {
            "history": history, "launches": launches, "checksums": sums, "profile": profile,
            "table_elems": table_elems(state.params),
            "peak_bytes": torch.cuda.max_memory_allocated(), "init_s": init_s,
            "state_bytes": held, "plan": plan,
            "state_bytes_expected": state_bytes_per_device(
                shapes, param_placements(shapes, sizes), sizes, mode)}
        del state, step, m
    return {"runs": out, "coords": grid.coords, "backend": grid.world.backend,
            "device": str(grid.world.device),
            "placement": _placement_train_rank(grid, cfg, train, mine, PLACEMENT_STEPS),
            "a2a": _a2a_train_rank(grid, cfg, train, mine, steps),
            "tp": _tp_train_rank(grid, cfg, train, batch),
            "pp": _pp_train_rank(grid),
            "serve": _grid_serve_rank(grid),
            "fsdp": _fsdp_train_rank(grid, cfg, train, mine),
            "fsdp_ep": _history_run(cfg, train, grid, *FSDP_EP_RUN, mine, EPSO_STEPS,
                                    fsdp=True),
            "fsdp_tp": _fsdp_tp_train_rank(grid, cfg, train, batch),
            "fsdp_pp": _fsdp_pp_train_rank(grid),
            "fsdp_placement": _fsdp_placement_rank(grid, cfg, train, mine)}


def _fsdp_train_rank(grid, cfg, train, rows):
    """fsdp_train on one rank: the spawn's processes re-cut as a ('data',
    FSDP_DP) grid (``init_grid``), the rank's ``rows``; EPSO_STEPS steps of
    FSDP 'none' (``fsdp_params``), the last profiled on rank 0, and the
    'so' run without fsdp, from init_state(seed 0), block remat."""
    from repro_torch.parallel import init_grid
    g = init_grid(grid.world, FSDP_DP, 1)
    return {"coords": g.coords,
            "fsdp": _history_run(cfg, train, g, "none", "off", rows, EPSO_STEPS,
                                 profile_last=True, fsdp=True),
            "so": _history_run(cfg, train, g, "so", "off", rows, EPSO_STEPS)}


def _fsdp_tp_train_rank(grid, cfg, train, batch):
    """fsdp_tp_train on one rank: the spawn's processes re-cut as
    FSDP_TP_GRID (``init_grid``), the dropless model, the rank's row (row d
    of the batch, the same on its tp peers); FSDP_GRID_STEPS steps without
    warmup of FSDP 'epso'/'ring' and of 'epso'/'ring' without fsdp, from
    init_state(seed 0), block remat."""
    import dataclasses

    from repro_torch.parallel import init_grid
    g = init_grid(grid.world, *FSDP_TP_GRID)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="dropless"))
    train = dataclasses.replace(train, warmup_steps=0)
    d = g.coords["data"]
    rows = {k: v[d:d + 1] for k, v in batch.items()}
    n = FSDP_GRID_STEPS
    return {"coords": g.coords,
            "fsdp": _history_run(cfg, train, g, "epso", "ring", rows, n, fsdp=True),
            "plain": _history_run(cfg, train, g, "epso", "ring", rows, n)}


def _fsdp_pp_train_rank(grid):
    """fsdp_pp_train on one rank: the spawn's processes re-cut as
    ('data', FSDP_PP_DP) x ('pp', FSDP_PP_STAGES), ``pp_train_config``'s
    model at EPSO_LAYERS layers, the rank's rows (block d of the fixed
    batch, the same on both stages); FSDP_GRID_STEPS 1f1b steps without
    warmup of FSDP 'epso'/'ring' and of 'epso'/'ring' without fsdp, from
    init_state(seed 0), block remat."""
    import dataclasses

    from repro_torch.parallel import init_grid
    cfg, train = pp_train_config(EPSO_LAYERS, FSDP_PP_DP, FSDP_PP_MB)
    train = dataclasses.replace(train, warmup_steps=0)
    g = init_grid(grid.world, FSDP_PP_DP, 1, 1, FSDP_PP_STAGES)
    batch = _fixed_batch(cfg.vocab_size, train.global_batch, train.seq_len, g.world.device)
    n = train.global_batch // FSDP_PP_DP
    d = g.coords["data"]
    rows = {k: v[d * n:(d + 1) * n] for k, v in batch.items()}
    kw = dict(microbatches=FSDP_PP_MB, pp_stages=FSDP_PP_STAGES)
    n = FSDP_GRID_STEPS
    return {"coords": g.coords,
            "fsdp": _history_run(cfg, train, g, "epso", "ring", rows, n, fsdp=True, **kw),
            "plain": _history_run(cfg, train, g, "epso", "ring", rows, n, **kw)}


def _fsdp_placement_rank(grid, cfg, train, rows):
    """fsdp_placement_train on one rank of the epso grid: the dropless model,
    FSDP 'epso'/'ring' (FSDP_EP_RUN) from init_state(seed 0) on the rank's
    ``rows``, FSDP_PLACEMENT_MOVE_AFTER + 1 steps; the state then kept on
    the host and the next step taken unplaced; the kept state written back,
    moved to ``placement_row``'s placement (``apply_placement`` on the fsdp
    layout) and that step taken again in a step built for it. Per step the
    metrics, counts, ms, launches and the gather's stats; for the move its
    wall ms, the bytes this rank sent, the slice sums of the expert stacks
    (the rank's 'data' tiles of its 'ep' slice) before and after it and the
    state bytes after it."""
    import dataclasses

    import torch
    from repro_torch.configs import ParallelConfig
    from repro_torch.ft import restore_into, snapshot
    from repro_torch.kernels import ops
    from repro_torch.parallel.placement import ExpertPlacement, apply_placement
    from repro_torch.train import init_state, make_train_step, state_layout
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="dropless"))
    mode, overlap = FSDP_EP_RUN
    par = ParallelConfig(microbatches=1, remat_policy="block", opt_overlap=overlap,
                         fsdp_params=True)
    layout = state_layout(cfg, grid.axis_sizes, mode, fsdp=True)
    L, E = cfg.num_layers, cfg.moe.num_experts
    placed = ExpertPlacement.broadcast(placement_row(E, grid.ep.world), L)
    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")

    def one(step, state):
        ops.reset_launches()
        stats = dict(step.fsdp_gather.stats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, rows)
        torch.cuda.synchronize()
        return state, {**{k: float(m[k]) for k in keys},
                       "counts": m["moe_counts"].double().cpu().tolist(),
                       "step_ms": (time.perf_counter() - t0) * 1e3,
                       "launches": dict(ops.launches),
                       "fsdp_stats": {k: v - stats[k] for k, v in step.fsdp_gather.stats.items()}}

    torch.cuda.empty_cache()
    state = init_state(cfg, train, seed=0, grid=grid, opt_sharding_mode=mode, fsdp=True)
    step = make_train_step(cfg, par, train, opt_sharding_mode=mode, grid=grid)
    history = []
    for _ in range(FSDP_PLACEMENT_MOVE_AFTER + 1):
        state, rec = one(step, state)
        history.append(rec)
    kept = snapshot(state)
    state, unplaced = one(step, state)
    restore_into(state, kept)
    del kept
    before = _slice_sums(state, layout, grid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, sent = apply_placement(state, ExpertPlacement.identity(L, E), placed, grid=grid,
                                  layout=layout)
    torch.cuda.synchronize()
    move = {"ms": (time.perf_counter() - t0) * 1e3, "sent_bytes": sent,
            "before": before, "after": _slice_sums(state, layout, grid),
            "state_bytes": sum(t.numel() * 4 for tree in (state.opt.master, state.opt.m,
                                                          state.opt.v) for t in leaves(tree))}
    step = make_train_step(cfg, par, train, opt_sharding_mode=mode, grid=grid, placement=placed)
    state, placed_rec = one(step, state)
    held = table_elems(state.params)
    del state, step
    return {"row": list(placed.perm[0]), "history": history, "unplaced": unplaced,
            "placed": placed_rec, "move": move, "table_elems": held}


def _fsdp_hybrid_train_rank(world):
    """fsdp_hybrid_train on one rank of the session: its processes re-cut as
    ('data', FSDP_DP), full-width Zamba2-7B at FSDP_HYBRID_LAYERS layers,
    the rank's FSDP_HYBRID_SEQ-token row of a fixed batch; FSDP_GRID_STEPS
    steps without warmup at peak lr CMP_LR of FSDP 'so' and of 'so'
    without fsdp, from init_state(seed 0), block remat."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.parallel import init_grid
    cfg = dataclasses.replace(get_config(ZAMBA), num_layers=FSDP_HYBRID_LAYERS)
    g = init_grid(world, FSDP_DP, 1)
    train = TrainConfig(seq_len=FSDP_HYBRID_SEQ, global_batch=FSDP_DP, warmup_steps=0,
                        total_steps=100, lr_peak=CMP_LR, lr_min=CMP_LR / 10)
    batch = _fixed_batch(cfg.vocab_size, FSDP_DP, FSDP_HYBRID_SEQ, g.world.device)
    d = g.coords["data"]
    rows = {k: v[d:d + 1] for k, v in batch.items()}
    n = FSDP_GRID_STEPS
    return {"coords": g.coords,
            "fsdp": _history_run(cfg, train, g, "so", "off", rows, n, fsdp=True),
            "plain": _history_run(cfg, train, g, "so", "off", rows, n)}


def _fsdp_ssm_pp_train_rank(world):
    """fsdp_ssm_pp_train on one rank of the session: its processes re-cut as
    ('data', FSDP_PP_DP) x ('pp', FSDP_PP_STAGES), full-width falcon-mamba-7b
    at FSDP_SSM_PP_LAYERS layers, the rank's FSDP_SSM_PP_MB rows of a fixed
    batch (block d, the same on both stages); FSDP_GRID_STEPS 1f1b steps
    without warmup at peak lr CMP_LR of FSDP 'so' and of 'so' without fsdp,
    from init_state(seed 0), block remat."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.parallel import init_grid
    cfg = dataclasses.replace(get_config(FALCON), num_layers=FSDP_SSM_PP_LAYERS)
    g = init_grid(world, FSDP_PP_DP, 1, 1, FSDP_PP_STAGES)
    n = FSDP_SSM_PP_MB
    train = TrainConfig(seq_len=FSDP_SSM_PP_SEQ, global_batch=FSDP_PP_DP * n, warmup_steps=0,
                        total_steps=100, lr_peak=CMP_LR, lr_min=CMP_LR / 10)
    batch = _fixed_batch(cfg.vocab_size, train.global_batch, FSDP_SSM_PP_SEQ, g.world.device)
    d = g.coords["data"]
    rows = {k: v[d * n:(d + 1) * n] for k, v in batch.items()}
    kw = dict(microbatches=n, pp_stages=FSDP_PP_STAGES)
    steps = FSDP_GRID_STEPS
    return {"coords": g.coords,
            "fsdp": _history_run(cfg, train, g, "so", "off", rows, steps, fsdp=True, **kw),
            "plain": _history_run(cfg, train, g, "so", "off", rows, steps, **kw)}


def _history_run(cfg, train, grid, mode, overlap, rows, steps, sac="block", profile=False,
                 fsdp=False, profile_last=False, microbatches=1, pp_stages=1):
    """``steps`` steps of ``cfg`` from init_state(seed 0) on ``grid`` in
    ``mode``/``overlap`` under the remat policy ``sac`` on the rank's
    ``rows`` in ``microbatches``: per step the metrics, the counts (a MoE
    model's) and the step ms; the launches, the peak memory (also of the steps alone) and
    the state bytes and param elements held. ``fsdp``: the state and step
    of ``ParallelConfig.fsdp_params``, and the steps' gather counts and
    bytes. ``pp_stages`` > 1: the 1f1b pipelined step on the grid's 'pp'
    axis, each step with its router aux term, the bytes handed to the
    neighbour stages and the rank's saved-input peak.
    ``profile``: one more step, profiled on rank 0 (``_profile_window``
    with the gloo and c10d events; every rank takes it), whose loss ends
    the history, and that step's own peak memory. ``profile_last``: the
    last of the ``steps`` steps profiled so on rank 0 instead (its step ms
    carries the profiler's cost)."""
    import torch
    from repro_torch.configs import ParallelConfig
    from repro_torch.kernels import ops
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import leaves

    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(cfg, train, seed=0, grid=grid, opt_sharding_mode=mode, fsdp=fsdp)
    par = ParallelConfig(microbatches=microbatches, remat_policy=sac, opt_overlap=overlap,
                         fsdp_params=fsdp, pp_stages=pp_stages)
    step = make_train_step(cfg, par, train, opt_sharding_mode=mode, grid=grid)
    held = sum(t.numel() * 4 for tree in (state.opt.master, state.opt.m, state.opt.v)
               for t in leaves(tree))
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    history, prof = [], None
    ops.reset_launches()
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profile_last and i == steps - 1 and grid.world.rank == 0:
            box = {}
            prof = _profile_window(lambda: box.update(r=step(state, rows)),
                                   host_prefixes=("gloo:", "c10d::"))
            state, m = box.pop("r")
        else:
            state, m = step(state, rows)
        torch.cuda.synchronize()
        history.append({**{k: float(m[k]) for k in keys if k in m},
                        "step_ms": (time.perf_counter() - t0) * 1e3})
        if "moe_counts" in m:
            history[-1]["counts"] = m["moe_counts"].double().cpu().tolist()
        if pp_stages > 1:
            history[-1].update(moe_aux=float(step.router_terms["moe_aux"]),
                               sent_bytes=step.sent_bytes,
                               saved_peak=step.saved_peak[grid.coords["pp"]])
    out = {"history": history, "launches": dict(ops.launches), "state_bytes": held,
           "param_elems": sum(t.numel() for t in leaves(state.params)),
           "table_elems": table_elems(state.params),
           "peak_bytes": max(init_peak, torch.cuda.max_memory_allocated()),
           "peak_bytes_steps": torch.cuda.max_memory_allocated(),
           "fsdp_stats": dict(step.fsdp_gather.stats) if step.fsdp_gather is not None else None,
           "profile": prof}
    if profile:
        last = {}

        def one():
            last["m"] = step(state, rows)[1]

        torch.cuda.reset_peak_memory_stats()
        if grid.world.rank == 0:
            out["profile"] = _profile_window(one, host_prefixes=("gloo:", "c10d::"))
        else:
            one()
            torch.cuda.synchronize()
        out["profiled_loss"] = float(last["m"]["loss"])
        out["peak_bytes_profiled"] = torch.cuda.max_memory_allocated()
    del state, step
    return out


def _a2a_train_rank(grid, cfg, train, mine, steps):
    """a2a_train on one rank of the epso grid: the all-to-all Stage 1
    (``stage1='a2a'``) and the allgather one, both at capacity factor
    A2A_CF and peak lr CMP_LR in 'epso'/'ring', ``steps`` steps from
    init_state(seed 0) on the rank's row."""
    import dataclasses
    train = dataclasses.replace(train, lr_peak=CMP_LR, lr_min=CMP_LR / 10)
    return {stage1: _history_run(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, stage1=stage1, capacity_factor=A2A_CF)), train, grid, "epso", "ring", mine,
        steps) for stage1 in ("a2a", "allgather")}


def pp_train_config(layers: int = PP_LAYERS, batch_ranks: int = PP_DP * PP_EP,
                    microbatches: int = PP_MB):
    """pp_train's model and TrainConfig: full-width Mula-7B-A1B at ``layers``
    layers, dropless, with the config's router terms (a stage takes them
    over the whole microbatch); ``microbatches`` one-row microbatches of
    PP_SEQ tokens a batch rank (``batch_ranks`` of them), peak lr CMP_LR."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_config
    cfg = dataclasses.replace(get_config(MULA), num_layers=layers)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="dropless"))
    train = TrainConfig(seq_len=PP_SEQ, global_batch=batch_ranks * microbatches, warmup_steps=2,
                        total_steps=100, lr_peak=CMP_LR, lr_min=CMP_LR / 10)
    return cfg, train


def pp_oracle_rows(batch: dict, ranks: int, n_mb: int) -> dict:
    """``batch``'s rows reordered so that one process's microbatch m holds
    microbatch m of each of the ``ranks`` batch ranks, in rank order: the
    microbatches the grid's stages see."""
    b = batch["tokens"].shape[0]
    c = b // (ranks * n_mb)
    idx = [r * (b // ranks) + m * c + j for m in range(n_mb) for r in range(ranks)
           for j in range(c)]
    return {k: v[idx] for k, v in batch.items()}


def _pp_train_rank(grid):
    """pp_train on one rank of epso_train's spawn: the 4 processes re-cut as
    PP_DP x PP_STAGES x PP_EP (``init_grid`` over the world); the rank's
    rows (block d * ep + e of the fixed batch, the same on both stages),
    'epso'/'ring' from init_state(seed 0), one step per schedule of
    PP_SCHEDULES; per step the metrics, step ms, bytes handed to the
    neighbour stage and the saved-input peak; the launches, peak memory
    and state bytes of the rank."""
    import torch
    from repro_torch.configs import ParallelConfig
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.optim.epso import state_bytes_per_device
    from repro_torch.parallel import init_grid
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.trainer import placements
    from repro_torch.tree import leaves

    cfg, train = pp_train_config()
    g = init_grid(grid.world, PP_DP, PP_EP, 1, PP_STAGES)
    batch = _fixed_batch(cfg.vocab_size, train.global_batch, train.seq_len, g.world.device)
    n = train.global_batch // (PP_DP * PP_EP)
    r = g.coords["data"] * PP_EP + g.coords["ep"]
    rows = {k: v[r * n:(r + 1) * n] for k, v in batch.items()}
    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(cfg, train, seed=0, grid=g, opt_sharding_mode="epso")
    held = sum(t.numel() * 4 for tree in (state.opt.master, state.opt.m, state.opt.v)
               for t in leaves(tree))
    steps = {sched: make_train_step(cfg, ParallelConfig(
        microbatches=PP_MB, remat_policy="block", opt_overlap="ring", pp_stages=PP_STAGES,
        pp_schedule=sched), train, opt_sharding_mode="epso", grid=g)
        for sched in sorted(set(PP_SCHEDULES))}
    history = []
    ops.reset_launches()
    for sched in PP_SCHEDULES:
        step = steps[sched]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, rows)
        torch.cuda.synchronize()
        history.append({**{k: float(m[k]) for k in keys}, "schedule": sched,
                        "counts": m["moe_counts"].double().cpu().tolist(),
                        "moe_aux": float(step.router_terms["moe_aux"]),
                        "step_ms": (time.perf_counter() - t0) * 1e3,
                        "sent_bytes": step.sent_bytes,
                        "saved_peak": step.saved_peak[g.coords["pp"]]})
    launches = dict(ops.launches)
    shapes = init_params(cfg, device="meta")
    out = {"history": history, "launches": launches, "coords": g.coords,
           "table_elems": table_elems(state.params),
           "peak_bytes": torch.cuda.max_memory_allocated(), "state_bytes": held,
           "state_bytes_expected": state_bytes_per_device(
               shapes, placements(cfg, shapes, g.axis_sizes), g.axis_sizes, "epso")}
    del state, steps
    return out


def grid_serve_config():
    """grid_serve's model: full-width Mula-7B-A1B at GRID_SERVE_LAYERS layers."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MULA), num_layers=GRID_SERVE_LAYERS)


def serve_tiles(cfg, axis_sizes: dict, coords: dict, device) -> dict:
    """The tiles a rank at ``coords`` of a grid of ``axis_sizes`` ({}: one
    rank, the whole model) holds of bf16 params made from seeds, one leaf
    and one layer at a time, so that no rank makes a whole model: each
    (leaf, layer) from its own generator (seeded by the leaf's path and the
    layer), normal times 1 / sqrt(fan-in) for the weights, 0.02 for the
    tables, ones for the norm scales, zeros for the biases."""
    import zlib

    import torch
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import tile_slices
    from repro_torch.train.trainer import placements
    from repro_torch.tree import leaves_with_path, unflatten

    shapes = init_params(cfg, device="meta")
    place = dict(leaves_with_path(placements(cfg, shapes, axis_sizes)))
    sizes = {"data": 1, "pp": 1, "ep": 1, "tp": 1, **axis_sizes}

    def make(path, shape, seed):
        name = path.rsplit("/", 1)[-1]
        if name in ("scale", "bias"):
            return torch.full(shape, float(name == "scale"), dtype=torch.bfloat16,
                              device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        scale = 0.02 if name == "table" else shape[-2] ** -0.5
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16).mul_(scale)

    out = []
    for path, leaf in leaves_with_path(shapes):
        full = tuple(leaf.shape)
        sl = tile_slices(place[path], full, coords, sizes)
        base = zlib.crc32(path.encode()) * 1000
        if not path.startswith("layers/"):
            out.append(make(path, full, base)[sl])
            continue
        tile = torch.empty(tuple(s.stop - s.start for s in sl), dtype=torch.bfloat16,
                           device=device)
        for i in range(full[0]):
            tile[i] = make(path, full[1:], base + i)[sl[1:]]
        out.append(tile)
    return unflatten(shapes, out)


def grid_serve_prompts(cfg) -> list:
    """GRID_SERVE_PROMPTS' prompts, from seed 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in GRID_SERVE_PROMPTS]


def serve_run(cfg, params, *, plan=None, grid=None) -> dict:
    """One serving run of grid_serve (on ``plan``/``grid``, or on one rank):
    the admission prefill of the first prompt through
    ``make_prefill_step(into_cache=True)`` and one decode step after it
    through ``make_serve_step`` (their logits, f32 on the host), then an
    engine over every prompt, greedy, GRID_SERVE_NEW tokens each, on
    GRID_SERVE_SLOTS slots; the launches of the engine's run, its tokens,
    prefills, decode steps, decode ms, wall and peak memory."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import init_cache
    from repro_torch.serve import ServeEngine
    from repro_torch.train import make_prefill_step, make_serve_step

    prompts = grid_serve_prompts(cfg)
    tp = grid.tp.world if grid is not None else 1
    dev = grid.world.device if grid is not None else DEV
    toks = torch.tensor([prompts[0]], device=dev)
    n = toks.shape[1]
    cache = init_cache(cfg, 1, GRID_SERVE_MAX_LEN, device=dev, dtype=torch.bfloat16, tp=tp)
    kw = dict(compute_dtype=torch.bfloat16, plan=plan, grid=grid, device=dev)
    last, cache = make_prefill_step(cfg, into_cache=True, **kw)(params, toks, cache, [0], [n])
    step, _ = make_serve_step(cfg, **kw)(params, last[:, :cfg.vocab_size].argmax(-1)[:, None],
                                         cache, n)
    out = {"prefill_logits": last[0, :cfg.vocab_size].float().cpu(),
           "decode_logits": step[0, 0, :cfg.vocab_size].float().cpu()}
    del cache
    decode_ms = []
    engine = ServeEngine(params, cfg, num_slots=GRID_SERVE_SLOTS, max_len=GRID_SERVE_MAX_LEN,
                         cache_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, plan=plan,
                         grid=grid, device=dev, on_decode=lambda s: decode_ms.append(s * 1e3))
    rids = [engine.submit(p, GRID_SERVE_NEW) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = engine.run()
    torch.cuda.synchronize()
    out.update(wall_s=time.perf_counter() - t0, launches=dict(ops.launches),
               tokens=[res[r].tokens for r in rids], prefills=engine.prefills,
               decode_steps=engine.decode_steps, decode_ms=decode_ms,
               peak_bytes=torch.cuda.max_memory_allocated())
    return out


def _grid_serve_rank(grid):
    """grid_serve on one rank of epso_train's spawn: the 4 processes re-cut
    as ep = GRID_SERVE_EP x tp = GRID_SERVE_TP (``init_grid`` over the
    world, dp = 1), the plan resolved for serving, the rank's tiles made
    leaf by leaf (``serve_tiles``), then ``serve_run`` on the plan."""
    import torch
    from repro_torch.parallel import init_grid
    from repro_torch.parallel.plan import ParallelPlan
    from repro_torch.tree import leaves

    cfg = grid_serve_config()
    g = init_grid(grid.world, 1, GRID_SERVE_EP, GRID_SERVE_TP)
    plan = ParallelPlan(ep=GRID_SERVE_EP, tp=GRID_SERVE_TP).resolve(cfg, serving=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = serve_tiles(cfg, g.axis_sizes, g.coords, g.world.device)
    torch.cuda.synchronize()
    params_s = time.perf_counter() - t0
    out = serve_run(cfg, params, plan=plan, grid=g)
    out.update(coords=g.coords, params_s=params_s, table_elems=table_elems(params),
               param_bytes=sum(t.numel() * t.element_size() for t in leaves(params)))
    del params
    torch.cuda.empty_cache()
    return out


def phase_grid_serve(ranks) -> dict:
    """The grid_serve runs of epso_train's ranks (``_grid_serve_rank``):
    full-width Mula-7B-A1B at GRID_SERVE_LAYERS layers served on ep =
    GRID_SERVE_EP x tp = GRID_SERVE_TP. Asserts every rank's tokens rank
    0's, every request's GRID_SERVE_NEW tokens in the vocab, the exact
    launch count of a rank (per layer and call: one dispatch plan, three
    gmm, one SwiGLU, one combine; one flash a prefill); then the same
    weights whole on one rank in this process (``serve_tiles`` on no grid)
    and ``serve_run`` there: the grid's prefill and first decode logits
    within GRID_SERVE_TOL of max|logits| of the one rank's. Prints the
    greedy tokens' agreement with the one-rank engine (bf16: not held),
    decode ms, peak memory and launches."""
    import torch

    cfg = grid_serve_config()
    L = cfg.num_layers
    r0 = ranks[0]["serve"]
    calls = r0["prefills"] + r0["decode_steps"]
    expect = {"gmm": 3 * L * calls, "swiglu": L * calls, "combine": L * calls,
              "dispatch_plan": L * calls, "token_counts": 0,
              "flash_attention": L * r0["prefills"], "tgmm": 0, "swiglu_bwd": 0,
              "combine_bwd": 0, "ssd_intra_chunk": 0}
    for i, rk in enumerate(ranks):
        run, where = rk["serve"], f"grid_serve rank {i}"
        if run["tokens"] != r0["tokens"]:
            raise AssertionError(f"{where}: tokens differ from rank 0's")
        if any(len(t) != GRID_SERVE_NEW or not all(0 <= x < cfg.vocab_size for x in t)
               for t in run["tokens"]):
            raise AssertionError(f"{where}: a request's tokens are off: {run['tokens']}")
        if run["launches"] != expect:
            raise AssertionError(f"{where}: launches {run['launches']} != {expect}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = serve_tiles(cfg, {}, {}, DEV)
    torch.cuda.synchronize()
    params_s = time.perf_counter() - t0
    one = serve_run(cfg, params)
    del params
    torch.cuda.empty_cache()
    rel = {k: float((r0[k] - one[k]).abs().max() / one[k].abs().max())
           for k in ("prefill_logits", "decode_logits")}
    agree = sum(a == b for g, o in zip(r0["tokens"], one["tokens"]) for a, b in zip(g, o))
    total = GRID_SERVE_NEW * len(r0["tokens"])
    row = {"model": cfg.name, "layers": L, "grid": {"ep": GRID_SERVE_EP, "tp": GRID_SERVE_TP},
           "experts_per_rank": cfg.moe.num_experts // GRID_SERVE_EP,
           "expert_d_ff_per_rank": cfg.moe.d_ff_expert // GRID_SERVE_TP,
           "heads_per_rank": cfg.num_heads // GRID_SERVE_TP, "dtype": "bfloat16",
           "prompt_lengths": list(GRID_SERVE_PROMPTS), "slots": GRID_SERVE_SLOTS,
           "new_tokens_each": GRID_SERVE_NEW, "prefills": r0["prefills"],
           "decode_steps": r0["decode_steps"], "logit_rel_err_to_one_rank": rel,
           "tolerance": GRID_SERVE_TOL,
           "greedy_tokens_agreeing_with_one_rank": f"{agree}/{total}",
           "tokens_equal_on_every_rank": True,
           "decode_ms_median_by_rank": [statistics.median(rk["serve"]["decode_ms"])
                                        for rk in ranks],
           "decode_ms_median_one_rank": statistics.median(one["decode_ms"]),
           "wall_s_by_rank": [rk["serve"]["wall_s"] for rk in ranks],
           "wall_s_one_rank": one["wall_s"],
           "peak_bytes_by_rank": [rk["serve"]["peak_bytes"] for rk in ranks],
           "peak_bytes_one_rank": one["peak_bytes"],
           "param_bytes_by_rank": [rk["serve"]["param_bytes"] for rk in ranks],
           **table_row("grid_serve", [rk["serve"]["table_elems"] for rk in ranks], cfg,
                       {"ep": GRID_SERVE_EP, "tp": GRID_SERVE_TP}),
           "params_s_by_rank": [rk["serve"]["params_s"] for rk in ranks],
           "params_s_one_rank": params_s,
           "coords_by_rank": [rk["serve"]["coords"] for rk in ranks],
           "launches_per_rank": r0["launches"], "expected_launches": expect,
           "launches_one_rank": one["launches"],
           "note": "4 ranks time-share one card over gloo (every tp and ep sum through "
                   "host memory): no step time here is a serving speed"}
    emit("grid_serve", **row)
    if max(rel.values()) > GRID_SERVE_TOL:
        raise AssertionError(f"grid_serve: logits off the one-rank run's by {rel} "
                             f"(> {GRID_SERVE_TOL} of max|logits|)")
    return row


def _tp_train_rank(grid, cfg, train, batch):
    """tp_train on one rank: the reference run on the spawn's own grid
    ('epso'/'ring'), then for each (dp, ep, tp) of TP_GRIDS a grid re-cut
    from the same processes (``init_grid`` over the world), the rank's rows
    (block d * ep + e of the batch, the same on its tp peers) and, for each
    (mode, overlap), TP_STEPS steps from init_state(seed 0): dropless,
    without router terms, at peak lr CMP_LR; the state bytes the EPSO plan
    gives the rank."""
    import dataclasses

    from repro_torch.models import init_params
    from repro_torch.optim.epso import state_bytes_per_device
    from repro_torch.parallel import init_grid
    from repro_torch.train.trainer import placements

    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="dropless", router_aux_coef=0.0, router_z_coef=0.0))
    train = dataclasses.replace(train, lr_peak=CMP_LR, lr_min=CMP_LR / 10)
    shapes = init_params(cfg, device="meta")
    r = grid.world.rank
    out = {"reference": _history_run(cfg, train, grid, "epso", "ring",
                                     {k: v[r:r + 1] for k, v in batch.items()}, TP_STEPS)}
    for (dp, ep, tp), runs in TP_GRIDS:
        g = init_grid(grid.world, dp, ep, tp)
        n = batch["tokens"].shape[0] // (dp * ep)
        b = g.coords["data"] * ep + g.coords["ep"]
        rows = {k: v[b * n:(b + 1) * n] for k, v in batch.items()}
        sizes = g.axis_sizes
        for mode, overlap in runs:
            # ep x tp 'none': also under 'block_sc', each with a profiled step
            sc = (ep, tp, mode) == (2, 2, "none")
            run = _history_run(cfg, train, g, mode, overlap, rows, TP_STEPS, profile=sc)
            run["state_bytes_expected"] = state_bytes_per_device(
                shapes, placements(cfg, shapes, sizes), sizes, mode)
            run["coords"], run["sizes"] = g.coords, sizes
            if sc:
                run["block_sc"] = _history_run(cfg, train, g, mode, overlap, rows, TP_STEPS,
                                               sac="block_sc", profile=True)
            out[f"{dp}x{ep}x{tp} {mode}/{overlap}"] = run
    return out


def placement_row(num_experts: int, ep: int, seed: int = PLACEMENT_SEED) -> tuple:
    """A fixed non-identity placement row from ``seed``: EP rank r keeps a
    random half of its experts and takes a random half of rank r + 1's (mod
    ep), in a random order within the rank."""
    import numpy as np
    rng = np.random.default_rng(seed)
    EL = num_experts // ep
    own = [[int(g) for g in rng.permutation(range(r * EL, (r + 1) * EL))] for r in range(ep)]
    half = EL // 2
    return tuple(int(g) for r in range(ep)
                 for g in rng.permutation(own[r][:half] + own[(r + 1) % ep][half:]))


def _slice_sums(state, layout, grid) -> dict:
    """Per expert stack of the state (params, master, m, v), this rank's
    tile summed exactly on every (layer, dim-1 index): {key: {"offset": the
    tile's first position, "other": the rank's coordinates on the axes
    splitting the other dims, "sums": (L, n, 2) int64}}, two sums of the
    elements' bit patterns (plain and index-weighted), so equal slices give
    equal sums and a changed bit changes them. The offset is worked out
    here from the layout, mesh-major, not by the port's helpers."""
    import torch
    from repro_torch.tree import keyed_leaves, leaves_with_path

    sizes, coords = grid.axis_sizes, grid.coords
    out = {}
    for prefix, tree in ((".params", state.params), (".opt.master", state.opt.master),
                         (".opt.m", state.opt.m), (".opt.v", state.opt.v)):
        for (key, t), (path, _) in zip(keyed_leaves(tree, prefix), leaves_with_path(tree)):
            shape, place = layout[key]
            if "/moe/" not in f"/{path}" or "shared" in path or \
                    path.rsplit("/", 1)[-1] not in ("gate", "up", "down"):
                continue
            k = 0
            for a in place[1]:
                k = k * sizes[a] + coords[a]
            bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
            bits = bits.reshape(t.shape[0], t.shape[1], -1)
            w = torch.arange(bits.shape[-1], device=t.device) % 1021 + 1
            sums = torch.stack([torch.stack((b.long().sum(-1), (b.long() * w).sum(-1)), -1)
                                for b in bits]).cpu()
            out[key] = {"offset": k * t.shape[1], "sums": sums,
                        "other": [(d, a, coords[a]) for d, axes in enumerate(place)
                                  if d != 1 for a in axes]}
    return out


def _placement_train_rank(grid, cfg, train, mine, steps):
    """placement_train on one rank of the epso grid: the dropless
    'epso'/'ring' run from init_state(seed 0), ``steps`` steps unplaced;
    then its state after step PLACEMENT_MOVE_AFTER, kept on the host, is
    written back, moved to ``placement_row``'s placement
    (``apply_placement``) and takes the later steps again in a step rebuilt
    for it. Per run the metrics and launches; for the move its wall ms, the
    bytes this rank sent (computed by ``apply_placement`` from the shapes),
    the slice sums of the expert stacks before and after it and the state
    bytes after it."""
    import dataclasses

    import torch
    from repro_torch.configs import ParallelConfig
    from repro_torch.ft import restore_into, snapshot
    from repro_torch.kernels import ops
    from repro_torch.parallel.placement import ExpertPlacement, apply_placement
    from repro_torch.train import init_state, make_train_step, state_layout
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="dropless"))
    mode = "epso"
    par = ParallelConfig(microbatches=1, remat_policy="block", opt_overlap="ring")
    layout = state_layout(cfg, grid.axis_sizes, mode)
    L, E = cfg.num_layers, cfg.moe.num_experts
    placed = ExpertPlacement.broadcast(placement_row(E, grid.ep.world), L)
    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")
    cut = PLACEMENT_MOVE_AFTER + 1

    def run(step, first):
        nonlocal state
        history = []
        ops.reset_launches()
        for i in range(first, steps):
            if i == cut and first == 0:
                kept.update(snapshot(state))
            state, m = step(state, mine)
            history.append({**{k: float(m[k]) for k in keys},
                            "counts": m["moe_counts"].double().cpu().tolist()})
        return {"history": history, "launches": dict(ops.launches)}

    torch.cuda.empty_cache()
    state, kept = init_state(cfg, train, seed=0, grid=grid, opt_sharding_mode=mode), {}
    out = {"row": list(placed.perm[0]),
           "unplaced": run(make_train_step(cfg, par, train, opt_sharding_mode=mode, grid=grid),
                           0)}
    restore_into(state, kept)
    del kept
    before = _slice_sums(state, layout, grid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, sent = apply_placement(state, ExpertPlacement.identity(L, E), placed, grid=grid,
                                  layout=layout)
    torch.cuda.synchronize()
    move = {"ms": (time.perf_counter() - t0) * 1e3, "sent_bytes": sent,
            "before": before, "after": _slice_sums(state, layout, grid),
            "state_bytes": sum(t.numel() * 4 for tree in (state.opt.master, state.opt.m,
                                                          state.opt.v) for t in leaves(tree))}
    out["placed"] = {**run(make_train_step(cfg, par, train, opt_sharding_mode=mode, grid=grid,
                                           placement=placed), cut), "move": move}
    out["table_elems"] = table_elems(state.params)
    del state
    return out


def _moved_slices_differ(moves, row, phase: str = "placement_train") -> tuple:
    """(slices compared, those that differ) over every rank's expert stacks
    (``moves``: each rank's move record, its ``before`` and ``after`` slice
    sums): the sums at position ``pos`` after the move against those of
    global id ``row[pos]`` before it, from the rank that held it with the
    same cut of the other dims (an fsdp tile's 'data' coordinate among
    them; replicas must agree)."""
    import numpy as np

    ref = {}
    for move in moves:
        for key, b in move["before"].items():
            table = ref.setdefault((key, repr(b["other"])), {})
            for j in range(b["sums"].shape[1]):
                got = b["sums"][:, j].numpy()
                if b["offset"] + j in table and not np.array_equal(table[b["offset"] + j], got):
                    raise AssertionError(f"{phase}: replicas of {key} differ before the move")
                table[b["offset"] + j] = got
    compared, differ = 0, []
    for i, move in enumerate(moves):
        for key, a in move["after"].items():
            table = ref[(key, repr(a["other"]))]
            if sorted(table) != list(range(len(row))):
                raise AssertionError(f"{phase}: {key} before the move covers "
                                     f"{len(table)} of {len(row)} experts")
            for j in range(a["sums"].shape[1]):
                pos = a["offset"] + j
                compared += a["sums"].shape[0]
                if not np.array_equal(a["sums"][:, j].numpy(), table[row[pos]]):
                    differ.append((i, key, pos))
    return compared, differ


def phase_epso_train(ranks, wall: float) -> tuple:
    """Full-width Mula-7B-A1B, EPSO_LAYERS of its 16 layers, on an EPSO_DP x
    EPSO_EP grid of ranks sharing the card over gloo, in each of
    EPSO_RUNS: EPSO_STEPS steps on the fixed batch (one EP_SEQ-token row a
    rank), microbatches 1, block remat, the config's capacity dispatch:
    the session's job ``ranks`` (``_epso_train_rank``), and the phases
    its ranks ran after it."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train.trainer import placements
    from repro_torch.tree import leaves_with_path

    cfg = get_config(MULA)
    world = EPSO_DP * EPSO_EP
    sizes = {"data": EPSO_DP, "ep": EPSO_EP}
    expect = expected_train_launches(EPSO_LAYERS, 1, EPSO_STEPS)
    # the leaves 'ep' splits (the expert stacks, the tables' vocab rows)
    on_ep = {path for path, pl in leaves_with_path(placements(
        cfg, init_params(cfg, device="meta"), sizes)) if any("ep" in e for e in pl)}
    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")
    names = [f"{mode}/{ov}" for mode, ov in EPSO_RUNS]
    base = [s["loss"] for s in ranks[0]["runs"][names[0]]["history"]]
    for name, (mode, _) in zip(names, EPSO_RUNS):
        for i, rk in enumerate(ranks):
            run = rk["runs"][name]
            h = run["history"]
            where = f"epso_train {name} rank {i}"
            if not all(math.isfinite(s[k]) for s in h for k in keys):
                raise AssertionError(f"{where}: non-finite metrics {h}")
            if not h[-1]["loss"] < h[0]["loss"]:
                raise AssertionError(f"{where}: loss did not fall: {[s['loss'] for s in h]}")
            if not all(s["clip_scale"] <= 1.0 for s in h):
                raise AssertionError(f"{where}: clip_scale above 1")
            if [{k: s[k] for k in keys} for s in h] != [
                    {k: s[k] for k in keys} for s in ranks[0]["runs"][name]["history"]]:
                raise AssertionError(f"{where}: metrics differ from rank 0's")
            if h[0]["loss"] != base[0]:
                raise AssertionError(f"{where}: step 0 loss {h[0]['loss']} != 'none''s {base[0]}")
            rel = [abs(s["loss"] - b) / abs(b) for s, b in zip(h, base)]
            if max(rel) > 0.01:
                raise AssertionError(f"{where}: losses off 'none''s by {rel} (> 1 %)")
            if not run["state_bytes"] == run["state_bytes_expected"] == EPSO_STATE_BYTES[mode]:
                raise AssertionError(f"{where}: state bytes {run['state_bytes']} measured, "
                                     f"{run['state_bytes_expected']} planned, "
                                     f"{EPSO_STATE_BYTES[mode]} expected")
            if run["launches"] != expect:
                raise AssertionError(f"{where}: launches {run['launches']} != {expect}")
            # replicated leaves equal on every rank, a tile 'ep' cuts (an
            # expert slice, a table's vocab rows) on the ranks holding it
            # (the same 'ep' coordinate)
            twin = next(o for o in ranks if o["coords"]["ep"] == rk["coords"]["ep"]
                        and o is not rk)["runs"][name]["checksums"]
            for path, cs in run["checksums"].items():
                other = twin if path in on_ep else ranks[0]["runs"][name]["checksums"]
                if cs != other[path]:
                    raise AssertionError(f"{where}: params {path} differ across ranks")
    runs = {}
    for name in names:
        r0 = ranks[0]["runs"][name]
        runs[name] = {
            "losses": [s["loss"] for s in r0["history"]],
            "grad_norms": [s["grad_norm"] for s in r0["history"]],
            "clip_scales": [s["clip_scale"] for s in r0["history"]],
            "loss_rel_to_none": [abs(s["loss"] - b) / abs(b)
                                 for s, b in zip(r0["history"], base)],
            "step_ms_by_rank": [[s["step_ms"] for s in rk["runs"][name]["history"]]
                                for rk in ranks],
            "step_ms_median_by_rank": [statistics.median(
                s["step_ms"] for s in rk["runs"][name]["history"][1:]) for rk in ranks],
            "peak_bytes_by_rank": [rk["runs"][name]["peak_bytes"] for rk in ranks],
            "init_s_by_rank": [rk["runs"][name]["init_s"] for rk in ranks],
            "state_bytes_per_rank": r0["state_bytes"], "plan": r0["plan"],
            **table_row(f"epso_train {name}", [rk["runs"][name]["table_elems"] for rk in ranks],
                        cfg, sizes),
            "collectives_host_ms_rank0": sum(
                v["ms"] for n, v in r0["profile"]["host_events"].items()
                if n.startswith("gloo:")),
            "profile_step_rank0": r0["profile"]}
    row = {"model": cfg.name, "layers": EPSO_LAYERS, "grid": {"data": EPSO_DP, "ep": EPSO_EP},
           "ranks": world, "backend": ranks[0]["backend"], "device": ranks[0]["device"],
           "experts_per_rank": cfg.moe.num_experts // EPSO_EP, "seq_per_rank": 1,
           "seq_len": EP_SEQ, "gathered_tokens_per_moe_call": EPSO_EP * EP_SEQ,
           "dispatch": cfg.moe.dispatch, "steps": EPSO_STEPS, "runs": runs,
           "launches_per_rank": ranks[0]["runs"][names[0]]["launches"],
           "expected_launches": expect, "wall_s": wall,
           "note": "4 ranks time-share one card; gloo carries the collectives through host "
                   "memory (the ring's point-to-point exchanges through pinned host "
                   "buffers, explicitly): no step time here is an EP, DP or EPSO speed"}
    emit("epso_train", **row)
    return (row, phase_placement_train(ranks, cfg), phase_a2a_train(ranks, cfg),
            phase_tp_train(ranks, cfg), phase_pp_train(ranks), phase_grid_serve(ranks),
            phase_fsdp_train(ranks, cfg), phase_fsdp_ep_train(ranks, cfg),
            phase_fsdp_tp_train(ranks, cfg), phase_fsdp_pp_train(ranks),
            phase_fsdp_placement_train(ranks, cfg))


def fsdp_layer_bytes(cfg, itemsize: int, sizes=None, part: str = "layers") -> int:
    """The bytes of one layer's fsdp-split leaves in a dtype of ``itemsize``
    bytes (the compute dtype) on a grid of ``sizes`` (default ('data',
    FSDP_DP)), what one gather of a layer of the stacked subtree ``part``
    (``layers``, the hybrid's ``groups`` or ``rem``, or its ``shared``
    block) assembles on every rank: each leaf whole over 'data', the rank's
    slice of it over the other axes that split a layer (an expert stack's
    'ep' slice, a tp shard)."""
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import stacked_dims
    from repro_torch.train.trainer import placements
    from repro_torch.tree import leaves
    sizes = sizes or {"data": FSDP_DP}
    shapes = init_params(cfg, device="meta")
    place = placements(cfg, shapes, sizes, fsdp=True)
    per = math.prod(leaves(shapes[part])[0].shape[:stacked_dims(part + "/")])
    return sum(t.numel() // per // math.prod(
        sizes[a] for e in pl for a in e if a not in ("data", "pp")) * itemsize
        for t, pl in zip(leaves(shapes[part]), leaves(place[part]))
        if any("data" in e for e in pl))


def _fsdp_held_to(h, ref, where: str, what: str) -> tuple:
    """Hold an fsdp run's history ``h`` to ``ref``, the history of the run
    without fsdp it is compared with (``what`` names it): step 0's loss bit
    for bit, the losses and the ce within FSDP_LOSS_TOL, the grad norms
    within FSDP_NORM_TOL while the params are step 0's (every earlier
    step's lr was 0) and within FSDP_NORM_TOL_UPDATED after an update.
    Returns the relative differences by metric and those steps."""
    fresh = [i for i in range(len(ref)) if all(s["lr"] == 0 for s in ref[:i])]
    rel = {k: [abs(s[k] - b[k]) / abs(b[k]) for s, b in zip(h, ref)]
           for k in ("loss", "ce", "grad_norm")}
    if h[0]["loss"] != ref[0]["loss"]:
        raise AssertionError(f"{where}: step 0 loss {h[0]['loss']} != {what}'s "
                             f"{ref[0]['loss']}")
    for key in ("loss", "ce"):
        if max(rel[key]) > FSDP_LOSS_TOL:
            raise AssertionError(f"{where}: {key} off {what}'s by {rel[key]} "
                                 f"(> {FSDP_LOSS_TOL})")
    norm = rel["grad_norm"]
    if max(norm[i] for i in fresh) > FSDP_NORM_TOL or max(norm) > FSDP_NORM_TOL_UPDATED:
        raise AssertionError(f"{where}: grad norms off {what}'s by {norm} (> {FSDP_NORM_TOL} "
                             f"at steps {fresh}, on step 0's params, or > "
                             f"{FSDP_NORM_TOL_UPDATED})")
    return rel, fresh


def phase_fsdp_train(ranks, cfg) -> dict:
    """The fsdp runs of epso_train's ranks (``_fsdp_train_rank``): full-width
    Mula-7B-A1B at EPSO_LAYERS layers on ('data', FSDP_DP), one EP_SEQ-token
    row a rank, block remat, EPSO_STEPS steps of FSDP 'none' and of 'so'
    without fsdp. Asserts on every rank finite metrics, a falling loss,
    clip_scale <= 1, rank 0's metrics, step 0's loss bit for bit the 'so'
    run's and later ones within FSDP_LOSS_TOL (the ce too), the grad norms
    within FSDP_NORM_TOL while the params are step 0's and within
    FSDP_NORM_TOL_UPDATED after an update, the state bytes and param
    elements a rank (planned = measured = FSDP_STATE_BYTES,
    FSDP_PARAM_ELEMS), the gathers, reduce-scatters and gathered bytes of
    the steps (a gather a layer in the forward and again in the recompute,
    a reduce-scatter a layer), the ``c10d::`` all-gathers (those and one
    an expert stack, of its grad-norm slice sums) and reduce-scatters of
    rank 0's profiled last step, and the exact launch count;
    prints peak memory (of the steps alone too), step ms a rank and the
    bytes gathered a step, counted and computed."""
    import dataclasses

    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import is_expert_stack_path
    from repro_torch.train.trainer import placements
    from repro_torch.tree import leaves_with_path
    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")
    L, n = EPSO_LAYERS, EPSO_STEPS
    expect = expected_train_launches(L, 1, n)
    layer = fsdp_layer_bytes(dataclasses.replace(cfg, num_layers=L),
                             getattr(torch, TrainConfig().compute_dtype).itemsize)
    want_stats = {"all_gather": 2 * L * n, "reduce_scatter": L * n,
                  "gathered_bytes": 2 * L * n * layer}
    so = ranks[0]["fsdp"]["so"]["history"][:n]
    for i, rk in enumerate(ranks):
        for name in ("fsdp", "so"):
            run, where = rk["fsdp"][name], f"fsdp_train {name} rank {i}"
            h = run["history"][:n]
            if not all(math.isfinite(s[k]) for s in h for k in keys) or \
                    not all(s["clip_scale"] <= 1.0 for s in h):
                raise AssertionError(f"{where}: non-finite metrics or clip_scale above 1: {h}")
            if not h[-1]["loss"] < h[0]["loss"]:
                raise AssertionError(f"{where}: loss did not fall: {[s['loss'] for s in h]}")
            if [{k: s[k] for k in keys} for s in h] != [
                    {k: s[k] for k in keys} for s in ranks[0]["fsdp"][name]["history"][:n]]:
                raise AssertionError(f"{where}: metrics differ from rank 0's")
            if run["state_bytes"] != FSDP_STATE_BYTES[name]:
                raise AssertionError(f"{where}: state bytes {run['state_bytes']}, expected "
                                     f"{FSDP_STATE_BYTES[name]}")
            if run["launches"] != expect:
                raise AssertionError(f"{where}: launches {run['launches']} != {expect}")
        run, where = rk["fsdp"]["fsdp"], f"fsdp_train fsdp rank {i}"
        rel, fresh = _fsdp_held_to(run["history"][:n], so, where, "'so'")
        if run["param_elems"] != FSDP_PARAM_ELEMS:
            raise AssertionError(f"{where}: {run['param_elems']} param elements, expected "
                                 f"{FSDP_PARAM_ELEMS}")
        if run["fsdp_stats"] != want_stats:
            raise AssertionError(f"{where}: gathers {run['fsdp_stats']} != {want_stats}")
    prof = ranks[0]["fsdp"]["fsdp"]["profile"]
    calls = {k: v["calls"] for k, v in prof["host_events"].items()}
    # and one all-gather of each expert stack's grad-norm slice sums, which
    # the update adds over 'data' in rank order (optim.adamw.sum_in_rank_order)
    lcfg = dataclasses.replace(cfg, num_layers=L)
    stacks = sum(is_expert_stack_path(path) and any("data" in e for e in pl)
                 for path, pl in leaves_with_path(placements(
                     lcfg, init_params(lcfg, device="meta"), {"data": FSDP_DP}, fsdp=True)))
    want_calls = {"c10d::allgather_": 2 * L + stacks, "c10d::reduce_scatter_": L}
    if {k: calls.get(k, 0) for k in want_calls} != want_calls:
        raise AssertionError(f"fsdp_train: rank 0's profiled step made {calls}, expected "
                             f"{want_calls}")
    runs = {}
    for name in ("fsdp", "so"):
        r0 = ranks[0]["fsdp"][name]
        rel = _fsdp_held_to(r0["history"], so, "fsdp_train", "'so'")[0]
        runs[name] = {
            "losses": [s["loss"] for s in r0["history"]],
            "grad_norms": [s["grad_norm"] for s in r0["history"]],
            "loss_rel_to_so": rel["loss"], "ce_rel_to_so": rel["ce"],
            "grad_norm_rel_to_so": rel["grad_norm"],
            "state_bytes_per_rank": r0["state_bytes"], "param_elems_per_rank": r0["param_elems"],
            "peak_bytes_by_rank": [rk["fsdp"][name]["peak_bytes"] for rk in ranks],
            "peak_bytes_steps_by_rank": [rk["fsdp"][name]["peak_bytes_steps"] for rk in ranks],
            "step_ms_by_rank": [[s["step_ms"] for s in rk["fsdp"][name]["history"]]
                                for rk in ranks],
            "step_ms_median_by_rank": [statistics.median(
                s["step_ms"] for s in rk["fsdp"][name]["history"][1:]) for rk in ranks]}
    fs = ranks[0]["fsdp"]["fsdp"]
    runs["fsdp"].update({
        "gathered_bytes_per_step_counted": fs["fsdp_stats"]["gathered_bytes"] / n,
        "gathered_bytes_per_step_computed": 2 * L * layer,
        "gathers_per_step": fs["fsdp_stats"]["all_gather"] / n,
        "reduce_scatters_per_step": fs["fsdp_stats"]["reduce_scatter"] / n,
        "profiled_step_calls_rank0": calls,
        "profiled_step_gloo_host_ms_rank0": sum(v["ms"] for k, v in prof["host_events"].items()
                                                if k.startswith("gloo:")),
        "profile_step_rank0": prof})
    row = {"model": cfg.name, "layers": L, "grid": {"data": FSDP_DP}, "ranks": len(ranks),
           "seq_per_rank": 1, "seq_len": EP_SEQ, "steps": n, "remat": "block",
           "dispatch": cfg.moe.dispatch, "runs": runs, "tolerance": FSDP_LOSS_TOL,
           "grad_norm_tolerance": {"steps_on_step0_params": fresh, "there": FSDP_NORM_TOL,
                                   "after_an_update": FSDP_NORM_TOL_UPDATED},
           "layer_bytes_gathered": layer,
           "launches_per_rank": ranks[0]["fsdp"]["fsdp"]["launches"],
           "expected_launches": expect,
           "note": "4 ranks time-share one card; gloo carries the gathers and reduce-scatters "
                   "(as all-reduces) through host memory: no step time here is an FSDP speed"}
    emit("fsdp_train", **row)
    return row


def phase_fsdp_ep_train(ranks, cfg) -> dict:
    """The fsdp run of epso_train's ranks on their EPSO_DP x EPSO_EP grid
    (``_history_run(fsdp=True)`` in FSDP_EP_RUN's mode): full-width
    Mula-7B-A1B at EPSO_LAYERS layers, one EP_SEQ-token row a rank, block
    remat, EPSO_STEPS steps, each rank holding its 'data' tile of every
    layer weight (of an expert stack, of its 'ep' slice) and the EPSO
    shards of those tiles. Held to epso_train's own run in that mode on the
    same rows: step 0's loss bit for bit, the later losses and the ce within
    FSDP_LOSS_TOL, the grad norms within FSDP_NORM_TOL while the params are
    step 0's and within FSDP_NORM_TOL_UPDATED after an update. Asserts on
    every rank finite metrics, a falling loss, clip_scale <= 1, rank 0's
    metrics, the state bytes and param elements a rank (FSDP_EP_STATE_BYTES
    = ``state_bytes_per_device`` of the fsdp placements, FSDP_EP_PARAM_ELEMS),
    the gathers, reduce-scatters and bytes gathered of each step, and the
    exact launch count; prints peak memory a rank beside epso_train's,
    step ms and the bytes gathered a step."""
    import dataclasses

    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.models import init_params
    from repro_torch.optim.epso import state_bytes_per_device
    from repro_torch.train.trainer import placements

    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")
    L, n = EPSO_LAYERS, EPSO_STEPS
    sizes = {"data": EPSO_DP, "ep": EPSO_EP}
    lcfg = dataclasses.replace(cfg, num_layers=L)
    shapes = init_params(lcfg, device="meta")
    planned = state_bytes_per_device(shapes, placements(lcfg, shapes, sizes, fsdp=True), sizes,
                                     FSDP_EP_RUN[0])
    expect = expected_train_launches(L, 1, n)
    layer = fsdp_layer_bytes(lcfg, getattr(torch, TrainConfig().compute_dtype).itemsize, sizes)
    want_stats = {"all_gather": 2 * L * n, "reduce_scatter": L * n,
                  "gathered_bytes": 2 * L * n * layer}
    name = "/".join(FSDP_EP_RUN)
    ref = ranks[0]["runs"][name]["history"][:n]
    if planned != FSDP_EP_STATE_BYTES:
        raise AssertionError(f"fsdp_ep_train: {planned} state bytes planned, expected "
                             f"{FSDP_EP_STATE_BYTES}")
    for i, rk in enumerate(ranks):
        run, where = rk["fsdp_ep"], f"fsdp_ep_train rank {i}"
        h = run["history"][:n]
        if not all(math.isfinite(s[k]) for s in h for k in keys) or \
                not all(s["clip_scale"] <= 1.0 for s in h):
            raise AssertionError(f"{where}: non-finite metrics or clip_scale above 1: {h}")
        if not h[-1]["loss"] < h[0]["loss"]:
            raise AssertionError(f"{where}: loss did not fall: {[s['loss'] for s in h]}")
        if [{k: s[k] for k in keys} for s in h] != [
                {k: s[k] for k in keys} for s in ranks[0]["fsdp_ep"]["history"][:n]]:
            raise AssertionError(f"{where}: metrics differ from rank 0's")
        rel, fresh = _fsdp_held_to(h, ref, where, f"epso_train {name}")
        if run["state_bytes"] != FSDP_EP_STATE_BYTES or \
                run["param_elems"] != FSDP_EP_PARAM_ELEMS:
            raise AssertionError(f"{where}: {run['state_bytes']} state bytes and "
                                 f"{run['param_elems']} param elements, expected "
                                 f"{FSDP_EP_STATE_BYTES} and {FSDP_EP_PARAM_ELEMS}")
        if run["fsdp_stats"] != want_stats:
            raise AssertionError(f"{where}: gathers {run['fsdp_stats']} != {want_stats}")
        if run["launches"] != expect:
            raise AssertionError(f"{where}: launches {run['launches']} != {expect}")
    r0 = ranks[0]["fsdp_ep"]
    rel, fresh = _fsdp_held_to(r0["history"], ref, "fsdp_ep_train", f"epso_train {name}")
    row = {"model": cfg.name, "layers": L, "grid": sizes, "ranks": len(ranks),
           "mode": name, "seq_per_rank": 1, "seq_len": EP_SEQ, "steps": n, "remat": "block",
           "dispatch": cfg.moe.dispatch,
           "losses": [s["loss"] for s in r0["history"]],
           "grad_norms": [s["grad_norm"] for s in r0["history"]],
           "loss_rel_to_epso": rel["loss"], "ce_rel_to_epso": rel["ce"],
           "grad_norm_rel_to_epso": rel["grad_norm"],
           "tolerance": FSDP_LOSS_TOL,
           "grad_norm_tolerance": {"steps_on_step0_params": fresh, "there": FSDP_NORM_TOL,
                                   "after_an_update": FSDP_NORM_TOL_UPDATED},
           "state_bytes_per_rank": r0["state_bytes"], "param_elems_per_rank": r0["param_elems"],
           **table_row("fsdp_ep_train", [rk["fsdp_ep"]["table_elems"] for rk in ranks], cfg,
                       sizes),
           "peak_bytes_by_rank": [rk["fsdp_ep"]["peak_bytes"] for rk in ranks],
           "peak_bytes_steps_by_rank": [rk["fsdp_ep"]["peak_bytes_steps"] for rk in ranks],
           "peak_bytes_by_rank_epso": [rk["runs"][name]["peak_bytes"] for rk in ranks],
           "step_ms_by_rank": [[s["step_ms"] for s in rk["fsdp_ep"]["history"]]
                               for rk in ranks],
           "step_ms_median_by_rank": [statistics.median(
               s["step_ms"] for s in rk["fsdp_ep"]["history"][1:]) for rk in ranks],
           # epso_train's last step is profiled on rank 0
           "step_ms_median_by_rank_epso": [statistics.median(
               s["step_ms"] for s in rk["runs"][name]["history"][1:-1]) for rk in ranks],
           "gathered_bytes_per_step_counted": r0["fsdp_stats"]["gathered_bytes"] / n,
           "gathered_bytes_per_step_computed": 2 * L * layer,
           "gathers_per_step": r0["fsdp_stats"]["all_gather"] / n,
           "reduce_scatters_per_step": r0["fsdp_stats"]["reduce_scatter"] / n,
           "layer_bytes_gathered": layer,
           "launches_per_rank": r0["launches"], "expected_launches": expect,
           "note": "4 ranks time-share one card; gloo carries the gathers, the "
                   "reduce-scatters and the EPSO collectives through host memory: no step "
                   "time here is an FSDP speed"}
    emit("fsdp_ep_train", **row)
    return row


def _fsdp_pair(ranks, key: str, sizes: dict, lcfg, want: dict, expect: dict, pairs: int,
               gathers: int, n_mb: int = 1) -> dict:
    """Hold the fsdp run of each rank's ``ranks[i][key]`` (``_history_run``
    pairs 'fsdp' and 'plain', the same grid of ``sizes`` and mode without
    fsdp) and return the phase's row: on every rank both runs' finite
    metrics, a falling loss, clip_scale <= 1, rank 0's metrics, no drops
    and ``pairs`` routed pairs a step, the exact launch count ``expect``;
    the fsdp run held to the plain one (``_fsdp_held_to``), its state
    bytes (planned and measured) and param elements ``want``, and its
    gathers (``gathers`` a layer of the rank and microbatch),
    reduce-scatters (one) and bytes gathered of each step; the plain run's
    state bytes its plan's. Under pp (``want['pp']``) each step's
    saved-input peak and bytes handed to the neighbour stage as pp_train's."""
    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.models import init_params
    from repro_torch.optim.epso import state_bytes_per_device
    from repro_torch.train.trainer import placements

    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")
    n = FSDP_GRID_STEPS
    pp = sizes.get("pp", 1)
    lay = lcfg.num_layers // pp * n_mb * n
    layer = fsdp_layer_bytes(lcfg, getattr(torch, TrainConfig().compute_dtype).itemsize, sizes)
    want_stats = {"all_gather": gathers * lay, "reduce_scatter": lay,
                  "gathered_bytes": gathers * lay * layer}
    shapes = init_params(lcfg, device="meta")
    planned = {f: state_bytes_per_device(shapes, placements(lcfg, shapes, sizes, fsdp=f), sizes,
                                         "epso") for f in (True, False)}
    if planned[True] != want["state_bytes"]:
        raise AssertionError(f"{key}: {planned[True]} state bytes planned, expected "
                             f"{want['state_bytes']}")
    name = f"{key}_train"
    for i, rk in enumerate(ranks):
        for which, fsdp in (("fsdp", True), ("plain", False)):
            run, where = rk[key][which], f"{name} {which} rank {i}"
            h = run["history"]
            if not all(math.isfinite(s[k]) for s in h for k in keys) or \
                    not all(s["clip_scale"] <= 1.0 for s in h):
                raise AssertionError(f"{where}: non-finite metrics or clip_scale above 1: {h}")
            if not h[-1]["loss"] < h[0]["loss"]:
                raise AssertionError(f"{where}: loss did not fall: {[s['loss'] for s in h]}")
            if [{k: s[k] for k in keys + ("counts",)} for s in h] != [
                    {k: s[k] for k in keys + ("counts",)}
                    for s in ranks[0][key][which]["history"]]:
                raise AssertionError(f"{where}: metrics differ from rank 0's")
            if any(s["moe_drops"] != 0 for s in h) or any(sum(s["counts"]) != pairs for s in h):
                raise AssertionError(f"{where}: drops or routed pairs off: "
                                     f"{[(s['moe_drops'], sum(s['counts'])) for s in h]}")
            if run["state_bytes"] != planned[fsdp]:
                raise AssertionError(f"{where}: state bytes {run['state_bytes']}, planned "
                                     f"{planned[fsdp]}")
            if run["launches"] != expect:
                raise AssertionError(f"{where}: launches {run['launches']} != {expect}")
            if pp > 1:
                stage = rk[key]["coords"]["pp"]
                act = PP_SEQ * lcfg.d_model * 2         # one row, bf16
                for s in h:
                    want_sent = n_mb * act * ((stage < pp - 1) + (stage > 0))
                    if s["saved_peak"] != pp - stage or s["sent_bytes"] != want_sent:
                        raise AssertionError(f"{where}: saved-input peak {s['saved_peak']} "
                                             f"(want {pp - stage}) or bytes handed off "
                                             f"{s['sent_bytes']} (want {want_sent})")
        run, where = rk[key]["fsdp"], f"{name} rank {i}"
        _fsdp_held_to(run["history"], rk[key]["plain"]["history"], where, "the plain run")
        if run["param_elems"] != want["param_elems"]:
            raise AssertionError(f"{where}: {run['param_elems']} param elements, expected "
                                 f"{want['param_elems']}")
        if run["fsdp_stats"] != want_stats:
            raise AssertionError(f"{where}: gathers {run['fsdp_stats']} != {want_stats}")
    r0, p0 = ranks[0][key]["fsdp"], ranks[0][key]["plain"]
    rel, fresh = _fsdp_held_to(r0["history"], p0["history"], name, "the plain run")
    tables = table_row(name, [rk[key][w]["table_elems"] for rk in ranks for w in
                              ("fsdp", "plain")], lcfg, sizes)
    row = {"model": lcfg.name, "layers": lcfg.num_layers, "grid": sizes, "ranks": len(ranks),
           **tables,
           "mode": "epso/ring", "dispatch": "dropless",
           "router_coefs": [lcfg.moe.router_aux_coef, lcfg.moe.router_z_coef],
           "microbatches": n_mb, "steps": n, "remat": "block",
           "coords_by_rank": [rk[key]["coords"] for rk in ranks],
           "losses": [s["loss"] for s in r0["history"]],
           "losses_plain": [s["loss"] for s in p0["history"]],
           "grad_norms": [s["grad_norm"] for s in r0["history"]],
           "grad_norms_plain": [s["grad_norm"] for s in p0["history"]],
           "loss_rel_to_plain": rel["loss"], "ce_rel_to_plain": rel["ce"],
           "grad_norm_rel_to_plain": rel["grad_norm"], "tolerance": FSDP_LOSS_TOL,
           "grad_norm_tolerance": {"steps_on_step0_params": fresh, "there": FSDP_NORM_TOL,
                                   "after_an_update": FSDP_NORM_TOL_UPDATED},
           "state_bytes_per_rank": r0["state_bytes"], "state_bytes_plain": p0["state_bytes"],
           "param_elems_per_rank": r0["param_elems"], "param_elems_plain": p0["param_elems"],
           "peak_bytes_by_rank": [rk[key]["fsdp"]["peak_bytes"] for rk in ranks],
           "peak_bytes_by_rank_plain": [rk[key]["plain"]["peak_bytes"] for rk in ranks],
           "peak_bytes_steps_by_rank": [rk[key]["fsdp"]["peak_bytes_steps"] for rk in ranks],
           "step_ms_by_rank": [[s["step_ms"] for s in rk[key]["fsdp"]["history"]]
                               for rk in ranks],
           "step_ms_median_by_rank": [statistics.median(
               s["step_ms"] for s in rk[key]["fsdp"]["history"][1:]) for rk in ranks],
           "step_ms_median_by_rank_plain": [statistics.median(
               s["step_ms"] for s in rk[key]["plain"]["history"][1:]) for rk in ranks],
           "gathered_bytes_per_step_counted": r0["fsdp_stats"]["gathered_bytes"] / n,
           "gathered_bytes_per_step_computed": gathers * lay // n * layer,
           "gathers_per_step": r0["fsdp_stats"]["all_gather"] / n,
           "reduce_scatters_per_step": r0["fsdp_stats"]["reduce_scatter"] / n,
           "layer_bytes_gathered": layer,
           "launches_per_rank": r0["launches"], "expected_launches": expect,
           "note": "4 ranks time-share one card; gloo carries the gathers, the "
                   "reduce-scatters, the tp sums, the stage hand-offs and the EPSO "
                   "collectives through host memory: no step time here is a speed"}
    if pp > 1:
        row.update(saved_peak_by_rank=[rk[key]["fsdp"]["history"][0]["saved_peak"]
                                       for rk in ranks],
                   handoff_bytes_per_step_by_rank=[rk[key]["fsdp"]["history"][0]["sent_bytes"]
                                                   for rk in ranks],
                   moe_aux=[s["moe_aux"] for s in r0["history"]])
    emit(name, **row)
    return row


def phase_fsdp_tp_train(ranks, cfg) -> dict:
    """The fsdp run of epso_train's ranks on ('data', 2) x ('tp', 2)
    (``_fsdp_tp_train_rank``): full-width Mula-7B-A1B at EPSO_LAYERS layers,
    the expert-TP EP = 1 form, dropless, router terms on, one EP_SEQ-token
    row a 'data' rank, FSDP_GRID_STEPS steps of 'epso'/'ring' with fsdp beside
    the same grid's run without it, held by ``_fsdp_pair`` (a layer
    gathered twice a step, in the forward and the recompute), the state
    bytes and param elements a rank FSDP_TP_STATE_BYTES and
    FSDP_TP_PARAM_ELEMS; prints peak memory, step ms and the bytes gathered
    a step."""
    import dataclasses
    dp, ep, tp = FSDP_TP_GRID
    lcfg = dataclasses.replace(cfg, num_layers=EPSO_LAYERS)
    lcfg = dataclasses.replace(lcfg, moe=dataclasses.replace(lcfg.moe, dispatch="dropless"))
    sizes = {a: k for a, k in (("data", dp), ("ep", ep), ("tp", tp)) if k > 1}
    return _fsdp_pair(ranks, "fsdp_tp", sizes, lcfg,
                      {"state_bytes": FSDP_TP_STATE_BYTES, "param_elems": FSDP_TP_PARAM_ELEMS},
                      expected_train_launches(EPSO_LAYERS, 1, FSDP_GRID_STEPS),
                      dp * EP_SEQ * lcfg.moe.experts_per_token, 2)


def phase_fsdp_pp_train(ranks) -> dict:
    """The fsdp run of epso_train's ranks on ('data', FSDP_PP_DP) x ('pp',
    FSDP_PP_STAGES) (``_fsdp_pp_train_rank``): full-width Mula-7B-A1B at
    EPSO_LAYERS layers, one a stage, 'epso'/'ring', dropless, router terms
    on, FSDP_PP_MB microbatches, FSDP_GRID_STEPS 1f1b steps with fsdp beside the same
    grid's run without it, held by ``_fsdp_pair`` (a layer gathered three
    times a microbatch: the F tick, the B tick's forward, the recompute),
    the state bytes and param elements a rank FSDP_PP_STATE_BYTES and
    FSDP_PP_PARAM_ELEMS, the exact launch count of a stage; prints peak
    memory, step ms and the bytes gathered a step."""
    cfg, train = pp_train_config(EPSO_LAYERS, FSDP_PP_DP, FSDP_PP_MB)
    sizes = {"data": FSDP_PP_DP, "pp": FSDP_PP_STAGES}
    return _fsdp_pair(ranks, "fsdp_pp", sizes, cfg,
                      {"state_bytes": FSDP_PP_STATE_BYTES, "param_elems": FSDP_PP_PARAM_ELEMS},
                      expected_pp_launches(EPSO_LAYERS // FSDP_PP_STAGES, FSDP_PP_MB,
                                           FSDP_GRID_STEPS),
                      train.global_batch * PP_SEQ * cfg.moe.experts_per_token, 3, FSDP_PP_MB)


def phase_fsdp_placement_train(ranks, cfg) -> dict:
    """The fsdp placement run of epso_train's ranks (``_fsdp_placement_rank``):
    full-width Mula-7B-A1B at EPSO_LAYERS layers on the EPSO_DP x EPSO_EP
    grid, FSDP 'epso'/'ring', dropless, one EP_SEQ-token row a rank; the
    state after step FSDP_PLACEMENT_MOVE_AFTER moved to placement_train's
    placement and the next step taken again under it. Asserts every moved
    (layer, expert) tile of params, master, m and v equal to its source by
    the exact sums of its bits (``_moved_slices_differ``, each rank's 'data'
    tile against the same tile), the state bytes FSDP_EP_STATE_BYTES after
    the move, the placed step's loss within PLACEMENT_LOSS_TOL of the
    unplaced step's, no drops and the routed pairs conserved, rank 0's
    metrics on every rank, each step's gathers, reduce-scatters and bytes
    gathered and its exact launch count. Prints the move's ms and bytes a
    rank."""
    import dataclasses

    import torch
    from repro_torch.configs import TrainConfig

    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")
    L, sizes = EPSO_LAYERS, {"data": EPSO_DP, "ep": EPSO_EP}
    lcfg = dataclasses.replace(cfg, num_layers=L)
    layer = fsdp_layer_bytes(lcfg, getattr(torch, TrainConfig().compute_dtype).itemsize, sizes)
    want_stats = {"all_gather": 2 * L, "reduce_scatter": L, "gathered_bytes": 2 * L * layer}
    expect = expected_train_launches(L, 1, 1)
    pairs = len(ranks) * EP_SEQ * cfg.moe.experts_per_token
    row0 = ranks[0]["fsdp_placement"]["row"]
    compared, differ = _moved_slices_differ([rk["fsdp_placement"]["move"] for rk in ranks], row0,
                                            "fsdp_placement_train")
    if differ:
        raise AssertionError(f"fsdp_placement_train: {len(differ)} of {compared} moved slices "
                             f"differ from their sources: {differ[:8]}")

    def steps_of(fp):
        return fp["history"] + [fp["unplaced"], fp["placed"]]

    for i, rk in enumerate(ranks):
        fp, where = rk["fsdp_placement"], f"fsdp_placement_train rank {i}"
        if [{k: s[k] for k in keys} for s in steps_of(fp)] != [
                {k: s[k] for k in keys} for s in steps_of(ranks[0]["fsdp_placement"])]:
            raise AssertionError(f"{where}: metrics differ from rank 0's")
        for s in steps_of(fp):
            if not all(math.isfinite(s[k]) for k in keys) or s["moe_drops"] != 0 or \
                    sum(s["counts"]) != pairs:
                raise AssertionError(f"{where}: non-finite metrics, drops or routed pairs off: "
                                     f"{ {k: s[k] for k in keys} }, {sum(s['counts'])} pairs")
            if s["launches"] != expect or s["fsdp_stats"] != want_stats:
                raise AssertionError(f"{where}: launches {s['launches']} (want {expect}) or "
                                     f"gathers {s['fsdp_stats']} (want {want_stats}) a step")
        move = fp["move"]
        if len(move["after"]) != 12 or sorted(move["after"]) != sorted(move["before"]):
            raise AssertionError(f"{where}: {len(move['after'])} expert stacks moved, 12 "
                                 f"expected")
        if move["state_bytes"] != FSDP_EP_STATE_BYTES:
            raise AssertionError(f"{where}: state bytes {move['state_bytes']} after the move, "
                                 f"{FSDP_EP_STATE_BYTES} expected")
        gap = abs(fp["placed"]["loss"] - fp["unplaced"]["loss"])
        if gap > PLACEMENT_LOSS_TOL:
            raise AssertionError(f"{where}: the placed step's loss off the unplaced one's by "
                                 f"{gap} (> {PLACEMENT_LOSS_TOL})")
    r0 = ranks[0]["fsdp_placement"]
    row = {"model": cfg.name, "layers": L, "grid": sizes, "mode": "/".join(FSDP_EP_RUN),
           "dispatch": "dropless", "move_after_step": FSDP_PLACEMENT_MOVE_AFTER, "row": row0,
           "move_ms_by_rank": [rk["fsdp_placement"]["move"]["ms"] for rk in ranks],
           "sent_bytes_by_rank": [rk["fsdp_placement"]["move"]["sent_bytes"] for rk in ranks],
           "slices_compared": compared, "slices_differ": len(differ),
           "state_bytes_per_rank": r0["move"]["state_bytes"],
           **table_row("fsdp_placement_train",
                       [rk["fsdp_placement"]["table_elems"] for rk in ranks], cfg, sizes),
           "losses_before_move": [s["loss"] for s in r0["history"]],
           "loss_unplaced": r0["unplaced"]["loss"], "loss_placed": r0["placed"]["loss"],
           "loss_gap": abs(r0["placed"]["loss"] - r0["unplaced"]["loss"]),
           "grad_norm_unplaced": r0["unplaced"]["grad_norm"],
           "grad_norm_placed": r0["placed"]["grad_norm"],
           "step_ms_by_rank": [[s["step_ms"] for s in steps_of(rk["fsdp_placement"])]
                               for rk in ranks],
           "gathers_per_step": want_stats, "layer_bytes_gathered": layer,
           "launches_per_rank": r0["placed"]["launches"], "expected_launches": expect,
           "tolerance": PLACEMENT_LOSS_TOL,
           "note": "4 ranks time-share one card; gloo carries the move and the fsdp "
                   "collectives through host memory: no time here is a speed"}
    emit("fsdp_placement_train", **row)
    return row


def phase_fsdp_state_space_train(ranks, name: str) -> dict:
    """A session job's fsdp runs of a state-space arch (``ranks``, each
    rank's 'fsdp' and 'plain' ``_history_run``): ``name``
    'fsdp_hybrid_train' (``_fsdp_hybrid_train_rank``) or
    'fsdp_ssm_pp_train' (``_fsdp_ssm_pp_train_rank``). Asserts on every rank
    both runs' finite metrics, a falling loss, clip_scale <= 1, rank 0's
    metrics, the state bytes planned (``state_bytes_per_device``, the fsdp
    one the CPU test's figure) and no port kernel launched (training takes
    the plain SSM math); the fsdp run held to the plain one
    (``_fsdp_held_to``: step 0's loss bit for bit), its param elements the
    CPU test's figure and its gathers, reduce-scatters and bytes gathered
    exactly: two gathers an SSM layer and microbatch (three under pp) and
    one reduce-scatter, and for the hybrid one gather and one
    reduce-scatter of the shared block a step, whatever its applications;
    under pp each step's saved-input peak and the bytes handed to the
    neighbour stage. Prints peak a rank of both runs, step ms and the bytes
    gathered a step."""
    import dataclasses

    import torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models import init_params
    from repro_torch.models.model import hybrid_layout
    from repro_torch.optim.epso import state_bytes_per_device
    from repro_torch.train.trainer import placements

    if name == "fsdp_hybrid_train":
        cfg = dataclasses.replace(get_config(ZAMBA), num_layers=FSDP_HYBRID_LAYERS)
        sizes, n_mb, seq = {"data": FSDP_DP}, 1, FSDP_HYBRID_SEQ
        want = {"state_bytes": FSDP_HYBRID_STATE_BYTES, "param_elems": FSDP_HYBRID_PARAM_ELEMS}
    else:
        cfg = dataclasses.replace(get_config(FALCON), num_layers=FSDP_SSM_PP_LAYERS)
        sizes, n_mb, seq = {"data": FSDP_PP_DP, "pp": FSDP_PP_STAGES}, FSDP_SSM_PP_MB, \
            FSDP_SSM_PP_SEQ
        want = {"state_bytes": FSDP_SSM_PP_STATE_BYTES, "param_elems": FSDP_SSM_PP_PARAM_ELEMS}
    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr")
    n, pp = FSDP_GRID_STEPS, sizes.get("pp", 1)
    item = getattr(torch, TrainConfig().compute_dtype).itemsize
    if cfg.arch_type == "hybrid":
        n_group, every, rem = hybrid_layout(cfg)
        ssm_layers = n_group * every + rem
        gathers, scatters = 2 * ssm_layers + 1, ssm_layers + 1
        nbytes = (2 * n_group * every * fsdp_layer_bytes(cfg, item, sizes, "groups")
                  + 2 * rem * fsdp_layer_bytes(cfg, item, sizes, "rem")
                  + fsdp_layer_bytes(cfg, item, sizes, "shared"))
    else:
        lay = cfg.num_layers // pp * n_mb
        gathers, scatters = (3 if pp > 1 else 2) * lay, lay
        nbytes = gathers * fsdp_layer_bytes(cfg, item, sizes)
    want_stats = {"all_gather": n * gathers, "reduce_scatter": n * scatters,
                  "gathered_bytes": n * nbytes}
    expect = _no_launches()
    shapes = init_params(cfg, device="meta")
    planned = {f: state_bytes_per_device(shapes, placements(cfg, shapes, sizes, fsdp=f), sizes,
                                         "so") for f in (True, False)}
    if planned[True] != want["state_bytes"]:
        raise AssertionError(f"{name}: {planned[True]} state bytes planned, expected "
                             f"{want['state_bytes']}")
    r0, p0 = ranks[0]["fsdp"], ranks[0]["plain"]
    h, ref = r0["history"], p0["history"]
    # the row first, so that it shows what an assertion below refuses
    fresh = [i for i in range(len(ref)) if all(s["lr"] == 0 for s in ref[:i])]
    rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(h, ref)]
           for k in ("loss", "ce", "grad_norm")}
    row = {"model": cfg.name, "layers": cfg.num_layers, "grid": sizes, "ranks": len(ranks),
           "mode": "so/off", "microbatches": n_mb, "seq_len": seq, "steps": n, "remat": "block",
           "coords_by_rank": [rk["coords"] for rk in ranks],
           "losses": [s["loss"] for s in r0["history"]],
           "losses_plain": [s["loss"] for s in p0["history"]],
           "grad_norms": [s["grad_norm"] for s in r0["history"]],
           "grad_norms_plain": [s["grad_norm"] for s in p0["history"]],
           "loss_rel_to_plain": rel["loss"], "ce_rel_to_plain": rel["ce"],
           "grad_norm_rel_to_plain": rel["grad_norm"], "tolerance": FSDP_LOSS_TOL,
           "grad_norm_tolerance": {"steps_on_step0_params": fresh, "there": FSDP_NORM_TOL,
                                   "after_an_update": FSDP_NORM_TOL_UPDATED},
           "state_bytes_per_rank": r0["state_bytes"], "state_bytes_plain": p0["state_bytes"],
           "param_elems_per_rank": r0["param_elems"], "param_elems_plain": p0["param_elems"],
           "peak_bytes_by_rank": [rk["fsdp"]["peak_bytes"] for rk in ranks],
           "peak_bytes_by_rank_plain": [rk["plain"]["peak_bytes"] for rk in ranks],
           "peak_bytes_steps_by_rank": [rk["fsdp"]["peak_bytes_steps"] for rk in ranks],
           "peak_bytes_steps_by_rank_plain": [rk["plain"]["peak_bytes_steps"] for rk in ranks],
           "step_ms_by_rank": [[s["step_ms"] for s in rk["fsdp"]["history"]] for rk in ranks],
           "step_ms_by_rank_plain": [[s["step_ms"] for s in rk["plain"]["history"]]
                                     for rk in ranks],
           "gathered_bytes_per_step_counted": r0["fsdp_stats"]["gathered_bytes"] / n,
           "gathered_bytes_per_step_computed": nbytes,
           "gathers_per_step": r0["fsdp_stats"]["all_gather"] / n,
           "reduce_scatters_per_step": r0["fsdp_stats"]["reduce_scatter"] / n,
           "launches_per_rank": r0["launches"], "expected_launches": expect,
           "note": "4 ranks time-share one card; gloo carries the gathers, the "
                   "reduce-scatters, the stage hand-offs and the SO collectives through host "
                   "memory: no step time here is a speed"}
    if pp > 1:
        row.update(saved_peak_by_rank=[rk["fsdp"]["history"][0]["saved_peak"] for rk in ranks],
                   handoff_bytes_per_step_by_rank=[rk["fsdp"]["history"][0]["sent_bytes"]
                                                   for rk in ranks])
    emit(name, **row)
    for i, rk in enumerate(ranks):
        for which, fsdp in (("fsdp", True), ("plain", False)):
            run, where = rk[which], f"{name} {which} rank {i}"
            h = run["history"]
            if not all(math.isfinite(s[k]) for s in h for k in keys) or \
                    not all(s["clip_scale"] <= 1.0 for s in h):
                raise AssertionError(f"{where}: non-finite metrics or clip_scale above 1: {h}")
            if not h[-1]["loss"] < h[0]["loss"]:
                raise AssertionError(f"{where}: loss did not fall: {[s['loss'] for s in h]}")
            if [{k: s[k] for k in keys} for s in h] != [
                    {k: s[k] for k in keys} for s in ranks[0][which]["history"]]:
                raise AssertionError(f"{where}: metrics differ from rank 0's")
            if run["state_bytes"] != planned[fsdp]:
                raise AssertionError(f"{where}: state bytes {run['state_bytes']}, planned "
                                     f"{planned[fsdp]}")
            if run["launches"] != expect:
                raise AssertionError(f"{where}: launches {run['launches']} != {expect}")
            if pp > 1:
                stage = rk["coords"]["pp"]
                want_sent = n_mb * seq * cfg.d_model * item * ((stage < pp - 1) + (stage > 0))
                for s in h:
                    if s["saved_peak"] != pp - stage or s["sent_bytes"] != want_sent:
                        raise AssertionError(f"{where}: saved-input peak {s['saved_peak']} "
                                             f"(want {pp - stage}) or bytes handed off "
                                             f"{s['sent_bytes']} (want {want_sent})")
        run, where = rk["fsdp"], f"{name} rank {i}"
        _fsdp_held_to(run["history"], rk["plain"]["history"], where, "the plain run")
        if run["param_elems"] != want["param_elems"]:
            raise AssertionError(f"{where}: {run['param_elems']} param elements, expected "
                                 f"{want['param_elems']}")
        if run["fsdp_stats"] != want_stats:
            raise AssertionError(f"{where}: gathers {run['fsdp_stats']} != {want_stats}")
    return row


def phase_pp_train(ranks) -> dict:
    """The pp runs of epso_train's ranks (``_pp_train_rank``): full-width
    Mula-7B-A1B at PP_LAYERS layers on PP_DP x PP_STAGES x PP_EP,
    'epso'/'ring', dropless, with router terms, PP_MB microbatches, 1f1b
    then gpipe (PP_SCHEDULES). Asserts on every rank finite metrics, a
    falling loss, clip_scale <= 1, rank 0's loss, grad norm and counts, no
    drops and every routed pair counted, the state bytes the EPSO plan gives
    the rank, the saved-input peak (1f1b: at most pp on stage 0; gpipe: all
    PP_MB), the bytes handed to the neighbour stage as computed from the
    shapes, the exact launch count of a stage; then runs the same model,
    rows (as the stages see them) and microbatches on one rank in this
    process and holds the grid's losses within PP_LOSS_TOL relative of it.
    Prints peak memory, state bytes, step ms and launches a rank."""
    import torch
    from repro_torch.configs import ParallelConfig
    from repro_torch.train import init_state, make_train_step

    cfg, train = pp_train_config()
    coefs = {"aux": cfg.moe.router_aux_coef, "z": cfg.moe.router_z_coef}
    if not min(coefs.values()) > 0:
        raise AssertionError(f"pp_train runs with the router terms on, got {coefs}")
    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")
    expect = expected_pp_launches(PP_LAYERS // PP_STAGES, PP_MB, len(PP_SCHEDULES))
    pairs = train.global_batch * PP_SEQ * cfg.moe.experts_per_token
    # one activation (or its gradient) of a microbatch: one row, bf16
    act = train.global_batch // (PP_DP * PP_EP) // PP_MB * PP_SEQ * cfg.d_model * 2
    r0 = ranks[0]["pp"]["history"]
    for i, rk in enumerate(ranks):
        run, where = rk["pp"], f"pp_train rank {i}"
        h, stage = run["history"], run["coords"]["pp"]
        if [{k: s[k] for k in ("loss", "grad_norm", "counts")} for s in h] != [
                {k: s[k] for k in ("loss", "grad_norm", "counts")} for s in r0]:
            raise AssertionError(f"{where}: loss, grad norm or counts differ from rank 0's")
        if not all(math.isfinite(s[k]) for s in h for k in keys) or \
                not all(s["clip_scale"] <= 1.0 for s in h) or not h[-1]["loss"] < h[0]["loss"]:
            raise AssertionError(f"{where}: metrics not finite, clip_scale above 1 or the loss "
                                 f"did not fall: {[s['loss'] for s in h]}")
        if any(s["moe_drops"] != 0 for s in h) or any(sum(s["counts"]) != pairs for s in h):
            raise AssertionError(f"{where}: drops or routed pairs off")
        if run["state_bytes"] != run["state_bytes_expected"]:
            raise AssertionError(f"{where}: state bytes {run['state_bytes']}, planned "
                                 f"{run['state_bytes_expected']}")
        for s in h:
            want_peak = PP_MB if s["schedule"] == "gpipe" else PP_STAGES - stage
            want_sent = PP_MB * act * ((stage < PP_STAGES - 1) + (stage > 0))
            if s["saved_peak"] != want_peak or s["sent_bytes"] != want_sent:
                raise AssertionError(f"{where}: saved-input peak {s['saved_peak']} (want "
                                     f"{want_peak}) or bytes handed off {s['sent_bytes']} "
                                     f"(want {want_sent}) under {s['schedule']}")
        if run["launches"] != expect:
            raise AssertionError(f"{where}: launches {run['launches']} != {expect}")
    # the one-rank run: the same state, rows and microbatches in one process
    torch.cuda.empty_cache()
    batch = pp_oracle_rows(_fixed_batch(cfg.vocab_size, train.global_batch, train.seq_len, DEV),
                           PP_DP * PP_EP, PP_MB)
    state = init_state(cfg, train, seed=0, device=DEV)
    ref = []
    for sched in PP_SCHEDULES:
        step = make_train_step(cfg, ParallelConfig(microbatches=PP_MB, remat_policy="block",
                                                   pp_stages=PP_STAGES, pp_schedule=sched), train)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        ref.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "moe_aux": float(step.router_terms["moe_aux"]),
                    "step_ms": (time.perf_counter() - t0) * 1e3})
    del state, step
    torch.cuda.empty_cache()
    rel = [abs(s["loss"] - q["loss"]) / abs(q["loss"]) for s, q in zip(r0, ref)]
    row = {"model": cfg.name, "layers": PP_LAYERS,
           "grid": {"data": PP_DP, "pp": PP_STAGES, "ep": PP_EP}, "mode": "epso/ring",
           "dispatch": "dropless", "router_coefs": coefs, "lr_peak": CMP_LR,
           "microbatches": PP_MB, "seq_len": PP_SEQ, "rows_per_batch_rank": PP_MB,
           "schedules": list(PP_SCHEDULES), "losses": [s["loss"] for s in r0],
           "losses_one_rank": [q["loss"] for q in ref], "loss_rel_to_one_rank": rel,
           "grad_norms": [s["grad_norm"] for s in r0],
           "grad_norms_one_rank": [q["grad_norm"] for q in ref], "tolerance": PP_LOSS_TOL,
           "moe_aux": [s["moe_aux"] for s in r0],
           "moe_aux_one_rank": [q["moe_aux"] for q in ref],
           "coords_by_rank": [rk["pp"]["coords"] for rk in ranks],
           "step_ms_by_rank": [[s["step_ms"] for s in rk["pp"]["history"]] for rk in ranks],
           "step_ms_one_rank": [q["step_ms"] for q in ref],
           "peak_bytes_by_rank": [rk["pp"]["peak_bytes"] for rk in ranks],
           "state_bytes_per_rank": [rk["pp"]["state_bytes"] for rk in ranks],
           **table_row("pp_train", [rk["pp"]["table_elems"] for rk in ranks], cfg,
                       {"data": PP_DP, "pp": PP_STAGES, "ep": PP_EP}),
           "handoff_bytes_per_message_computed": act,
           "handoff_bytes_per_step_by_rank": [rk["pp"]["history"][0]["sent_bytes"]
                                              for rk in ranks],
           "saved_peak_by_rank": [[s["saved_peak"] for s in rk["pp"]["history"]]
                                  for rk in ranks],
           "launches_per_rank": ranks[0]["pp"]["launches"], "expected_launches": expect,
           "note": "4 ranks time-share one card over gloo; the activations and their "
                   "gradients go between stages through pinned host buffers: no step time "
                   "here is a PP speed"}
    emit("pp_train", **row)
    if max(rel) > PP_LOSS_TOL:
        raise AssertionError(f"pp_train: losses off the one-rank run's by {rel} "
                             f"(> {PP_LOSS_TOL})")
    return row


def a2a_bytes(cfg, tokens: int, ep: int, cf: float) -> dict:
    """Computed (from the shapes, not measured): the bytes one rank sends
    to the other ranks for one MoE layer's forward, under the all-to-all
    Stage 1 (ep - 1 of its ep send groups of Cd rows: the bf16 row, its
    int64 expert position and f32 weight; the rows back) and under the
    allgather (its ``tokens`` bf16 rows, int64 ids and f32 weights to each
    of ep - 1 peers; the reduce-scatter of the bf16 partial outputs), and
    a train step's (forward, the block remat's recompute and the backward,
    each collective's backward the same bytes, times the layers)."""
    import math
    d, K = cfg.d_model, cfg.moe.experts_per_token
    Cd = -(-math.ceil(cf * tokens * K / ep) // 8) * 8
    a2a = (ep - 1) * Cd * (2 * d + 8 + 4) + (ep - 1) * Cd * 2 * d
    ag = (ep - 1) * tokens * (2 * d + 12 * K) + (ep - 1) * tokens * 2 * d
    return {"computed": True, "Cd": Cd, "a2a_bytes_per_layer_forward": a2a,
            "allgather_bytes_per_layer_forward": ag,
            "a2a_bytes_per_step": 3 * cfg.num_layers * a2a,
            "allgather_bytes_per_step": 3 * cfg.num_layers * ag, "ratio": a2a / ag}


def phase_a2a_train(ranks, cfg) -> dict:
    """The a2a runs of epso_train's ranks (``_a2a_train_rank``): full-width
    Mula-7B-A1B at EPSO_LAYERS layers on the EPSO_DP x EPSO_EP grid,
    'epso'/'ring', capacity dispatch at A2A_CF and peak lr CMP_LR, against
    the allgather 'epso'/'ring' run at the same factor and lr. Asserts no
    drops in either, every rank the a2a run's metrics of
    rank 0, the losses within A2A_LOSS_TOL relative at every step (the a2a
    sums a token's K rows at the source, the allgather over the ranks:
    another bf16 grouping), and the exact launch count: two dispatch plans
    a layer and forward. Prints the bytes of both Stage 1s (computed) and
    each run's step ms, on the same host."""
    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")
    expect = expected_a2a_launches(EPSO_LAYERS, 1, EPSO_STEPS)
    for i, rk in enumerate(ranks):
        where = f"a2a_train rank {i}"
        a, ref = rk["a2a"]["a2a"]["history"], rk["a2a"]["allgather"]["history"]
        if [{k: s[k] for k in keys} for s in a] != [
                {k: s[k] for k in keys} for s in ranks[0]["a2a"]["a2a"]["history"]]:
            raise AssertionError(f"{where}: metrics differ from rank 0's")
        if not all(math.isfinite(s[k]) for s in a for k in keys):
            raise AssertionError(f"{where}: non-finite metrics")
        if any(s["moe_drops"] != 0 for s in a + ref):
            raise AssertionError(f"{where}: drops {[s['moe_drops'] for s in a]} (a2a), "
                                 f"{[s['moe_drops'] for s in ref]} (allgather) at capacity "
                                 f"factor {A2A_CF}: take a factor at which neither drops")
        rel = [abs(x["loss"] - y["loss"]) / abs(y["loss"]) for x, y in zip(a, ref)]
        if len(rel) != EPSO_STEPS or max(rel) > A2A_LOSS_TOL:
            raise AssertionError(f"{where}: losses off the allgather run's by {rel} "
                                 f"(> {A2A_LOSS_TOL})")
        if rk["a2a"]["a2a"]["launches"] != expect:
            raise AssertionError(f"{where}: launches {rk['a2a']['a2a']['launches']} != "
                                 f"{expect}")
    r0, ref0 = ranks[0]["a2a"]["a2a"], ranks[0]["a2a"]["allgather"]["history"]
    row = {"model": cfg.name, "layers": EPSO_LAYERS, "grid": {"data": EPSO_DP, "ep": EPSO_EP},
           "mode": "epso/ring/a2a", "capacity_factor": A2A_CF, "lr_peak": CMP_LR,
           "steps": EPSO_STEPS,
           "losses_a2a": [s["loss"] for s in r0["history"]],
           "losses_allgather": [s["loss"] for s in ref0],
           "loss_rel": [abs(x["loss"] - y["loss"]) / abs(y["loss"])
                        for x, y in zip(r0["history"], ref0)],
           "grad_norms_a2a": [s["grad_norm"] for s in r0["history"]],
           "grad_norms_allgather": [s["grad_norm"] for s in ref0],
           "moe_drops": [s["moe_drops"] for s in r0["history"] + ref0],
           "step_ms_by_rank_a2a": [[s["step_ms"] for s in rk["a2a"]["a2a"]["history"]]
                                   for rk in ranks],
           "step_ms_median_a2a": statistics.median(s["step_ms"] for s in r0["history"][1:]),
           "step_ms_median_allgather": statistics.median(s["step_ms"] for s in ref0[1:]),
           "peak_bytes_by_rank": [rk["a2a"]["a2a"]["peak_bytes"] for rk in ranks],
           **table_row("a2a_train", [rk["a2a"][s]["table_elems"] for rk in ranks
                                     for s in ("a2a", "allgather")], cfg,
                       {"data": EPSO_DP, "ep": EPSO_EP}),
           "stage1_bytes": a2a_bytes(cfg, EP_SEQ, EPSO_EP, A2A_CF),
           "dispatch_plans_per_layer_forward": r0["launches"]["dispatch_plan"] / (
               EPSO_LAYERS * EPSO_STEPS * 2),
           "launches_per_rank": r0["launches"], "expected_launches": expect,
           "tolerance": A2A_LOSS_TOL}
    row["note"] = (f"4 ranks time-share one card over gloo; at ep = {EPSO_EP}, top "
                   f"{cfg.moe.experts_per_token} and capacity factor {A2A_CF} the all-to-all "
                   f"moves {row['stage1_bytes']['ratio']:.1f}x the allgather's bytes (computed; "
                   f"it moves fewer only where ep > cf * K): no step time here is a speed of "
                   f"either")
    emit("a2a_train", **row)
    return row


def phase_tp_train(ranks, cfg) -> dict:
    """The tp runs of epso_train's ranks (``_tp_train_rank``): full-width
    Mula-7B-A1B at EPSO_LAYERS layers, the same fixed batch, dropless,
    without router terms, at peak lr CMP_LR, on ep = 2 x tp = 2 ('none',
    'epso'/'ring') and ep = 1 x tp = 4 (the expert-TP form, 'epso'/'ring'),
    TP_STEPS steps each. Asserts on every rank finite metrics, no drops,
    rank 0's loss, grad norm and counts, the losses within TP_LOSS_TOL
    relative of the reference run (the same on the 2 x 2 grid, 'epso'/
    'ring'), the state bytes the EPSO plan gives the rank (computed) and the
    exact launch count; prints the peak memory and step ms a rank."""
    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")
    ref = [s["loss"] for s in ranks[0]["tp"]["reference"]["history"]]
    expect = expected_train_launches(EPSO_LAYERS, 1, TP_STEPS)
    pairs = len(ranks) * EP_SEQ * cfg.moe.experts_per_token
    runs = {}
    for name in ranks[0]["tp"]:
        if name == "reference":
            continue
        r0 = ranks[0]["tp"][name]["history"]
        for i, rk in enumerate(ranks):
            run, where = rk["tp"][name], f"tp_train {name} rank {i}"
            h = run["history"]
            if [{k: s[k] for k in ("loss", "grad_norm", "counts")} for s in h] != [
                    {k: s[k] for k in ("loss", "grad_norm", "counts")} for s in r0]:
                raise AssertionError(f"{where}: loss, grad norm or counts differ from rank 0's")
            if not all(math.isfinite(s[k]) for s in h for k in keys) or \
                    not all(s["clip_scale"] <= 1.0 for s in h):
                raise AssertionError(f"{where}: non-finite metrics or clip_scale above 1")
            if any(s["moe_drops"] != 0 for s in h) or any(sum(s["counts"]) != pairs for s in h):
                raise AssertionError(f"{where}: drops or routed pairs off: "
                                     f"{[(s['moe_drops'], sum(s['counts'])) for s in h]}")
            rel = [abs(s["loss"] - b) / abs(b) for s, b in zip(h, ref)]
            if len(rel) != TP_STEPS or max(rel) > TP_LOSS_TOL:
                raise AssertionError(f"{where}: losses off the 2 x 2 dropless run's by {rel} "
                                     f"(> {TP_LOSS_TOL})")
            if run["state_bytes"] != run["state_bytes_expected"]:
                raise AssertionError(f"{where}: state bytes {run['state_bytes']}, planned "
                                     f"{run['state_bytes_expected']}")
            if run["launches"] != expect:
                raise AssertionError(f"{where}: launches {run['launches']} != {expect}")
            if "block_sc" in run:
                sc = run["block_sc"]
                if [s["loss"] for s in sc["history"]] + [sc["profiled_loss"]] != \
                        [s["loss"] for s in h] + [run["profiled_loss"]]:
                    raise AssertionError(f"{where}: 'block_sc' losses differ from 'block''s")
                if sc["launches"] != expect:
                    raise AssertionError(f"{where}: 'block_sc' launches {sc['launches']}")
        runs[name] = {
            "losses": [s["loss"] for s in r0],
            "loss_rel_to_2x2": [abs(s["loss"] - b) / abs(b) for s, b in zip(r0, ref)],
            "grad_norms": [s["grad_norm"] for s in r0],
            "state_bytes_per_rank": ranks[0]["tp"][name]["state_bytes"],
            "state_bytes_planned": ranks[0]["tp"][name]["state_bytes_expected"],
            "peak_bytes_by_rank": [rk["tp"][name]["peak_bytes"] for rk in ranks],
            "step_ms_median_by_rank": [statistics.median(s["step_ms"] for s in
                                                         rk["tp"][name]["history"][1:])
                                       for rk in ranks],
            "coords_by_rank": [rk["tp"][name]["coords"] for rk in ranks],
            **table_row(f"tp_train {name}", [rk["tp"][name]["table_elems"] for rk in ranks],
                        cfg, ranks[0]["tp"][name]["sizes"])}
        if "block_sc" in ranks[0]["tp"][name]:
            runs[name]["block_sc"] = _block_sc_row(ranks[0]["tp"][name], EPSO_LAYERS)
    row = {"model": cfg.name, "layers": EPSO_LAYERS, "dispatch": "dropless", "steps": TP_STEPS,
           "router_terms": False, "lr_peak": CMP_LR, "reference_losses_2x2": ref,
           "reference_step_ms_median": statistics.median(
               s["step_ms"] for s in ranks[0]["tp"]["reference"]["history"][1:]),
           "runs": runs, "tolerance": TP_LOSS_TOL,
           "launches_per_rank": ranks[0]["tp"][next(iter(runs))]["launches"],
           "expected_launches": expect,
           "note": "4 ranks time-share one card over gloo: the tensor-parallel all-reduces go "
                   "through host memory; no step time here is a TP speed"}
    emit("tp_train", **row)
    for name, r in runs.items():
        sc = r.get("block_sc")
        if sc is not None and sc["gloo_calls_saved"] != sc["gloo_calls_saved_expected"]:
            raise AssertionError(f"tp_train {name}: 'block_sc' made {sc['gloo_calls_saved']} "
                                 f"fewer gloo calls on rank 0 than 'block', expected "
                                 f"{sc['gloo_calls_saved_expected']}")
    return row


def _block_sc_row(run, layers: int) -> dict:
    """Rank 0's profiled steps of 'block' and 'block_sc' side by side: the
    ``gloo:*`` calls (by name) and host ms of each, and the calls saved,
    measured and computed (BLOCK_SC_SAVED_PER_LAYER a layer of the
    ``layers``, one microbatch)."""
    def gloo(prof):
        return {n: v for n, v in prof["host_events"].items() if n.startswith("gloo:")}

    block, sc = gloo(run["profile"]), gloo(run["block_sc"]["profile"])
    calls = {k: sum(v["calls"] for v in g.values()) for k, g in (("block", block),
                                                               ("block_sc", sc))}
    return {"losses_equal_block": True, "gloo_calls_block": calls["block"],
            "gloo_calls_block_sc": calls["block_sc"],
            "gloo_calls_saved": calls["block"] - calls["block_sc"],
            "gloo_calls_saved_expected": BLOCK_SC_SAVED_PER_LAYER * layers,
            "gloo_by_name_block": block, "gloo_by_name_block_sc": sc,
            "gloo_host_ms_block": sum(v["ms"] for v in block.values()),
            "gloo_host_ms_block_sc": sum(v["ms"] for v in sc.values()),
            "profiled_step_wall_ms_block": run["profile"]["wall_ms"],
            "profiled_step_wall_ms_block_sc": run["block_sc"]["profile"]["wall_ms"],
            "peak_bytes_rank0_block_sc": run["block_sc"]["peak_bytes"],
            "peak_bytes_profiled_step_block": run["peak_bytes_profiled"],
            "peak_bytes_profiled_step_block_sc": run["block_sc"]["peak_bytes_profiled"]}


def phase_placement_train(ranks, cfg) -> dict:
    """The placement runs of epso_train's ranks (``_placement_train_rank``):
    full-width Mula-7B-A1B at EPSO_LAYERS layers on the EPSO_DP x EPSO_EP
    grid, 'epso'/'ring', dropless, PLACEMENT_STEPS steps unplaced, then the
    state after step PLACEMENT_MOVE_AFTER moved and the later steps again
    (the placed run's earlier steps are the unplaced run's). Asserts every
    moved (layer, expert) slice of params, master, m and v equal to its
    source by the exact sums of its bits (``_moved_slices_differ``), no
    drops, the state bytes exactly EPSO_STATE_BYTES['epso'] after the
    move, the steps after it within PLACEMENT_LOSS_TOL of the unplaced
    run's, the routed pairs conserved, the same metrics on every rank and
    the exact launch count of every kernel."""
    import numpy as np
    from repro_torch.parallel.placement import imbalance

    keys = ("loss", "ce", "grad_norm", "clip_scale", "lr", "moe_drops")
    cut = PLACEMENT_MOVE_AFTER + 1
    expect = {"unplaced": expected_train_launches(EPSO_LAYERS, 1, PLACEMENT_STEPS),
              "placed": expected_train_launches(EPSO_LAYERS, 1, PLACEMENT_STEPS - cut)}
    pairs = len(ranks) * EP_SEQ * cfg.moe.experts_per_token
    compared, differ = _moved_slices_differ([rk["placement"]["placed"]["move"] for rk in ranks],
                                            ranks[0]["placement"]["row"])
    if differ:
        raise AssertionError(f"placement_train: {len(differ)} of {compared} moved slices "
                             f"differ from their sources: {differ[:8]}")
    for i, rk in enumerate(ranks):
        pr, where = rk["placement"], f"placement_train rank {i}"
        a, b = pr["unplaced"]["history"], pr["placed"]["history"]
        if [{k: s[k] for k in keys} for s in b] != [
                {k: s[k] for k in keys} for s in ranks[0]["placement"]["placed"]["history"]]:
            raise AssertionError(f"{where}: metrics differ from rank 0's")
        move = pr["placed"]["move"]
        if len(move["after"]) != 12 or sorted(move["after"]) != sorted(move["before"]):
            raise AssertionError(f"{where}: {len(move['after'])} expert stacks moved, 12 "
                                 f"expected")
        if move["state_bytes"] != EPSO_STATE_BYTES["epso"]:
            raise AssertionError(f"{where}: state bytes {move['state_bytes']} after the move, "
                                 f"{EPSO_STATE_BYTES['epso']} expected")
        for name, h in (("unplaced", a), ("placed", b)):
            if not all(math.isfinite(s[k]) for s in h for k in keys):
                raise AssertionError(f"{where} {name}: non-finite metrics")
            if any(s["moe_drops"] != 0 for s in h):
                raise AssertionError(f"{where} {name}: dropless run dropped pairs")
            if any(sum(s["counts"]) != pairs for s in h):
                raise AssertionError(f"{where} {name}: routed pairs "
                                     f"{[sum(s['counts']) for s in h]} != {pairs} a step")
            if pr[name]["launches"] != expect[name]:
                raise AssertionError(f"{where} {name}: launches {pr[name]['launches']} != "
                                     f"{expect[name]}")
        if len(b) != PLACEMENT_STEPS - cut:
            raise AssertionError(f"{where}: {len(b)} steps after the move")
        gap = [abs(x["loss"] - y["loss"]) for x, y in zip(a[cut:], b)]
        if max(gap) > PLACEMENT_LOSS_TOL:
            raise AssertionError(f"{where}: losses after the move off by {gap} "
                                 f"(> {PLACEMENT_LOSS_TOL})")
    r0 = ranks[0]["placement"]
    a, b = r0["unplaced"]["history"], r0["placed"]["history"]
    before = np.sum([s["counts"] for s in a[:cut]], axis=0)
    row = {"model": cfg.name, "layers": EPSO_LAYERS, "grid": {"data": EPSO_DP, "ep": EPSO_EP},
           "mode": "epso/ring", "dispatch": "dropless", "steps": PLACEMENT_STEPS,
           "move_after_step": PLACEMENT_MOVE_AFTER, "row": r0["row"],
           "experts_moved_per_rank": [sum(1 for g in r0["row"][e * len(r0["row"]) // EPSO_EP:
                                                              (e + 1) * len(r0["row"]) // EPSO_EP]
                                          if g * EPSO_EP // len(r0["row"]) != e)
                                      for e in range(EPSO_EP)],
           "move_ms_rank0": r0["placed"]["move"]["ms"],
           "move_ms_by_rank": [rk["placement"]["placed"]["move"]["ms"] for rk in ranks],
           "sent_bytes_by_rank": [rk["placement"]["placed"]["move"]["sent_bytes"]
                                  for rk in ranks],
           "imbalance_steps_0_2": {"identity": imbalance(before, tuple(range(len(before))),
                                                         EPSO_EP),
                                   "placed": imbalance(before, tuple(r0["row"]), EPSO_EP)},
           "slices_compared": compared, "slices_differ": len(differ),
           "state_bytes_per_rank": r0["placed"]["move"]["state_bytes"],
           **table_row("placement_train", [rk["placement"]["table_elems"] for rk in ranks],
                       cfg, {"data": EPSO_DP, "ep": EPSO_EP}),
           "moe_drops": [s["moe_drops"] for s in a + b],
           "routed_pairs": [sum(s["counts"]) for s in a + b],
           "placed_steps": list(range(cut, PLACEMENT_STEPS)),
           "losses_unplaced": [s["loss"] for s in a], "losses_placed": [s["loss"] for s in b],
           "loss_gap_after_move": [abs(x["loss"] - y["loss"]) for x, y in zip(a[cut:], b)],
           "max_loss_gap_after_move": max(abs(x["loss"] - y["loss"])
                                          for x, y in zip(a[cut:], b)),
           "grad_norms_unplaced": [s["grad_norm"] for s in a],
           "grad_norms_placed": [s["grad_norm"] for s in b],
           "launches_per_rank": r0["placed"]["launches"],
           "launches_per_rank_unplaced": r0["unplaced"]["launches"],
           "expected_launches": expect, "tolerance": PLACEMENT_LOSS_TOL}
    emit("placement_train", **row)
    return row


# ----------------------------------------------------------------------------
# the training launcher: dense Mula-1B, and fault tolerance through
# the MoE kernels
# ----------------------------------------------------------------------------

def launcher_ft_cfg():
    """The model ``run(FT_ARCH, **FT_RUN)`` builds (a reduced config with the
    byte vocabulary)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import ByteTokenizer
    return reduced(get_config(FT_ARCH), layers=FT_RUN["layers"], d_model=FT_RUN["d_model"],
                   vocab=ByteTokenizer.VOCAB)


class _RssPeak:
    """The process's resident set, sampled every 10 ms on a thread: its
    largest value while the ``with`` block runs (the kernel's own peak,
    ``ru_maxrss``, covers the whole process's life)."""

    def __enter__(self):
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, self._rss())
        return False


@contextlib.contextmanager
def _launcher_probe(*, profile_call: int = -1, need_disk: bool = False):
    """Time what ``repro_torch.launch.train.run`` does without changing it:
    each batch's move to the device and each train step (synchronized
    before and after: the launcher syncs after the step anyway), each full
    and model-only save and each restore, each expert move
    (``apply_placement``: its ms and the bytes it sent), and the free disk
    before a save.
    The step call numbered ``profile_call`` (from 0, counted over every run
    inside the block) is profiled instead of timed. With ``need_disk`` a
    save that the disk cannot hold whole fails before it writes."""
    import torch
    from repro_torch.checkpoint import checkpointer
    from repro_torch.launch import train as launch
    from repro_torch.tree import keyed_leaves, leaves

    rec = {"step_ms": [], "h2d_ms": [], "save_ms": [], "save_model_only_ms": [],
           "restore_ms": [], "disk_free_before_save": [], "profile": None,
           "state_bytes": None, "table_elems": None, "calls": [], "move_ms": [],
           "move_sent_bytes": []}
    made, mover, place = launch.make_train_step, launch._batch_mover, launch.apply_placement
    calls = [0]

    def batch_mover(*a, **k):
        move = mover(*a, **k)

        def timed(b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = move(b)
            torch.cuda.synchronize()
            rec["h2d_ms"].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    def make_train_step(*a, **k):
        fn = made(*a, **k)

        def timed(state, batch):
            i, calls[0] = calls[0], calls[0] + 1
            if rec["state_bytes"] is None:      # the fp32 master, m and v this rank holds
                rec["state_bytes"] = sum(t.numel() * t.element_size() for tree in (
                    state.opt.master, state.opt.m, state.opt.v) for t in leaves(tree))
                rec["table_elems"] = table_elems(state.params)
            if i == profile_call:
                out = []
                rec["profile"] = _profile_window(lambda: out.append(fn(state, batch)))
                return out[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(state, batch)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            # every call's loss and grad norm, a replayed step's attempts too
            rec["calls"].append({k: float(out[1][k]) for k in ("loss", "grad_norm")})
            return out
        return timed

    def apply_placement(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = place(*a, **k)
        torch.cuda.synchronize()
        rec["move_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["move_sent_bytes"].append(out[1])
        return out

    def timer(name, fn, before=None):
        def wrapped(self, *a, **k):
            if before is not None:
                before(self, *a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            rec[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapped

    def check_disk(ck, state, step):
        free = shutil.disk_usage(ck.root).free
        rec["disk_free_before_save"].append(free)
        full = sum(t.numel() * t.element_size() for _, t in keyed_leaves(state))
        model = sum(t.numel() * t.element_size() for t in leaves(state.params))
        if need_disk and free < full + model:
            raise AssertionError(f"launcher_dense: {free / 1e9:.2f} GB free in {ck.root}, the "
                                 f"checkpoint needs {full / 1e9:.2f} GB and the model-only one "
                                 f"{model / 1e9:.2f} GB")

    cls = checkpointer.Checkpointer
    saved = {n: getattr(cls, n) for n in ("save", "save_model_only", "restore")}
    launch.make_train_step, launch._batch_mover = make_train_step, batch_mover
    launch.apply_placement = apply_placement
    cls.save = timer("save_ms", saved["save"], check_disk)
    cls.save_model_only = timer("save_model_only_ms", saved["save_model_only"])
    cls.restore = timer("restore_ms", saved["restore"])
    try:
        yield rec
    finally:
        launch.make_train_step, launch._batch_mover = made, mover
        launch.apply_placement = place
        for n, fn in saved.items():
            setattr(cls, n, fn)


def _finite(history) -> bool:
    return all(math.isfinite(v) for h in history for k, v in h.items() if k != "step")


def phase_launcher_dense() -> dict:
    """Mula-1B at full width and DENSE_LAYERS of its 16 layers through the
    launcher: ``run(DENSE_ARCH, **DENSE_RUN)``'s ``launch_ranks(prepare_run(
    ...))`` with the spec's model cut to that depth (6 steps, a checkpoint
    after step 3), then the same call in the same directory, which resumes
    at step 4; steps 4 and 5 must agree bit for bit. The second run's last
    step is profiled."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import launch_ranks

    cfg = dataclasses.replace(get_config(DENSE_ARCH), num_layers=DENSE_LAYERS)

    def run(arch, **kw):
        return launch_ranks(_prepare_grid_run(arch, kw, DENSE_LAYERS))[0]

    out = LAUNCH_DIR / "dense"
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        with _RssPeak() as rss, _launcher_probe(profile_call=7, need_disk=True) as rec:
            ops.reset_launches()
            t0 = time.perf_counter()
            first = run(DENSE_ARCH, out=str(out), **DENSE_RUN)
            wall_first = time.perf_counter() - t0
            peak_mem = torch.cuda.max_memory_allocated()
            gc.collect()
            t0 = time.perf_counter()
            second = run(DENSE_ARCH, out=str(out), **DENSE_RUN)
            wall_second = time.perf_counter() - t0
            launches = dict(ops.launches)
        sizes = {"full_ckpt_bytes": sum(f.stat().st_size for f in (out / "ckpt").glob(
                     "ckpt-*/state.npz")),
                 "model_only_ckpt_bytes": sum(f.stat().st_size for f in (out / "ckpt").glob(
                     "model-*.npz"))}
        members = _npz_members(next((out / "ckpt").glob("ckpt-*/state.npz")))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    keys = ("loss", "grad_norm", "lr")
    resumed = {h["step"]: {k: h[k] for k in keys} for h in second}
    straight = {h["step"]: {k: h[k] for k in keys} for h in first[4:]}
    step_ms = rec["step_ms"][1:6]          # the first run's steps 1-5
    tokens = DENSE_RUN["batch"] * DENSE_RUN["seq"]
    row = {"model": DENSE_ARCH, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "run": DENSE_RUN, "losses": [h["loss"] for h in first],
           "grad_norms": [h["grad_norm"] for h in first], "resumed_steps": resumed,
           "step_ms": rec["step_ms"], "step_ms_median_steps_1_5": statistics.median(step_ms),
           "h2d_ms_per_batch": rec["h2d_ms"],
           "tokens_per_s": tokens / statistics.median(step_ms) * 1e3,
           "max_memory_allocated_bytes": peak_mem, **sizes,
           "save_ms": rec["save_ms"], "save_model_only_ms": rec["save_model_only_ms"],
           "restore_ms": rec["restore_ms"], "disk_free_before_save": rec["disk_free_before_save"],
           "host_rss_start_bytes": rss.start, "host_rss_peak_bytes": rss.peak,
           "host_ru_maxrss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
           "wall_s": [wall_first, wall_second], "launches": launches,
           "profile_step_5_resumed": rec["profile"]}
    emit("launcher_dense", **row)
    if [h["step"] for h in first] != list(range(6)) or sorted(resumed) != [4, 5]:
        raise AssertionError(f"launcher_dense: steps {[h['step'] for h in first]} then "
                             f"{sorted(resumed)}, not 0-5 then 4-5")
    if resumed != straight:
        raise AssertionError(f"launcher_dense: resumed steps {resumed} differ from the "
                             f"uninterrupted run's {straight}")
    if not (_finite(first) and first[-1]["loss"] < first[0]["loss"]):
        raise AssertionError(f"launcher_dense: losses {row['losses']} not finite and falling")
    if any(launches.values()):
        raise AssertionError(f"launcher_dense: the dense path launched kernels {launches}")
    if not (sizes["full_ckpt_bytes"] and sizes["model_only_ckpt_bytes"]):
        raise AssertionError(f"launcher_dense: checkpoint files missing: {sizes}")
    return {**row, "ckpt_members": members}


def phase_launcher_ft() -> dict:
    """``run(FT_ARCH, **FT_RUN)`` clean, then with a hard failure at step 7
    and a soft one at step 12 (FT_INJECT): the clean run takes 18 steps,
    the faulty one 21 (step 6 again after the restore from step 5, steps
    11 and 12 after the restore from step 10)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run

    shutil.rmtree(LAUNCH_DIR / "ft", ignore_errors=True)
    runs, launches = {}, {}
    try:
        with _launcher_probe() as rec:
            for name, kw in (("clean", {}), ("faulty", FT_INJECT)):
                ops.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[name] = run(FT_ARCH, out=str(LAUNCH_DIR / "ft" / name), **FT_RUN, **kw)
                runs[name + "_wall_s"] = time.perf_counter() - t0
                launches[name] = dict(ops.launches)
        manifests = [json.loads((LAUNCH_DIR / "ft" / "faulty" / "ckpt" / slot /
                                 "MANIFEST.json").read_text()) for slot in ("ckpt-1", "ckpt-2")]
    finally:
        shutil.rmtree(LAUNCH_DIR / "ft", ignore_errors=True)
    clean, faulty = runs["clean"], runs["faulty"]
    layers = FT_RUN["layers"]
    expect = {"clean": expected_train_launches(layers, 1, FT_RUN["steps"]),
              "faulty": expected_train_launches(layers, 1, FT_RUN["steps"] + 3)}
    row = {"model": launcher_ft_cfg().name, "run": FT_RUN, "inject": FT_INJECT,
           "losses": [h["loss"] for h in clean], "moe_drops": [h["moe_drops"] for h in clean],
           "relaunches": faulty.relaunches, "replaced": faulty.replaced,
           "slot_steps": sorted(m["step"] for m in manifests if m.get("valid")),
           "history_bit_identical": list(faulty) == list(clean),
           "step_ms_median": statistics.median(rec["step_ms"]),
           "h2d_ms_median": statistics.median(rec["h2d_ms"]), "save_ms": rec["save_ms"],
           "restore_ms": rec["restore_ms"], "wall_s": [runs["clean_wall_s"],
                                                       runs["faulty_wall_s"]],
           "launches": launches, "expected_launches": expect}
    emit("launcher_ft", **row)
    if clean.relaunches != 0 or faulty.relaunches != 2 or faulty.replaced != [(0, 2), (1, 3)]:
        raise AssertionError(f"launcher_ft: relaunches {clean.relaunches} / "
                             f"{faulty.relaunches}, node swaps {faulty.replaced}")
    if row["slot_steps"] != [10, 15]:
        raise AssertionError(f"launcher_ft: valid slots at {row['slot_steps']}, not 10 and 15")
    if not row["history_bit_identical"] or [h["step"] for h in faulty] != list(range(18)):
        raise AssertionError("launcher_ft: the faulty run's history differs from the clean one")
    if not (_finite(clean) and clean[-1]["loss"] < clean[0]["loss"]):
        raise AssertionError(f"launcher_ft: losses {row['losses']} not finite and falling")
    if launches != expect:
        raise AssertionError(f"launcher_ft: kernel launches {launches} != expected {expect}")
    return row


def _npz_members(path) -> dict:
    """{member key: [shape, dtype]} of an npz file, from the headers only."""
    import zipfile

    import numpy as np
    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            with zf.open(name) as f:
                read = {(1, 0): np.lib.format.read_array_header_1_0,
                        (2, 0): np.lib.format.read_array_header_2_0}[np.lib.format.read_magic(f)]
                shape, _, dtype = read(f)
            out[name[:-len(".npy")]] = [list(shape), str(dtype)]
    return out


def _launcher_grid_rank(grid, spec):
    """One rank of a launcher run on a grid: the launcher's own rank body
    (``launch.train._rank_main``) under ``_launcher_probe``, with this
    rank's kernel launches counted from 0 around it."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch

    torch.cuda.reset_peak_memory_stats()
    with _launcher_probe() as rec:
        ops.reset_launches()
        t0 = time.perf_counter()
        result = launch._rank_main(grid, spec)
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
    return {"result": result, "rec": rec, "launches": launches, "wall_s": wall,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "coords": grid.coords if grid is not None else None}


def _prepare_grid_run(arch: str, run_kw: dict, layers: int = 0):
    """``launch.train.prepare_run(arch, **run_kw)``, with the model cut to
    ``layers`` of its layers if given."""
    import dataclasses

    from repro_torch.launch import train as launch
    spec = launch.prepare_run(arch, **run_kw)
    if layers:
        spec = dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg, num_layers=layers))
    return spec


def _same_history(name: str, ranks) -> None:
    for i, r in enumerate(ranks):
        if list(r["result"]) != list(ranks[0]["result"]):
            raise AssertionError(f"{name}: rank {i}'s history differs from rank 0's")


def _launch_grid(name: str, arch: str, run_kw: dict, layers: int = 0) -> tuple:
    """The run's spec (``_prepare_grid_run``), then its ranks through
    ``launch.train.launch_ranks`` with ``_launcher_grid_rank`` as the rank
    body (in this process for a plan of one rank); the spec, the ranks'
    results and the wall time. Every rank must see the same history."""
    import torch
    from repro_torch.launch import train as launch
    torch.cuda.empty_cache()
    spec = _prepare_grid_run(arch, run_kw, layers)
    t0 = time.perf_counter()
    ranks = launch.launch_ranks(spec, _launcher_grid_rank)
    wall = time.perf_counter() - t0
    _same_history(name, ranks)
    return spec, ranks, wall


# the multi-rank launcher runs that share the session's processes: name,
# arch, run keywords (``out`` added under LAUNCH_DIR / name), layers; in this
# order (each grid_dense run resumes the one before it in the same directory)
LAUNCHER_GRID_RUNS = (
    ("grid_dense/first", DENSE_ARCH, GRID_DENSE_RUN, GRID_DENSE_LAYERS),
    ("grid_dense/second", DENSE_ARCH, GRID_DENSE_RUN, GRID_DENSE_LAYERS),
    ("grid_ft/clean", FT_ARCH, GRID_FT_RUN, 0),
    ("grid_tp/clean", FT_ARCH, GRID_TP_RUN, 0),
    ("grid_tp/faulty", FT_ARCH, dict(GRID_TP_RUN, **GRID_TP_INJECT), 0),
    ("grid_rebalance/clean", FT_ARCH, GRID_REB_RUN, 0),
    ("grid_rebalance/faulty", FT_ARCH, dict(GRID_REB_RUN, **GRID_REB_INJECT), 0),
    ("grid_fsdp/first", FT_ARCH, GRID_FSDP_RUN, 0),
    ("grid_fsdp/second", FT_ARCH, GRID_FSDP_RUN, 0),
    ("grid_fsdp_pp/first", FT_ARCH, GRID_FSDP_PP_RUN, 0),
    ("grid_fsdp_pp/second", FT_ARCH, GRID_FSDP_PP_RUN, 0),
    ("grid_fsdp_rebalance/clean", FT_ARCH, GRID_FSDP_REB_RUN, 0),
    ("grid_fsdp_rebalance/faulty", FT_ARCH, dict(GRID_FSDP_REB_RUN, **GRID_REB_INJECT), 0))


def _grid_run_dir(name: str) -> Path:
    """A session launcher run's directory: one for a run and the run that
    resumes it (``.../first``, ``.../second``)."""
    base, _, which = name.partition("/")
    return LAUNCH_DIR / (base if which in ("first", "second") else name)


def launcher_grid_jobs() -> tuple:
    """The session jobs of LAUNCHER_GRID_RUNS, each ``launch.train.
    _rank_main`` under ``_launcher_grid_rank``, as ``launch_ranks`` would
    run it: its spec, and its data prepared here first (``prepare_data``),
    in an emptied directory; the jobs and {name: spec}."""
    from repro_torch.launch import train as launch

    for name, *_ in LAUNCHER_GRID_RUNS:
        shutil.rmtree(_grid_run_dir(name), ignore_errors=True)
    jobs, specs = [], {}
    for name, arch, run_kw, layers in LAUNCHER_GRID_RUNS:
        spec = _prepare_grid_run(arch, dict(run_kw, out=str(_grid_run_dir(name))), layers)
        os.makedirs(spec.out, exist_ok=True)
        launch.prepare_data(spec.out, context=spec.train.seq_len, seed=spec.train.seed)
        specs[name] = spec
        jobs.append((name, _launcher_grid_rank, (spec,), spec.plan.grid))
    return jobs, specs


def _grid_run(session: dict, specs: dict, name: str) -> tuple:
    """A session launcher run's spec, ranks and rank 0's wall time; every
    rank must see the same history."""
    ranks = session["ranks"][name]
    _same_history(f"launcher_{name}", ranks)
    return specs[name], ranks, session["wall_s"][name]


def _session_rank(world, jobs):
    """One rank of the session: each job ``(name, fn, args, shape)`` in
    turn, ``fn(g, *args)`` with ``g`` the world's group (``shape`` None) or
    the grid of that ``spawn(grid=)`` shape cut from it (``init_grid``,
    collective: every rank runs the jobs in one order); {name: result} and
    {name: the job's seconds}."""
    import torch
    from repro_torch.parallel import init_grid

    out, wall = {}, {}
    for name, fn, args, shape in jobs:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        g = world if shape is None else init_grid(world, *shape)
        try:
            out[name] = fn(g, *args)
        except Exception as e:
            raise RuntimeError(f"session job {name} failed") from e
        wall[name] = time.perf_counter() - t0
    return {"results": out, "wall_s": wall}


def grid_session(jobs) -> dict:
    """The multi-rank phases' ranks, SESSION_RANKS processes sharing the
    card over gloo, started once for all ``jobs`` (``_session_rank``): each
    process start, CUDA context and gloo rendezvous took ~20-25 s a spawn
    when every phase had its own. {"ranks": {name: the ranks' results in
    rank order}, "wall_s": {name: rank 0's seconds}}."""
    import torch
    from repro_torch.parallel import spawn

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(_session_rank, SESSION_RANKS, args=(jobs,), backend="gloo", device=DEV,
                  timeout_s=SESSION_TIMEOUT_S)
    wall = time.perf_counter() - t0
    names = [j[0] for j in jobs]
    out = {"ranks": {n: [r["results"][n] for r in ranks] for n in names},
           "wall_s": ranks[0]["wall_s"]}
    emit("grid_session", ranks=SESSION_RANKS, wall_s=wall, job_wall_s_rank0=out["wall_s"],
         job_wall_s_by_rank={n: [r["wall_s"][n] for r in ranks] for n in names})
    return out


def phase_launcher_grid_dense(session: dict, specs: dict) -> dict:
    """Mula-1B at full width and GRID_DENSE_LAYERS of its 16 layers through
    the multi-rank launcher: launcher_dense's run (GRID_DENSE_RUN) with
    ``parallel='dp=4'`` and ``opt_shard='so'``, four ranks sharing the card
    over gloo, one 2048-token row each; then the same run, which resumes
    from the last checkpoint (both in the session's processes). Beside it
    the same run on one rank (no plan) at the same depth. The resumed
    steps must agree bit for bit, the losses within 1 % of the one-rank
    run's (same seed), the checkpoint hold the one-rank run's members
    (whole arrays) and the plan's layout, each rank exactly its planned
    state bytes."""
    from repro_torch.models import init_params
    from repro_torch.optim.epso import state_bytes_per_device
    from repro_torch.parallel.sharding import param_placements

    out, one_out = _grid_run_dir("grid_dense/first"), LAUNCH_DIR / "grid_dense_one"
    one_run = {k: v for k, v in GRID_DENSE_RUN.items() if k not in ("parallel", "opt_shard")}
    shutil.rmtree(one_out, ignore_errors=True)
    try:
        _, one, wall_one = _launch_grid("launcher_grid_dense", DENSE_ARCH,
                                        dict(one_run, out=str(one_out)), GRID_DENSE_LAYERS)
        one_members = _npz_members(next((one_out / "ckpt").glob("ckpt-*/state.npz")))
        shutil.rmtree(one_out, ignore_errors=True)
        spec, first, wall_first = _grid_run(session, specs, "grid_dense/first")
        _, second, wall_second = _grid_run(session, specs, "grid_dense/second")
        ckpt = next((out / "ckpt").glob("ckpt-*/state.npz"))
        members = _npz_members(ckpt)
        manifest = json.loads((ckpt.parent / "MANIFEST.json").read_text())
        sizes = {"full_ckpt_bytes": ckpt.stat().st_size,
                 "model_only_ckpt_bytes": sum(f.stat().st_size for f in (out / "ckpt").glob(
                     "model-*.npz"))}
    finally:
        for d in (out, one_out):
            shutil.rmtree(d, ignore_errors=True)
    one_losses = [h["loss"] for h in one[0]["result"]]
    cfg = spec.cfg
    shapes = init_params(cfg, device="meta")
    want_bytes = state_bytes_per_device(shapes, param_placements(shapes, {"data": 4}),
                                        {"data": 4}, "so")
    hist, again = first[0]["result"], second[0]["result"]
    keys = ("loss", "grad_norm", "lr")
    resumed = {h["step"]: {k: h[k] for k in keys} for h in again}
    steps, every = GRID_DENSE_RUN["steps"], GRID_DENSE_RUN["ckpt_interval"]
    last_ckpt = (steps - 1) // every * every
    straight = {h["step"]: {k: h[k] for k in keys} for h in hist[last_ckpt + 1:]}
    losses = [h["loss"] for h in hist]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, one_losses)]
    row = {"model": DENSE_ARCH, "layers": cfg.num_layers, "run": GRID_DENSE_RUN,
           "ranks": len(first), "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
           "losses_one_rank": one_losses, "loss_rel_to_one_rank": rel,
           "one_rank_wall_s": wall_one, "resumed_steps": resumed,
           "step_ms_by_rank": [r["rec"]["step_ms"] for r in first],
           "step_ms_median_after_step_0_by_rank": [statistics.median(r["rec"]["step_ms"][1:steps])
                                                   for r in first],
           "peak_bytes_by_rank": [r["peak_bytes"] for r in first],
           "peak_bytes_by_rank_resumed": [r["peak_bytes"] for r in second],
           "state_bytes_by_rank": [r["rec"]["state_bytes"] for r in first],
           "state_bytes_expected": want_bytes,
           "save_ms_by_rank": [r["rec"]["save_ms"] for r in first],
           "save_model_only_ms_by_rank": [r["rec"]["save_model_only_ms"] for r in first],
           "restore_ms_by_rank": [r["rec"]["restore_ms"] for r in second],
           "h2d_ms_rank0": first[0]["rec"]["h2d_ms"], **sizes,
           "ckpt_gb": sizes["full_ckpt_bytes"] / 1e9, "manifest_plan": manifest.get("plan"),
           "wall_s": [wall_first, wall_second],
           "launches_per_rank": first[0]["launches"],
           "note": "4 ranks time-share one card; gloo carries the gradient reduce-scatter, "
                   "the param gather and the checkpoint tiles through host memory: no step "
                   "time here is a DP speed"}
    emit("launcher_grid_dense", **row)
    if [h["step"] for h in hist] != list(range(steps)) or \
            sorted(resumed) != list(range(last_ckpt + 1, steps)):
        raise AssertionError(f"launcher_grid_dense: steps {[h['step'] for h in hist]} then "
                             f"{sorted(resumed)}, not 0-{steps - 1} then "
                             f"{last_ckpt + 1}-{steps - 1}")
    if resumed != straight:
        raise AssertionError(f"launcher_grid_dense: resumed steps {resumed} differ from the "
                             f"uninterrupted run's {straight}")
    if not (_finite(hist) and losses[-1] < losses[0]):
        raise AssertionError(f"launcher_grid_dense: losses {losses} not finite and falling")
    if len(rel) != steps or max(rel) > 0.01:
        raise AssertionError(f"launcher_grid_dense: losses off the one-rank run's by {rel} "
                             f"(> 1 %)")
    if members != one_members:
        raise AssertionError("launcher_grid_dense: the checkpoint's members differ from "
                             "the one-rank run's (keys, whole shapes, dtypes)")
    if (manifest.get("plan") or {}).get("layout") != GRID_DENSE_LAYOUT:
        raise AssertionError(f"launcher_grid_dense: MANIFEST plan {manifest.get('plan')}")
    if any(r["rec"]["state_bytes"] != want_bytes for r in first + second):
        raise AssertionError(f"launcher_grid_dense: state bytes {row['state_bytes_by_rank']}, "
                             f"planned {want_bytes}")
    if any(any(r["launches"].values()) for r in first + second):
        raise AssertionError("launcher_grid_dense: the dense path launched kernels")
    return row


def _run_tables(phase: str, ranks, spec) -> dict:
    """``table_row`` of a launcher run's ranks (their probes' table elements)
    on its plan's grid."""
    return table_row(phase, [r["rec"]["table_elems"] for r in ranks], spec.cfg,
                     spec.plan.axis_sizes)


def _cli_args(run: dict) -> list:
    """The launcher's command line (``launch.train.main``) for the
    ``run`` keywords of ``launch.train.run``: each key as its --flag."""
    return [arg for k, v in run.items() for arg in (f"--{k.replace('_', '-')}", str(v))]


def phase_launcher_grid_ft(ft: dict, session: dict, specs: dict) -> dict:
    """launcher_ft's runs on a dp = 2 x ep = 2 grid under EPSO
    (GRID_FT_RUN): clean in the session, its ranks under the probe (the
    exact launches of 18 steps on every rank); then with FT_INJECT through
    the command line, ``python -m repro_torch.launch.train`` in a fresh
    process whose ranks run the launcher's own body: two relaunches with
    the node swaps, and its history (rank 0's ``history.json``) the clean
    run's bit for bit. The losses are held to launcher_ft's (``ft``, same
    seed and data): within 0.1 % for steps 0-2, where the warmup's small
    steps leave both runs' params nearly the same, so the losses compare
    the forward and the first updates through this grid's kernel shapes;
    within 5 % after. The two runs' ``moe_drops`` are recorded side by
    side: under capacity dispatch a rank's MoE call here routes its 'ep'
    group's 512 gathered tokens against launcher_ft's 1,024, so each expert
    gets a smaller capacity, and once routing concentrates the grid drops
    pairs that launcher_ft keeps (measured on the card: drops from step 3
    on here, none there, and the losses part at that step). That is the
    reference's own EP semantics (``tests/test_torch_ep.py`` holds each
    rank's capacity dispatch to the JAX one), not rounding."""
    out = LAUNCH_DIR / "grid_ft"
    shutil.rmtree(out, ignore_errors=True)
    cli = [sys.executable, "-m", "repro_torch.launch.train", "--arch", FT_ARCH,
           *_cli_args(dict(GRID_FT_RUN, **FT_INJECT, out=str(out / "faulty")))]
    try:
        spec, clean, clean_wall = _grid_run(session, specs, "grid_ft/clean")
        t0 = time.perf_counter()
        proc = subprocess.run(cli, capture_output=True, text=True, timeout=600, cwd=str(ROOT),
                              env={**os.environ, "PYTHONPATH": str(SRC)})
        faulty_wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"launcher_grid_ft: the command line run {cli} failed "
                                 f"(rc {proc.returncode}): {proc.stderr[-3000:]}")
        faulty = json.loads((out / "faulty" / "history.json").read_text())
        summary = json.loads((out / "faulty" / "summary.json").read_text())
        manifests = [json.loads((out / "faulty" / "ckpt" / slot / "MANIFEST.json").read_text())
                     for slot in ("ckpt-1", "ckpt-2")]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    layers = FT_RUN["layers"]
    expect = expected_train_launches(layers, 1, FT_RUN["steps"])
    # the clean history as the command line's history.json holds it
    c0 = json.loads(json.dumps(list(clean[0]["result"])))
    losses = [h["loss"] for h in c0]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ft["losses"])]
    drops = [h["moe_drops"] for h in c0]
    row = {"model": launcher_ft_cfg().name, "run": GRID_FT_RUN, "inject": FT_INJECT,
           "ranks": len(clean), "losses": losses, "loss_rel_to_launcher_ft": rel,
           "moe_drops": drops, "moe_drops_launcher_ft": ft["moe_drops"],
           "moe_drops_differ_at_steps": [i for i, (a, b) in enumerate(zip(drops, ft["moe_drops"]))
                                         if a != b],
           "cli": cli[1:], "cli_relaunches": summary["relaunches"],
           "cli_replaced": summary["replaced"], "cli_summary": summary,
           "cli_stdout_tail": proc.stdout[-1500:],
           "slot_steps": sorted(m["step"] for m in manifests if m.get("valid")),
           "history_bit_identical": faulty == c0,
           "step_ms_median_by_rank": [statistics.median(r["rec"]["step_ms"]) for r in clean],
           "peak_bytes_by_rank": [r["peak_bytes"] for r in clean],
           **_run_tables("launcher_grid_ft", clean, spec),
           "wall_s": [clean_wall, faulty_wall],
           "launches_per_rank": clean[0]["launches"], "expected_launches": expect}
    emit("launcher_grid_ft", **row)
    for i, c in enumerate(clean):
        where = f"launcher_grid_ft rank {i}"
        if c["result"].relaunches != 0:
            raise AssertionError(f"{where}: the clean run relaunched {c['result'].relaunches} "
                                 f"times")
        if c["launches"] != expect:
            raise AssertionError(f"{where}: kernel launches {c['launches']} != expected {expect}")
    if summary["relaunches"] != 2 or summary["replaced"] != [[0, 4], [1, 5]] or \
            summary["steps"] != FT_RUN["steps"] or summary["parallel"] != "dp=2,ep=2,opt=epso":
        raise AssertionError(f"launcher_grid_ft: the command line run's summary {summary}")
    if faulty != c0 or [h["step"] for h in faulty] != list(range(FT_RUN["steps"])):
        raise AssertionError("launcher_grid_ft: the command line's faulty history differs from "
                             "the clean one")
    if row["slot_steps"] != [10, 15]:
        raise AssertionError(f"launcher_grid_ft: valid slots at {row['slot_steps']}, not 10, 15")
    if not (_finite(c0) and c0[-1]["loss"] < c0[0]["loss"]):
        raise AssertionError(f"launcher_grid_ft: losses {row['losses']} not finite and falling")
    if len(rel) != FT_RUN["steps"] or max(rel[:3]) > 1e-3 or max(rel) > 0.05:
        raise AssertionError(f"launcher_grid_ft: losses off launcher_ft's by {rel} (> 0.1 % "
                             f"in steps 0-2 or > 5 %)")
    return row


def phase_launcher_grid_tp(ft: dict, session: dict, specs: dict) -> dict:
    """launcher_ft's runs on an ep = 2 x tp = 2 grid under EPSO
    (GRID_TP_RUN: attention, the expert stacks' d_ff and the SO/EPSO state
    split over 'tp'): clean, then with a hard failure at step 7 that
    relaunches from the step-5 checkpoint (both in the session's
    processes). Every rank relaunches once and
    ends with the clean run's history, bit for bit, and launches exactly
    the kernels of 18 and 19 steps; the MANIFEST holds the plan's layout;
    the losses are finite, fall, and lie within GRID_TP_LOSS_TOL relative
    of launcher_ft's (same seed and data) at the steps where neither run
    drops pairs (the capacity pools differ by design: ROADMAP.md §3, "Not
    faults")."""
    runs = {}
    try:
        for name in ("clean", "faulty"):
            runs[name] = _grid_run(session, specs, f"grid_tp/{name}")[1:]
        spec = specs["grid_tp/clean"]
        manifest = _newest_manifest(_grid_run_dir("grid_tp/faulty") / "ckpt")
    finally:
        shutil.rmtree(LAUNCH_DIR / "grid_tp", ignore_errors=True)
    (clean, clean_wall), (faulty, faulty_wall) = runs["clean"], runs["faulty"]
    layers, steps = FT_RUN["layers"], FT_RUN["steps"]
    expect = {"clean": expected_train_launches(layers, 1, steps),
              "faulty": expected_train_launches(layers, 1, steps + 1)}
    c0 = clean[0]["result"]
    losses, drops = [h["loss"] for h in c0], [h["moe_drops"] for h in c0]
    both_clean = [i for i, (a, b) in enumerate(zip(drops, ft["moe_drops"])) if a == 0 == b]
    rel = {i: abs(losses[i] - ft["losses"][i]) / abs(ft["losses"][i]) for i in both_clean}
    row = {"model": launcher_ft_cfg().name, "run": GRID_TP_RUN, "inject": GRID_TP_INJECT,
           "ranks": len(clean), "coords_by_rank": [r["coords"] for r in clean],
           "losses": losses, "losses_launcher_ft": ft["losses"], "moe_drops": drops,
           "moe_drops_launcher_ft": ft["moe_drops"], "steps_without_drops": both_clean,
           "loss_rel_to_launcher_ft": rel, "tolerance": GRID_TP_LOSS_TOL,
           "relaunches_by_rank": [r["result"].relaunches for r in faulty],
           "replaced_by_rank": [r["result"].replaced for r in faulty],
           "history_bit_identical": list(faulty[0]["result"]) == list(c0),
           "manifest_plan": manifest.get("plan"),
           "step_ms_median_by_rank": [statistics.median(r["rec"]["step_ms"]) for r in clean],
           "save_ms_rank0": faulty[0]["rec"]["save_ms"],
           "restore_ms_rank0": faulty[0]["rec"]["restore_ms"],
           "peak_bytes_by_rank": [r["peak_bytes"] for r in clean + faulty],
           **_run_tables("launcher_grid_tp", clean + faulty, spec),
           "wall_s": [clean_wall, faulty_wall],
           "launches_per_rank": {"clean": clean[0]["launches"], "faulty": faulty[0]["launches"]},
           "expected_launches": expect}
    emit("launcher_grid_tp", **row)
    for i, (c, f) in enumerate(zip(clean, faulty)):
        where = f"launcher_grid_tp rank {i}"
        if c["result"].relaunches != 0 or f["result"].relaunches != 1:
            raise AssertionError(f"{where}: relaunches {c['result'].relaunches} / "
                                 f"{f['result'].relaunches}")
        if list(f["result"]) != list(c["result"]) or \
                [h["step"] for h in f["result"]] != list(range(steps)):
            raise AssertionError(f"{where}: the faulty run's history differs from the clean one")
        if {"clean": c["launches"], "faulty": f["launches"]} != expect:
            raise AssertionError(f"{where}: kernel launches {c['launches']} / "
                                 f"{f['launches']} != expected {expect}")
    if (manifest.get("plan") or {}).get("layout") != GRID_TP_LAYOUT:
        raise AssertionError(f"launcher_grid_tp: MANIFEST plan {manifest.get('plan')}")
    if not (_finite(c0) and c0[-1]["loss"] < c0[0]["loss"]):
        raise AssertionError(f"launcher_grid_tp: losses {losses} not finite and falling")
    if not both_clean or max(rel.values()) > GRID_TP_LOSS_TOL:
        raise AssertionError(f"launcher_grid_tp: losses off launcher_ft's by {rel} at the "
                             f"steps without drops (> {GRID_TP_LOSS_TOL})")
    return row


def phase_launcher_grid_fsdp(session: dict, specs: dict, base: str = "grid_fsdp",
                             ft: dict = None) -> dict:
    """launcher_ft's shapes with fsdp under EPSO: ``base`` 'grid_fsdp' on a
    dp = 2 x ep = 2 grid (GRID_FSDP_RUN, ``--parallel dp=2,ep=2,fsdp
    --opt-shard epso``), 'grid_fsdp_pp' on dp = 2 x pp = 2
    (GRID_FSDP_PP_RUN, ``--parallel dp=2,pp=2,fsdp``: one layer a stage).
    18 steps that checkpoint every 5 (the fsdp tiles and their EPSO shards
    gathered to rank 0 into whole arrays), then the same run again, which
    resumes from the last (the tiles sent back) and takes steps 16-17 (both
    in the session's processes). Asserts the resumed steps bit-identical,
    the checkpoint's members the whole arrays of the config (keys, shapes,
    dtypes), the plan's layout with fsdp in the MANIFEST, each rank's state
    bytes ``state_bytes_per_device`` of the fsdp placements, the exact
    launch count of both runs (of a stage under pp), losses finite and
    falling; 'grid_fsdp': step 0's loss bit for bit launcher_grid_ft's
    clean run's (the same plan without fsdp) and the later ones within
    GRID_FSDP_LOSS_TOL of it where both drop as many pairs; 'grid_fsdp_pp':
    the losses within GRID_FSDP_LOSS_TOL of launcher_ft's (``ft``, one
    rank) at the steps where neither run drops pairs. Prints save and
    restore ms and the checkpoint's bytes."""
    from repro_torch.models import init_params
    from repro_torch.optim.epso import state_bytes_per_device
    from repro_torch.train import state_layout
    from repro_torch.train.trainer import placements

    phase = f"launcher_{base}"
    run, layout = {"grid_fsdp": (GRID_FSDP_RUN, GRID_FSDP_LAYOUT),
                   "grid_fsdp_pp": (GRID_FSDP_PP_RUN, GRID_FSDP_PP_LAYOUT)}[base]
    out = _grid_run_dir(f"{base}/first")
    try:
        spec, first, wall_first = _grid_run(session, specs, f"{base}/first")
        _, second, wall_second = _grid_run(session, specs, f"{base}/second")
        ckpt = next((out / "ckpt").glob("ckpt-*/state.npz"))
        members = _npz_members(ckpt)
        manifest = json.loads((ckpt.parent / "MANIFEST.json").read_text())
        ckpt_bytes = {"full_ckpt_bytes": ckpt.stat().st_size,
                      "model_only_ckpt_bytes": sum(f.stat().st_size for f in (out / "ckpt").glob(
                          "model-*.npz"))}
    finally:
        shutil.rmtree(out, ignore_errors=True)
    cfg, sizes, par = spec.cfg, spec.plan.axis_sizes, spec.par
    shapes = init_params(cfg, device="meta")
    want_bytes = state_bytes_per_device(shapes, placements(cfg, shapes, sizes, fsdp=True), sizes,
                                        "epso")
    want_members = {k: [list(shape), "int32" if k == ".opt.step" else "float32"]
                    for k, (shape, _) in state_layout(cfg, sizes, "epso", fsdp=True).items()
                    if k.startswith((".params", ".opt"))}
    steps, every = run["steps"], run["ckpt_interval"]
    last_ckpt = (steps - 1) // every * every
    if par.pp_stages > 1:
        # a stage's layers; capacity dispatch: each forward also makes the
        # one-device plan of the microbatch gathered over 'data'
        expect = {k: expected_pp_launches(cfg.num_layers // par.pp_stages, par.microbatches, n,
                                          whole_pool=True)
                  for k, n in (("first", steps), ("second", steps - last_ckpt - 1))}
    else:
        expect = {k: expected_train_launches(cfg.num_layers, 1, n)
                  for k, n in (("first", steps), ("second", steps - last_ckpt - 1))}
    keys = ("loss", "grad_norm", "lr", "moe_drops")
    hist, again = first[0]["result"], second[0]["result"]
    resumed = {h["step"]: {k: h[k] for k in keys} for h in again}
    straight = {h["step"]: {k: h[k] for k in keys} for h in hist[last_ckpt + 1:]}
    losses, drops = [h["loss"] for h in hist], [h["moe_drops"] for h in hist]
    if base == "grid_fsdp":
        ref_name = "launcher_grid_ft"
        ref = list(_grid_run(session, specs, "grid_ft/clean")[1][0]["result"])[:steps]
        ref_losses, ref_drops = [r["loss"] for r in ref], [r["moe_drops"] for r in ref]
        compared = [i for i, (a, b) in enumerate(zip(drops, ref_drops)) if a == b]
    else:
        ref_name = "launcher_ft"
        ref_losses, ref_drops = ft["losses"][:steps], ft["moe_drops"][:steps]
        compared = [i for i, (a, b) in enumerate(zip(drops, ref_drops)) if a == 0 == b]
    rel = {i: abs(losses[i] - ref_losses[i]) / abs(ref_losses[i]) for i in compared}
    row = {"model": cfg.name, "run": run, "ranks": len(first),
           "coords_by_rank": [r["coords"] for r in first],
           "microbatches": par.microbatches, "pp_stages": par.pp_stages,
           "losses": losses, "grad_norms": [h["grad_norm"] for h in hist], "moe_drops": drops,
           f"losses_{ref_name}": ref_losses, f"moe_drops_{ref_name}": ref_drops,
           "steps_compared": compared, f"loss_rel_to_{ref_name}": rel,
           "tolerance": GRID_FSDP_LOSS_TOL,
           "resumed_steps": resumed, "history_bit_identical": resumed == straight,
           "step_ms_median_by_rank": [statistics.median(r["rec"]["step_ms"]) for r in first],
           "peak_bytes_by_rank": [r["peak_bytes"] for r in first],
           "state_bytes_by_rank": [r["rec"]["state_bytes"] for r in first],
           "state_bytes_expected": want_bytes,
           **_run_tables(phase, first + second, spec),
           "save_ms_by_rank": [r["rec"]["save_ms"] for r in first],
           "save_model_only_ms_by_rank": [r["rec"]["save_model_only_ms"] for r in first],
           "restore_ms_by_rank": [r["rec"]["restore_ms"] for r in second], **ckpt_bytes,
           "manifest_plan": manifest.get("plan"), "wall_s": [wall_first, wall_second],
           "launches_per_rank": {"first": first[0]["launches"],
                                 "second": second[0]["launches"]},
           "expected_launches": expect}
    emit(phase, **row)
    if [h["step"] for h in hist] != list(range(steps)) or \
            sorted(resumed) != list(range(last_ckpt + 1, steps)):
        raise AssertionError(f"{phase}: steps {[h['step'] for h in hist]} then "
                             f"{sorted(resumed)}, not 0-{steps - 1} then "
                             f"{last_ckpt + 1}-{steps - 1}")
    if resumed != straight:
        raise AssertionError(f"{phase}: resumed steps {resumed} differ from the "
                             f"uninterrupted run's {straight}")
    for i, (f, g) in enumerate(zip(first, second)):
        if {"first": f["launches"], "second": g["launches"]} != expect:
            raise AssertionError(f"{phase} rank {i}: kernel launches "
                                 f"{f['launches']} / {g['launches']} != expected {expect}")
        if f["rec"]["state_bytes"] != want_bytes or g["rec"]["state_bytes"] != want_bytes:
            raise AssertionError(f"{phase} rank {i}: state bytes "
                                 f"{f['rec']['state_bytes']}, planned {want_bytes}")
    if members != want_members:
        raise AssertionError(f"{phase}: the checkpoint's members {members} are not "
                             f"the config's whole arrays {want_members}")
    if (manifest.get("plan") or {}).get("layout") != layout:
        raise AssertionError(f"{phase}: MANIFEST plan {manifest.get('plan')}")
    if not (_finite(hist) and losses[-1] < losses[0]):
        raise AssertionError(f"{phase}: losses {losses} not finite and falling")
    if base == "grid_fsdp" and losses[0] != ref_losses[0]:
        raise AssertionError(f"{phase}: step 0's loss {losses[0]} != {ref_name}'s "
                             f"{ref_losses[0]}")
    if not compared or max(rel.values()) > GRID_FSDP_LOSS_TOL:
        raise AssertionError(f"{phase}: losses off {ref_name}'s by {rel} at steps "
                             f"{compared} (> {GRID_FSDP_LOSS_TOL})")
    return row


def phase_launcher_grid_pp() -> dict:
    """launcher_ft's run on a pp = 2 x ep = 2 grid under EPSO (GRID_PP_RUN:
    one layer a stage, two one-row microbatches a rank, 1f1b) through the
    launcher's command line, ``launch.train.main(argv)`` (the entry of
    ``python -m repro_torch.launch.train``) in this process, each rank's
    body under ``_launcher_probe`` (``_launcher_grid_rank``), with a hard
    failure at step GRID_PP_INJECT: one relaunch from the step-5
    checkpoint (the stage tiles gathered into whole arrays on save, sent
    back on restore), the replayed step's loss and grad norm bit-identical
    to its first attempt's on every rank, the plan's layout in the
    MANIFEST, finite and falling losses, every rank's launches exactly a
    stage's 19 steps. Then its last checkpoint (step 15) restores on one
    rank: the one-rank launcher resumes steps 16 and 17 from it."""
    from repro_torch.launch import train as launch

    out = LAUNCH_DIR / "grid_pp"
    shutil.rmtree(out, ignore_errors=True)
    run = GRID_PP_RUN
    argv = ["--arch", FT_ARCH, "--parallel", run["parallel"], "--opt-shard", run["opt_shard"],
            "--d-model", str(run["d_model"]), "--layers", str(run["layers"]),
            "--steps", str(run["steps"]), "--batch", str(run["batch"]), "--seq", str(run["seq"]),
            "--ckpt-interval", str(run["ckpt_interval"]),
            "--compute-dtype", run["compute_dtype"], "--inject-hard-at", str(GRID_PP_INJECT),
            "--log-every", "100", "--out", str(out / "grid")] + \
        (["--device", run["device"]] if "device" in run else [])
    rank_main, real_launch = launch._rank_main, launch.launch_ranks
    ranks = []

    def keep(spec, rank_fn=None):
        ranks.extend(real_launch(spec, rank_fn))
        return ranks

    try:
        # the command line's own path, each rank's body under the probe
        launch._rank_main, launch.launch_ranks = _launcher_grid_rank, keep
        t0 = time.perf_counter()
        launch.main(argv)
        wall = time.perf_counter() - t0
    finally:
        launch._rank_main, launch.launch_ranks = rank_main, real_launch
    try:
        history = json.loads((out / "grid" / "history.json").read_text())
        manifest = _newest_manifest(out / "grid" / "ckpt")
        # its last checkpoint on one rank: resume the remaining steps here
        t0 = time.perf_counter()
        one = launch.run(FT_ARCH, **{k: v for k, v in run.items()
                                     if k not in ("parallel", "opt_shard")},
                         out=str(out / "grid"))
        one_wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(out, ignore_errors=True)
    steps = run["steps"]
    spec = launch.prepare_run(FT_ARCH, **run, out=str(out / "grid"))
    par = spec.par
    expect = expected_pp_launches(run["layers"] // par.pp_stages, par.microbatches, steps + 1,
                                  whole_pool=True)
    losses = [h["loss"] for h in history]
    # calls 0-6 are steps 0-6; the failure at step 7 restores step 5's
    # checkpoint, so call 7 replays step 6
    first = GRID_PP_INJECT - 1
    row = {"model": launcher_ft_cfg().name, "run": run, "inject_hard_at": GRID_PP_INJECT,
           "argv": argv, "wall_s": wall, "plan": str(par.pp_stages) + " stages, "
           + par.pp_schedule + ", " + par.pp_impl + f", {par.microbatches} microbatches",
           "ranks": len(ranks), "coords_by_rank": [r["coords"] for r in ranks],
           "relaunches_by_rank": [r["result"].relaunches for r in ranks],
           "replaced_by_rank": [r["result"].replaced for r in ranks],
           "calls_by_rank": [len(r["rec"]["calls"]) for r in ranks],
           "step6_first_attempt": ranks[0]["rec"]["calls"][first],
           "step6_replay": ranks[0]["rec"]["calls"][first + 1],
           "losses": losses, "moe_drops": [h.get("moe_drops") for h in history],
           "manifest_plan": manifest.get("plan"), "last_checkpoint_step": manifest["step"],
           "step_ms_median_by_rank": [statistics.median(r["rec"]["step_ms"]) for r in ranks],
           "save_ms_rank0": ranks[0]["rec"]["save_ms"],
           "restore_ms_rank0": ranks[0]["rec"]["restore_ms"],
           "peak_bytes_by_rank": [r["peak_bytes"] for r in ranks],
           **_run_tables("launcher_grid_pp", ranks, spec),
           "one_rank_resumed_steps": [h["step"] for h in one],
           "one_rank_losses": [h["loss"] for h in one],
           "grid_losses_same_steps": [losses[h["step"]] for h in one],
           "one_rank_wall_s": one_wall, "launches_per_rank": ranks[0]["launches"],
           "expected_launches": expect}
    emit("launcher_grid_pp", **row)
    for i, r in enumerate(ranks):
        where, calls = f"launcher_grid_pp rank {i}", r["rec"]["calls"]
        if r["result"].relaunches != 1 or [h["step"] for h in r["result"]] != list(range(steps)):
            raise AssertionError(f"{where}: {r['result'].relaunches} relaunches, steps "
                                 f"{[h['step'] for h in r['result']]}")
        if len(calls) != steps + 1 or calls[first] != calls[first + 1]:
            raise AssertionError(f"{where}: step {first}'s replay {calls[first + 1:first + 2]} "
                                 f"differs from its first attempt {calls[first]} "
                                 f"({len(calls)} step calls)")
        if r["launches"] != expect:
            raise AssertionError(f"{where}: launches {r['launches']} != {expect}")
    if (manifest.get("plan") or {}).get("layout") != GRID_PP_LAYOUT:
        raise AssertionError(f"launcher_grid_pp: MANIFEST plan {manifest.get('plan')}")
    if not (_finite(history) and losses[-1] < losses[0]):
        raise AssertionError(f"launcher_grid_pp: losses {losses} not finite and falling")
    if [h["step"] for h in one] != list(range(manifest["step"] + 1, steps)) or not _finite(one):
        raise AssertionError(f"launcher_grid_pp: the one-rank resume took "
                             f"{[(h['step'], h['loss']) for h in one]}")
    return row


def _newest_manifest(ckpt) -> dict:
    """The MANIFEST of the newest valid slot under ``ckpt``."""
    mans = [json.loads((ckpt / slot / "MANIFEST.json").read_text())
            for slot in ("ckpt-1", "ckpt-2") if (ckpt / slot / "MANIFEST.json").exists()]
    return max((m for m in mans if m.get("valid")), key=lambda m: m["step"])


def phase_launcher_grid_rebalance(session: dict, specs: dict,
                                  base: str = "grid_rebalance") -> dict:
    """launcher_grid_ft's run with live EP rebalancing on the dp = 2 x ep = 2
    EPSO grid: ``base`` 'grid_rebalance' (GRID_REB_RUN: the plan's
    ``rebalance=2:1.0`` and ``rebalance_force_at=3``) or
    'grid_fsdp_rebalance' (GRID_FSDP_REB_RUN: the same with fsdp, the
    moves taking the 'data' tiles of the expert stacks): clean, then with a
    hard failure (GRID_REB_INJECT) after the step-5 checkpoint that follows
    the event, so that the relaunch restores placed arrays and the
    MANIFEST's placement (both in the session's processes). Asserts at least
    one event before step 9, the faulty run's history bit-identical to the
    clean one's (imbalances and events included) on every rank, the same
    placement in both runs' last MANIFEST, finite losses and the exact
    launch count of every kernel (one more step replayed in the faulty
    run); with fsdp also the plan's fsdp layout in the MANIFESTs and each
    rank's state bytes ``state_bytes_per_device`` of the fsdp placements.
    Prints save, restore and move ms."""
    from repro_torch.models import init_params
    from repro_torch.optim.epso import state_bytes_per_device
    from repro_torch.train.trainer import placements

    phase, fsdp = f"launcher_{base}", base == "grid_fsdp_rebalance"
    run = GRID_FSDP_REB_RUN if fsdp else GRID_REB_RUN
    runs = {}
    try:
        for name in ("clean", "faulty"):
            d = _grid_run_dir(f"{base}/{name}")
            runs[name] = _grid_run(session, specs, f"{base}/{name}")
            runs[name] += (_newest_manifest(d / "ckpt"),
                           json.loads((d / "summary.json").read_text()))
    finally:
        shutil.rmtree(LAUNCH_DIR / base, ignore_errors=True)
    (spec, clean, clean_wall, man_c, sum_c), (_, faulty, faulty_wall, man_f, sum_f) = \
        runs["clean"], runs["faulty"]
    layers, steps = FT_RUN["layers"], FT_RUN["steps"]
    replayed = GRID_REB_INJECT["inject_hard_at"] - 1 - FT_RUN["ckpt_interval"]
    expect = {"clean": expected_train_launches(layers, 1, steps),
              "faulty": expected_train_launches(layers, 1, steps + replayed)}
    c0, f0 = clean[0]["result"], faulty[0]["result"]
    events = [h["step"] for h in c0 if h.get("rebalanced")]
    cfg, sizes = spec.cfg, spec.plan.axis_sizes
    shapes = init_params(cfg, device="meta")
    want_bytes = state_bytes_per_device(shapes, placements(cfg, shapes, sizes, fsdp=fsdp), sizes,
                                        "epso")
    row = {"model": launcher_ft_cfg().name, "run": run, "inject": GRID_REB_INJECT,
           **_run_tables(phase, clean + faulty, spec),
           "ranks": len(clean), "events_at_steps": events, "rebalances": sum_c["rebalances"],
           "rebalances_faulty": sum_f["rebalances"],
           "moe_imbalance": [h["moe_imbalance"] for h in c0],
           "final_imbalance": sum_c["final_imbalance"], "losses": [h["loss"] for h in c0],
           "moe_drops": [h["moe_drops"] for h in c0],
           "relaunches_by_rank": [r["result"].relaunches for r in faulty],
           "history_bit_identical": list(f0) == list(c0),
           "manifest_step": [man_c["step"], man_f["step"]],
           "manifest_plan": man_c.get("plan"),
           "manifest_placement": man_c.get("placement"),
           "manifest_placement_equal": man_c.get("placement") == man_f.get("placement"),
           "step_ms_median_by_rank": [statistics.median(r["rec"]["step_ms"]) for r in clean],
           "state_bytes_by_rank": [r["rec"]["state_bytes"] for r in clean],
           "state_bytes_expected": want_bytes,
           "save_ms_by_rank": [r["rec"]["save_ms"] for r in clean],
           "restore_ms_by_rank": [r["rec"]["restore_ms"] for r in faulty],
           "move_ms_by_rank": [r["rec"]["move_ms"] for r in clean],
           "move_sent_bytes_by_rank": [r["rec"]["move_sent_bytes"] for r in clean],
           "restore_ms_rank0": faulty[0]["rec"]["restore_ms"],
           "wall_s": [clean_wall, faulty_wall],
           "launches_per_rank": {"clean": clean[0]["launches"], "faulty": faulty[0]["launches"]},
           "expected_launches": expect}
    emit(phase, **row)
    if not events or events[0] >= 9 or sum_c["rebalances"] < 1:
        raise AssertionError(f"{phase}: events at {events} (none before step 9)")
    restored = (GRID_REB_INJECT["inject_hard_at"] - 1) // FT_RUN["ckpt_interval"] * \
        FT_RUN["ckpt_interval"]
    if not any(s <= restored for s in events) or man_c.get("placement") is None:
        raise AssertionError(f"{phase}: the relaunch restores no placed checkpoint")
    for i, (c, f) in enumerate(zip(clean, faulty)):
        where = f"{phase} rank {i}"
        if f["result"].relaunches != 1 or list(f["result"]) != list(c["result"]) or \
                list(c["result"]) != list(c0):
            raise AssertionError(f"{where}: the faulty run's history differs from the clean one "
                                 f"(relaunches {f['result'].relaunches})")
        if {"clean": c["launches"], "faulty": f["launches"]} != expect:
            raise AssertionError(f"{where}: kernel launches {c['launches']} / "
                                 f"{f['launches']} != expected {expect}")
        if fsdp and (c["rec"]["state_bytes"] != want_bytes or
                     f["rec"]["state_bytes"] != want_bytes):
            raise AssertionError(f"{where}: state bytes {c['rec']['state_bytes']} / "
                                 f"{f['rec']['state_bytes']}, planned {want_bytes}")
    if man_c["step"] != man_f["step"] or man_c.get("placement") != man_f.get("placement"):
        raise AssertionError(f"{phase}: last MANIFESTs differ: {man_c} / {man_f}")
    if fsdp and any((m.get("plan") or {}).get("layout") != GRID_FSDP_LAYOUT
                    for m in (man_c, man_f)):
        raise AssertionError(f"{phase}: MANIFEST plans {man_c.get('plan')} / "
                             f"{man_f.get('plan')}, not the fsdp layout {GRID_FSDP_LAYOUT}")
    if not _finite(c0):
        raise AssertionError(f"{phase}: losses {row['losses']} not finite")
    return row


# ----------------------------------------------------------------------------
# device launches, counted by the profiler after every timed phase
# ----------------------------------------------------------------------------

def _moe_block_decode(cfg, device):
    """One MoE block of the model's widths (random weights from seed 0, one
    layer) and a decode step's 8 tokens, as serving runs it: dropless, no
    grad, no aux where the block takes ``aux``. Returns a call."""
    import inspect

    import torch
    from repro_torch.core.moe import init_moe_block, sparse_moe_block
    from repro_torch.serve.engine import dropless_cfg
    scfg = dropless_cfg(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    p = {k: v[0] for k, v in init_moe_block(scfg, num_layers=1, generator=gen, device=device,
                                             dtype=torch.bfloat16).items()}
    x = torch.randn((8, 1, cfg.d_model), generator=gen, device=device).bfloat16()
    kw = {"aux": False} if "aux" in inspect.signature(sparse_moe_block).parameters else {}

    def block():
        with torch.no_grad():
            sparse_moe_block(p, x, scfg, **kw)

    block()
    return block


def graph_launches(fn) -> int:
    """Device launches (kernel, memset and copy nodes) of one call of
    ``fn()``, captured in a CUDA graph (a capture fails on a host sync) and
    counted in the graph's DOT dump. The profiler's device events lose some
    launches of short windows on the card, a graph does not."""
    import re
    import tempfile
    import warnings

    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)      # keep the graph for the dump
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn()
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore")            # the dump's own DEBUG notices
        dot = Path(tmp) / "graph.dot"
        graph.debug_dump(str(dot))
        text = dot.read_text()
    del graph
    return len(re.findall(r'^"graph_\d+_node_\d+"\s*\[', text, flags=re.M))


def phase_launches(cfg) -> dict:
    """The device launches of one dispatch plan at each kernel case's shape
    (at most 3: the plan must not grow into a chain again) and of one MoE
    block at a decode step's 8 tokens, each call captured in a CUDA graph."""
    import torch
    gen = torch.Generator(device=DEV).manual_seed(1)
    plans = {c["case"]: graph_launches(lambda c=c: c["fn"](*c["args"]))
             for c in dispatch_plan_cases(cfg, gen)}
    row = {"dispatch_plan_device_launches": plans,
           "moe_block_decode_device_launches": graph_launches(_moe_block_decode(cfg, DEV))}
    emit("launches", **row)
    bad = {k: v for k, v in plans.items() if not 1 <= v <= 3}
    if bad:
        raise AssertionError(f"dispatch_plan: device launches per plan {bad}, not 1 to 3")
    return row


# ----------------------------------------------------------------------------
# parent against change: --compare runs the serve and train phases and
# epso_train's runs of two trees in turns, each side in its own process
# (--side)
# ----------------------------------------------------------------------------

def _smoke_under(root: str):
    """The chip_smoke.py under ``root`` as a module (its ``src/`` first on
    the path), profiled by this file's ``_profile_window``."""
    import importlib.util

    if sys.path[0] != str(Path(root) / "src"):
        sys.path.insert(0, str(Path(root) / "src"))
    spec = importlib.util.spec_from_file_location("smoke_under_test",
                                                  Path(root) / "chip_smoke.py")
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    other._profile_window = _profile_window
    return other


def _compare_grid_rank(grid, root: str) -> dict:
    """One rank of a ``--compare`` side's grid runs: epso_train's model,
    grid and row, each (mode, overlap) of EPSO_RUNS through the
    ``_history_run`` of the chip_smoke.py under ``root``, EPSO_STEPS steps,
    the last profiled on rank 0: the losses, step ms, peak memory, state
    bytes and param elements, and rank 0's ``gloo:`` and ``c10d::`` calls
    and host ms of the profiled step."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_config

    other = _smoke_under(root)
    cfg = dataclasses.replace(get_config(MULA), num_layers=EPSO_LAYERS)
    r = grid.world.rank
    train = TrainConfig(seq_len=EP_SEQ, global_batch=grid.world.world, warmup_steps=2,
                        total_steps=100)
    batch = _fixed_batch(cfg.vocab_size, train.global_batch, train.seq_len, grid.world.device)
    mine = {k: v[r:r + 1] for k, v in batch.items()}
    out = {}
    for mode, overlap in EPSO_RUNS:
        run = other._history_run(cfg, train, grid, mode, overlap, mine, EPSO_STEPS,
                                 profile_last=True)
        prof = run["profile"]
        out[f"{mode}/{overlap}"] = {
            **{k: run[k] for k in ("state_bytes", "param_elems", "peak_bytes",
                                   "peak_bytes_steps")},
            "losses": [h["loss"] for h in run["history"]],
            "step_ms": [h["step_ms"] for h in run["history"]],
            "collectives_rank0": None if prof is None else {
                k: v for k, v in prof["host_events"].items()
                if k.startswith(("gloo:", "c10d::"))}}
    return out


def _side(root: str) -> None:
    """One side of ``--compare``: the serve and train phases of the
    chip_smoke.py under ``root`` (with that tree's ``src/`` and launch
    expectations), profiled by this file's ``_profile_window``; the tokens
    of the serve run; the host time to enqueue one ``make_dispatch_plan``
    at a decode step's and a train microbatch's shapes; the device launches
    of one MoE block at a decode step; then epso_train's four runs on
    SESSION_RANKS ranks sharing the card (``_compare_grid_rank``). Prints a
    ``side`` line."""
    other = _smoke_under(root)

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import moe
    from repro_torch.kernels import _build, ops
    from repro_torch.parallel import spawn
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import dropless_cfg

    _build.library()
    runs = []
    engine_run = ServeEngine.run

    def run(self):
        res = engine_run(self)
        runs.append({int(k): v.tokens for k, v in res.items()})
        return res

    ServeEngine.run = run
    cfg = get_config(MULA)
    gen = torch.Generator(device=DEV).manual_seed(0)
    plan_us = {}
    for name, T, m in (("decode", 8, dropless_cfg(cfg).moe), ("train", TRAIN_TOKENS, cfg.moe)):
        ids = torch.rand((T, cfg.moe.num_experts), generator=gen, device=DEV).topk(
            cfg.moe.experts_per_token, dim=-1).indices
        rows = moe.dispatch_pool_rows(T, m)
        plan_us[name] = host_us(lambda i, rows=rows: moe.make_dispatch_plan(
            i, num_experts=cfg.moe.num_experts, pool_rows=rows, align=ops.gmm_align()), (ids,))
    serve = other.phase_serve()
    moe_launches = graph_launches(_moe_block_decode(cfg, DEV))
    torch.cuda.empty_cache()
    train = other.phase_train()
    torch.cuda.empty_cache()
    grid = spawn(_compare_grid_rank, SESSION_RANKS, args=(str(root),), backend="gloo",
                 device=DEV, timeout_s=SESSION_TIMEOUT_S, grid=(EPSO_DP, EPSO_EP))
    emit("side", root=str(root), nvidia_smi=nvidia_smi(), host_us_make_dispatch_plan=plan_us,
         epso_train={name: {**grid[0][name], "peak_bytes_by_rank": [
             g[name]["peak_bytes"] for g in grid]} for name in grid[0]},
         moe_block_decode_device_launches=moe_launches, serve_tokens=runs[1],
         serve={k: serve[k] for k in ("decode_step_ms_median", "tokens_per_s", "wall_s",
                                      "profile_decode_3_steps", "profile_prefill_1024")},
         train={k: train[k] for k in ("losses", "step_ms_median", "tokens_per_s",
                                      "profile_step")})


def compare(parent: str) -> int:
    """The parent tree's and this tree's sides in turns: parent, this, this,
    parent, each in its own process on the card."""
    for root in (parent, ROOT, ROOT, parent):
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--side", str(root)],
                       check=True, timeout=1200)
    print(nvidia_smi(), flush=True)
    return 0


# ----------------------------------------------------------------------------

SOURCES = {"gmm": "src/repro_torch/csrc/gmm.cu",
           "tgmm": "src/repro_torch/csrc/tgmm.cu",
           "swiglu": "src/repro_torch/csrc/swiglu.cu",
           "swiglu_bwd": "src/repro_torch/csrc/swiglu.cu",
           "combine": "src/repro_torch/csrc/combine.cu",
           "combine_bwd": "src/repro_torch/csrc/combine.cu",
           "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
           "ssd_intra_chunk": "src/repro_torch/csrc/ssd.cu",
           "token_counts": "src/repro_torch/csrc/token_counts.cu",
           "dispatch_plan": "src/repro_torch/csrc/dispatch_plan.cu"}
REPLACES = {"gmm": "src/repro/kernels/gmm.py:40",
            "tgmm": "src/repro/kernels/gmm.py:98",
            "swiglu": "src/repro/kernels/swiglu.py:21",
            "swiglu_bwd": "src/repro/kernels/ops.py:253",
            "combine": "src/repro/kernels/combine.py:26",
            "combine_bwd": "src/repro/kernels/combine.py:58",
            "flash_attention": "src/repro/kernels/flash_attention.py:67",
            "ssd_intra_chunk": "src/repro/kernels/ssd.py:54",
            "token_counts": "src/repro/kernels/moe_dispatch.py:34",
            "dispatch_plan": "src/repro/kernels/moe_dispatch.py:34 with "
                             "src/repro/core/moe.py:171"}
# the case whose numbers head the summary line: the training path's for the
# kernels it runs, the 512-token prefill for flash (serving only), the
# 4096-token prompt for the SSD stage, EP's gathered ids for the histogram,
# a train microbatch for the dispatch plan
HEADLINE = {"gmm": "train gate", "tgmm": "train gate M", "swiglu": "train",
            "swiglu_bwd": "train", "combine": "train", "combine_bwd": "train",
            "flash_attention": "Sq=512 ", "ssd_intra_chunk": "S=4096 ",
            "token_counts": "EP F=65536 EL=16 offset=16", "dispatch_plan": "train F=32768"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", metavar="PARENT_ROOT",
                    help="instead of the smoke run: the serve and train phases of the "
                         "checkout at PARENT_ROOT and of this one, in turns")
    ap.add_argument("--side", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the repository",
              file=sys.stderr)
        return 2
    if args.side:
        _side(args.side)
        return 0
    if args.compare:
        return compare(args.compare)
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
    phase_hybrid_reference()
    hybrid = phase_hybrid_serve()
    phase_hybrid_train_reference()
    hybrid_train = phase_hybrid_train()
    ssm_serve = phase_ssm_serve()
    ssm_train = phase_ssm_train()
    phase_launcher_ssm()
    # the multi-rank phases share one set of processes (grid_session)
    ep_ref = ep_reference_prep()
    grid_jobs, grid_specs = launcher_grid_jobs()
    try:
        session = grid_session([
            ep_ref["job"], ("ep_train", _ep_train_rank, (EP_STEPS,), None),
            ("epso_train", _epso_train_rank, (EPSO_STEPS,), (EPSO_DP, EPSO_EP)),
            ("fsdp_hybrid_train", _fsdp_hybrid_train_rank, (), None),
            ("fsdp_ssm_pp_train", _fsdp_ssm_pp_train_rank, (), None), *grid_jobs])
    except BaseException:
        shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
        raise
    ranks, walls = session["ranks"], session["wall_s"]
    phase_ep_reference(ranks["ep_reference"], walls["ep_reference"], ep_ref)
    ep_train = phase_ep_train(ranks["ep_train"], walls["ep_train"])
    epso, placement, a2a, tp, pp, grid_serve, fsdp, fsdp_ep, fsdp_tp, fsdp_pp, fsdp_placed = \
        phase_epso_train(ranks["epso_train"], walls["epso_train"])
    fsdp_hybrid = phase_fsdp_state_space_train(ranks["fsdp_hybrid_train"], "fsdp_hybrid_train")
    fsdp_ssm_pp = phase_fsdp_state_space_train(ranks["fsdp_ssm_pp_train"], "fsdp_ssm_pp_train")
    dense = phase_launcher_dense()
    ft = phase_launcher_ft()
    grid_dense = phase_launcher_grid_dense(session, grid_specs)
    grid_ft = phase_launcher_grid_ft(ft, session, grid_specs)
    grid_tp = phase_launcher_grid_tp(ft, session, grid_specs)
    grid_reb = phase_launcher_grid_rebalance(session, grid_specs)
    grid_fsdp_reb = phase_launcher_grid_rebalance(session, grid_specs, "grid_fsdp_rebalance")
    grid_fsdp = phase_launcher_grid_fsdp(session, grid_specs)
    grid_fsdp_pp = phase_launcher_grid_fsdp(session, grid_specs, "grid_fsdp_pp", ft)
    grid_pp = phase_launcher_grid_pp()
    phase_launches(get_config(MULA))
    emit("phase_times", seconds=PHASE_S, total_s=time.perf_counter() - T_START)

    summary = []
    for name in SOURCES:
        rows = [r for r in kernel_rows if r["kernel"] == name]
        head = next((r for r in rows if HEADLINE[name] in r["case"]), rows[0])
        by_path = {"serve": serve["launches"][name], "train": train["launches"][name],
                   "hybrid": hybrid["launches"][name],
                   "hybrid_train": hybrid_train["launches"][name],
                   "ssm_serve": ssm_serve["launches"][name],
                   "ssm_train": ssm_train["launches"][name],
                   "ep_train": ep_train["launches_per_rank"][name],
                   "epso_train": epso["launches_per_rank"][name],
                   "placement_train": placement["launches_per_rank"][name],
                   "a2a_train": a2a["launches_per_rank"][name],
                   "tp_train": tp["launches_per_rank"][name],
                   "pp_train": pp["launches_per_rank"][name],
                   "grid_serve": grid_serve["launches_per_rank"][name],
                   "fsdp_train": fsdp["launches_per_rank"][name],
                   "fsdp_ep_train": fsdp_ep["launches_per_rank"][name],
                   "fsdp_tp_train": fsdp_tp["launches_per_rank"][name],
                   "fsdp_pp_train": fsdp_pp["launches_per_rank"][name],
                   "fsdp_placement_train": fsdp_placed["launches_per_rank"][name],
                   "fsdp_hybrid_train": fsdp_hybrid["launches_per_rank"][name],
                   "fsdp_ssm_pp_train": fsdp_ssm_pp["launches_per_rank"][name],
                   "launcher_dense": dense["launches"][name],
                   "launcher_ft": ft["launches"]["clean"][name] + ft["launches"]["faulty"][name],
                   "launcher_grid_dense": grid_dense["launches_per_rank"][name],
                   "launcher_grid_ft": grid_ft["launches_per_rank"][name],
                   "launcher_grid_rebalance": grid_reb["launches_per_rank"]["clean"][name]
                   + grid_reb["launches_per_rank"]["faulty"][name],
                   "launcher_grid_fsdp_rebalance":
                       grid_fsdp_reb["launches_per_rank"]["clean"][name]
                       + grid_fsdp_reb["launches_per_rank"]["faulty"][name],
                   "launcher_grid_tp": grid_tp["launches_per_rank"]["clean"][name]
                   + grid_tp["launches_per_rank"]["faulty"][name],
                   "launcher_grid_pp": grid_pp["launches_per_rank"][name],
                   "launcher_grid_fsdp": grid_fsdp["launches_per_rank"]["first"][name]
                   + grid_fsdp["launches_per_rank"]["second"][name],
                   "launcher_grid_fsdp_pp": grid_fsdp_pp["launches_per_rank"]["first"][name]
                   + grid_fsdp_pp["launches_per_rank"]["second"][name]}
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": by_path["train"] or by_path["serve"] or by_path["hybrid"],
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "host_us": head["host_us"], "plain_host_us": head.get("plain_host_us"),
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
