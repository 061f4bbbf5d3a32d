"""PyTorch port, FSDP (ZeRO-3) with tensor and pipeline parallelism against
the JAX package: fsdp on ('data', 'tp') and ('data', 'pp'[, 'ep']) grids
in every optimizer mode, the grid checkpoints of those layouts and the
launcher's ``--parallel dp=2,pp=2,fsdp``.

* Layout: ``train.placements(..., fsdp=True)`` leaf by leaf the JAX
  ``param_specs`` with ``ShardingRules(..., fsdp=True)`` on the plan mesh
  (meta tensors, ``jax.eval_shape``): full-size Mula-1B and Mula-7B-A1B on
  ('data', 2) x ('tp', 2) and ('data', 2) x ('pp', 2), Mula-100B-A7B on
  ('data', 2) x ('pp', 4) x ('ep', 2), Mula-220B-A10B on ('data', 2) x
  ('pp', 8) x ('ep', 2) x ('tp', 2), the embedding and head tables' vocab
  rows on the model axis ('tp', else 'ep') too. The state bytes a rank
  the JAX ``state_bytes_per_device``'s in every mode. Full-width
  Mula-7B-A1B at 2 layers: the param elements and state bytes a rank on
  both 4-rank grids (the H100 smoke's figures).
* Step: one spawn of 4 gloo ranks (in a thread, beside the JAX oracles)
  runs every 4-rank case, each on a grid re-cut from the same processes
  (``torch_ep_ranks.fsdp_grid_cases_rank``), reduced Mula-7B-A1B (4
  layers, 8 experts, dropless, the Mula router terms on) and reduced
  Mula-1B, 3 steps from one state converted from JAX:
  - (dp=2, tp=2) in 'none', 'so' (overlap 'off'), 'epso' ('ring' and
    'xla') for both models, and one 'block_sc' case: against the JAX
    single-device step with dp = 2 microbatches at atol = rtol = 1e-4
    (losses, grad norms, the params' tiles, the gathered master, m and v);
  - (dp=2, pp=2), 1f1b and gpipe, 'none' and 'epso', 2 microbatches, 1f1b
    'so', and dense Mula-1B under 1f1b 'epso': against the port's one-process PP
    step (tests/test_torch_pp_train.py holds it to the JAX PP step) at
    1e-4, the router terms too (``step.router_terms``);
  - every case against the port's step on the same grid in the same mode
    without fsdp: step 0's loss bit for bit, the later losses and grad
    norms within 1e-5 relative.
  A second spawn, of 8 ranks and side by side with the first, runs the
  paper's Mula-100B pairing at reduced size: (dp=2, pp=2, ep=2), 'epso',
  1f1b, 2 steps, held to the one-process PP step at 1e-4.
* Collectives: the all-gathers and reduce-scatters over the 'data' group,
  exactly: the gather's two a layer and microbatch (forward and
  recompute) and one reduce-scatter, three gathers under pp (the F tick,
  the B tick's forward, the recompute), and the update's collectives of
  the buckets it reduces or gathers over 'data' alone. No fsdp tile's
  gradient takes a second sum over 'data', 'tp' or 'pp' in either update
  path (gradients that tell the 'data', 'pp' and 'ep' coordinates apart;
  the grad norm each tile's once).
* Checkpoints: an fsdp 'epso' state on (dp=2, pp=2) and one on (dp=2,
  tp=2), saved by the grid ``Checkpointer``, restore on their grid bit for
  bit, in one port process as whole arrays equal to the gathered state,
  and through the JAX package's ``Checkpointer.restore``.
* Launcher: ``--parallel dp=2,pp=2,fsdp --opt-shard epso`` on reduced
  Mula-7B-A1B checkpoints, then resumes with losses and grad norms
  bit-identical; ``prepare_run`` takes ``dp=2,tp=2,fsdp``.
"""
import dataclasses
import json
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, AxisType  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.configs.base import ParallelConfig as JParallel  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.optim import epso as jepso  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro.parallel.sharding import ShardingRules, param_specs  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import (opt_state_from_jax, opt_state_from_ranks,  # noqa: E402
                                 params_from_jax)
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import epso as tepso  # noqa: E402
from repro_torch.optim.epso import DEFAULT_BUCKET_BYTES  # noqa: E402
from repro_torch.parallel import ParallelPlan, ProcessGrid, spawn  # noqa: E402
from repro_torch.parallel.ep import EPGroup  # noqa: E402
from repro_torch.parallel.grid import SUM_AXES, rank_coords  # noqa: E402
from repro_torch.parallel.sharding import tile_slices  # noqa: E402
from repro_torch.train import init_state, make_train_step  # noqa: E402
from repro_torch.train.trainer import opt_layout, placements  # noqa: E402
from repro_torch.tree import keyed_leaves, leaves, leaves_with_path  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402
from test_torch_epso import F32, TOL, _jleaves, _np, _placements  # noqa: E402
from test_torch_pp_grid import _oracle_batch  # noqa: E402

AXES = ("data", "pp", "ep", "tp")
TP_GRID, PP_GRID, PP_EP_GRID = (2, 1, 1, 2), (2, 2, 1, 1), (2, 2, 2, 1)
ARCHS = ("mula-7b-a1b", "mula-1b")
MODES = (("none", "off"), ("so", "off"), ("epso", "ring"), ("epso", "xla"))
STEPS = 3
BATCH, SEQ = 8, 16
PP_MB = 2
# a case: (config, (dp, pp, ep, tp), mode, overlap, schedule, microbatches,
# remat policy, fsdp)
TP_CASES = [(a, TP_GRID, m, o, None, 1, "block", True) for a in ARCHS for m, o in MODES] + [
    ("mula-7b-a1b", TP_GRID, "epso", "ring", None, 1, "block_sc", True)]
PP_CASES = [("mula-7b-a1b", PP_GRID, m, o, s, PP_MB, "block", True)
            for s in ("1f1b", "gpipe") for m, o in (("none", "off"), ("epso", "ring"))] + [
    ("mula-7b-a1b", PP_GRID, "so", "off", "1f1b", PP_MB, "block", True),
    ("mula-1b", PP_GRID, "epso", "ring", "1f1b", PP_MB, "block", True)]
CASES4 = TP_CASES + PP_CASES
# every fsdp case's twin without fsdp ('block')
TWINS = list(dict.fromkeys(c[:6] + ("block", False) for c in CASES4))
# the paper's Mula-100B pairing (dp x pp x ep), on 8 ranks, 2 steps
CASES8 = [("mula-7b-a1b", PP_EP_GRID, "epso", "ring", "1f1b", PP_MB, "block", True)]
STEPS8 = 2
# train_step.update of torch_ep_ranks.fsdp_grid_grad gradients: (config,
# grid, mode, overlap)
UPDATES4 = [("mula-7b-a1b", TP_GRID, m, o) for m, o in MODES] + [
    ("mula-1b", TP_GRID, "none", "off")] + [
    ("mula-7b-a1b", PP_GRID, m, o) for m, o in (("none", "off"), ("so", "off"),
                                                ("epso", "ring"))]
UPDATES8 = [("mula-7b-a1b", PP_EP_GRID, m, o) for m, o in (("none", "off"), ("epso", "ring"))]
CKPT_SPECS = ("dp=2,pp=2,opt=epso,fsdp", "dp=2,tp=2,opt=epso,fsdp")
# the fsdp step against its twin without fsdp, after step 0
SAME_STEP_RTOL = 1e-5
TIMEOUT_S = 300
TABLES = ("embed/table", "head/table")
# full-width Mula-7B-A1B at 2 of its 16 layers with fsdp, a rank: param
# elements and fp32 state bytes by mode on (dp=2, tp=2) and (dp=2, pp=2)
# (the H100 smoke's fsdp_tp_train and fsdp_pp_train hold their measured
# 'epso' ones to these)
FULL_PARAM_ELEMS = {TP_GRID: 313_141_248, PP_GRID: 416_356_352}
FULL_STATE_BYTES = {TP_GRID: {"none": 3_757_694_976, "so": 3_137_925_120,
                              "epso": 3_137_107_968},
                    PP_GRID: {"none": 4_996_276_224, "so": 3_756_822_528,
                              "epso": 3_756_822_528}}
# full-size Mula-220B-A10B on ('data' 2, 'pp' 8, 'ep' 2, 'tp' 2) under 'epso':
# fp32 state bytes a rank with and without fsdp (meta tensors)
M220_EPSO_STATE_BYTES = {True: 42_148_311_552, False: 41_695_326_720}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models run faster on one torch thread than on every core,
    and the suite runs several test processes side by side (the spawned
    ranks take one thread each already)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sizes(shape):
    return {a: n for a, n in zip(AXES, shape) if n > 1}


def _ids(case):
    name, (dp, pp, ep, tp), mode, overlap, schedule, nmb, sac, fsdp = case
    return (f"{name}-dp{dp}pp{pp}ep{ep}tp{tp}-{mode}-{overlap}"
            + (f"-{schedule}-mb{nmb}" if pp > 1 else "") + f"-{sac}")


def _view(shape, rank):
    """Rank ``rank``'s view of a (dp, pp, ep, tp) grid without process
    groups: the sizes and coordinates the layout functions read."""
    sizes = dict(zip(AXES, shape))
    c = rank_coords(rank, sizes)
    dev = torch.device("cpu")

    def g(a):
        return EPGroup(None, c[a], sizes[a], dev, "gloo")
    return ProcessGrid(EPGroup(None, rank, math.prod(shape), dev, "gloo"), g("data"), g("ep"),
                       tp=g("tp"), pp=g("pp"))


def _cfgs(arch):
    kw = dict(d_model=64, vocab=128, layers=4, **({"max_experts": 8} if arch != "mula-1b"
                                                  else {}))
    jc, tc = jreduced(jget(arch), **kw), treduced(tget(arch), **kw)
    if jc.moe is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, dispatch="dropless"))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, dispatch="dropless"))
        assert (tc.moe.router_aux_coef, tc.moe.router_z_coef) == (0.01, 0.001)
    return jc, tc


def _place(tc, shape, fsdp=True):
    return dict(leaves_with_path(placements(tc, init_params(tc, device="meta"), _sizes(shape),
                                            fsdp=fsdp)))


# ----------------------------------------------------------------------------
# layout
# ----------------------------------------------------------------------------

def _plan_rules(jc, shape):
    """The JAX fsdp rules of a ('data', 'pp', 'ep', 'tp') plan mesh, its
    size-1 axes dropped as ``ParallelPlan.mesh_axes`` drops them."""
    sizes = _sizes(shape)
    mesh = AbstractMesh(tuple(sizes.values()), tuple(sizes),
                        axis_types=(AxisType.Auto,) * len(sizes))
    batch = tuple(a for a in ("data", "ep") if a in sizes)
    return ShardingRules(mesh, batch, "tp" if "tp" in sizes else None,
                         "ep" if "ep" in sizes else None,
                         pp_axis="pp" if "pp" in sizes else None, fsdp=True, cfg=jc)


LAYOUTS = [("mula-1b", TP_GRID), ("mula-7b-a1b", TP_GRID), ("mula-1b", PP_GRID),
           ("mula-7b-a1b", PP_GRID), ("mula-100b-a7b", (2, 4, 2, 1)),
           ("mula-220b-a10b", (2, 8, 2, 2))]


@pytest.mark.parametrize("arch,shape", LAYOUTS,
                         ids=[f"{a}-{'x'.join(map(str, s))}" for a, s in LAYOUTS])
def test_fsdp_grid_layout_matches_jax(arch, shape):
    """Full size, on the plan mesh: the fsdp param placements leaf by leaf
    the JAX fsdp ``param_specs``: 'pp' on the layer dim, then 'ep' and
    'tp', then 'data' on the largest per-layer dim still whole; the tables'
    vocab rows on the model axis ('tp', else 'ep') and never on 'data'; the
    state bytes a rank the JAX ``state_bytes_per_device``'s in 'none', 'so'
    and 'epso'."""
    jc, tc = jget(arch), tget(arch)
    shapes = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jc))
    rules, sizes = _plan_rules(jc, shape), _sizes(shape)
    meta = init_params(tc, device="meta")
    place = placements(tc, meta, sizes, fsdp=True)
    want = leaves(_placements(param_specs(shapes, rules), shapes))
    tiled = 0
    for (path, got), w in zip(leaves_with_path(place), want):
        assert got == w, (path, got, w)
        if path in TABLES:
            assert "data" not in {a for e in got for a in e}, path
        tiled += any("data" in e for e in got)
        if "pp" in sizes and path.startswith("layers/"):
            assert got[0] == ("pp",), path
    assert tiled
    for mode in ("none", "so", "epso"):
        got = tepso.state_bytes_per_device(meta, place, sizes, mode)
        assert got == jepso.state_bytes_per_device(shapes, rules, mode), (mode, got)
    if arch == "mula-220b-a10b":
        for fsdp in (True, False):
            assert tepso.state_bytes_per_device(
                meta, placements(tc, meta, sizes, fsdp=fsdp), sizes, "epso") == \
                M220_EPSO_STATE_BYTES[fsdp]


@pytest.mark.parametrize("mode", ["none", "so", "epso"])
@pytest.mark.parametrize("shape", [TP_GRID, PP_GRID], ids=["dp2tp2", "dp2pp2"])
def test_fsdp_grid_state_of_full_width_mula_7b_a1b(shape, mode):
    """Full-width Mula-7B-A1B at 2 of its 16 layers with fsdp, on meta
    tensors, every rank: ``init_state``'s param elements and fp32 state
    bytes, ``state_bytes_per_device``'s on the fsdp placements."""
    tc = dataclasses.replace(tget("mula-7b-a1b"), num_layers=2)
    shapes = init_params(tc, device="meta")
    sizes = _sizes(shape)
    assert tepso.state_bytes_per_device(shapes, placements(tc, shapes, sizes, fsdp=True), sizes,
                                        mode) == FULL_STATE_BYTES[shape][mode]
    for rank in range(math.prod(shape)):
        st = init_state(tc, TrainConfig(), seed=0, device="meta", grid=_view(shape, rank),
                        opt_sharding_mode=mode, fsdp=True)
        assert sum(t.numel() for t in leaves(st.params)) == FULL_PARAM_ELEMS[shape]
        assert sum(t.numel() * 4 for tr in (st.opt.master, st.opt.m, st.opt.v)
                   for t in leaves(tr)) == FULL_STATE_BYTES[shape][mode], rank


# ----------------------------------------------------------------------------
# the steps on 4 and 8 gloo ranks, their collectives and the checkpoints
# ----------------------------------------------------------------------------

def _batches(n):
    out = []
    for i in range(n):
        t = np.random.default_rng(60 + i).integers(0, 128, (BATCH, SEQ + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def _pp_oracle(tc, case, params, batches, train):
    """The port's one-process PP step on the grid's microbatches: per step
    the metrics with the router terms, and the final params."""
    _, (dp, pp, ep, _), _, _, schedule, n_mb, _, _ = case
    state = init_state(tc, train, seed=0, device="cpu")
    for dst, src in zip(leaves(state.params), leaves(params)):
        dst.copy_(src)
    step = make_train_step(tc, ParallelConfig(microbatches=n_mb, pp_stages=pp,
                                              pp_schedule=schedule), train)
    metrics = []
    for b in batches:
        state, m = step(state, _oracle_batch(b, dp * ep, n_mb))
        metrics.append({**m, **step.router_terms})
    return metrics, dict(leaves_with_path(state.params))


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """Every 4-rank case and its twin without fsdp, the update checks and
    the two grid checkpoints on one spawn of 4 ranks, the 8-rank case and
    its update checks on a second, both in threads; beside them the JAX
    single-device oracles of the tp cases (per model the JAX state after
    STEPS steps with dp microbatches and its metrics) and the one-process
    PP oracles of the pp cases."""
    tkw = dict(seq_len=SEQ, global_batch=BATCH, warmup_steps=1, total_steps=10, lr_peak=1e-2,
               lr_min=1e-3)
    jtrain, train = JTrain(**tkw, **F32), TrainConfig(**tkw, **F32)
    batches = _batches(STEPS)
    tb = [{k: torch.from_numpy(v).long() for k, v in b.items()} for b in batches]
    cfgs, jstates, params, opts = {}, {}, {}, {}
    for arch in ARCHS:
        cfgs[arch] = _cfgs(arch)
        jstates[arch] = jinit_state(jax.random.PRNGKey(0), cfgs[arch][0], jtrain)
        params[arch] = params_from_jax(_np(jstates[arch].params), cfgs[arch][1], device="cpu")
        opts[arch] = opt_state_from_jax(_np(jstates[arch].opt), device="cpu")
    tcs = {a: cfgs[a][1] for a in ARCHS}
    root = tmp_path_factory.mktemp("fsdp_grid")
    ckpts = [("mula-7b-a1b", spec, str(root / spec.replace(",", "_"))) for spec in CKPT_SPECS]
    with ThreadPoolExecutor(2) as pool:
        fut4 = pool.submit(spawn, ranks.fsdp_grid_cases_rank, 4, device="cpu",
                           timeout_s=TIMEOUT_S,
                           args=(tcs, params, opts, train, tb, CASES4 + TWINS, UPDATES4, ckpts))
        fut8 = pool.submit(spawn, ranks.fsdp_grid_cases_rank, 8, device="cpu",
                           timeout_s=TIMEOUT_S,
                           args=(tcs, params, opts, train, tb[:STEPS8], CASES8, UPDATES8))
        oracle = {}
        with use_kernel_plan(KernelPlan()):
            for arch in ARCHS:
                jstep = jax.jit(jmake_train_step(cfgs[arch][0], JParallel(
                    microbatches=TP_GRID[0], remat_policy="none"), jtrain))
                js, jms = jstates[arch], []
                for b in batches:
                    js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
                    jms.append(jm)
                oracle[arch] = (js, jms)
        pp_oracle = {c: _pp_oracle(tcs[c[0]], c, params[c[0]],
                                   tb[:STEPS8] if c in CASES8 else tb, train)
                     for c in PP_CASES + CASES8}
        res4, res8 = fut4.result(), fut8.result()
    return {"cfgs": cfgs, "oracle": oracle, "pp_oracle": pp_oracle, "ranks4": res4,
            "ranks8": res8, "ckpts": {spec: r for _, spec, r in ckpts}}


def _runs(grid_runs, case):
    return [r[case] for r in grid_runs["ranks8" if case in CASES8 else "ranks4"]]


@pytest.mark.parametrize("case", TP_CASES, ids=_ids)
def test_fsdp_tp_step_matches_jax(grid_runs, case):
    """(dp=2, tp=2): every rank's metrics and param tiles ('data' and 'tp'),
    and the master, m and v put back together from the ranks' shards,
    against the JAX single-device step with 2 microbatches at atol = rtol =
    1e-4; each rank holds ``state_bytes_per_device`` bytes of state."""
    arch, shape, mode = case[0], case[1], case[2]
    jstate, jms = grid_runs["oracle"][arch]
    tc = grid_runs["cfgs"][arch][1]
    place = _place(tc, shape)
    jp = _jleaves(jstate.params)
    runs = _runs(grid_runs, case)
    for rank, run in enumerate(runs):
        for i, jm in enumerate(jms):
            for k in ranks.KEYS:
                if k in jm:
                    np.testing.assert_allclose(run["metrics"][i][k].numpy(), np.asarray(jm[k]),
                                               **TOL, err_msg=f"rank {rank} step {i} {k}")
        assert run["state_bytes"] == run["state_bytes_expected"]
        for path, leaf in run["params"].items():
            sl = tile_slices(place[path], jp[path].shape, run["coords"], _sizes(shape))
            assert tuple(leaf.shape) == jp[path][sl].shape, path
            np.testing.assert_allclose(leaf.numpy(), jp[path][sl], **TOL,
                                       err_msg=f"rank {rank} params {path}")
    full = opt_state_from_ranks([r["opt"] for r in runs], tc, dp=shape[0], ep=1, tp=shape[3],
                                mode=mode, fsdp=True)
    assert full["step"] == STEPS
    for what in ("master", "m", "v"):
        for path, ref in _jleaves(getattr(jstate.opt, what)).items():
            np.testing.assert_allclose(full[what][path], ref, **TOL, err_msg=f"{what} {path}")


@pytest.mark.parametrize("case", PP_CASES + CASES8, ids=_ids)
def test_fsdp_pp_step_matches_one_process_pp_step(grid_runs, case):
    """(dp=2, pp=2) and (dp=2, pp=2, ep=2): every rank's metrics and router
    terms equal the one-process PP step's at atol = rtol = 1e-4 and rank 0's
    exactly; its params after the last step its tiles ('data', 'pp', 'ep')
    of the one-process step's; its state bytes ``state_bytes_per_device``'s;
    the 1f1b and gpipe saved-input peaks and the bytes handed to the
    neighbour stage as without fsdp."""
    tc = grid_runs["cfgs"][case[0]][1]
    shape, schedule, n_mb = case[1], case[4], case[5]
    want_m, want_p = grid_runs["pp_oracle"][case]
    place = _place(tc, shape)
    runs = _runs(grid_runs, case)
    dp, pp, ep, _ = shape
    for r in runs:
        for i, (got, want) in enumerate(zip(r["metrics"], want_m)):
            assert sorted(got) == sorted(k for k in want if k in ranks.KEYS + (
                "moe_aux", "moe_z"))
            for k in got:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TOL,
                                           err_msg=f"step {i} {k} {r['coords']}")
                assert torch.equal(got[k], runs[0]["metrics"][i][k]), (k, r["coords"])
        for path, full in want_p.items():
            sl = tile_slices(place[path], tuple(full.shape), r["coords"], _sizes(shape))
            np.testing.assert_allclose(r["params"][path].numpy(), full[sl].numpy(), **TOL,
                                       err_msg=f"{path} {r['coords']}")
        assert r["state_bytes"] == r["state_bytes_expected"], r["coords"]
        stage = r["coords"]["pp"]
        assert r["saved_peak"][stage] == (pp - stage if schedule == "1f1b" else n_mb)
        act = BATCH // (dp * ep) // n_mb * SEQ * tc.d_model * 4
        assert r["sent_bytes"] == n_mb * act * ((stage < pp - 1) + (stage > 0))


@pytest.mark.parametrize("case", CASES4, ids=_ids)
def test_fsdp_grid_step_matches_the_unsharded_step(grid_runs, case):
    """Against the port's step on the same grid in the same mode without
    fsdp ('block'): step 0's loss bit for bit (the gathered weights are the
    whole ones' bits), the later losses, ce and grad norms within
    SAME_STEP_RTOL; rank 0's metrics on every rank; fewer param elements a
    rank."""
    twin = case[:6] + ("block", False)
    for got, ref in zip(_runs(grid_runs, case), _runs(grid_runs, twin)):
        assert torch.equal(got["metrics"][0]["loss"], ref["metrics"][0]["loss"])
        for g, f in zip(got["metrics"], ref["metrics"]):
            for k in ("loss", "grad_norm", "ce"):
                np.testing.assert_allclose(g[k].numpy(), f[k].numpy(), rtol=SAME_STEP_RTOL,
                                           atol=0, err_msg=k)
        for g, f in zip(got["metrics"], _runs(grid_runs, case)[0]["metrics"]):
            assert all(torch.equal(g[k], f[k]) for k in g)
        assert got["param_elems"] < ref["param_elems"]


def _layer_bytes(tc, shape):
    """The f32 bytes one gather of a layer assembles on a rank: each
    fsdp-split leaf of the layer whole over 'data', the rank's tile of it
    over the other axes."""
    sizes = _sizes(shape)
    shapes = init_params(tc, device="meta")
    place = placements(tc, shapes, sizes, fsdp=True)
    return sum(t.numel() // tc.num_layers // math.prod(
        sizes[a] for e in pl for a in e if a not in ("data", "pp")) * 4
        for t, pl in zip(leaves(shapes["layers"]), leaves(place["layers"]))
        if any("data" in e for e in pl))


def _update_data_calls(tc, shape, mode, impl):
    """The all-gathers and reduce-scatters over the 'data' group alone of
    one update: under SO/EPSO (``optim.overlap``) a reduce-scatter for each
    set of leaves of a bucket reduced over 'data' alone that sums over the
    same axes afterwards, an all-gather (not under 'ring', whose exchanges
    are point to point) of each bucket gathered over 'data' alone; in every
    mode one all-gather of the grad-norm slice sums of each expert stack
    whose state (under 'none': whose tile) uses 'data': over the layer or
    expert dim it splits, or over a per-slice dim, which the slice sums are
    added over in rank order (``optim.adamw.sum_in_rank_order``)."""
    sizes = _sizes(shape)
    meta = init_params(tc, device="meta")
    if mode == "none":
        specs = leaves(placements(tc, meta, sizes, fsdp=True))
        plan = None
    else:
        plan, specs = opt_layout(tc, _view(shape, 0), mode, fsdp=True,
                                 max_bucket_bytes=0 if impl == "off" else DEFAULT_BUCKET_BYTES)
    rs = ag = 0
    for b in plan.buckets if plan is not None else ():
        if tuple(a for a in b.axes if a in SUM_AXES) == ("data",):
            rs += len({tuple(a for a in sizes if a in SUM_AXES and a not in lf.psum_axes)
                       for lf in b.leaves})
        ag += b.axes == ("data",) and impl != "ring"
    for (path, _), spec in zip(leaves_with_path(meta), specs):
        if path.split("/")[-2:-1] == ["moe"] and path.endswith(("gate", "up", "down")):
            ag += sum("data" in e for e in spec)
    return {"all_gather": ag, "reduce_scatter": rs}


@pytest.mark.parametrize("case", CASES4 + CASES8, ids=_ids)
def test_fsdp_grid_data_collectives_are_exact(grid_runs, case):
    """The gather's ``stats`` and the all-gathers and reduce-scatters over
    the 'data' group of the steps, exactly: a layer of the rank's stage is
    gathered twice a microbatch (forward, recompute; also under
    'block_sc'), three times under pp (the F tick's forward, the B tick's,
    the recompute), and reduce-scattered once; the update adds its
    collectives over 'data' alone (``_update_data_calls``)."""
    name, shape, mode, _, _, n_mb, _, _ = case
    tc = grid_runs["cfgs"][name][1]
    steps = STEPS8 if case in CASES8 else STEPS
    pp = shape[1]
    n = tc.num_layers // pp * n_mb * steps
    k = 3 if pp > 1 else 2
    layer = _layer_bytes(tc, shape)
    for r in _runs(grid_runs, case):
        assert r["stats"] == {"all_gather": k * n, "reduce_scatter": n,
                              "gathered_bytes": k * n * layer}, r["stats"]
        up = _update_data_calls(tc, shape, mode, r["impl"])
        assert r["data_calls"]["all_gather"] == k * n + steps * up["all_gather"], r["data_calls"]
        assert r["data_calls"]["reduce_scatter"] == n + steps * up["reduce_scatter"], \
            r["data_calls"]


def _summed_grads(tc, shape, coords):
    """Per leaf, the ``fsdp_grid_grad`` gradient of the rank at ``coords``
    summed as the step must sum it: over the axes of SUM_AXES that do not
    split its leaf (a 'data' tile's sum over 'data' was the gather's
    reduce-scatter; a stage's layers take none over 'pp'), never over 'tp';
    and the grad norm, each distinct tile once."""
    sizes = dict(zip(AXES, shape))

    def value(c, axes):
        tot = 0.0
        summed = [a for a in ("data", "pp", "ep") if a not in axes and sizes[a] > 1]
        for pick in np.ndindex(*(sizes[a] for a in summed)):
            cc = dict(c, **dict(zip(summed, pick)))
            tot += cc["data"] + 1.0 + 10.0 * cc["pp"] + 100.0 * cc["ep"]
        return tot

    numel = {path: t.numel() for path, t in leaves_with_path(init_params(tc, device="meta"))}
    mine, sq = {}, 0.0
    for path, pl in _place(tc, shape).items():
        axes = {a for e in pl for a in e}
        mine[path] = value(coords, axes)
        split = [a for a in ("data", "pp", "ep") if a in axes]
        tiles = math.prod(sizes[a] for a in axes)
        for pick in np.ndindex(*(sizes[a] for a in split)):
            sq += numel[path] / tiles * math.prod(sizes[a] for a in axes if a not in split) \
                * value(dict(coords, **dict(zip(split, pick))), axes) ** 2
    return mine, math.sqrt(sq)


@pytest.mark.parametrize("update", UPDATES4 + UPDATES8,
                         ids=[f"{n}-{'x'.join(map(str, s))}-{m}-{o}"
                              for n, s, m, o in UPDATES4 + UPDATES8])
def test_fsdp_grid_tiles_take_no_second_sum(grid_runs, update):
    """``train_step.update`` of the fsdp step on gradients of (d + 1) + 10 p
    + 100 e at ('data' d, 'pp' p, 'ep' e), the same on the tp ranks: every
    rank's grad norm is that of the gradients summed as the step must sum
    them (``_summed_grads``), in both update paths; under 'none' the summed
    gradients themselves."""
    name, shape = update[0], update[1]
    tc = grid_runs["cfgs"][name][1]
    res = grid_runs["ranks8" if shape == PP_EP_GRID else "ranks4"]
    for rank, r in enumerate(res):
        up = r[("update",) + update]
        coords = rank_coords(rank, dict(zip(AXES, shape)))
        want, norm = _summed_grads(tc, shape, coords)
        np.testing.assert_allclose(float(up["grad_norm"]), norm, rtol=1e-6)
        if update[2] == "none":
            for path, v in up["grads"].items():
                assert v.tolist() == [want[path]], (rank, path, v)


def _gathered_state(tc, saved, spec):
    """The grid state of ``spec`` that the ranks saved (``saved``, in rank
    order) as whole numpy arrays by checkpoint key: their param tiles and
    optimizer shards put together."""
    plan = ParallelPlan.parse(spec)
    shape = (plan.dp, plan.pp, plan.ep, plan.tp)
    place = _place(tc, shape)
    meta = dict(leaves_with_path(init_params(tc, device="meta")))
    params = {}
    for rank, s in enumerate(saved):
        coords = rank_coords(rank, dict(zip(AXES, shape)))
        for path, t in leaves_with_path(s.params):
            full = params.setdefault(path, np.full(tuple(meta[path].shape), np.nan,
                                                   dtype=np.float32))
            full[tile_slices(place[path], full.shape, coords, _sizes(shape))] = t.numpy()
    opt = opt_state_from_ranks([s.opt for s in saved], tc, dp=plan.dp, ep=plan.ep, tp=plan.tp,
                               pp=plan.pp, mode="epso", fsdp=True)
    out = {".opt.step": np.asarray(opt["step"], dtype=np.int32)}
    for path in params:
        key = "".join(f"['{k}']" for k in path.split("/"))
        out[".params" + key] = params[path]
        for what in ("master", "m", "v"):
            out[f".opt.{what}" + key] = opt[what][path]
    return out


@pytest.mark.parametrize("spec", CKPT_SPECS)
def test_fsdp_grid_checkpoint_restores_on_the_grid(grid_runs, spec):
    """The fsdp 'epso' state saved by the grid ``Checkpointer``
    (``grid_checkpoint_rank``) comes back on every rank of the same plan bit
    for bit: params (the fsdp tiles of a tp shard or of a stage), master, m
    and v (their shards), the step; the model-only checkpoint into fresh
    params too; the MANIFEST carries the plan with fsdp."""
    for r in grid_runs["ranks4"]:
        saved, back = r[("ckpt", spec)]["saved"], r[("ckpt", spec)]["restored"]
        assert back["error"] is None and back["step"] == 5
        for (k, a), (_, b) in zip(keyed_leaves(saved), keyed_leaves(back["state"])):
            assert a.shape == b.shape and torch.equal(a, b), k
        for (k, a), (_, b) in zip(keyed_leaves(saved.params), keyed_leaves(back["model_only"])):
            assert torch.equal(a, b), k
    tc = grid_runs["cfgs"]["mula-7b-a1b"][1]
    root = grid_runs["ckpts"][spec]
    with open(f"{root}/ckpt-1/MANIFEST.json") as f:
        man = json.load(f)
    plan = ParallelPlan.parse(spec).resolve(tc)
    assert man["plan"] == {"spec": plan.spec(), "layout": plan.layout_signature()}
    assert man["plan"]["layout"]["fsdp"]


@pytest.mark.parametrize("spec", CKPT_SPECS)
def test_fsdp_grid_checkpoint_restores_in_one_process(grid_runs, spec):
    """The same files restored by a one-process port ``Checkpointer`` into
    a whole state of other values: every leaf the whole array the ranks'
    tiles and shards put together."""
    tc = grid_runs["cfgs"]["mula-7b-a1b"][1]
    tmpl = init_state(tc, TrainConfig(param_dtype="float32"), seed=3, device="cpu")
    restored, step = Checkpointer(grid_runs["ckpts"][spec]).restore(tmpl)
    assert step == 5
    want = _gathered_state(grid_runs["cfgs"]["mula-7b-a1b"][1],
                           [r[("ckpt", spec)]["saved"] for r in grid_runs["ranks4"]], spec)
    got = dict(keyed_leaves(restored))
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        assert not np.isnan(ref).any(), key
        np.testing.assert_array_equal(got[key].numpy(), ref, err_msg=key)


@pytest.mark.parametrize("spec", CKPT_SPECS)
def test_fsdp_grid_checkpoint_restores_in_jax(grid_runs, spec):
    """The same files restored by the JAX package's ``Checkpointer`` into a
    JAX TrainState of other values: every leaf bit for bit the gathered
    state, in the JAX dtypes."""
    jc = grid_runs["cfgs"]["mula-7b-a1b"][0]
    tmpl = jinit_state(jax.random.PRNGKey(5), jc, JTrain(param_dtype="float32"))
    restored, step = JCheckpointer(grid_runs["ckpts"][spec]).restore(tmpl)
    assert step == 5
    want = _gathered_state(grid_runs["cfgs"]["mula-7b-a1b"][1],
                           [r[("ckpt", spec)]["saved"] for r in grid_runs["ranks4"]], spec)
    flat = jax.tree_util.tree_leaves_with_path(restored)
    assert len(flat) == len(want)
    for path, x in flat:
        key = jax.tree_util.keystr(path)
        assert np.asarray(x).dtype == want[key].dtype, key
        np.testing.assert_array_equal(np.asarray(x), want[key], err_msg=key)


# ----------------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------------

def test_fsdp_pp_launcher_resumes_bit_identically(tmp_path):
    """``--parallel dp=2,pp=2,fsdp --opt-shard epso`` on reduced
    Mula-7B-A1B (2 layers, one a stage, 4 experts, dropless): 8 steps that
    checkpoint at step 4, then the same command again, which resumes from
    it and takes steps 5-7 with losses and grad norms bit-identical;
    finite, falling losses; the summary names the plan."""
    kw = dict(out=str(tmp_path / "run"), device="cpu", parallel="dp=2,pp=2,fsdp",
              opt_shard="epso", steps=8, ckpt_interval=4, d_model=64, batch=8, seq=32,
              log_every=100, moe_dispatch="dropless")
    first = tlaunch.run("mula-7b-a1b", **kw)
    second = tlaunch.run("mula-7b-a1b", **kw)
    assert [h["step"] for h in second] == [5, 6, 7]
    for h, ref in zip(second, first[5:]):
        assert (h["loss"], h["grad_norm"]) == (ref["loss"], ref["grad_norm"]), h["step"]
    losses = [h["loss"] for h in first]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    with open(tmp_path / "run" / "summary.json") as f:
        summary = json.load(f)
    plan = ParallelPlan.parse(summary["parallel"])
    assert (plan.dp, plan.pp, plan.fsdp, summary["opt_shard"]) == (2, 2, True, "epso")


@pytest.mark.parametrize("parallel,arch", [("dp=2,tp=2,fsdp", "mula-1b"),
                                           ("dp=2,tp=2,fsdp", "mula-7b-a1b"),
                                           ("dp=2,pp=2,ep=2,fsdp", "mula-7b-a1b")])
def test_prepare_run_takes_fsdp_with_tp_and_pp(tmp_path, parallel, arch):
    """``prepare_run`` resolves fsdp with 'tp' and with 'pp' beside 'ep':
    the grid, the step's ``fsdp_params``, nothing written yet."""
    spec = tlaunch.prepare_run(arch, out=str(tmp_path / "run"), device="cpu",
                               parallel=parallel, opt_shard="epso", steps=2, batch=8)
    plan = ParallelPlan.parse(parallel)
    assert spec.par.fsdp_params and spec.plan.grid == tuple(
        spec.plan.grid) and spec.plan.plan.tp == plan.tp and spec.plan.plan.pp == plan.pp
    assert not (tmp_path / "run").exists()
