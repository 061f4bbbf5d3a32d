"""PyTorch port, FSDP (ZeRO-3) with expert parallelism and the sharded
optimizer against the JAX package: fsdp on a dp = 2 x ep = 2 grid
('data' x 'ep') under 'none', 'so' and 'epso', the grid checkpoints of its
layout and the launcher's ``--parallel dp=2,ep=2,fsdp``.

* Layout: ``train.placements(..., fsdp=True)`` on ('data', 2) x ('ep', 2)
  leaf by leaf the JAX ``param_specs`` with ``ShardingRules(..., fsdp=True)``
  on the plan mesh, and the port's optimizer specs, state bytes and update
  plans on those specs the JAX package's, for reduced Mula-7B-A1B and
  Mula-1B; ``init_state(fsdp=True)`` under 'so' and 'epso' cuts the shards
  ``opt_state_for_rank`` cuts from the one-process state; full-width
  Mula-7B-A1B at 2 layers holds 321,529,856 param elements a rank and
  3,858,358,272 ('none'), 3,238,588,416 ('so') and 3,137,107,968 ('epso')
  fp32 state bytes (meta tensors; the tables' vocab rows split over
  'ep').
* Step: one spawn of 4 gloo ranks (in a thread, beside the JAX oracles)
  runs every case: reduced Mula-7B-A1B (dropless, router terms on) and
  reduced Mula-1B, 'none', 'so' (overlap 'off'), 'epso' ('ring' and
  'xla'), 'block', and one 'block_sc' case; 3 steps from one state
  converted from JAX, against the JAX single-device step with dp x ep = 4
  microbatches at atol = rtol = 1e-4 (losses, grad norms, the params'
  tiles, the gathered master, m and v); against the port's 2 x 2 step in
  the same mode without fsdp: step 0's loss bit for bit, later losses and
  grad norms within 1e-5 relative.
* Collectives: the all-gathers and reduce-scatters over the 'data' group
  of 3 steps, exactly (the gather's two a layer and microbatch, its
  reduce-scatter's one, and under 'so' one of each for each update bucket
  gathered over 'data' alone); no fsdp tile's gradient takes a second sum
  over 'data' in either update path (gradients that tell the ranks apart,
  the grad norm each tile's once).
* Checkpoints: a 2 x 2 fsdp 'epso' state saved by the grid ``Checkpointer``
  restores on the grid bit for bit, in one port process as whole arrays
  equal to the gathered state, and through the JAX package's
  ``Checkpointer.restore``.
* Launcher: ``--parallel dp=2,ep=2,fsdp --opt-shard epso`` on reduced
  Mula-7B-A1B (2 layers, 4 experts), a run that checkpoints, then the same
  command again, which resumes with losses and grad norms bit-identical.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

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
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import (opt_state_for_rank, opt_state_from_jax,  # noqa: E402
                                 opt_state_from_ranks, params_from_jax)
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import epso as tepso  # noqa: E402
from repro_torch.parallel import spawn  # noqa: E402
from repro_torch.parallel.grid import rank_coords  # noqa: E402
from repro_torch.parallel.sharding import is_expert_stack_path, tile_slices  # noqa: E402
from repro_torch.train import init_state  # noqa: E402
from repro_torch.train.trainer import placements  # noqa: E402
from repro_torch.tree import keyed_leaves, leaves, leaves_with_path  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402
from test_torch_epso import (F32, TIMEOUT_S, TOL, _batches, _jleaves, _mesh, _np,  # noqa: E402
                             _placement, _placements, _view)

DP, EP = 2, 2
SIZES = {"data": DP, "ep": EP}
ARCHS = ("mula-7b-a1b", "mula-1b")
MODES = (("none", "off"), ("so", "off"), ("epso", "ring"), ("epso", "xla"))
# the fsdp cases of the one spawn: every arch and mode under 'block', and
# one 'block_sc'; each has its twin without fsdp ('block', same mode)
CASES = [(a, m, o, "block") for a in ARCHS for m, o in MODES] + [
    ("mula-7b-a1b", "epso", "ring", "block_sc")]
STEPS = 3
# the fsdp step against its twin without fsdp, after step 0
SAME_STEP_RTOL = 1e-5
# full-width Mula-7B-A1B at 2 of its 16 layers on 2 x 2 with fsdp: param
# elements and fp32 state bytes a rank (the H100 smoke's fsdp_ep_train
# holds its measured 'epso' ones to these)
FULL_PARAM_ELEMS = 321_529_856
FULL_STATE_BYTES = {"none": 3_858_358_272, "so": 3_238_588_416, "epso": 3_137_107_968}
CKPT_SPEC = "dp=2,ep=2,opt=epso,fsdp"
TABLES = ("embed/table", "head/table")


def _ids(case):
    return "-".join(case)


def _cfgs(arch, **kw):
    jc = jreduced(jget(arch), d_model=64, vocab=128, **kw)
    tc = treduced(tget(arch), d_model=64, vocab=128, **kw)
    if jc.moe is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, dispatch="dropless"))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, dispatch="dropless"))
    return jc, tc


def _place(tc):
    return dict(leaves_with_path(placements(tc, init_params(tc, device="meta"), SIZES,
                                            fsdp=True)))


# ----------------------------------------------------------------------------
# layout
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_ep_layout_matches_jax(arch):
    """On the plan mesh ('data', 2) x ('ep', 2): the fsdp param placements
    leaf by leaf the JAX fsdp ``param_specs`` (an expert stack keeps 'ep' on
    E and takes 'data' on another dim; the embedding and head take 'ep' on
    their vocab rows and never 'data'); the
    optimizer specs, state bytes and update plans ('none', 'so', 'epso')
    the JAX package's on them."""
    jc, tc = _cfgs(arch)
    shapes = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jc))
    rules = ShardingRules(_mesh((DP, EP), ("data", "ep")), ("data", "ep"), None, "ep",
                          fsdp=True, cfg=jc)
    want = _placements(param_specs(shapes, rules), shapes)
    got = placements(tc, init_params(tc, device="meta"), SIZES, fsdp=True)
    jflat = jax.tree.leaves(want, is_leaf=lambda s: isinstance(s, tuple))
    tflat = leaves_with_path(got)
    assert len(jflat) == len(tflat)
    for js, (path, ts) in zip(jflat, tflat):
        assert ts == js, path
        if path in TABLES:
            assert ts == (("ep",), ()), path
    split = {p: pl for p, pl in tflat if any("data" in e for e in pl)}
    assert split and not any(p in TABLES for p in split)
    if jc.moe is not None:
        gate = dict(leaves_with_path(got))["layers/moe/gate"]
        assert gate[1] == ("ep",) and ("data",) in gate[2:]
    # the port's sharded-optimizer functions on the JAX specs themselves
    for mode in ("none", "so", "epso"):
        jspecs = jepso.optimizer_state_specs(shapes, rules, mode)
        tspecs = tepso.optimizer_state_specs(shapes, want, SIZES, mode)
        for js, ts, x in zip(jax.tree.leaves(jspecs, is_leaf=lambda s: isinstance(s, P)),
                             leaves(tspecs), jax.tree.leaves(shapes)):
            assert ts == _placement(js, len(x.shape)), mode
        assert (tepso.state_bytes_per_device(shapes, want, SIZES, mode)
                == jepso.state_bytes_per_device(shapes, rules, mode)), mode
        jplan = jepso.plan_update_buckets(shapes, rules, mode)
        assert tuple(tepso.plan_update_buckets(shapes, want, SIZES, mode)) == tuple(jplan)


@pytest.mark.parametrize("mode", ["so", "epso"])
def test_fsdp_init_state_cuts_the_shards_of_the_tiles(mode):
    """On every rank of 2 x 2, ``init_state(fsdp=True)`` under 'so' and
    'epso': params that are the rank's fsdp tiles (tensors of their own),
    and master, m and v exactly the shards ``opt_state_for_rank(fsdp=True)``
    cuts from the one-process state (the tiles cut on the axes the state
    adds alone: no leaf is cut on 'data' twice)."""
    _, tc = _cfgs("mula-7b-a1b")
    train = TrainConfig(**F32)
    one = init_state(tc, train, seed=0, device="cpu")
    whole = dict(leaves_with_path(one.params))
    place = _place(tc)
    for rank in range(DP * EP):
        st = init_state(tc, train, seed=0, device="cpu", grid=_view(DP, EP, rank),
                        opt_sharding_mode=mode, fsdp=True)
        want = opt_state_for_rank(one.opt, tc, dp=DP, ep=EP, rank=rank, mode=mode, fsdp=True)
        for what in ("master", "m", "v"):
            for (path, a), b in zip(leaves_with_path(getattr(st.opt, what)),
                                    leaves(getattr(want, what))):
                assert torch.equal(a, b), (rank, what, path)
        coords = rank_coords(rank, {"data": DP, "ep": EP})
        for (path, p), ma in zip(leaves_with_path(st.params), leaves(st.opt.master)):
            assert torch.equal(p, whole[path][tile_slices(place[path], whole[path].shape,
                                                          coords, SIZES)]), path
            assert p.data_ptr() != ma.data_ptr(), path


@pytest.mark.parametrize("mode", ["none", "so", "epso"])
def test_fsdp_ep_state_of_full_width_mula_7b_a1b(mode):
    """Full-width Mula-7B-A1B at 2 of its 16 layers on 2 x 2 with fsdp, on
    meta tensors: ``init_state``'s param elements and fp32 state bytes on
    every rank, ``state_bytes_per_device``'s on the fsdp placements."""
    tc = dataclasses.replace(tget("mula-7b-a1b"), num_layers=2)
    shapes = init_params(tc, device="meta")
    assert tepso.state_bytes_per_device(shapes, placements(tc, shapes, SIZES, fsdp=True), SIZES,
                                        mode) == FULL_STATE_BYTES[mode]
    for rank in range(DP * EP):
        st = init_state(tc, TrainConfig(), seed=0, device="meta", grid=_view(DP, EP, rank),
                        opt_sharding_mode=mode, fsdp=True)
        assert sum(t.numel() for t in leaves(st.params)) == FULL_PARAM_ELEMS
        assert sum(t.numel() * 4 for tr in (st.opt.master, st.opt.m, st.opt.v)
                   for t in leaves(tr)) == FULL_STATE_BYTES[mode], rank


# ----------------------------------------------------------------------------
# the step on 4 gloo ranks, its collectives and the checkpoints
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fsdp_ep_runs(tmp_path_factory):
    """Every case and its twin without fsdp on one spawn of 4 ranks (in a
    thread), the update checks and the grid checkpoint; beside it the JAX
    single-device oracles: per arch the JAX state after STEPS steps with 4
    microbatches and its metrics."""
    tkw = dict(seq_len=16, global_batch=4, warmup_steps=1, total_steps=10, lr_peak=1e-2,
               lr_min=1e-3)
    jtrain, train = JTrain(**tkw, **F32), TrainConfig(**tkw, **F32)
    batches = _batches(STEPS)
    cfgs, jstates, params, opts = {}, {}, {}, {}
    for arch in ARCHS:
        cfgs[arch] = _cfgs(arch)
        jstates[arch] = jinit_state(jax.random.PRNGKey(0), cfgs[arch][0], jtrain)
        params[arch] = params_from_jax(_np(jstates[arch].params), cfgs[arch][1], device="cpu")
        opts[arch] = opt_state_from_jax(_np(jstates[arch].opt), device="cpu")
    cases = [c + (True,) for c in CASES] + [
        (a, m, o, "block", False) for a in ARCHS for m, o in MODES]
    root = tmp_path_factory.mktemp("fsdp_ep") / "ck"
    args = ({a: cfgs[a][1] for a in ARCHS}, params, opts, train,
            [{k: torch.from_numpy(v).long() for k, v in b.items()} for b in batches], cases,
            str(root))
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn, ranks.fsdp_ep_cases_rank, DP * EP, args=args, device="cpu",
                          timeout_s=TIMEOUT_S, grid=(DP, EP))
        oracle = {}
        with use_kernel_plan(KernelPlan()):
            for arch in ARCHS:
                jstep = jax.jit(jmake_train_step(cfgs[arch][0], JParallel(
                    microbatches=DP * EP, remat_policy="none"), jtrain))
                js, jms = jstates[arch], []
                for b in batches:
                    js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
                    jms.append(jm)
                oracle[arch] = (js, jms)
        res = fut.result()
    return {"cfgs": cfgs, "oracle": oracle, "ranks": res, "root": root}


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_fsdp_ep_step_matches_jax(fsdp_ep_runs, case):
    """Every rank's metrics and param tiles, and the master, m and v put
    back together from the ranks' shards, against the JAX step with dp x
    ep microbatches at atol = rtol = 1e-4; each rank holds its tiles
    ('data' and 'ep') of every split leaf and ``state_bytes_per_device``
    bytes of state."""
    arch, mode = case[0], case[1]
    jstate, jms = fsdp_ep_runs["oracle"][arch]
    tc = fsdp_ep_runs["cfgs"][arch][1]
    place = _place(tc)
    jp = _jleaves(jstate.params)
    runs = [r[case + (True,)] for r in fsdp_ep_runs["ranks"]]
    for rank, run in enumerate(runs):
        for i, jm in enumerate(jms):
            for k in ranks.KEYS:
                if k in jm:
                    np.testing.assert_allclose(run["metrics"][i][k].numpy(), np.asarray(jm[k]),
                                               **TOL, err_msg=f"rank {rank} step {i} {k}")
        assert run["state_bytes"] == run["state_bytes_expected"]
        coords = rank_coords(rank, {"data": DP, "ep": EP})
        for path, leaf in run["params"].items():
            sl = tile_slices(place[path], jp[path].shape, coords, SIZES)
            assert tuple(leaf.shape) == jp[path][sl].shape, path
            np.testing.assert_allclose(leaf.numpy(), jp[path][sl], **TOL,
                                       err_msg=f"rank {rank} params {path}")
    full = opt_state_from_ranks([r["opt"] for r in runs], tc, dp=DP, ep=EP, mode=mode,
                                fsdp=True)
    assert full["step"] == STEPS
    for what in ("master", "m", "v"):
        for path, ref in _jleaves(getattr(jstate.opt, what)).items():
            np.testing.assert_allclose(full[what][path], ref, **TOL, err_msg=f"{what} {path}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_fsdp_ep_step_matches_the_unsharded_step(fsdp_ep_runs, case):
    """Against the port's 2 x 2 step in the same mode without fsdp
    ('block'): step 0's loss bit for bit (the gathered weights are the
    whole ones' bits), the later losses and every grad norm within
    SAME_STEP_RTOL, rank 0's metrics on every rank, fewer param elements
    a rank."""
    twin = case[:3] + ("block", False)
    for r in fsdp_ep_runs["ranks"]:
        got, ref = r[case + (True,)], r[twin]
        assert torch.equal(got["metrics"][0]["loss"], ref["metrics"][0]["loss"])
        for g, f in zip(got["metrics"], ref["metrics"]):
            for k in ("loss", "grad_norm", "ce"):
                np.testing.assert_allclose(g[k].numpy(), f[k].numpy(), rtol=SAME_STEP_RTOL,
                                           atol=0, err_msg=k)
        for g, f in zip(got["metrics"], fsdp_ep_runs["ranks"][0][case + (True,)]["metrics"]):
            assert all(torch.equal(g[k], f[k]) for k in g)
        assert got["param_elems"] < ref["param_elems"]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_fsdp_ep_data_collectives_are_exact(fsdp_ep_runs, case):
    """The all-gathers and reduce-scatters over the 'data' group of STEPS
    steps: the gather's (one a layer and microbatch in the forward, one in
    the recompute, also under 'block_sc'), its reduce-scatters (one a
    layer), and under 'so' and 'epso' one reduce-scatter for each update
    bucket gathered over 'data' alone (under 'so' the leaves fsdp leaves
    whole, under 'epso' the tables, which 'ep' splits) and one all-gather
    for it (blocking under 'off'); in every mode one all-gather
    a step of each expert stack's grad-norm slice sums, added over 'data'
    in rank order; its counts and bytes agree with the gather's
    ``stats``."""
    tc = fsdp_ep_runs["cfgs"][case[0]][1]
    n = tc.num_layers * STEPS
    shapes = init_params(tc, device="meta")
    place = placements(tc, shapes, SIZES, fsdp=True)
    layer = sum(t.numel() // tc.num_layers // (EP if "ep" in {a for e in pl for a in e}
                                                 else 1) * 4
                for t, pl in zip(leaves(shapes["layers"]), leaves(place["layers"]))
                if any("data" in e for e in pl))
    # the grad norm's slice sums of each expert stack, over 'data' in rank order
    stacks = sum(is_expert_stack_path(path) and any("data" in e for e in pl)
                 for path, pl in leaves_with_path(place)) * STEPS
    for r in fsdp_ep_runs["ranks"]:
        run = r[case + (True,)]
        buckets = run["data_buckets"] * STEPS
        assert (case[1] != "none") == (buckets > 0)
        assert run["data_calls"]["all_gather"] == 2 * n + stacks + (
            buckets if run["impl"] != "ring" else 0), run["data_calls"]
        assert run["data_calls"]["reduce_scatter"] == n + buckets, run["data_calls"]
        assert run["stats"] == {"all_gather": 2 * n, "reduce_scatter": n,
                                "gathered_bytes": 2 * n * layer}


def _grad_norm_of_update(tc):
    """The grad norm of ``torch_ep_ranks.fsdp_ep_grad`` gradients summed
    as the step sums them: a leaf each rank holds whole over every rank, a
    layer tile ('data') over 'ep' alone, a table's vocab rows ('ep') over
    'data' alone, an expert stack's tile ('data' and 'ep') not at all;
    each distinct tile counted once."""
    vals = {(d, e): d + 1.0 + 10.0 * e for d in range(DP) for e in range(EP)}
    numel = {path: t.numel() for path, t in leaves_with_path(init_params(tc, device="meta"))}
    sq = 0.0
    for path, pl in _place(tc).items():
        axes = {a for e in pl for a in e}
        n = numel[path]
        if not axes:
            sq += n * sum(vals.values()) ** 2
        elif axes == {"data"}:
            sq += n / DP * sum((vals[d, 0] + vals[d, 1]) ** 2 for d in range(DP))
        elif axes == {"ep"}:
            sq += n / EP * sum(sum(vals[d, e] for d in range(DP)) ** 2 for e in range(EP))
        else:
            assert axes == {"data", "ep"}, path
            sq += n / (DP * EP) * sum(v * v for v in vals.values())
    return np.sqrt(sq)


@pytest.mark.parametrize("arch,mode,overlap", [(a, m, o) for a in ARCHS for m, o in MODES])
def test_fsdp_tiles_take_no_second_sum_over_data(fsdp_ep_runs, arch, mode, overlap):
    """``train_step.update`` on gradients of (d + 1) + 10 e at ('data' d,
    'ep' e): every rank's grad norm is that of the gradients summed as the
    step must sum them (a layer tile's sum over 'data' was the gather's
    reduce-scatter, so it takes 'ep' alone; a table's vocab rows, split on
    'ep', 'data' alone; an expert stack's tile none), in both update paths;
    under 'none' the summed gradients themselves."""
    tc = fsdp_ep_runs["cfgs"][arch][1]
    want = _grad_norm_of_update(tc)
    place = _place(tc)
    for rank, r in enumerate(fsdp_ep_runs["ranks"]):
        up = r["update", arch, mode, overlap]
        np.testing.assert_allclose(float(up["grad_norm"]), want, rtol=1e-6)
        if mode != "none":
            continue
        c = rank_coords(rank, {"data": DP, "ep": EP})
        mine = c["data"] + 1.0 + 10.0 * c["ep"]
        for path, v in up["grads"].items():
            axes = frozenset(a for e in place[path] for a in e)
            expect = {frozenset(): 26.0, frozenset({"data"}): 2 * (c["data"] + 1.0) + 10.0,
                      frozenset({"ep"}): sum(d + 1.0 + 10.0 * c["ep"] for d in range(DP)),
                      frozenset({"data", "ep"}): mine}[axes]
            assert v.tolist() == [expect], (rank, path, v)


def _whole_params(runs_params, tc):
    """The ranks' param tiles put together into whole numpy arrays."""
    place = _place(tc)
    shapes = dict(leaves_with_path(init_params(tc, device="meta")))
    out = {}
    for rank, params in enumerate(runs_params):
        coords = rank_coords(rank, {"data": DP, "ep": EP})
        for path, t in leaves_with_path(params):
            shape = shapes[path].shape
            full = out.setdefault(path, np.full(tuple(shape), np.nan, dtype=np.float32))
            full[tile_slices(place[path], tuple(shape), coords, SIZES)] = t.numpy()
    return out


def test_fsdp_ep_grid_checkpoint_restores_on_the_grid(fsdp_ep_runs):
    """The 2 x 2 fsdp 'epso' state saved by the grid ``Checkpointer``
    (``grid_checkpoint_rank``) comes back on every rank of the same plan bit
    for bit: params (the fsdp tiles), master, m and v (their shards), the
    step; the model-only checkpoint into fresh params too; the MANIFEST
    carries the plan with fsdp."""
    import json
    from repro_torch.parallel import ParallelPlan
    for r in fsdp_ep_runs["ranks"]:
        saved, back = r["ckpt"]["saved"], r["ckpt"]["restored"]
        assert back["error"] is None and back["step"] == 5
        for (k, a), (_, b) in zip(keyed_leaves(saved), keyed_leaves(back["state"])):
            assert a.shape == b.shape and torch.equal(a, b), k
        for (k, a), (_, b) in zip(keyed_leaves(saved.params), keyed_leaves(back["model_only"])):
            assert torch.equal(a, b), k
    tc = fsdp_ep_runs["cfgs"]["mula-7b-a1b"][1]
    man = json.loads((fsdp_ep_runs["root"] / "ckpt-1" / "MANIFEST.json").read_text())
    plan = ParallelPlan.parse(CKPT_SPEC).resolve(tc)
    assert man["plan"] == {"spec": CKPT_SPEC, "layout": plan.layout_signature()}
    assert man["plan"]["layout"]["fsdp"]


def _gathered_state(fsdp_ep_runs):
    """The saved grid state as whole numpy arrays by checkpoint key."""
    tc = fsdp_ep_runs["cfgs"]["mula-7b-a1b"][1]
    saved = [r["ckpt"]["saved"] for r in fsdp_ep_runs["ranks"]]
    params = _whole_params([s.params for s in saved], tc)
    opt = opt_state_from_ranks([s.opt for s in saved], tc, dp=DP, ep=EP, mode="epso",
                               fsdp=True)
    out = {".opt.step": np.asarray(opt["step"], dtype=np.int32)}
    for path in params:
        key = "".join(f"['{k}']" for k in path.split("/"))
        out[".params" + key] = params[path]
        for what in ("master", "m", "v"):
            out[f".opt.{what}" + key] = opt[what][path]
    return out


def test_fsdp_ep_grid_checkpoint_restores_in_one_process(fsdp_ep_runs):
    """The same files restored by a one-process port ``Checkpointer`` into
    a whole state of other values: every leaf the whole array the ranks'
    tiles and shards put together."""
    tc = fsdp_ep_runs["cfgs"]["mula-7b-a1b"][1]
    tmpl = init_state(tc, TrainConfig(param_dtype="float32"), seed=3, device="cpu")
    restored, step = Checkpointer(str(fsdp_ep_runs["root"])).restore(tmpl)
    assert step == 5
    want = _gathered_state(fsdp_ep_runs)
    got = dict(keyed_leaves(restored))
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        assert not np.isnan(ref).any(), key
        np.testing.assert_array_equal(got[key].numpy(), ref, err_msg=key)


def test_fsdp_ep_grid_checkpoint_restores_in_jax(fsdp_ep_runs):
    """The same files restored by the JAX package's ``Checkpointer`` into a
    JAX TrainState of other values: every leaf bit for bit the gathered
    state, in the JAX dtypes."""
    jc = fsdp_ep_runs["cfgs"]["mula-7b-a1b"][0]
    tmpl = jinit_state(jax.random.PRNGKey(5), jc, JTrain(param_dtype="float32"))
    restored, step = JCheckpointer(str(fsdp_ep_runs["root"])).restore(tmpl)
    assert step == 5
    want = _gathered_state(fsdp_ep_runs)
    flat = jax.tree_util.tree_leaves_with_path(restored)
    assert len(flat) == len(want)
    for path, x in flat:
        key = jax.tree_util.keystr(path)
        assert np.asarray(x).dtype == want[key].dtype, key
        np.testing.assert_array_equal(np.asarray(x), want[key], err_msg=key)


# ----------------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------------

def test_fsdp_ep_launcher_resumes_bit_identically(tmp_path):
    """``--parallel dp=2,ep=2,fsdp --opt-shard epso`` on reduced
    Mula-7B-A1B (2 layers, 4 experts, dropless): 8 steps that checkpoint
    at step 4, then the same command again, which resumes from it and
    takes steps 5-7 with losses and grad norms bit-identical; finite,
    falling losses; the summary names the plan."""
    import json
    kw = dict(out=str(tmp_path / "run"), device="cpu", parallel="dp=2,ep=2,fsdp",
              opt_shard="epso", steps=8, ckpt_interval=4, d_model=64, batch=4, seq=32,
              log_every=100, moe_dispatch="dropless")
    first = tlaunch.run("mula-7b-a1b", **kw)
    second = tlaunch.run("mula-7b-a1b", **kw)
    assert [h["step"] for h in second] == [5, 6, 7]
    for h, ref in zip(second, first[5:]):
        assert (h["loss"], h["grad_norm"]) == (ref["loss"], ref["grad_norm"]), h["step"]
    losses = [h["loss"] for h in first]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    summary = json.loads((tmp_path / "run" / "summary.json").read_text())
    assert summary["parallel"] == "dp=2,ep=2,opt=epso,moe=dropless,fsdp"
    assert summary["opt_shard"] == "epso"
