"""PyTorch port, FSDP (ZeRO-3) on the 'data' axis against the JAX package:
the ``fsdp`` layout, and the 'none' training step that gathers each
layer's tiles inside its remat block and reduce-scatters its gradients.

* Layout: ``param_placements(..., fsdp=True)`` (through
  ``train.placements``) leaf by leaf the JAX ``param_specs`` with
  ``ShardingRules(..., fsdp=True)`` on ('data', 2), ('data', 3) (the dims
  it does not divide) and ('data', 4): full-size Mula-1B and Mula-7B-A1B
  (meta tensors, ``jax.eval_shape``) and reduced ones with as many experts
  as model dims (the stable sort's tie: the expert dim); the 'none' state
  bytes exactly ``state_bytes_per_device``'s; the port's optimizer specs,
  bytes and update plans on the JAX fsdp specs, as tests/test_torch_epso.py
  holds them without fsdp.
* Step: one spawn of 2 gloo ranks runs every case: reduced dense Mula-1B
  and reduced Mula-7B-A1B (dropless, router terms on), 1 and 2
  microbatches, 'block' and 'block_sc', 3 steps from one state converted
  from JAX, against the JAX single-device step with 2 x microbatches
  microbatches (no remat) at atol = rtol = 1e-4 (losses, grad norms, the params'
  tiles, the gathered master, m and v); against the port's dp = 2 'none'
  step without fsdp: step 0's loss bit for bit, the later losses and grad
  norms within 1e-5 relative (the gradient sums associate differently:
  per microbatch over the ranks, then over the microbatches).
* Collectives and memory: the 'data' all-gathers (forward and recompute)
  and reduce-scatters of a step, exactly; between a forward and its backward
  no storage that a gather made is alive and autograd packed no gathered
  leaf's shape, under 'block' and 'block_sc' (the tape keeps no gather);
  the fsdp tiles' gradients take no second sum over 'data' in the update.
* Refusals: the step under a remat policy that would keep the gathered
  weights, naming ROADMAP.md §1 item 5.1e; the step builds with a placement
  and for a state-space arch, and ``init_state`` cuts a hybrid and an ssm
  model's tiles (their steps: tests/test_torch_fsdp_placed.py and
  tests/test_torch_fsdp_ssm.py); a grid ``Checkpointer`` takes an fsdp
  layout on grids with 'tp' and 'pp' (the ('data', 'ep') grids and the
  sharded optimizer: tests/test_torch_fsdp_ep.py; 'tp' and 'pp':
  tests/test_torch_fsdp_grid.py).
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.configs.base import ParallelConfig as JParallel  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.optim import epso as jepso  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro.parallel.sharding import ShardingRules, make_rules, param_specs  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import opt_state_from_jax, opt_state_from_ranks  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import epso as tepso  # noqa: E402
from repro_torch.parallel import spawn  # noqa: E402
from repro_torch.parallel.grid import rank_coords  # noqa: E402
from repro_torch.parallel.sharding import is_expert_stack_path, tile_slices  # noqa: E402
from repro_torch.train import init_state, make_train_step  # noqa: E402
from repro_torch.train.trainer import placements, state_layout  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402
from test_torch_epso import (F32, TIMEOUT_S, TOL, _batches, _jleaves, _mesh, _np,  # noqa: E402
                             _placement, _placements)

ITEM = "ROADMAP.md §1 item 5.1e"
BF16 = dict(param_dtype="float32", compute_dtype="bfloat16", grad_reduce_dtype="bfloat16")
DP = 2
ARCHS = ("mula-1b", "mula-7b-a1b")
CASES = [(arch, nmb, sac) for arch in ARCHS for nmb in (1, 2) for sac in ("block", "block_sc")]
STEPS = 3
# the port's fsdp step against its step without fsdp, after step 0 (float32,
# and bf16 compute with bf16 gradient reduction)
SAME_STEP_RTOL = 1e-5
BF16_RTOL = 1e-4


# ----------------------------------------------------------------------------
# layout
# ----------------------------------------------------------------------------

def _cfg_pair(arch, size):
    """(JAX config, port config): ``size`` 'full' (the published widths),
    'reduced', or 'tie' (reduced with 64 experts, as many as model dims:
    the expert stacks' tie)."""
    if size == "full":
        return jget(arch), tget(arch)
    kw = dict(d_model=64, max_experts=64 if size == "tie" else 4)
    return jreduced(jget(arch), **kw), treduced(tget(arch), **kw)


@pytest.fixture(scope="module")
def shape_trees():
    out = {}
    for arch in ARCHS:
        for size in ("full", "reduced", "tie"):
            jc, tc = _cfg_pair(arch, size)
            out[arch, size] = (jc, tc, jax.eval_shape(
                lambda c=jc: jinit_params(jax.random.PRNGKey(0), c)),
                init_params(tc, device="meta"))
    return out


def _fsdp_rules(jc, dp):
    return ShardingRules(_mesh((dp,), ("data",)), ("data",), None, None, fsdp=True, cfg=jc)


@pytest.mark.parametrize("dp", [2, 3, 4])
@pytest.mark.parametrize("size", ["full", "reduced", "tie"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_placements_match_jax(shape_trees, arch, size, dp):
    """Leaf by leaf the JAX fsdp ``param_specs`` on ('data', dp), and the
    'none' state bytes the JAX ``state_bytes_per_device``'s."""
    jc, tc, jshapes, tshapes = shape_trees[arch, size]
    rules = _fsdp_rules(jc, dp)
    want = _placements(param_specs(jshapes, rules), jshapes)
    got = placements(tc, tshapes, {"data": dp}, fsdp=True)
    jflat = jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda s: isinstance(s, tuple))[0]
    tflat = leaves_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [
        "".join(f"['{k}']" for k in path.split("/")) for path, _ in tflat]
    for (jpath, js), (path, ts) in zip(jflat, tflat):
        assert ts == js, path
    split = [path for path, ts in tflat if any(ts)]
    assert not any(p.startswith(("embed", "head")) or "ln" in p or "norm" in p for p in split)
    if dp == 3 and size == "full":
        assert not split                  # 3 divides no dim of either model
    assert (tepso.state_bytes_per_device(tshapes, got, {"data": dp}, "none")
            == jepso.state_bytes_per_device(jshapes, rules, "none"))
    # the layout the step and the checkpoints read carries the same tiles
    layout = state_layout(tc, {"data": dp}, "none", fsdp=True)
    assert [layout[".params" + "".join(f"['{k}']" for k in p.split("/"))][1]
            for p, _ in tflat] == [ts for _, ts in tflat]


@pytest.mark.parametrize("mesh_name", ["data4", "data4-model2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_specs_bytes_and_plans_match_jax(shape_trees, arch, mesh_name):
    """The port's ``optimizer_state_specs``, ``state_bytes_per_device`` and
    ``plan_update_buckets`` on the JAX fsdp param specs, for 'none', 'so'
    and 'epso', exactly the JAX package's (tests/test_torch_epso.py's
    comparison, with fsdp)."""
    jc, _, shapes, _ = shape_trees[arch, "reduced"]
    if mesh_name == "data4":
        rules = _fsdp_rules(jc, 4)
    else:
        rules = make_rules(jc, _mesh((4, 2), ("data", "model")), kind="train", fsdp=True,
                           global_batch=512)
    sizes = dict(rules.mesh.shape)
    place = _placements(param_specs(shapes, rules), shapes)
    assert any("data" in e for pl in jax.tree.leaves(
        place, is_leaf=lambda s: isinstance(s, tuple)) for e in pl)
    for mode in ("none", "so", "epso"):
        jspecs = jepso.optimizer_state_specs(shapes, rules, mode)
        tspecs = tepso.optimizer_state_specs(shapes, place, sizes, mode)
        for (path, js), ts, x in zip(
                jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda s: isinstance(
                    s, P))[0], leaves(tspecs), jax.tree.leaves(shapes)):
            assert ts == _placement(js, len(x.shape)), (mode, jax.tree_util.keystr(path))
        assert (tepso.state_bytes_per_device(shapes, place, sizes, mode)
                == jepso.state_bytes_per_device(shapes, rules, mode)), mode
        for cap in (tepso.DEFAULT_BUCKET_BYTES, 1024):
            jplan = jepso.plan_update_buckets(shapes, rules, mode, max_bucket_bytes=cap)
            tplan = tepso.plan_update_buckets(shapes, place, sizes, mode, max_bucket_bytes=cap)
            assert tuple(tplan) == tuple(jplan), (mode, cap)


def test_fsdp_state_bytes_of_full_width_mula_7b_a1b_on_data4():
    """Full-width Mula-7B-A1B at 2 of its 16 layers on ('data', 4): the
    fp32 state bytes and param elements a rank that the H100 smoke's
    fsdp_train holds its measured ones to, the JAX package's; and its 'so'
    reference run's state bytes."""
    jc = dataclasses.replace(jget("mula-7b-a1b"), num_layers=2)
    tc = dataclasses.replace(tget("mula-7b-a1b"), num_layers=2)
    jshapes = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jc))
    tshapes = init_params(tc, device="meta")
    rules, sizes = _fsdp_rules(jc, 4), {"data": 4}
    place = placements(tc, tshapes, sizes, fsdp=True)
    assert tepso.state_bytes_per_device(tshapes, place, sizes, "none") == \
        jepso.state_bytes_per_device(jshapes, rules, "none") == 4_996_325_376
    elems = sum(int(np.prod([s.stop - s.start for s in tile_slices(
        pl, t.shape, {"data": 0}, sizes)])) for t, pl in zip(leaves(tshapes), leaves(place)))
    jelems = sum(x.size // int(np.prod([4 if e else 1 for e in _placement(s, len(x.shape))]))
                 for s, x in zip(jax.tree.leaves(param_specs(jshapes, rules),
                                                 is_leaf=lambda s: isinstance(s, P)),
                                 jax.tree.leaves(jshapes)))
    assert elems == jelems == 416_360_448
    assert tepso.state_bytes_per_device(tshapes, placements(tc, tshapes, sizes), sizes,
                                        "so") == 3_137_107_968


def _view(dp, rank):
    """Rank ``rank``'s view of a ('data', dp) grid without process groups
    (what the layout functions read)."""
    from repro_torch.parallel import ProcessGrid
    from repro_torch.parallel.ep import EPGroup
    dev = torch.device("cpu")
    return ProcessGrid(EPGroup(None, rank, dp, dev, "gloo"), EPGroup(None, rank, dp, dev, "gloo"),
                       EPGroup(None, 0, 1, dev, "gloo"))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_state_cuts_the_fsdp_tiles(arch):
    """``init_state(fsdp=True)`` on each rank of ('data', DP): the tiles of
    the one-process state's params (``tile_slices`` of the fsdp
    placements), the float32 params sharing the master's storage, zero moments
    of the tiles' shapes; ``params_for_rank(fsdp=True)`` cuts the same."""
    from repro_torch.convert import params_for_rank
    _, tc = _step_cfgs(arch)
    train = TrainConfig(**F32)
    tree = init_state(tc, train, seed=0, device="cpu").params
    whole = dict(leaves_with_path(tree))
    sizes = {"data": DP}
    place = dict(leaves_with_path(placements(tc, init_params(tc, device="meta"), sizes,
                                             fsdp=True)))
    for rank in range(DP):
        st = init_state(tc, train, seed=0, grid=_view(DP, rank), fsdp=True)
        cut = dict(leaves_with_path(params_for_rank(tree, tc, dp=DP, ep=1, rank=rank,
                                                    fsdp=True)))
        for (path, p), ma, m, v in zip(leaves_with_path(st.params), leaves(st.opt.master),
                                       leaves(st.opt.m), leaves(st.opt.v)):
            want = whole[path][tile_slices(place[path], whole[path].shape, {"data": rank},
                                           sizes)]
            assert torch.equal(p, want) and torch.equal(cut[path], want), path
            assert p.data_ptr() == ma.data_ptr() and ma.shape == p.shape, path
            assert not m.any() and not v.any() and m.shape == v.shape == p.shape, path
        assert sum(p.numel() for p in leaves(st.params)) < sum(
            t.numel() for t in whole.values())


# ----------------------------------------------------------------------------
# the step on 2 gloo ranks
# ----------------------------------------------------------------------------

def _step_cfgs(arch):
    jc = jreduced(jget(arch), d_model=64, vocab=128)
    tc = treduced(tget(arch), d_model=64, vocab=128)
    if jc.moe is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, dispatch="dropless"))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, dispatch="dropless"))
    return jc, tc


@pytest.fixture(scope="module")
def fsdp_runs():
    """Every case of the step on one spawn of DP ranks (in a thread), and
    beside it the JAX single-device oracles: per (arch, microbatches) the
    JAX state after STEPS steps with DP x microbatches microbatches and its
    metrics."""
    tkw = dict(seq_len=16, global_batch=4, warmup_steps=1, total_steps=10, lr_peak=1e-2,
               lr_min=1e-3)
    jtrain = JTrain(**tkw, **F32)
    trains = {"f32": TrainConfig(**tkw, **F32), "bf16": TrainConfig(**tkw, **BF16)}
    batches = _batches(STEPS)
    cfgs, jstates, params, opts = {}, {}, {}, {}
    for arch in ARCHS:
        jc, tc = _step_cfgs(arch)
        cfgs[arch] = (jc, tc)
        jstates[arch] = jinit_state(jax.random.PRNGKey(0), jc, jtrain)
        params[arch] = params_from_jax(_np(jstates[arch].params), tc, device="cpu")
        opts[arch] = opt_state_from_jax(_np(jstates[arch].opt), device="cpu")
    cases = [c + (True, "f32") for c in CASES] + [
        (a, n, "block", False, "f32") for a in ARCHS for n in (1, 2)] + [
        (a, 1, "block", f, "bf16") for a in ARCHS for f in (True, False)]
    args = ({a: cfgs[a][1] for a in ARCHS}, params, opts, trains,
            [{k: torch.from_numpy(v).long() for k, v in b.items()} for b in batches], cases)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn, ranks.fsdp_cases_rank, DP, args=args, device="cpu",
                          timeout_s=TIMEOUT_S, grid=(DP, 1))
        oracle = {}
        with use_kernel_plan(KernelPlan()):
            for arch in ARCHS:
                for nmb in (1, 2):
                    # no remat in the oracle: it changes what JAX recomputes,
                    # not the math, and compiles in about half the time
                    jstep = jax.jit(jmake_train_step(
                        cfgs[arch][0], JParallel(microbatches=DP * nmb, remat_policy="none"),
                        jtrain))
                    js, jms = jstates[arch], []
                    for b in batches:
                        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
                        jms.append(jm)
                    oracle[arch, nmb] = (js, jms)
        res = fut.result()
    return {"cfgs": cfgs, "oracle": oracle, "ranks": res}


@pytest.mark.parametrize("arch,nmb,sac", CASES)
def test_fsdp_step_matches_jax(fsdp_runs, arch, nmb, sac):
    """Every rank's metrics and param tiles, and the master, m and v put
    back together from the ranks' tiles, against the JAX step with DP x
    nmb microbatches at atol = rtol = 1e-4; each rank holds only its 'data'
    tiles of every split leaf, its float32 params are its master's
    tensors, and its state bytes are ``state_bytes_per_device``'s."""
    jstate, jms = fsdp_runs["oracle"][arch, nmb]
    tc = fsdp_runs["cfgs"][arch][1]
    sizes = {"data": DP}
    place = dict(leaves_with_path(placements(tc, init_params(tc, device="meta"), sizes,
                                             fsdp=True)))
    assert sum(any(pl) for pl in place.values()) >= 7
    jp = _jleaves(jstate.params)
    runs = [r[arch, nmb, sac, True, "f32"] for r in fsdp_runs["ranks"]]
    for rank, run in enumerate(runs):
        for i, jm in enumerate(jms):
            for k in ranks.KEYS:
                if k in jm:
                    np.testing.assert_allclose(run["metrics"][i][k].numpy(), np.asarray(jm[k]),
                                               **TOL, err_msg=f"rank {rank} step {i} {k}")
        assert run["state_bytes"] == run["state_bytes_expected"]
        assert run["shares_master"]
        coords = rank_coords(rank, {"data": DP, "ep": 1})
        for path, leaf in run["params"].items():
            sl = tile_slices(place[path], jp[path].shape, coords, sizes)
            assert tuple(leaf.shape) == jp[path][sl].shape, path
            if any(place[path]):
                assert leaf.numel() * DP == jp[path].size, path
            np.testing.assert_allclose(leaf.numpy(), jp[path][sl], **TOL,
                                       err_msg=f"rank {rank} params {path}")
    full = opt_state_from_ranks([r["opt"] for r in runs], tc, dp=DP, ep=1, mode="none",
                                fsdp=True)
    assert full["step"] == STEPS
    for what in ("master", "m", "v"):
        for path, ref in _jleaves(getattr(jstate.opt, what)).items():
            np.testing.assert_allclose(full[what][path], ref, **TOL, err_msg=f"{what} {path}")


@pytest.mark.parametrize("arch,nmb,sac", CASES)
def test_fsdp_step_matches_the_unsharded_step(fsdp_runs, arch, nmb, sac):
    """Against the port's dp = 2 'none' step without fsdp ('block', same
    microbatches): step 0's loss bit for bit (the gathered weights are the
    whole ones' bits), later losses and every grad norm within
    SAME_STEP_RTOL, the same metrics on both ranks."""
    for r in fsdp_runs["ranks"]:
        got = r[arch, nmb, sac, True, "f32"]["metrics"]
        ref = r[arch, nmb, "block", False, "f32"]["metrics"]
        assert torch.equal(got[0]["loss"], ref[0]["loss"])
        for g, f in zip(got, ref):
            for k in ("loss", "grad_norm", "ce"):
                np.testing.assert_allclose(g[k].numpy(), f[k].numpy(), rtol=SAME_STEP_RTOL,
                                           atol=0, err_msg=k)
        for g, f in zip(got, fsdp_runs["ranks"][0][arch, nmb, sac, True, "f32"]["metrics"]):
            assert all(torch.equal(g[k], f[k]) for k in g)


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_bf16_gather_matches_the_unsharded_step(fsdp_runs, arch):
    """The paper's recipe (bf16 compute, bf16 gradient reduction): the
    layers are gathered in bf16, the bits each layer casts its f32 weights
    to, so steps 0 and 1 (the first update has lr 0) give the losses of
    the step without fsdp bit for bit, and step 2 within BF16_RTOL (the
    grad norm, and so the clip scale, associates its sums otherwise); the
    gather moves half the bytes of a float32 one."""
    tc = fsdp_runs["cfgs"][arch][1]
    shapes = init_params(tc, device="meta")
    place = placements(tc, shapes, {"data": DP}, fsdp=True)
    layer = sum(t.numel() // tc.num_layers * 2 for t, pl in zip(leaves(shapes["layers"]),
                                                               leaves(place["layers"]))
                if any(pl))
    for r in fsdp_runs["ranks"]:
        got = r[arch, 1, "block", True, "bf16"]
        ref = r[arch, 1, "block", False, "bf16"]["metrics"]
        for i in (0, 1):
            assert torch.equal(got["metrics"][i]["loss"], ref[i]["loss"]), i
        np.testing.assert_allclose(got["metrics"][2]["loss"].numpy(), ref[2]["loss"].numpy(),
                                   rtol=BF16_RTOL, atol=0)
        assert got["stats"]["gathered_bytes"] == 2 * tc.num_layers * STEPS * layer


@pytest.mark.parametrize("arch,nmb,sac", CASES)
def test_fsdp_collective_counts_are_exact(fsdp_runs, arch, nmb, sac):
    """The all-gathers and reduce-scatters of STEPS steps (the
    ``torch.distributed`` calls): a gather for each layer and microbatch in
    the forward and again in the backward's recompute (also under
    'block_sc': the tape does not replay it), a reduce-scatter for each in
    the backward, and an all-gather a step of each expert stack's grad-norm
    slice sums (added over 'data' in rank order); the gather's own counts
    agree, and its bytes are the whole layers'. Without fsdp a dp step
    calls neither."""
    tc = fsdp_runs["cfgs"][arch][1]
    n = tc.num_layers * nmb * STEPS
    shapes = init_params(tc, device="meta")
    place = placements(tc, shapes, {"data": DP}, fsdp=True)
    layer = sum(t.numel() // tc.num_layers * 4 for t, pl in zip(leaves(shapes["layers"]),
                                                               leaves(place["layers"]))
                if any(pl))
    # the grad norm's slice sums of each expert stack, over 'data' in rank order
    stacks = sum(is_expert_stack_path(path) for path, pl in leaves_with_path(place)
                 if any(pl)) * STEPS
    for r in fsdp_runs["ranks"]:
        run = r[arch, nmb, sac, True, "f32"]
        calls = run["calls"]
        assert (calls.get("all_gather", 0), calls.get("reduce_scatter", 0)) == (
            2 * n + stacks, n), calls
        assert run["stats"] == {"all_gather": 2 * n, "reduce_scatter": n,
                                "gathered_bytes": 2 * n * layer}
        ref = r[arch, nmb, "block", False, "f32"]["calls"]
        assert "all_gather" not in ref and "reduce_scatter" not in ref, ref


@pytest.mark.parametrize("sac", ["block", "block_sc"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_keeps_no_gathered_weight(fsdp_runs, arch, sac):
    """Between ``loss_fn``'s forward and its backward no storage that a
    gather made (the flat buffer or a whole leaf) is alive, and autograd
    packed no tensor of a gathered leaf's whole per-layer shape; the
    forward gathers each layer once, the backward once more (the
    recompute) and reduce-scatters each once."""
    tc = fsdp_runs["cfgs"][arch][1]
    shapes = init_params(tc, device="meta")
    place = placements(tc, shapes, {"data": DP}, fsdp=True)
    split = [tuple(t.shape[1:]) for t, pl in zip(leaves(shapes["layers"]),
                                                  leaves(place["layers"])) if any(pl)]
    whole = set(split)
    L = tc.num_layers
    for r in fsdp_runs["ranks"]:
        mem = r["memory", arch, sac]
        assert mem["gathered"] == L * (1 + len(split))      # a flat buffer and its leaves
        assert mem["alive"] == 0, mem
        assert not whole & set(mem["packed"]), whole & set(mem["packed"])
        assert mem["forward"]["all_gather"] == L and mem["forward"]["reduce_scatter"] == 0
        assert mem["after_backward"]["all_gather"] == 2 * L
        assert mem["after_backward"]["reduce_scatter"] == L


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_tiles_take_no_second_sum(fsdp_runs, arch):
    """``train_step.update`` on gradients of rank + 1: the whole leaves'
    are summed over 'data' (1 + 2), the fsdp tiles' stay each rank's own
    (their sum over 'data' was the gather's reduce-scatter), and both ranks
    report the grad norm of that tree, each tile counted once."""
    tc = fsdp_runs["cfgs"][arch][1]
    shapes = init_params(tc, device="meta")
    place = dict(leaves_with_path(placements(tc, shapes, {"data": DP}, fsdp=True)))
    sq = 0.0
    for rank, r in enumerate(fsdp_runs["ranks"]):
        up = r["update", arch]
        for path, vals in up["grads"].items():
            want = rank + 1.0 if any(place[path]) else 3.0
            assert vals.tolist() == [want], (rank, path, vals)
    for path, t in leaves_with_path(shapes):
        n = t.numel()
        sq += (n // DP) * (1.0 + 4.0) if any(place[path]) else n * 9.0
    for r in fsdp_runs["ranks"]:
        np.testing.assert_allclose(float(r["update", arch]["grad_norm"]),
                                   np.sqrt(sq), rtol=1e-6)


# ----------------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("kw,placed,arch", [
    (dict(remat_policy="none"), False, "mula-7b-a1b"),
    (dict(remat_policy="attn,moe"), False, "mula-7b-a1b"), (dict(), True, "mula-7b-a1b"),
    (dict(), False, "falcon-mamba-7b")],
    ids=["remat-none", "remat-attn-moe", "placement", "ssm"])
def test_fsdp_step_refuses_what_it_does_not_run(kw, placed, arch):
    """The step refuses fsdp under a remat policy without 'block' or
    'block_sc' (autograd would keep every layer's gathered weights), naming
    ROADMAP.md §1 item 5.1e. It builds with an expert placement and for a
    state-space arch (refused until fsdp took them: their steps run in
    tests/test_torch_fsdp_placed.py and tests/test_torch_fsdp_ssm.py), and
    ``init_state(fsdp=True)`` of a hybrid and an ssm model gives each rank
    its 'data' tiles of the SSM mixers and of the shared block."""
    from repro_torch.parallel.placement import ExpertPlacement
    tc = _step_cfgs(arch)[1] if arch != "falcon-mamba-7b" else treduced(
        tget(arch), d_model=64, vocab=128)
    train = TrainConfig(**F32)
    placement = None
    if placed:
        L, E = tc.num_layers, tc.moe.num_experts
        placement = ExpertPlacement(L, E, tuple(tuple(reversed(range(E))) for _ in range(L)))
    par = ParallelConfig(fsdp_params=True, **kw)
    if kw:
        with pytest.raises(NotImplementedError, match=ITEM):
            make_train_step(tc, par, train, placement=placement)
        return
    assert callable(make_train_step(tc, par, train, placement=placement))
    if placed:
        return
    hybrid = dataclasses.replace(treduced(tget("zamba2-7b"), d_model=64, vocab=128, layers=5),
                                 shared_attn_every=2)
    for cfg in (hybrid, tc):
        whole = dict(leaves_with_path(init_state(cfg, train, seed=0, device="cpu").params))
        place = dict(leaves_with_path(placements(cfg, init_params(cfg, device="meta"),
                                                 {"data": DP}, fsdp=True)))
        tiled = {p.split("/")[0] for p, pl in place.items() if any(pl)}
        assert tiled == ({"groups", "rem", "shared"} if cfg is hybrid else {"layers"}), tiled
        for rank in range(DP):
            st = init_state(cfg, train, seed=0, grid=_view(DP, rank), fsdp=True)
            for path, p in leaves_with_path(st.params):
                want = whole[path][tile_slices(place[path], whole[path].shape, {"data": rank},
                                               {"data": DP})]
                assert torch.equal(p, want), path


def test_grid_checkpointer_takes_fsdp_layouts(tmp_path):
    """A grid ``Checkpointer`` takes an fsdp layout on a grid with 'tp' and
    on one with 'pp' (it refused both before fsdp took those axes; their
    round trips: tests/test_torch_fsdp_grid.py), as on ('data', DP): the
    layout's params carry their 'data' tiles beside the 'tp' shards or the
    stages."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.parallel import ProcessGrid
    from repro_torch.parallel.ep import EPGroup
    _, tc = _step_cfgs("mula-1b")
    dev = torch.device("cpu")

    def view(n):
        return EPGroup(None, 0, n, dev, "gloo")

    for name, grid in (("tp", ProcessGrid(view(2 * DP), view(DP), view(1), tp=view(2))),
                       ("pp", ProcessGrid(view(2 * DP), view(DP), view(1), pp=view(2))),
                       ("data", ProcessGrid(view(DP), view(DP), view(1)))):
        layout = state_layout(tc, grid.axis_sizes, "none", fsdp=True)
        Checkpointer(str(tmp_path / name), grid=grid, layout=layout)
        axes = {a for key, (_, place) in layout.items() if key.startswith(".params")
                for e in place for a in e}
        assert axes == set(grid.axis_sizes), name
