"""PyTorch port, FSDP (ZeRO-3) with an expert placement and live EP
rebalancing: the fsdp step on ('data', 'ep') and ('data', 'ep', 'tp')
grids with its expert stacks in placed order, ``apply_placement`` on the
fsdp state, the placed fsdp checkpoint and the launcher's ``--parallel
dp=2,ep=2,fsdp,rebalance=...`` with ``--rebalance-force-at``.

* Layout: full-size Mula-7B-A1B on (dp=2, ep=2) and (dp=2, ep=2, tp=2)
  with fsdp, meta tensors: the param placements leaf by leaf the JAX fsdp
  ``param_specs`` but the tables' (tests/test_torch_fsdp_grid.py), and in
  every optimizer mode an expert stack's state keeps its expert dim on
  'ep' alone, the dim ``apply_placement`` moves slices along.
* Steps: one spawn of 4 gloo ranks on dp = 2 x ep = 2 (reduced Mula-7B-A1B
  at 4 layers with 8 experts, top 4, dropless, the router terms on, in
  'none', 'so', 'epso' 'ring' and 'xla' under 'block', and 'epso' 'ring'
  under 'block_sc'; reduced Mula-7B-A1B at 2 layers with 4 experts, top 2,
  in 'epso' 'ring') and, beside it, one of 8 ranks on dp = 2 x ep = 2 x tp
  = 2 ('epso' 'ring'), 2 steps without warmup (step 0 on the initial
  params, step 1 after an update) with clipping on, every rank's experts
  half moved to the other EP rank (``torch_ep_ranks.fsdp_placed_cases_rank``).
  Each case is held to:
  - the placed step without fsdp from the same moved state: step 0's loss
    bit for bit, the later losses, ce and grad norms within 1e-5 relative;
  - the fsdp step without a placement, with a live move after step 0
    (``apply_placement``, then the placed step): bit for bit at top 2 (the
    metrics and the whole final state against the unplaced run's moved),
    within 1e-5 at top 4, where the EP combine's sum over ranks
    reassociates;
  - every (layer, expert) tile of params, master, m and v that the move
    wrote equal to the tile its global id held before, exactly, and the
    bytes sent the tiles' over 'ep';
  - the gathers and reduce-scatters over 'data', exactly.
* Checkpoint: the moved 'epso' state of dp = 2 x ep = 2 saved with its
  placement restores on the grid bit for bit with the placement, in one
  process as whole arrays in placed order, and through the JAX package's
  ``Checkpointer.restore`` with its ``restored_placement``.
* Launcher: ``--parallel dp=2,ep=2,fsdp,rebalance=2:1.0 --opt-shard epso
  --rebalance-force-at 3`` on reduced Mula-7B-A1B moves before step 9 with
  losses and grad norms bit for bit the unbalanced fsdp run's, and again
  with a hard failure after the step-5 checkpoint, bit-identically; the
  last MANIFESTs carry the fsdp layout and the same placement.
"""
import dataclasses
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.data import ByteTokenizer  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.parallel import placement as jpl  # noqa: E402
from repro.parallel.sharding import param_specs  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.parallel import ParallelPlan, spawn  # noqa: E402
from repro_torch.parallel.placement import ExpertPlacement  # noqa: E402
from repro_torch.parallel.sharding import tile_slices  # noqa: E402
from repro_torch.train import init_state, state_layout  # noqa: E402
from repro_torch.train.trainer import placements  # noqa: E402
from repro_torch.tree import keyed_leaves, leaves, leaves_with_path  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402
from test_torch_epso import F32, _placements  # noqa: E402
from test_torch_fsdp_grid import _plan_rules, _sizes, _update_data_calls  # noqa: E402

EP_GRID, TP_GRID = (2, 1, 2, 1), (2, 1, 2, 2)
STEPS, BATCH, SEQ = 2, 8, 16
# every rank's experts split across both EP ranks, each layer its own row
ROWS = {"top4": ((4, 0, 5, 1, 2, 6, 3, 7), (0, 6, 1, 7, 4, 2, 5, 3), (5, 4, 1, 0, 3, 2, 7, 6),
                 (2, 7, 3, 6, 0, 5, 1, 4)),
        "top2": ((2, 0, 3, 1), (1, 3, 0, 2))}
MODES = (("none", "off"), ("so", "off"), ("epso", "ring"), ("epso", "xla"))
# a case: (config, (dp, pp, ep, tp), mode, overlap, remat policy)
CASES4 = [("top4", EP_GRID, m, o, "block") for m, o in MODES] + [
    ("top4", EP_GRID, "epso", "ring", "block_sc"), ("top2", EP_GRID, "epso", "ring", "block")]
CASES8 = [("top4", TP_GRID, "epso", "ring", "block")]
CKPT_CASE, CKPT_SPEC = CASES4[2], "dp=2,ep=2,opt=epso,fsdp"
# the fsdp step against the placed step without fsdp after step 0, and at
# top 4 against the unplaced fsdp step (the EP combine reassociates)
SAME_STEP_RTOL = 1e-5
STATE_ATOL = 1e-5
TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models run faster on one torch thread; the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(case):
    name, (dp, pp, ep, tp), mode, overlap, sac = case
    return f"{name}-dp{dp}ep{ep}tp{tp}-{mode}-{overlap}-{sac}"


def _cfgs():
    """The two reduced Mula-7B-A1B configs, dropless: 'top4' (4 layers, 8
    experts, top 4) and 'top2' (2 layers, 4 experts, top 2)."""
    out = {}
    for name, kw in (("top4", dict(layers=4, max_experts=8)), ("top2", {})):
        tc = treduced(tget("mula-7b-a1b"), d_model=64, vocab=128, **kw)
        out[name] = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, dispatch="dropless"))
    assert [out[n].moe.experts_per_token for n in ("top4", "top2")] == [4, 2]
    assert (out["top4"].moe.router_aux_coef, out["top4"].moe.router_z_coef) == (0.01, 0.001)
    return out


# ----------------------------------------------------------------------------
# layout
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [EP_GRID, TP_GRID], ids=["dp2ep2", "dp2ep2tp2"])
def test_fsdp_placed_layout_matches_jax(shape):
    """Full-size Mula-7B-A1B: the fsdp param placements the JAX fsdp
    ``param_specs`` leaf by leaf, the tables' too; an expert stack's 'data'
    tile on a per-slice dim, and in 'none', 'so' and 'epso' its state's
    expert dim on ('ep',) alone, so that a placement moves whole (layer,
    expert) tiles over 'ep' and leaves their 'data' cut alone."""
    jc, tc = jget("mula-7b-a1b"), tget("mula-7b-a1b")
    shapes = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jc))
    sizes = _sizes(shape)
    got = placements(tc, init_params(tc, device="meta"), sizes, fsdp=True)
    want = leaves(_placements(param_specs(shapes, _plan_rules(jc, shape)), shapes))
    for (path, g), w in zip(leaves_with_path(got), want):
        assert g == w, (path, g, w)
    for mode in ("none", "so", "epso"):
        layout = state_layout(tc, sizes, mode, fsdp=True)
        stacks = [(k, pl) for k, (_, pl) in layout.items() if k.endswith(
            ("['moe']['gate']", "['moe']['up']", "['moe']['down']"))]
        assert len(stacks) == 5 * 3
        for key, pl in stacks:
            assert pl[1] == ("ep",) and any("data" in e for e in pl[2:]), (mode, key, pl)


# ----------------------------------------------------------------------------
# the placed steps on 4 and 8 gloo ranks, and the checkpoint
# ----------------------------------------------------------------------------

def _batches():
    out = []
    for i in range(STEPS):
        t = np.random.default_rng(70 + i).integers(0, 128, (BATCH, SEQ + 1))
        out.append({"tokens": torch.from_numpy(t[:, :-1]).long(),
                    "labels": torch.from_numpy(t[:, 1:]).long()})
    return out


@pytest.fixture(scope="module")
def placed_runs(tmp_path_factory):
    """Every case on its spawn (4 and 8 ranks, side by side in threads)."""
    tcs = _cfgs()
    train = TrainConfig(seq_len=SEQ, global_batch=BATCH, warmup_steps=0, total_steps=10,
                        lr_peak=1e-2, lr_min=1e-3, grad_clip=0.05, **F32)
    root = str(tmp_path_factory.mktemp("fsdp_placed") / "ckpt")
    tb = _batches()
    with ThreadPoolExecutor(2) as pool:
        fut4 = pool.submit(spawn, ranks.fsdp_placed_cases_rank, 4, device="cpu",
                           timeout_s=TIMEOUT_S,
                           args=(tcs, train, tb, ROWS, CASES4, (CKPT_CASE, CKPT_SPEC, root)))
        fut8 = pool.submit(spawn, ranks.fsdp_placed_cases_rank, 8, device="cpu",
                           timeout_s=TIMEOUT_S, args=(tcs, train, tb, ROWS, CASES8))
        res4, res8 = fut4.result(), fut8.result()
    return {"cfgs": tcs, "ranks4": res4, "ranks8": res8, "root": root}


def _runs(placed_runs, case):
    return [r[case] for r in placed_runs["ranks8" if case in CASES8 else "ranks4"]]


def _close(got, want, rtol):
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in ("loss", "grad_norm", "ce", "clip_scale"):
            np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), rtol=rtol, atol=0,
                                       err_msg=f"step {i} {k}")


@pytest.mark.parametrize("case", CASES4 + CASES8, ids=_ids)
def test_fsdp_placed_step_matches_the_placed_step_without_fsdp(placed_runs, case):
    """From the same state moved to the placement: step 0's loss bit for
    bit (the gathered tiles are the whole placed stacks' bits), the later
    losses, ce, grad norms and clip scales within SAME_STEP_RTOL; rank 0's
    metrics on every rank; clipping on."""
    runs = _runs(placed_runs, case)
    for r in runs:
        got, ref = r["placed"], r["twin"]
        assert torch.equal(got[0]["loss"], ref[0]["loss"])
        _close(got, ref, SAME_STEP_RTOL)
        for g, f in zip(got, runs[0]["placed"]):
            assert all(torch.equal(g[k], f[k]) for k in g)
        assert any(m["clip_scale"] < 1 for m in got)


def test_expert_slice_norm_is_the_same_at_every_position(placed_runs):
    """The grad norm's slice-sum total (``optim.adamw.reduce_slice_sums``)
    on a 4-rank 'tp' group whose ranks hold 1, 1e8, -1e8 and 3 at one
    (layer, expert) position of an (L, E) tensor: the same bits at two
    positions, the ranks' values added in rank order (3; a gloo all-reduce
    gave 0, 1 or 4 by the offset), so a move cannot change it."""
    for r in placed_runs["ranks4"]:
        a, b = r["norm_positions"]
        assert torch.equal(a, b) and a.item() == 3.0


@pytest.mark.parametrize("case", CASES4 + CASES8, ids=_ids)
def test_fsdp_placed_step_matches_the_unplaced_fsdp_step(placed_runs, case):
    """The fsdp step with a live move after step 0, and from the state moved
    before step 0, against the fsdp step without a placement: at top 2
    every metric bit for bit and the moved run's final state (params,
    master, m, v) the unplaced run's moved to the placement, bit for bit;
    at top 4 within SAME_STEP_RTOL and STATE_ATOL (the EP combine's sum over
    the ranks reassociates when the experts change ranks)."""
    top2 = case[0] == "top2"
    for r in _runs(placed_runs, case):
        for run in ("moved", "placed"):
            if top2:
                for s, (a, b) in enumerate(zip(r[run], r["unplaced"])):
                    assert sorted(a) == sorted(b)
                    for k in a:
                        assert torch.equal(a[k], b[k]), (run, s, k, a[k], b[k])
            else:
                assert torch.equal(r[run][0]["loss"], r["unplaced"][0]["loss"])
                _close(r[run], r["unplaced"], SAME_STEP_RTOL)
        if top2:
            assert r["state_differ"] == [], r["state_differ"]
        else:
            assert all(d <= STATE_ATOL for _, d in r["state_differ"]), r["state_differ"]


def _whole(runs, layout, sizes, what):
    """The whole arrays of the ranks' expert tiles ``what`` ('before' or
    'after' the move), by key; NaN where no rank held a value."""
    out = {}
    for r in runs:
        for key, t in r[what].items():
            shape, place = layout[key]
            full = out.setdefault(key, np.full(shape, np.nan, dtype=np.float32))
            full[tile_slices(place, shape, r["coords"], sizes)] = t.numpy()
    return out


@pytest.mark.parametrize("case", CASES4 + CASES8, ids=_ids)
def test_apply_placement_moves_fsdp_tiles_exactly(placed_runs, case):
    """``apply_placement`` on the fsdp state after one step: every (layer,
    position) tile of every expert stack of params, master, m and v after
    the move is, bit for bit, the tile its global id held before (the
    ranks' tiles put together), the moments nonzero; the state moved before
    step 0 holds the whole init params permuted; each rank sent its tiles'
    bytes over 'ep', each distinct tensor once."""
    name, shape, mode = case[0], case[1], case[2]
    tc = placed_runs["cfgs"][name]
    L, E = tc.num_layers, tc.moe.num_experts
    sizes = _sizes(shape)
    layout = state_layout(tc, sizes, mode, fsdp=True)
    runs = _runs(placed_runs, case)
    before, after = _whole(runs, layout, sizes, "before"), _whole(runs, layout, sizes, "after")
    rel = ExpertPlacement.identity(L, E).relative_to(ExpertPlacement(L, E, ROWS[name]))
    assert len(before) == 4 * 3
    for key, b in before.items():
        assert not np.isnan(b).any() and not np.isnan(after[key]).any(), key
        want = b[np.arange(L)[:, None], rel]
        np.testing.assert_array_equal(after[key], want, err_msg=key)
        assert not np.array_equal(after[key], b), key
        if ".opt.m" in key or ".opt.v" in key:
            assert np.abs(b).max() > 0, key
    for r in runs:
        assert r["tiles_differ"] == [], r["tiles_differ"]
        tile = sum(math.prod(s.stop - s.start for s in tile_slices(
            layout[k][1], layout[k][0], r["coords"], sizes)) for k in r["after"]
            if not (mode == "none" and k.startswith(".params")))
        assert r["sent"] == tile * 4 * (sizes["ep"] - 1), (r["sent"], tile)


@pytest.mark.parametrize("case", CASES4 + CASES8, ids=_ids)
def test_fsdp_placed_data_collectives_are_exact(placed_runs, case):
    """The unplaced fsdp run's gather stats (two all-gathers a layer and
    step, forward and recompute, also under 'block_sc', one reduce-scatter)
    and its all-gathers and reduce-scatters over the 'data' group, exactly:
    the gather's and the update's."""
    name, shape, mode, overlap = case[:4]
    tc = placed_runs["cfgs"][name]
    n = tc.num_layers * STEPS
    sizes = _sizes(shape)
    shapes = init_params(tc, device="meta")
    place = placements(tc, shapes, sizes, fsdp=True)
    layer = sum(t.numel() // tc.num_layers // math.prod(
        sizes[a] for e in pl for a in e if a != "data") * 4
        for t, pl in zip(leaves(shapes["layers"]), leaves(place["layers"]))
        if any("data" in e for e in pl))
    for r in _runs(placed_runs, case):
        assert r["stats"] == {"all_gather": 2 * n, "reduce_scatter": n,
                              "gathered_bytes": 2 * n * layer}, r["stats"]
        up = _update_data_calls(tc, shape, mode, overlap)
        assert r["data_calls"]["all_gather"] == 2 * n + STEPS * up["all_gather"], r["data_calls"]
        assert r["data_calls"]["reduce_scatter"] == n + STEPS * up["reduce_scatter"], \
            r["data_calls"]


def test_placed_fsdp_checkpoint_restores_on_the_grid(placed_runs):
    """The moved 'epso' state, saved by the grid ``Checkpointer`` with its
    placement, comes back on every rank bit for bit with
    ``restored_placement`` the placement; the MANIFEST carries the plan with
    fsdp and the placement in the JAX format."""
    tc = placed_runs["cfgs"][CKPT_CASE[0]]
    for r in _runs(placed_runs, CKPT_CASE):
        ck = r["ckpt"]
        assert ck["step"] == 5 and ck["placement"]
        assert sorted(ck["saved"]) == sorted(ck["restored"])
        for k, a in ck["saved"].items():
            assert torch.equal(a, ck["restored"][k]), k
    with open(os.path.join(placed_runs["root"], "ckpt-1", "MANIFEST.json")) as f:
        man = json.load(f)
    plan = ParallelPlan.parse(CKPT_SPEC).resolve(tc)
    assert man["plan"] == {"spec": plan.spec(), "layout": plan.layout_signature()}
    assert man["plan"]["layout"]["fsdp"]
    L, E = tc.num_layers, tc.moe.num_experts
    assert man["placement"] == ExpertPlacement(L, E, ROWS[CKPT_CASE[0]]).to_manifest()


def _saved_whole(placed_runs):
    """The saved state as whole arrays by key: the ranks' param tiles and
    optimizer shards put together by the state layout."""
    name, shape, mode = CKPT_CASE[:3]
    tc = placed_runs["cfgs"][name]
    sizes = _sizes(shape)
    layout = state_layout(tc, sizes, mode, fsdp=True)
    out = {}
    for r in _runs(placed_runs, CKPT_CASE):
        for key, t in r["ckpt"]["saved"].items():
            shape_, place = layout[key]
            if key == ".opt.step":
                out[key] = t.numpy()
                continue
            full = out.setdefault(key, np.full(shape_, np.nan, dtype=np.float32))
            full[tile_slices(place, shape_, r["coords"], sizes)] = t.numpy()
    return out


def test_placed_fsdp_checkpoint_restores_in_one_process(placed_runs):
    """The same files restored by a one-process port ``Checkpointer`` into
    a whole state of other values: every leaf the whole array, in placed
    order, that the ranks' tiles and shards put together; the placement
    restored."""
    name = CKPT_CASE[0]
    tc = placed_runs["cfgs"][name]
    tmpl = init_state(tc, TrainConfig(param_dtype="float32"), seed=3, device="cpu")
    ck = Checkpointer(placed_runs["root"])
    restored, step = ck.restore(tmpl)
    assert step == 5
    assert ck.restored_placement == ExpertPlacement(tc.num_layers, tc.moe.num_experts,
                                                    ROWS[name])
    want = _saved_whole(placed_runs)
    got = dict(keyed_leaves(restored))
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        assert not np.isnan(ref).any(), key
        np.testing.assert_array_equal(got[key].numpy(), ref, err_msg=key)


def test_placed_fsdp_checkpoint_restores_in_jax(placed_runs):
    """The same files restored by the JAX package's ``Checkpointer`` into a
    JAX TrainState of other values: every leaf bit for bit the gathered
    state, and its ``restored_placement`` the placement."""
    name = CKPT_CASE[0]
    jc = jreduced(jget("mula-7b-a1b"), d_model=64, vocab=128, layers=4, max_experts=8)
    tmpl = jinit_state(jax.random.PRNGKey(5), jc, JTrain(param_dtype="float32"))
    jck = JCheckpointer(placed_runs["root"])
    restored, step = jck.restore(tmpl)
    assert step == 5
    assert jck.restored_placement == jpl.ExpertPlacement(jc.num_layers, jc.moe.num_experts,
                                                         ROWS[name])
    want = _saved_whole(placed_runs)
    flat = jax.tree_util.tree_leaves_with_path(restored)
    assert len(flat) == len(want)
    for path, x in flat:
        key = jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(x), want[key], err_msg=key)


# ----------------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------------

KW = dict(steps=10, batch=4, seq=32, d_model=64, ckpt_interval=5, log_every=100,
          device="cpu", moe_dispatch="dropless", opt_shard="epso")
REBALANCE = dict(parallel="dp=2,ep=2,fsdp,rebalance=2:1.0", rebalance_force_at=3)


def _manifest(out):
    """The newest valid MANIFEST under ``out/ckpt``."""
    best = None
    for slot in ("ckpt-1", "ckpt-2"):
        path = os.path.join(out, "ckpt", slot, "MANIFEST.json")
        if os.path.exists(path):
            with open(path) as f:
                m = json.load(f)
            if m.get("valid") and (best is None or m["step"] > best["step"]):
                best = m
    return best


@pytest.fixture(scope="module")
def launcher_runs(tmp_path_factory):
    """The unbalanced fsdp run, the rebalancing one and the rebalancing one
    with a hard failure at step 7 (after the step-5 checkpoint, which the
    windows of 2 steps end at)."""
    root = tmp_path_factory.mktemp("fsdp_rebalance")
    out = {"root": root}
    out["static"] = tlaunch.run("mula-7b-a1b", out=str(root / "static"),
                                parallel="dp=2,ep=2,fsdp", **KW)
    out["clean"] = tlaunch.run("mula-7b-a1b", out=str(root / "clean"), **REBALANCE, **KW)
    out["faulty"] = tlaunch.run("mula-7b-a1b", out=str(root / "faulty"), inject_hard_at=7,
                                **REBALANCE, **KW)
    return out


def test_fsdp_launcher_rebalances_bit_identically(launcher_runs):
    """The rebalancing fsdp run moves before step 9 (a window of its
    policy, or the forced proposal after step 3) with losses, grad norms, lr, drops and
    load bit for bit the unbalanced fsdp run's (top 2, dropless); its
    summary and last MANIFEST name the fsdp plan and the placement."""
    static, clean = launcher_runs["static"], launcher_runs["clean"]
    keys = ("loss", "grad_norm", "lr", "moe_drops", "moe_load_max")
    assert [h["step"] for h in clean] == list(range(KW["steps"]))
    for a, b in zip(clean, static):
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}, a["step"]
    events = [h["step"] for h in clean if h.get("rebalanced")]
    assert events and events[0] < 9, events
    root = launcher_runs["root"]
    with open(root / "clean" / "summary.json") as f:
        summary = json.load(f)
    assert summary["rebalances"] == len(events) and summary["rebalance"] == "2:1.0"
    plan = ParallelPlan.parse(summary["parallel"])
    assert (plan.dp, plan.ep, plan.fsdp, summary["opt_shard"]) == (2, 2, True, "epso")
    man = _manifest(root / "clean")
    assert man["plan"]["layout"] == {"axes": [["data", 2], ["ep", 2]], "opt_shard": "epso",
                                     "fsdp": True}
    assert man.get("placement") is not None
    assert man["placement"]["perm"] != [list(range(4))] * 2
    assert np.isfinite([h["loss"] for h in clean]).all()


def test_fsdp_launcher_resumes_across_the_event_bit_identically(launcher_runs):
    """A hard failure at step 7 rolls back to the step-5 checkpoint (placed
    arrays and the MANIFEST's placement, restored on the fsdp layout): one
    relaunch, the history bit for bit the clean run's, events and
    imbalances included, and the same placement in both last MANIFESTs,
    which the JAX ``Checkpointer`` reads."""
    clean, faulty = launcher_runs["clean"], launcher_runs["faulty"]
    assert faulty.relaunches == 1
    assert list(faulty) == list(clean)
    root = launcher_runs["root"]
    man_c, man_f = _manifest(root / "clean"), _manifest(root / "faulty")
    assert man_c["step"] == man_f["step"] and man_c["placement"] == man_f["placement"]
    jc = jreduced(jget("mula-7b-a1b"), d_model=64, vocab=ByteTokenizer.VOCAB)
    jck = JCheckpointer(str(root / "faulty" / "ckpt"))
    template = jinit_state(jax.random.PRNGKey(0), jc, JTrain(param_dtype="float32"))
    assert jck.restore(template)[1] == man_f["step"]
    assert jck.restored_placement == jpl.ExpertPlacement.from_manifest(man_f["placement"])
