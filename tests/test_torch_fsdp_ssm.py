"""PyTorch port, FSDP (ZeRO-3) for the state-space archs against the JAX
package: fsdp for the ssm arch (falcon-mamba-7b, Mamba-1) on 'data' and
('data', 'pp') grids and for the hybrid arch (Zamba2-7B: Mamba-2 groups,
the shared attention+MLP block, the remaining layers) on 'data' grids, in
the step, SO/EPSO, the PP executor, the grid checkpoints and the launcher.

* Layout: ``train.placements(..., fsdp=True)`` leaf by leaf the JAX
  ``param_specs`` with ``ShardingRules(..., fsdp=True)`` (meta tensors,
  ``jax.eval_shape``): Zamba2-7B and falcon-mamba-7b on ('data', 2) and
  ('data', 4), full size and reduced (``groups/`` with its two stacked
  dims, ``rem/`` and ``shared/``), falcon-mamba-7b on ('data', 2) x ('pp',
  2); the state bytes a rank the JAX ``state_bytes_per_device``'s in
  'none', 'so' and 'epso'. Full-width Zamba2-7B at 7 layers on ('data', 4)
  and falcon-mamba-7b at 2 layers on ('data', 2) x ('pp', 2): the param
  elements and state bytes a rank (the H100 smoke's figures).
* Steps: reduced Zamba2-7B (5 layers, ``shared_attn_every=2``: 2 groups of
  2 and one remaining layer, the shared block applied twice) and
  falcon-mamba-7b (4 layers, d_model 64; its scan streams kept in float32
  on both sides, as tests/test_torch_mamba1.py's ``exact_streams``), 3
  steps from one state converted from JAX (a warmup step with lr 0 first:
  Adam's first step moves each weight by lr times the sign of its
  gradient, which the JAX step and the port's may part on at an element
  whose gradient is ~0), on a spawn of 2 gloo ranks
  (('data', 2)) and one of 4 (('data', 4), and ('data', 2) x ('pp', 2)
  for falcon-mamba under 1f1b and gpipe), side by side in threads:
  - on the 'data' grids in 'none', 'so' ('off') and 'epso' ('ring'),
    'block' remat, and one 'block_sc' case each:
    against the JAX single-device step with dp microbatches at atol = rtol
    = 1e-4 (losses, grad norms, the params' tiles, the gathered master, m
    and v);
  - under pp: against the port's one-process PP step
    (tests/test_torch_pp_train.py holds it to the JAX PP step) at 1e-4;
  - every case against the same grid without fsdp: step 0's loss bit for
    bit, the later losses, ce and grad norms within 1e-5 relative;
  - the gathers and reduce-scatters over 'data', exactly: two gathers and
    one reduce-scatter a layer and microbatch (three gathers under pp), and
    for the hybrid one gather and one reduce-scatter of the shared block a
    microbatch, whatever its applications;
  - ``train_step.update`` on gradients that tell the 'data' (and 'pp')
    coordinates apart: no fsdp tile, the shared block's included, takes a
    second sum over 'data', in both update paths.
* Checkpoints: an fsdp 'epso' state of Zamba2 on ('data', 2) and of
  falcon-mamba on ('data', 2) x ('pp', 2) restores on its grid bit for
  bit, in one process as whole arrays, and through the JAX package's
  ``Checkpointer.restore``.
* Launcher: ``--parallel dp=2,fsdp`` trains Zamba2 and falcon-mamba,
  checkpoints, and resumes with losses and grad norms bit-identical.
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

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.configs.base import ParallelConfig as JParallel  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import epso as jepso  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro.parallel.sharding import param_specs  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import (opt_state_from_jax, opt_state_from_ranks,  # noqa: E402
                                 params_from_jax)
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.optim import epso as tepso  # noqa: E402
from repro_torch.parallel import ParallelPlan, spawn  # noqa: E402
from repro_torch.parallel.grid import rank_coords  # noqa: E402
from repro_torch.parallel.sharding import tile_slices  # noqa: E402
from repro_torch.train import init_state  # noqa: E402
from repro_torch.train.trainer import placements  # noqa: E402
from repro_torch.tree import keyed_leaves, leaves, leaves_with_path  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402
from test_torch_epso import F32, TOL, _jleaves, _np, _placements  # noqa: E402
from test_torch_fsdp_grid import (AXES, _gathered_state, _plan_rules, _pp_oracle,  # noqa: E402
                                  _sizes, _summed_grads, _update_data_calls, _view)
from test_torch_mamba1 import _F32Streams  # noqa: E402

ARCHS = ("zamba2-7b", "falcon-mamba-7b")
DP2, DP4, PP_GRID = (2, 1, 1, 1), (4, 1, 1, 1), (2, 2, 1, 1)
STEPS, BATCH, SEQ = 3, 8, 16
PP_MB = 2
JPLAN = KernelPlan(backend="pallas", attn_impl="blockwise", interpret=True)
# a case: (config, (dp, pp, ep, tp), mode, overlap, schedule, microbatches,
# remat policy, fsdp), as tests/test_torch_fsdp_grid.py's
MODES = (("none", "off"), ("so", "off"), ("epso", "ring"))
CASES2 = [(a, DP2, m, o, None, 1, "block", True) for a in ARCHS for m, o in MODES] + [
    (a, DP2, "epso", "ring", None, 1, "block_sc", True) for a in ARCHS]
CASES4 = [(a, DP4, m, o, None, 1, "block", True) for a in ARCHS for m, o in MODES]
PP_CASES = [("falcon-mamba-7b", PP_GRID, "none", "off", s, PP_MB, "block", True)
            for s in ("1f1b", "gpipe")] + [
    ("falcon-mamba-7b", PP_GRID, "so", "off", "1f1b", PP_MB, "block", True)]
DATA_CASES = CASES2 + CASES4
ALL_CASES = DATA_CASES + PP_CASES


def _twin(case):
    return case[:6] + ("block", False)


TWINS2 = list(dict.fromkeys(_twin(c) for c in CASES2))
TWINS4 = list(dict.fromkeys(_twin(c) for c in CASES4 + PP_CASES))
# train_step.update of torch_ep_ranks.fsdp_grid_grad gradients: (config,
# grid, mode, overlap)
UPDATES2 = [("zamba2-7b", DP2, m, o) for m, o in MODES] + [
    ("falcon-mamba-7b", DP2, "none", "off")]
UPDATES4 = [("falcon-mamba-7b", PP_GRID, m, o) for m, o in (("none", "off"), ("so", "off"))]
CKPTS = {"dp=2,opt=epso,fsdp": "zamba2-7b", "dp=2,pp=2,opt=epso,fsdp": "falcon-mamba-7b"}
SAME_STEP_RTOL = 1e-5
TIMEOUT_S = 300
# full width: Zamba2-7B at 7 layers (one group of 6, the shared block, one
# remaining layer) on ('data', 4) and falcon-mamba-7b at 2 layers on ('data',
# 2) x ('pp', 2): param elements a rank with fsdp, and fp32 state bytes a rank
# under 'so', the same with fsdp and without (the H100 smoke's
# fsdp_hybrid_train and fsdp_ssm_pp_train hold their measured ones to these)
FULL = {"zamba2-7b": (7, DP4), "falcon-mamba-7b": (2, PP_GRID)}
FULL_PARAM_ELEMS = {"zamba2-7b": 417_325_104, "falcon-mamba-7b": 585_416_704}
FULL_SO_STATE_BYTES = {"zamba2-7b": 2_942_262_288, "falcon-mamba-7b": 3_827_957_760}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models run faster on one torch thread; the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(case):
    name, (dp, pp, ep, tp), mode, overlap, schedule, nmb, sac, fsdp = case
    return (f"{name}-dp{dp}pp{pp}-{mode}-{overlap}" + (f"-{schedule}" if pp > 1 else "")
            + f"-{sac}")


def _cfgs(arch, **kw):
    """(JAX config, port config), reduced: Zamba2 at 5 layers with
    ``shared_attn_every=2`` (``reduced`` keeps 2; set both fields),
    falcon-mamba at 4 layers; d_model 64, vocab 128 unless ``kw`` says."""
    kw = dict(dict(d_model=64, vocab=128, layers=5 if arch == "zamba2-7b" else 4), **kw)
    jc, tc = jreduced(jget(arch), **kw), treduced(tget(arch), **kw)
    if arch == "zamba2-7b":
        jc = dataclasses.replace(jc, shared_attn_every=2)
        tc = dataclasses.replace(tc, shared_attn_every=2)
    return jc, tc


def _place(tc, shape, fsdp=True):
    return dict(leaves_with_path(placements(tc, init_params(tc, device="meta"), _sizes(shape),
                                            fsdp=fsdp)))


# ----------------------------------------------------------------------------
# layout
# ----------------------------------------------------------------------------

LAYOUTS = [(a, s, size) for a in ARCHS for s in (DP2, DP4) for size in ("full", "reduced")] + [
    ("falcon-mamba-7b", PP_GRID, size) for size in ("full", "reduced")]


@pytest.mark.parametrize("arch,shape,size", LAYOUTS,
                         ids=[f"{a}-{'x'.join(map(str, s))}-{z}" for a, s, z in LAYOUTS])
def test_fsdp_ssm_layout_matches_jax(arch, shape, size):
    """The fsdp param placements leaf by leaf the JAX fsdp ``param_specs``:
    the SSM mixers' in_proj, out_proj, conv_w (and Mamba-1's x_proj and
    dt_proj) on 'data' on their largest per-layer dim that dp divides,
    under ``groups/`` past its two stacked dims; the shared block's
    attention and MLP; never a norm, a table or a stacked dim; 'pp' on
    ``layers/``' layer dim. The state bytes a rank in 'none', 'so' and
    'epso' the JAX ``state_bytes_per_device``'s."""
    jc, tc = (jget(arch), tget(arch)) if size == "full" else _cfgs(arch)
    shapes = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jc))
    rules, sizes = _plan_rules(jc, shape), _sizes(shape)
    meta = init_params(tc, device="meta")
    got = placements(tc, meta, sizes, fsdp=True)
    want = leaves(_placements(param_specs(shapes, rules), shapes))
    flat = leaves_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(
        shapes)[0]] == ["".join(f"['{k}']" for k in path.split("/")) for path, _ in flat]
    for (path, g), w in zip(flat, want):
        assert g == w, (path, g, w)
    split = {path for path, g in flat if any("data" in e for e in g)}
    parts = ("groups/", "rem/", "shared/") if arch == "zamba2-7b" else ("layers/",)
    for part in parts:
        assert any(p.startswith(part) for p in split), part
    assert not any("norm" in p or "ln" in p or "table" in p for p in split)
    lead = {"groups": 2, "layers": 1, "rem": 1, "shared": 0}
    for path, g in flat:
        assert not any("data" in e for e in g[:lead.get(path.split("/")[0], 0)]), path
    for mode in ("none", "so", "epso"):
        assert (tepso.state_bytes_per_device(meta, got, sizes, mode)
                == jepso.state_bytes_per_device(shapes, rules, mode)), mode


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "so"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_ssm_state_of_full_width_models(arch, fsdp):
    """Full-width Zamba2-7B at 7 layers on ('data', 4) and falcon-mamba-7b
    at 2 layers on ('data', 2) x ('pp', 2), meta tensors, every rank:
    ``init_state``'s param elements (with fsdp) and fp32 state bytes under
    'so', with and without fsdp (the smoke's reference runs), and
    ``state_bytes_per_device``'s."""
    layers, shape = FULL[arch]
    tc = dataclasses.replace(tget(arch), num_layers=layers)
    shapes = init_params(tc, device="meta")
    sizes = _sizes(shape)
    want = FULL_SO_STATE_BYTES[arch]
    assert tepso.state_bytes_per_device(shapes, placements(tc, shapes, sizes, fsdp=fsdp),
                                        sizes, "so") == want
    for rank in range(math.prod(shape)):
        st = init_state(tc, TrainConfig(), seed=0, device="meta", grid=_view(shape, rank),
                        opt_sharding_mode="so", fsdp=fsdp)
        if fsdp:
            assert sum(t.numel() for t in leaves(st.params)) == FULL_PARAM_ELEMS[arch]
        assert sum(t.numel() * 4 for tr in (st.opt.master, st.opt.m, st.opt.v)
                   for t in leaves(tr)) == want, rank


# ----------------------------------------------------------------------------
# the steps on 2 and 4 gloo ranks, their collectives and the checkpoints
# ----------------------------------------------------------------------------

def _batches(n):
    out = []
    for i in range(n):
        t = np.random.default_rng(80 + i).integers(0, 128, (BATCH, SEQ + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


@pytest.fixture(scope="module")
def ssm_runs(tmp_path_factory):
    """Every case and its twin without fsdp, the update checks and the two
    grid checkpoints on a spawn of 2 ranks and one of 4 (in threads); beside
    them the JAX single-device oracles of the 'data' cases (per model and
    dp the JAX state after STEPS steps with dp microbatches, and its
    metrics) and the one-process PP oracles of the pp cases, all with
    Mamba-1's streams in float32."""
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
    root = tmp_path_factory.mktemp("fsdp_ssm")
    roots = {spec: str(root / spec.replace(",", "_")) for spec in CKPTS}
    ck2 = [(CKPTS[s], s, roots[s]) for s in CKPTS if "pp" not in s]
    ck4 = [(CKPTS[s], s, roots[s]) for s in CKPTS if "pp" in s]
    with ThreadPoolExecutor(2) as pool, pytest.MonkeyPatch.context() as mp:
        fut2 = pool.submit(spawn, ranks.fsdp_ssm_cases_rank, 2, device="cpu",
                           timeout_s=TIMEOUT_S,
                           args=(tcs, params, opts, train, tb, CASES2 + TWINS2, UPDATES2, ck2))
        fut4 = pool.submit(spawn, ranks.fsdp_ssm_cases_rank, 4, device="cpu",
                           timeout_s=TIMEOUT_S,
                           args=(tcs, params, opts, train, tb, CASES4 + PP_CASES + TWINS4,
                                 UPDATES4, ck4))
        mp.setattr(jssm, "jnp", _F32Streams())
        mp.setattr(tssm, "STREAM_DTYPE", torch.float32)
        oracle = {}
        with use_kernel_plan(JPLAN):
            for arch in ARCHS:
                for dp in (2, 4):
                    jstep = jax.jit(jmake_train_step(cfgs[arch][0], JParallel(
                        microbatches=dp, remat_policy="none"), jtrain))
                    js, jms = jstates[arch], []
                    for b in batches:
                        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
                        jms.append(jm)
                    oracle[arch, dp] = (js, jms)
        pp_oracle = {c: _pp_oracle(tcs[c[0]], c, params[c[0]], tb, train) for c in PP_CASES}
        res2, res4 = fut2.result(), fut4.result()
    return {"cfgs": cfgs, "oracle": oracle, "pp_oracle": pp_oracle, "ranks2": res2,
            "ranks4": res4, "ckpts": roots}


def _runs(ssm_runs, case):
    return [r[case] for r in ssm_runs["ranks2" if case[1] == DP2 else "ranks4"]]


@pytest.mark.parametrize("case", DATA_CASES, ids=_ids)
def test_fsdp_ssm_step_matches_jax(ssm_runs, case):
    """On ('data', dp): every rank's metrics and param tiles, and the master,
    m and v put back together from the ranks' shards, against the JAX
    single-device step with dp microbatches at atol = rtol = 1e-4; each
    rank holds ``state_bytes_per_device`` bytes of state."""
    arch, shape, mode = case[0], case[1], case[2]
    jstate, jms = ssm_runs["oracle"][arch, shape[0]]
    tc = ssm_runs["cfgs"][arch][1]
    place = _place(tc, shape)
    jp = _jleaves(jstate.params)
    runs = _runs(ssm_runs, case)
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
    full = opt_state_from_ranks([r["opt"] for r in runs], tc, dp=shape[0], ep=1, mode=mode,
                                fsdp=True)
    assert full["step"] == STEPS
    for what in ("master", "m", "v"):
        for path, ref in _jleaves(getattr(jstate.opt, what)).items():
            np.testing.assert_allclose(full[what][path], ref, **TOL, err_msg=f"{what} {path}")


@pytest.mark.parametrize("case", PP_CASES, ids=_ids)
def test_fsdp_ssm_pp_step_matches_one_process_pp_step(ssm_runs, case):
    """falcon-mamba on (dp=2, pp=2): every rank's metrics equal the
    one-process PP step's at atol = rtol = 1e-4 and rank 0's exactly; its
    params after the last step its tiles ('data', 'pp') of the one-process
    step's; its state bytes ``state_bytes_per_device``'s; the saved-input
    peaks and the bytes handed to the neighbour stage as without fsdp."""
    tc = ssm_runs["cfgs"][case[0]][1]
    shape, schedule, n_mb = case[1], case[4], case[5]
    want_m, want_p = ssm_runs["pp_oracle"][case]
    place = _place(tc, shape)
    runs = _runs(ssm_runs, case)
    dp, pp = shape[0], shape[1]
    for r in runs:
        for i, (got, want) in enumerate(zip(r["metrics"], want_m)):
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
        act = BATCH // dp // n_mb * SEQ * tc.d_model * 4
        assert r["sent_bytes"] == n_mb * act * ((stage < pp - 1) + (stage > 0))


@pytest.mark.parametrize("case", ALL_CASES, ids=_ids)
def test_fsdp_ssm_step_matches_the_unsharded_step(ssm_runs, case):
    """Against the port's step on the same grid in the same mode without
    fsdp ('block'): step 0's loss bit for bit (the gathered weights are the
    whole ones' bits), the later losses, ce and grad norms within
    SAME_STEP_RTOL; rank 0's metrics on every rank; fewer param elements a
    rank."""
    for got, ref in zip(_runs(ssm_runs, case), _runs(ssm_runs, _twin(case))):
        assert torch.equal(got["metrics"][0]["loss"], ref["metrics"][0]["loss"])
        for g, f in zip(got["metrics"], ref["metrics"]):
            for k in ("loss", "grad_norm", "ce"):
                np.testing.assert_allclose(g[k].numpy(), f[k].numpy(), rtol=SAME_STEP_RTOL,
                                           atol=0, err_msg=k)
        for g, f in zip(got["metrics"], _runs(ssm_runs, case)[0]["metrics"]):
            assert all(torch.equal(g[k], f[k]) for k in g)
        assert got["param_elems"] < ref["param_elems"]


def _part_bytes(tc, shape, part):
    """The f32 bytes one gather of a layer of the stacked subtree ``part``
    (or of the shared block) assembles on a rank: its fsdp-split leaves
    whole over 'data'."""
    shapes = init_params(tc, device="meta")
    place = placements(tc, shapes, _sizes(shape), fsdp=True)
    lead = {"layers": 1, "rem": 1, "groups": 2, "shared": 0}[part]
    per = math.prod(leaves(shapes[part])[0].shape[:lead])
    return sum(t.numel() // per * 4 for t, pl in zip(leaves(shapes[part]), leaves(place[part]))
               if any("data" in e for e in pl))


@pytest.mark.parametrize("case", ALL_CASES, ids=_ids)
def test_fsdp_ssm_data_collectives_are_exact(ssm_runs, case):
    """The gather's ``stats`` and the all-gathers and reduce-scatters over
    the 'data' group of the steps, exactly: an SSM layer of the rank's
    stage gathered twice a microbatch (forward, recompute; also under
    'block_sc'), three times under pp, and reduce-scattered once; the
    hybrid's shared block gathered once a microbatch, whatever its
    applications, and reduce-scattered once; the update's collectives over
    'data' alone (tests/test_torch_fsdp_grid.py's count)."""
    name, shape, mode, _, _, n_mb, _, _ = case
    tc = ssm_runs["cfgs"][name][1]
    pp = shape[1]
    k = 3 if pp > 1 else 2
    if name == "zamba2-7b":
        layers = tc.num_layers
        gathers = STEPS * (k * layers + 1)
        scatters = STEPS * (layers + 1)
        nbytes = STEPS * (k * 4 * _part_bytes(tc, shape, "groups")
                          + k * _part_bytes(tc, shape, "rem") + _part_bytes(tc, shape, "shared"))
    else:
        n = tc.num_layers // pp * n_mb * STEPS
        gathers, scatters = k * n, n
        nbytes = k * n * _part_bytes(tc, shape, "layers")
    for r in _runs(ssm_runs, case):
        assert r["stats"] == {"all_gather": gathers, "reduce_scatter": scatters,
                              "gathered_bytes": nbytes}, r["stats"]
        up = _update_data_calls(tc, shape, mode, r["impl"])
        assert r["data_calls"]["all_gather"] == gathers + STEPS * up["all_gather"], \
            r["data_calls"]
        assert r["data_calls"]["reduce_scatter"] == scatters + STEPS * up["reduce_scatter"], \
            r["data_calls"]


@pytest.mark.parametrize("update", UPDATES2 + UPDATES4,
                         ids=[f"{n}-{'x'.join(map(str, s))}-{m}-{o}"
                              for n, s, m, o in UPDATES2 + UPDATES4])
def test_fsdp_ssm_tiles_take_no_second_sum(ssm_runs, update):
    """``train_step.update`` of the fsdp step on gradients of (d + 1) + 10 p
    at ('data' d, 'pp' p): every rank's grad norm is that of the gradients
    summed as the step must sum them, a tile (the shared block's
    included) over no 'data' rank but its own, in both update paths; under
    'none' the summed gradients themselves."""
    name, shape = update[0], update[1]
    tc = ssm_runs["cfgs"][name][1]
    res = ssm_runs["ranks2" if shape == DP2 else "ranks4"]
    shared = [p for p, pl in _place(tc, shape).items() if p.startswith("shared/") and any(pl)]
    assert (name == "zamba2-7b") == bool(shared)
    for rank, r in enumerate(res):
        up = r[("update",) + update]
        coords = rank_coords(rank, dict(zip(AXES, shape)))
        want, norm = _summed_grads(tc, shape, coords)
        np.testing.assert_allclose(float(up["grad_norm"]), norm, rtol=1e-6)
        if update[2] == "none":
            for path, v in up["grads"].items():
                assert v.tolist() == [want[path]], (rank, path, v)
            for path in shared:
                assert want[path] == coords["data"] + 1.0, path


def _grid_state(ssm_runs, spec):
    name = CKPTS[spec]
    return name, ssm_runs["ranks2" if "pp" not in spec else "ranks4"]


@pytest.mark.parametrize("spec", list(CKPTS))
def test_fsdp_ssm_checkpoint_restores_on_the_grid(ssm_runs, spec):
    """The fsdp 'epso' state saved by the grid ``Checkpointer`` comes back
    on every rank of the same plan bit for bit: params (the 'data' tiles
    of the groups, the shared block and the remaining layers, or of a
    stage's layers), master, m and v, the step; the model-only checkpoint
    into fresh params too; the MANIFEST carries the plan with fsdp."""
    name, res = _grid_state(ssm_runs, spec)
    for r in res:
        saved, back = r[("ckpt", spec)]["saved"], r[("ckpt", spec)]["restored"]
        assert back["error"] is None and back["step"] == 5
        for (k, a), (_, b) in zip(keyed_leaves(saved), keyed_leaves(back["state"])):
            assert a.shape == b.shape and torch.equal(a, b), k
        for (k, a), (_, b) in zip(keyed_leaves(saved.params), keyed_leaves(back["model_only"])):
            assert torch.equal(a, b), k
    tc = ssm_runs["cfgs"][name][1]
    with open(f"{ssm_runs['ckpts'][spec]}/ckpt-1/MANIFEST.json") as f:
        man = json.load(f)
    plan = ParallelPlan.parse(spec).resolve(tc)
    assert man["plan"] == {"spec": plan.spec(), "layout": plan.layout_signature()}
    assert man["plan"]["layout"]["fsdp"]


def _whole_state(ssm_runs, spec):
    """The saved state of ``spec`` as whole arrays by checkpoint key."""
    name, res = _grid_state(ssm_runs, spec)
    return _gathered_state(ssm_runs["cfgs"][name][1], [r[("ckpt", spec)]["saved"] for r in res],
                           spec)


@pytest.mark.parametrize("spec", list(CKPTS))
def test_fsdp_ssm_checkpoint_restores_in_one_process(ssm_runs, spec):
    """The same files restored by a one-process port ``Checkpointer`` into
    a whole state of other values: every leaf the whole array the ranks'
    tiles and shards put together."""
    tc = ssm_runs["cfgs"][CKPTS[spec]][1]
    tmpl = init_state(tc, TrainConfig(param_dtype="float32"), seed=3, device="cpu")
    restored, step = Checkpointer(ssm_runs["ckpts"][spec]).restore(tmpl)
    assert step == 5
    want = _whole_state(ssm_runs, spec)
    got = dict(keyed_leaves(restored))
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        assert not np.isnan(ref).any(), key
        np.testing.assert_array_equal(got[key].numpy(), ref, err_msg=key)


@pytest.mark.parametrize("spec", list(CKPTS))
def test_fsdp_ssm_checkpoint_restores_in_jax(ssm_runs, spec):
    """The same files restored by the JAX package's ``Checkpointer`` into a
    JAX TrainState of other values: every leaf bit for bit the gathered
    state, in the JAX dtypes."""
    jc = ssm_runs["cfgs"][CKPTS[spec]][0]
    tmpl = jinit_state(jax.random.PRNGKey(5), jc, JTrain(param_dtype="float32"))
    restored, step = JCheckpointer(ssm_runs["ckpts"][spec]).restore(tmpl)
    assert step == 5
    want = _whole_state(ssm_runs, spec)
    flat = jax.tree_util.tree_leaves_with_path(restored)
    assert len(flat) == len(want)
    for path, x in flat:
        key = jax.tree_util.keystr(path)
        assert np.asarray(x).dtype == want[key].dtype, key
        np.testing.assert_array_equal(np.asarray(x), want[key], err_msg=key)


# ----------------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layers", [("zamba2-7b", 5), ("falcon-mamba-7b", 2)])
def test_fsdp_ssm_launcher_resumes_bit_identically(tmp_path, arch, layers):
    """``--parallel dp=2,fsdp`` (Zamba2 at 5 layers: 2 groups of 2 and one
    remaining layer; falcon-mamba at 2): 6 steps that checkpoint at step
    3, then the same command again, which resumes from it and takes steps
    4-5 with losses and grad norms bit-identical; finite losses; the
    summary and the MANIFEST name the fsdp plan."""
    kw = dict(out=str(tmp_path / "run"), device="cpu", parallel="dp=2,fsdp", steps=6,
              ckpt_interval=3, d_model=64, layers=layers, batch=4, seq=32, log_every=100)
    first = tlaunch.run(arch, **kw)
    second = tlaunch.run(arch, **kw)
    assert [h["step"] for h in second] == [4, 5]
    for h, ref in zip(second, first[4:]):
        assert (h["loss"], h["grad_norm"]) == (ref["loss"], ref["grad_norm"]), h["step"]
    assert np.isfinite([h["loss"] for h in first]).all()
    with open(tmp_path / "run" / "summary.json") as f:
        summary = json.load(f)
    plan = ParallelPlan.parse(summary["parallel"])
    assert (plan.dp, plan.fsdp) == (2, True)
    with open(tmp_path / "run" / "ckpt" / "ckpt-1" / "MANIFEST.json") as f:
        man = json.load(f)
    assert man["plan"]["layout"] == {"axes": [["data", 2]], "opt_shard": "none", "fsdp": True}
