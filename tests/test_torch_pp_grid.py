"""PyTorch port, pipeline parallelism on a process grid with a 'pp' axis
(the per-stage executor, ``parallel.pipeline.run_schedule`` over
``StageLink``), CPU ranks over gloo, float32, against the one-process PP
step (``tests/test_torch_pp_train.py`` holds that one to the JAX PP step):

* grids (pp=2) on 2 ranks and (dp=2, pp=2), (pp=2, ep=2), (pp=2, tp=2),
  (pp=4) on 4, each in 'none', 'so' and 'epso', two steps of reduced
  Mula-7B-A1B (4 layers, 8 experts, dropless, the Mula router terms: aux
  0.01, z 0.001) from one whole state: every rank's metrics and router
  terms (``step.router_terms``: moe_aux, moe_z) equal the one-process
  step's at atol = rtol = 1e-4 and the other ranks' exactly, and every
  rank's params after the second step its tiles of the one-process
  step's. A stage takes the aux and z of the whole microbatch, over the
  ranks that split it ('data' x 'ep'), as the one-process step does. The
  one-process step sees each microbatch as the grid does: microbatch m is
  the ranks' microbatches m side by side (``_oracle_batch``);
* capacity dispatch with overflowing experts on (pp=2, ep=2) and (dp=2,
  pp=2), and without overflow on (dp=2, pp=2): the stage's MoE block drops
  the pairs of the one-device pool of the whole microbatch (the plan of
  the ids gathered over 'data' x 'ep'), so the drops are the one-process
  step's; the same overflowing (pp=2, ep=2) case with ``stage1='a2a'``,
  which a stage runs as the allgather, bit for bit its allgather run's;
  the overflowing (dp=2, pp=2) case with ``moe_impl='dense_capacity'``
  (the dense path, which takes the same whole-microbatch pool and router
  terms);
* a stage's MoE block alone on dp x ep grids of 4 ranks (dp=2 x ep=2 for
  fsmoe and the dense path, dp=4, ep=4), overflowing capacity dispatch:
  outputs, aux, z, counts, drops and gradients the one-device block's on
  the whole batch (``torch_ep_ranks.whole_pool_block_rank``);
* every rank holds ``state_bytes_per_device`` bytes of optimizer state,
  and under 1f1b stage 0 never more than pp saved stage inputs;
* placements and state bytes of full-width Mula-7B-A1B on ('data', 'pp',
  'ep', 'tp') meshes equal the JAX plan's ``param_specs`` and
  ``state_bytes_per_device``, the embedding and head tables' vocab split
  over the model axis ('tp', else 'ep') too.

Each world size spawns once (two spawns, run side by side; the block
cases a third), every case a grid re-cut from the same processes
(``torch_ep_ranks.pp_grid_cases_rank``).
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, AxisType  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.optim import epso as jepso  # noqa: E402
from repro.parallel.sharding import ShardingRules, param_specs  # noqa: E402
from repro_torch.configs import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.optim import epso as tepso  # noqa: E402
from repro_torch.parallel import spawn  # noqa: E402
from repro_torch.parallel.sharding import tile_slices  # noqa: E402
from repro_torch.train import init_state, make_train_step  # noqa: E402
from repro_torch.train.trainer import placements  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402
from test_torch_epso import _placements  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(param_dtype="float32", compute_dtype="float32", grad_reduce_dtype="float32")
MODES = ("none", "so", "epso")
BATCH, SEQ = 8, 16
TRAIN = TrainConfig(seq_len=SEQ, global_batch=BATCH, warmup_steps=1, total_steps=10,
                    lr_peak=1e-2, lr_min=1e-3, **F32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models run faster on one torch thread than on every core,
    and the suite runs several test processes side by side (the spawned
    ranks take one thread each already)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**moe_kw):
    tc = treduced(tget("mula-7b-a1b"), d_model=64, vocab=128, layers=4, max_experts=8)
    assert (tc.moe.router_aux_coef, tc.moe.router_z_coef) == (0.01, 0.001)
    moe = {"dispatch": "dropless", **moe_kw}
    return dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))


CFGS = {"moe": _cfg(), "capacity": _cfg(dispatch="capacity", capacity_factor=0.25),
        "roomy": _cfg(dispatch="capacity", capacity_factor=8.0),
        "capacity_a2a": _cfg(dispatch="capacity", capacity_factor=0.25, stage1="a2a"),
        "dense_capacity": _cfg(dispatch="capacity", capacity_factor=0.25,
                               moe_impl="dense_capacity")}
# each case of the first config run as its twin of the second, bit for bit
TWINS = {"capacity_a2a": "capacity"}
ROUTER = ("moe_aux", "moe_z")
# (config, (dp, pp, ep, tp), mode, schedule, microbatches)
CASES2 = [("moe", (1, 2, 1, 1), mode, s, 4) for mode, s in zip(MODES, ("1f1b", "gpipe", "1f1b"))]
CASES4 = [("moe", grid, mode, s, n)
          for grid, s, n in (((2, 2, 1, 1), "1f1b", 2), ((1, 2, 2, 1), "gpipe", 4),
                             ((1, 2, 1, 2), "1f1b", 4), ((1, 4, 1, 1), "1f1b", 4))
          for mode in MODES] + [("capacity", (1, 2, 2, 1), "epso", "1f1b", 2),
                                ("roomy", (2, 2, 1, 1), "so", "gpipe", 2),
                                ("capacity", (2, 2, 1, 1), "so", "1f1b", 2),
                                ("capacity_a2a", (1, 2, 2, 1), "epso", "1f1b", 2),
                                ("dense_capacity", (2, 2, 1, 1), "so", "1f1b", 2)]


def _batches(n=2):
    out = []
    for i in range(n):
        t = torch.from_numpy(np.random.default_rng(40 + i).integers(0, 128, (BATCH, SEQ + 1)))
        out.append({"tokens": t[:, :-1].long(), "labels": t[:, 1:].long()})
    return out


def _oracle_batch(b, w, n_mb):
    """The rows of ``b`` reordered so that one process's microbatch m holds
    microbatch m of each of the ``w`` ranks splitting the batch, in rank
    order (rank r takes the r-th of w row blocks, ``grid_rows``)."""
    B = b["tokens"].shape[0]
    c = B // (w * n_mb)
    idx = [r * (B // w) + m * c + j for m in range(n_mb) for r in range(w) for j in range(c)]
    return {k: v[idx] for k, v in b.items()}


def _oracle(case, params, batches):
    """The one-process PP step on the grid's microbatches: per step the
    metrics, and the final params."""
    name, (dp, pp, ep, _), _, schedule, n_mb = case
    tc = CFGS[name]
    state = init_state(tc, TRAIN, seed=0, device="cpu")
    for dst, src in zip(leaves(state.params), leaves(params)):
        dst.copy_(src)
    step = make_train_step(tc, ParallelConfig(microbatches=n_mb, pp_stages=pp,
                                              pp_schedule=schedule), TRAIN)
    metrics = []
    for b in batches:
        state, m = step(state, _oracle_batch(b, dp * ep, n_mb))
        metrics.append({**m, **step.router_terms})
    return metrics, dict(leaves_with_path(state.params))


@pytest.fixture(scope="module")
def grid_runs():
    params = {n: init_params(tc, seed=0, device="cpu") for n, tc in CFGS.items()}
    opts = {n: adamw_init(p) for n, p in params.items()}      # copied into each rank
    batches = _batches()
    args = (CFGS, params, opts, TRAIN, batches)
    with ThreadPoolExecutor(2) as pool:
        futs = {w: pool.submit(spawn, ranks.pp_grid_cases_rank, w, args=args + (cases,),
                               device="cpu", timeout_s=240)
                for w, cases in ((2, CASES2), (4, CASES4))}
        want = [_oracle(c, params[c[0]], batches) for c in CASES2 + CASES4]
        got = futs[2].result(), futs[4].result()
    res = [[r[i] for r in got[0]] for i in range(len(CASES2))] + \
        [[r[i] for r in got[1]] for i in range(len(CASES4))]
    return list(zip(CASES2 + CASES4, res, want))


def _ids(case):
    name, (dp, pp, ep, tp), mode, schedule, n = case
    return f"{name}-dp{dp}pp{pp}ep{ep}tp{tp}-{mode}-{schedule}-mb{n}"


@pytest.mark.parametrize("index", range(len(CASES2 + CASES4)),
                         ids=[_ids(c) for c in CASES2 + CASES4])
def test_grid_matches_one_process_pp_step(grid_runs, index):
    case, rank_res, (want_m, want_p) = grid_runs[index]
    name, (dp, pp, ep, tp), mode, schedule, n_mb = case
    tc = CFGS[name]
    sizes = {a: n for a, n in zip(("data", "pp", "ep", "tp"), (dp, pp, ep, tp)) if n > 1}
    place = dict(leaves_with_path(placements(tc, init_params(tc, device="meta"), sizes)))
    for r in rank_res:
        for i, (got, want) in enumerate(zip(r["metrics"], want_m)):
            assert sorted(got) == sorted(k for k in want if k in ranks.KEYS + ROUTER)
            for k in got:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TOL,
                                           err_msg=f"{_ids(case)} step {i} {k} {r['coords']}")
                assert torch.equal(got[k], rank_res[0]["metrics"][i][k]), (k, r["coords"])
        for path, full in want_p.items():
            sl = tile_slices(place[path], tuple(full.shape), r["coords"], sizes)
            np.testing.assert_allclose(r["params"][path].numpy(), full[sl].numpy(), **TOL,
                                       err_msg=f"{_ids(case)} {path} {r['coords']}")
        assert r["state_bytes"] == r["state_bytes_expected"], r["coords"]
        stage = r["coords"]["pp"]
        assert r["saved_peak"][stage] <= (pp if schedule == "1f1b" else n_mb)
        if stage == 0:
            assert r["saved_peak"][0] == (min(pp, n_mb) if schedule == "1f1b" else n_mb)
        # each microbatch's activation forward (not on the last stage) and its
        # gradient back (not on stage 0), 4 bytes an element
        act = BATCH // (dp * ep) // n_mb * SEQ * tc.d_model * 4
        assert r["sent_bytes"] == n_mb * act * ((stage < pp - 1) + (stage > 0))
    if "capacity" in name:
        assert all(float(m["moe_drops"]) > 0 for m in want_m)
    if name in TWINS:
        twin = next(r for c, r, _ in grid_runs if c == (TWINS[name],) + case[1:])
        for r, t in zip(rank_res, twin):
            for got, want in zip(r["metrics"], t["metrics"]):
                assert all(torch.equal(got[k], want[k]) for k in got), _ids(case)
            assert all(torch.equal(r["params"][k], t["params"][k]) for k in r["params"])


# (config, dp, ep): the MoE block of a stage on a dp x ep grid
BLOCK_CASES = [("capacity", 2, 2), ("dense_capacity", 2, 2), ("capacity", 4, 1),
               ("capacity", 1, 4)]


@pytest.fixture(scope="module")
def block_runs():
    names = sorted({c[0] for c in BLOCK_CASES})
    tcs = {n: CFGS[n] for n in names}
    p = {n: {k: v[0] for k, v in init_params(tcs[n], seed=1, device="cpu")["layers"]["moe"]
             .items()} for n in names}
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((BATCH, SEQ, 64), dtype=np.float32))
    ct = torch.from_numpy(rng.standard_normal((BATCH, SEQ, 64), dtype=np.float32))
    got = spawn(ranks.whole_pool_block_rank, 4, device="cpu", timeout_s=240,
                args=(tcs, p, x, ct, BLOCK_CASES))
    return tcs, p, x, ct, got


@pytest.mark.parametrize("index", range(len(BLOCK_CASES)),
                         ids=[f"{n}-dp{d}ep{e}" for n, d, e in BLOCK_CASES])
def test_whole_pool_block_matches_one_device(block_runs, index):
    """A pipeline stage's MoE block on a dp x ep grid, capacity dispatch
    with overflowing experts: every rank's outputs (its rows), aux, z,
    counts and drops are the one-device block's on the whole batch, and so
    are its x gradients; the router's and the stacks' gradients summed
    over the ranks that hold them are the one-device gradients. With dp >
    1 and ep > 1 the gathered ids come in row order d * ep + e, the
    order an overflowing expert's first-come pool shows."""
    tcs, p, x, ct, got = block_runs
    name, dp, ep = BLOCK_CASES[index]
    tc = tcs[name]
    pw = {k: v.clone().requires_grad_() for k, v in p[name].items()}
    xw = x.clone().requires_grad_()
    out, aux, z, st = tmoe.sparse_moe_block(pw, xw, tc)
    keys = ("router", "gate", "up", "down")
    loss = (out * ct).sum() + ranks.AUX * aux + ranks.Z * z
    gx, *gp = torch.autograd.grad(loss, [xw] + [pw[k] for k in keys])
    assert float(st.drops) > 0
    n = BATCH // (dp * ep)
    total = {k: torch.zeros_like(v) for k, v in zip(keys, gp)}
    for r in (res[index] for res in got):
        c = r["coords"]
        i = c["data"] * ep + c["ep"]
        rows = slice(i * n, (i + 1) * n)
        np.testing.assert_allclose(r["out"].numpy(), out[rows].detach().numpy(), **TOL)
        for k, want in (("aux", aux), ("z", z), ("counts", st.counts), ("drops", st.drops)):
            np.testing.assert_allclose(r[k].numpy(), want.detach().numpy(), **TOL, err_msg=k)
        np.testing.assert_allclose(r["grads"]["x"].numpy(), gx[rows].numpy(), **TOL)
        for k in keys:
            g = r["grads"][k]
            if g.shape == total[k].shape:
                total[k] += g
            else:             # the rank's expert slice
                el = g.shape[0]
                total[k][c["ep"] * el:(c["ep"] + 1) * el] += g
    for k, want in zip(keys, gp):
        np.testing.assert_allclose(total[k].numpy(), want.numpy(), **TOL, err_msg=k)


def _plan_rules(cfg, dp, pp, ep, tp):
    """The JAX rules of a ('data', 'pp', 'ep', 'tp') plan mesh, its size-1
    axes dropped as ``ParallelPlan.mesh_axes`` drops them."""
    axes = [(a, n) for a, n in (("data", dp), ("pp", pp), ("ep", ep), ("tp", tp)) if n > 1]
    mesh = AbstractMesh(tuple(n for _, n in axes), tuple(a for a, _ in axes),
                        axis_types=(AxisType.Auto,) * len(axes))
    batch = tuple(a for a in ("data", "ep") if a in mesh.shape)
    return ShardingRules(mesh, batch, "tp" if tp > 1 else None, "ep" if ep > 1 else None,
                         pp_axis="pp" if pp > 1 else None, cfg=cfg), dict(mesh.shape)


@pytest.mark.parametrize("grid", [(1, 2, 1, 1), (2, 2, 1, 1), (1, 2, 2, 1), (1, 2, 1, 2),
                                  (1, 4, 1, 1), (2, 2, 2, 2)])
def test_placements_and_state_bytes_match_jax_plan(grid):
    """Full-width Mula-7B-A1B at 4 layers: every leaf's placement is the
    JAX plan's (the layer stacks' leading dim on 'pp', the tables' vocab
    rows on the model axis, 'tp', else 'ep'); the per-rank state bytes are
    the JAX plan's in 'none', 'so' and 'epso'."""
    dp, pp, ep, tp = grid
    jc, tc = (dataclasses.replace(get("mula-7b-a1b"), num_layers=4) for get in (jget, tget))
    shapes = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jc))
    rules, sizes = _plan_rules(jc, dp, pp, ep, tp)
    meta = init_params(tc, device="meta")
    place = placements(tc, meta, sizes)
    want = leaves(_placements(param_specs(shapes, rules), shapes))
    staged = 0
    for (path, g), w in zip(leaves_with_path(place), want):
        assert g == w, (grid, path, g, w)
        staged += path.startswith("layers/") and g[0] == ("pp",)
    assert staged == len([p for p, _ in leaves_with_path(meta) if p.startswith("layers/")])
    for mode in MODES:
        got = tepso.state_bytes_per_device(meta, place, sizes, mode)
        assert got == jepso.state_bytes_per_device(shapes, rules, mode), (grid, mode)
