"""PyTorch port, the sharded optimizer's placement rules (``optim/epso.py``)
against the JAX package's, and SO training on a dp = 4 x ep = 1 grid.

* Specs, bytes and update plans, exactly equal: on the abstract meshes of
  tests/test_epso.py and tests/test_opt_overlap.py (('data', 'model') (4,
  2), the multi-pod ('pod', 'data', 'model') (2, 16, 16) and the plan mesh
  ('data', 'ep') (2, 2)), for reduced Mula-7B-A1B and reduced Mula-1B, the
  port's functions take the JAX ``param_specs`` as placements and the
  mesh's shape as their axis sizes. A JAX spec compares with a port
  placement after both are written out per dim (trailing ``None`` as
  ``()``, one axis as a 1-tuple).
* ``_augment`` against the JAX one under hypothesis, on the strategies of
  tests/test_epso.py.
* The port's grid layout and its conversions: ``opt_state_for_rank`` and
  ``opt_state_from_ranks`` are inverse, and ``train.init_state`` cuts the
  same shards; a grid checkpoint of EP slices holds whole stacks.
* Training: 'so' on 4 CPU ranks over gloo (reduced dense Mula-1B, float32)
  against the JAX single-device step with 4 microbatches in rank order
  (the oracle of tests/test_torch_ep.py), 3 steps from one state converted
  from JAX, atol = rtol = 1e-4: losses, grad norms, the params and the
  gathered master, m and v.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402
from jax.sharding import AbstractMesh, AxisType, PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.configs.base import ParallelConfig as JParallel  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.optim import epso as jepso  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro.parallel.sharding import ShardingRules, make_rules, param_specs  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import (opt_state_for_rank, opt_state_from_jax,  # noqa: E402
                                 opt_state_from_ranks, params_from_jax)
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import epso as tepso  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.parallel import spawn  # noqa: E402
from repro_torch.train import init_state  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(param_dtype="float32", compute_dtype="float32", grad_reduce_dtype="float32")
TIMEOUT_S = 120


def _mesh(shape, axes):
    return AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))


MESHES = {
    "data4-model2": (((4, 2), ("data", "model")), None),
    "multi-pod": (((2, 16, 16), ("pod", "data", "model")), None),
    "data2-ep2": (((2, 2), ("data", "ep")), "ep"),
}


def _rules(cfg, name):
    (shape, axes), ep = MESHES[name]
    mesh = _mesh(shape, axes)
    if ep is None:
        return make_rules(cfg, mesh, kind="train", global_batch=512)
    # the plan mesh's rules, as ParallelPlan.resolve builds them for dp=2,ep=2
    return ShardingRules(mesh, ("data", "ep"), None, "ep", cfg=cfg)


def _entries(e):
    return tuple(a for a in (e if isinstance(e, tuple) else (e,)) if a is not None)


def _placement(spec, ndim):
    """A JAX PartitionSpec written out per dim, as the port's placements."""
    return tuple(_entries(spec[d]) if d < len(spec) else () for d in range(ndim))


def _placements(specs, shapes):
    return jax.tree.map(lambda s, x: _placement(s, len(x.shape)), specs, shapes,
                        is_leaf=lambda s: isinstance(s, P))


@pytest.fixture(scope="module")
def shape_trees():
    out = {}
    for arch in ("mula-7b-a1b", "mula-1b"):
        cfg = jreduced(jget(arch), d_model=64)
        out[arch] = (cfg, jax.eval_shape(lambda c=cfg: jinit_params(jax.random.PRNGKey(0), c)))
    return out


@pytest.mark.parametrize("arch", ["mula-7b-a1b", "mula-1b"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_specs_bytes_and_plans_match_jax(shape_trees, arch, mesh_name):
    """For 'none', 'so' and 'epso': ``optimizer_state_specs`` leaf by leaf,
    ``state_bytes_per_device`` and ``plan_update_buckets`` (buckets, leaf
    indices and paths, added axes, psum axes, elems) at the default cap and
    at a 1 KiB cap, exactly the JAX package's."""
    cfg, shapes = shape_trees[arch]
    rules = _rules(cfg, mesh_name)
    sizes = dict(rules.mesh.shape)
    place = _placements(param_specs(shapes, rules), shapes)
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
        assert tepso.update_axis_order(sizes) == jepso.update_axis_order(rules.mesh)


def test_epso_state_bytes_of_full_width_mula_7b_a1b_on_2x2():
    """The per-rank state bytes of full-width Mula-7B-A1B at 2 of its 16
    layers on the port's dp = 2 x ep = 2 grid (the embedding and head
    tables' vocab rows on 'ep'): the figures the H100 run holds its
    measured bytes to."""
    import dataclasses
    cfg = dataclasses.replace(tget("mula-7b-a1b"), num_layers=2)
    shapes = init_params(cfg, device="meta")
    sizes = {"data": 2, "ep": 2}
    from repro_torch.parallel.sharding import param_placements
    place = param_placements(shapes, sizes)
    got = {m: tepso.state_bytes_per_device(shapes, place, sizes, m)
           for m in ("none", "so", "epso")}
    assert got == {"none": 6_477_176_832, "so": 3_238_588_416, "epso": 3_137_107_968}


# ----------------------------------------------------------------------------
# _augment, under hypothesis (the strategies of tests/test_epso.py)
# ----------------------------------------------------------------------------

_PROP_MESHES = [
    ((16, 16), ("data", "model")),
    ((2, 4), ("data", "model")),
    ((4, 2), ("data", "model")),
    ((8, 1), ("data", "model")),
    ((1, 8), ("data", "model")),
    ((8,), ("data",)),
    ((2, 2, 2), ("pod", "data", "model")),
    ((2, 4, 4), ("pod", "data", "model")),
]


def _base_spec(mesh, shape, choice):
    options = [P()]
    if "model" in mesh.shape:
        n = mesh.shape["model"]
        for i, d in enumerate(shape):
            if d % n == 0 and n > 1:
                options.append(P(*([None] * i + ["model"])))
                break
    return options[choice % len(options)]


@settings(max_examples=80, deadline=None)
@given(st.integers(0, len(_PROP_MESHES) - 1),
       st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 16, 17, 24, 32, 64]),
                min_size=1, max_size=3),
       st.integers(0, 3))
def test_augment_matches_jax(mesh_i, shape, spec_choice):
    mesh = _mesh(*_PROP_MESHES[mesh_i])
    shape = tuple(shape)
    base = _base_spec(mesh, shape, spec_choice)
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    group = dp + (("model",) if "model" in mesh.shape else ())
    want = jepso._augment(base, shape, [group], mesh)
    got = tepso._augment(_placement(base, len(shape)), shape, [group], dict(mesh.shape))
    assert got == _placement(want, len(shape)), (base, shape, got, want)


@settings(max_examples=60, deadline=None)
@given(st.integers(0, len(_PROP_MESHES) - 1),
       st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 16, 17, 24, 32, 64]),
                min_size=1, max_size=3),
       st.lists(st.sampled_from(["pod", "data", "model", "data", "model"]),
                min_size=1, max_size=5))
def test_augment_adversarial_groups_match_jax(mesh_i, shape, group):
    """Repeated axes, axes absent from the mesh, any order."""
    mesh = _mesh(*_PROP_MESHES[mesh_i])
    shape = tuple(shape)
    want = jepso._augment(P(), shape, [tuple(group)], mesh)
    got = tepso._augment((), shape, [tuple(group)], dict(mesh.shape))
    assert got == _placement(want, len(shape)), (group, shape, got, want)


# ----------------------------------------------------------------------------
# the port's grid layout
# ----------------------------------------------------------------------------

def _view(dp, ep, rank):
    """Rank ``rank``'s view of a dp x ep grid, without process groups: what
    the layout functions read (sizes and coordinates); no collective."""
    from repro_torch.parallel import ProcessGrid
    from repro_torch.parallel.ep import EPGroup
    dev = torch.device("cpu")
    return ProcessGrid(EPGroup(None, rank, dp * ep, dev, "gloo"),
                       EPGroup(None, rank // ep, dp, dev, "gloo"),
                       EPGroup(None, rank % ep, ep, dev, "gloo"))


@pytest.mark.parametrize("dp,ep", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("mode", ["none", "so", "epso"])
def test_rank_shards_round_trip(dp, ep, mode):
    """``opt_state_for_rank`` cuts each rank's tiles of a full state (the
    GSPMD tiling of the state placements), each rank holding
    ``state_bytes_per_device`` bytes, and ``opt_state_from_ranks`` puts the
    full state back exactly."""
    from repro_torch.parallel.sharding import param_placements
    from repro_torch.tree import leaves_with_path
    cfg = treduced(tget("mula-7b-a1b"), d_model=64, vocab=128, max_experts=8)
    opt = adamw_init(init_params(cfg, seed=3, device="cpu"))
    opt = opt._replace(m=tree_map(lambda t: t + 1.0, opt.m), v=tree_map(lambda t: t + 2.0, opt.v))
    sizes = {a: n for a, n in (("data", dp), ("ep", ep)) if n > 1}
    shapes = init_params(cfg, device="meta")
    want_bytes = tepso.state_bytes_per_device(shapes, param_placements(shapes, sizes), sizes,
                                              mode)
    states = [opt_state_for_rank(opt, cfg, dp=dp, ep=ep, rank=rank, mode=mode)
              for rank in range(dp * ep)]
    for st_ in states:
        assert sum(t.numel() * 4 for tr in (st_.master, st_.m, st_.v)
                   for t in leaves(tr)) == want_bytes
    back = opt_state_from_ranks(states, cfg, dp=dp, ep=ep, mode=mode)
    for what in ("master", "m", "v"):
        for path, ref in leaves_with_path(getattr(opt, what)):
            np.testing.assert_array_equal(back[what][path], ref.numpy(), err_msg=path)


@pytest.mark.parametrize("dp,ep", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("mode", ["so", "epso"])
def test_init_state_cuts_the_shards_of_the_one_process_state(dp, ep, mode):
    """On every rank, ``init_state`` on the grid holds exactly the shards
    ``opt_state_for_rank`` cuts from the one-process state (its in-rank cut
    is the expert slice, then the added axes; the other is the tiling of
    the global leaf), and its params (tensors of their own) the rank's
    expert slices."""
    cfg = treduced(tget("mula-7b-a1b"), d_model=64, vocab=128, max_experts=8)
    tc = TrainConfig(**F32)
    one = init_state(cfg, tc, seed=0, device="cpu")
    for rank in range(dp * ep):
        st_ = init_state(cfg, tc, seed=0, device="cpu", grid=_view(dp, ep, rank),
                         opt_sharding_mode=mode)
        want = opt_state_for_rank(one.opt, cfg, dp=dp, ep=ep, rank=rank, mode=mode)
        for what in ("master", "m", "v"):
            for a, b in zip(leaves(getattr(st_.opt, what)), leaves(getattr(want, what))):
                assert torch.equal(a, b), (rank, what)
        for p, ma in zip(leaves(st_.params), leaves(st_.opt.master)):
            assert p.data_ptr() != ma.data_ptr()
        e, el = rank % ep, 8 // ep
        assert torch.equal(st_.params["layers"]["moe"]["up"],
                           one.params["layers"]["moe"]["up"][:, e * el:(e + 1) * el])


def test_grid_checkpoint_of_ep_slices_holds_whole_stacks(tmp_path):
    """A (2, 2) grid's 'none' state (each rank holding its expert slices of
    params, master, m and v) saved through the grid ``Checkpointer``: the
    file holds whole (L, E, ...) stacks under the JAX keys, equal to the
    one-process state's, and the MANIFEST the plan."""
    import json
    from repro_torch.parallel import ParallelPlan, spawn
    from repro_torch.tree import keyed_leaves
    from repro_torch.train import TrainState
    cfg = treduced(tget("mula-7b-a1b"), d_model=64, vocab=128, max_experts=8)
    root = tmp_path / "ck"
    spawn(ranks.grid_checkpoint_rank, 4, args=(cfg, "dp=2,ep=2", str(root), "save"),
          device="cpu", grid=(2, 2), timeout_s=TIMEOUT_S)
    one = init_state(cfg, TrainConfig(param_dtype="float32"), seed=0, device="cpu")
    one = TrainState(one.params, one.opt._replace(
        step=torch.full_like(one.opt.step, 7), m=tree_map(lambda t: t * 0.5 + 1.0, one.opt.master),
        v=tree_map(lambda t: t * t + 1e-3, one.opt.master)))
    with np.load(root / "ckpt-1" / "state.npz") as f:
        assert list(f.files) == [k for k, _ in keyed_leaves(one)]
        for key, leaf in keyed_leaves(one):
            np.testing.assert_array_equal(f[key], leaf.numpy(), err_msg=key)
        assert f[".params['layers']['moe']['up']"].shape[:2] == (2, 8)
    man = json.loads((root / "ckpt-1" / "MANIFEST.json").read_text())
    plan = ParallelPlan.parse("dp=2,ep=2").resolve(cfg)
    assert man["plan"] == {"spec": "dp=2,ep=2", "layout": plan.layout_signature()}


# ----------------------------------------------------------------------------
# SO training on a dp = 4 x ep = 1 grid against the JAX package
# ----------------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(n, b=4, s=16, vocab=128):
    out = []
    for i in range(n):
        toks = np.random.default_rng(20 + i).integers(0, vocab, size=(b, s + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _jleaves(tree):
    return {jax.tree_util.keystr(p).replace("['", "").replace("']", "/").rstrip("/"):
            np.asarray(x) for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def run_grid_against_jax(arch, dp, ep, runs, experts=None, tp=1, **moe_kw):
    """``runs`` ((mode, overlap) pairs) on a dp x ep x tp grid of CPU ranks
    from one state converted from JAX, 3 steps, and the JAX single-device
    step with dp * ep microbatches from the same state: (JAX state, JAX
    metrics, the ranks' results, the port's config). ``moe_kw``: more
    MoEConfig fields for both packages."""
    kw = {} if experts is None else dict(max_experts=experts)
    jc = jreduced(jget(arch), d_model=64, vocab=128, **kw)
    tc = treduced(tget(arch), d_model=64, vocab=128, **kw)
    if jc.moe is not None:
        import dataclasses
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, dispatch="dropless",
                                                             **moe_kw))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, dispatch="dropless",
                                                             **moe_kw))
    tkw = dict(seq_len=16, global_batch=4, warmup_steps=1, total_steps=10, lr_peak=1e-2,
               lr_min=1e-3, **F32)
    jtrain, ttrain = JTrain(**tkw), TrainConfig(**tkw)
    jstate = jinit_state(jax.random.PRNGKey(0), jc, jtrain)
    params = params_from_jax(_np(jstate.params), tc, device="cpu")
    opt = opt_state_from_jax(_np(jstate.opt), device="cpu")
    batches = _batches(3)

    def oracle(jstate=jstate):
        with use_kernel_plan(KernelPlan()):
            jstep = jax.jit(jmake_train_step(jc, JParallel(microbatches=dp * ep), jtrain))
            jms = []
            for b in batches:
                jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
                jms.append(jm)
        return jstate, jms

    args = (tc, ttrain, params, opt,
            [{k: torch.from_numpy(v).long() for k, v in b.items()} for b in batches], runs)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn, ranks.grid_train_rank, dp * ep * tp, args=args, device="cpu",
                          timeout_s=TIMEOUT_S, grid=(dp, ep, tp))
        jstate, jms = oracle()
        res = fut.result()
    return jstate, jms, res, tc


def check_against_jax(jstate, jms, res, tc, dp, ep, run, tp=1):
    """Every rank's metrics, params (its tiles) and the gathered master, m
    and v of ``run`` against the JAX step's, atol = rtol = 1e-4; the state
    bytes each rank holds equal ``state_bytes_per_device``."""
    from repro_torch.parallel.grid import rank_coords
    from repro_torch.parallel.sharding import tile_slices
    from repro_torch.train.trainer import placements
    from repro_torch.tree import leaves_with_path
    mode = run[0]
    sizes = {a: n for a, n in (("data", dp), ("ep", ep), ("tp", tp)) if n > 1}
    place = dict(leaves_with_path(placements(tc, init_params(tc, device="meta"), sizes)))
    for i, jm in enumerate(jms):
        for k in ranks.KEYS:
            if k not in jm:
                continue
            for rank, r in enumerate(res):
                np.testing.assert_allclose(r[run]["metrics"][i][k].numpy(), np.asarray(jm[k]),
                                           **TOL, err_msg=f"{run} step {i} rank {rank} {k}")
    jp = _jleaves(jstate.params)
    for rank, r in enumerate(res):
        assert r[run]["state_bytes"] == r[run]["state_bytes_expected"], (run, rank)
        coords = rank_coords(rank, {"data": dp, "ep": ep, "tp": tp})
        for path, leaf in r[run]["params"].items():
            ref = jp[path][tile_slices(place[path], jp[path].shape, coords, sizes)]
            np.testing.assert_allclose(leaf.numpy(), ref, **TOL,
                                       err_msg=f"{run} params rank {rank} {path}")
    full = opt_state_from_ranks([r[run]["opt"] for r in res], tc, dp=dp, ep=ep, mode=mode,
                                tp=tp)
    assert full["step"] == 3
    for what in ("master", "m", "v"):
        jl = _jleaves(getattr(jstate.opt, what))
        assert sorted(full[what]) == sorted(jl)
        for path, ref in jl.items():
            np.testing.assert_allclose(full[what][path], ref, **TOL,
                                       err_msg=f"{run} {what} {path}")


def test_so_on_4x1_grid_matches_jax_dense():
    """Reduced dense Mula-1B, 'so' on a dp = 4 x ep = 1 grid ('off': the
    blocking per-leaf schedule, the 'auto' choice for 'so')."""
    run = ("so", "auto")
    jstate, jms, res, tc = run_grid_against_jax("mula-1b", 4, 1, [run])
    assert float(jms[0]["clip_scale"]) == 1.0 and float(jms[2]["clip_scale"]) < 1.0
    check_against_jax(jstate, jms, res, tc, 4, 1, run)
