"""PyTorch port, ``parallel.ParallelPlan`` against the JAX package's
``repro.parallel.plan.ParallelPlan``: the same specs parse to the same
fields and canonical ``str``, the same bad specs raise the same
``ValueError``, ``from_legacy`` translates the same ``--mesh`` specs, and a
plan's checkpoint metadata (``layout_signature``, ``spec``) equals the JAX
``ResolvedPlan``'s (which needs no mesh for either). ``resolve`` refuses,
naming its ROADMAP.md item, what the port cannot run."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.parallel.plan import ParallelPlan as JPlan, ResolvedPlan as JResolved  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.parallel import ParallelPlan, ResolvedPlan  # noqa: E402
from repro_torch.parallel.grid import grid_spec  # noqa: E402

FIELDS = ("dp", "pp", "ep", "tp", "pod", "opt_shard", "opt_overlap", "pp_schedule", "pp_impl",
          "microbatches", "fsdp", "moe_dispatch", "rebalance")

SPECS = [
    "dp=1", "dp=2", "dp=2,ep=2", "dp=4,opt=so", "ep=4,moe=dropless",
    "dp=2,ep=2,opt=epso,overlap=ring", "dp=2,ep=2,overlap=auto", "dp=2,pp=2,ep=2",
    "dp=2,ep=2,tp=2", "pod=2,dp=2", "dp=2,fsdp", "dp=2,fsdp=0", "dp=8,mb=4",
    "dp=2,schedule=gpipe,impl=masked", "dp=2,ep=2,rebalance=50:1.25", "dp=2,rebalance=off",
    "dp=2,tiles=128x512x512", "dp=2,tiles=auto", "dp=2,tiles=64x256x128",
    " dp = 2 , ep = 2 ,", "tp=2,ep=2,dp=2,pod=2,pp=2",
    "dp=2,microbatches=2,sched=1f1b,opt_shard=so,opt_overlap=xla,moe_dispatch=capacity",
]

BAD_SPECS = [
    "", "dp=0", "dp=x", "foo=2", "dp=2,dp=4", "dp", "opt=bad", "overlap=nope",
    "schedule=zz", "impl=zz", "moe=zz", "rebalance=5", "rebalance=0:1.0", "tiles=12x3",
    "tiles=0x512x512", "dp=2,opt=so,opt_shard=epso", "mb=0",
]


def _tiles(jplan):
    k = jplan.kernel
    if k.tiles == "auto":
        return "auto"
    t = (k.tile_m, k.tile_k, k.tile_n)
    return None if t == (128, 512, 512) else "x".join(map(str, t))


@pytest.mark.parametrize("spec", SPECS)
def test_parse_matches_jax(spec):
    """Fields, tiles, canonical spec, round trip, derived sizes and the
    checkpoint metadata, equal to the JAX plan's."""
    j, t = JPlan.parse(spec), ParallelPlan.parse(spec)
    assert {f: getattr(t, f) for f in FIELDS} == {f: getattr(j, f) for f in FIELDS}
    assert t.tiles == _tiles(j)
    assert str(t) == str(j)
    assert ParallelPlan.parse(str(t)) == t
    assert (t.num_devices, t.mesh_axes()) == (j.num_devices, j.mesh_axes())
    assert t.rebalance_params() == j.rebalance_params()
    jr, tr = JResolved(plan=j), ResolvedPlan(plan=t)
    assert tr.layout_signature() == jr.layout_signature()
    assert tr.spec() == jr.spec()


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_the_jax_error(spec):
    with pytest.raises(ValueError) as je:
        JPlan.parse(spec)
    with pytest.raises(ValueError) as te:
        ParallelPlan.parse(spec)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("mesh", ["8", "4,2", "2,2,2", "2,2,2,2", "2,3", "1,4"])
@pytest.mark.parametrize("arch", ["mula-7b-a1b", "mula-1b"])
def test_from_legacy_matches_jax(mesh, arch):
    """MoE: the model axis becomes ep where the experts divide it, else tp;
    dense: tp."""
    jc, tc = jreduced(jget(arch)), treduced(tget(arch))
    j = JPlan.from_legacy(mesh, cfg=jc, opt_shard="so", pp_schedule="gpipe")
    t = ParallelPlan.from_legacy(mesh, cfg=tc, opt_shard="so", pp_schedule="gpipe")
    assert str(t) == str(j)
    assert {f: getattr(t, f) for f in FIELDS} == {f: getattr(j, f) for f in FIELDS}


def test_bad_mesh_spec_raises_the_jax_error():
    for mesh in ("1,2,3,4,5", "0", "2,x"):
        with pytest.raises(ValueError) as je:
            JPlan.from_legacy(mesh)
        with pytest.raises(ValueError) as te:
            ParallelPlan.from_legacy(mesh)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("spec,arch,layers", [
    ("ep=2", "mula-1b", 2), ("ep=3", "mula-7b-a1b", 2), ("pp=3", "mula-7b-a1b", 2),
    ("tp=3", "mula-7b-a1b", 2), ("tp=3", "mula-1b", 2), ("rebalance=5:1.5", "mula-1b", 2),
    ("pp=2,rebalance=5:1.5", "mula-7b-a1b", 2)])
def test_validate_model_matches_jax(spec, arch, layers):
    jc, tc = jreduced(jget(arch), layers=layers), treduced(tget(arch), layers=layers)
    with pytest.raises((ValueError, NotImplementedError)) as je:
        JPlan.parse(spec).validate_model(jc)
    with pytest.raises(je.type) as te:
        ParallelPlan.parse(spec).validate_model(tc)
    assert str(te.value) == str(je.value)


def test_apply_to_model_matches_jax():
    jc, tc = jreduced(jget("mula-7b-a1b")), treduced(tget("mula-7b-a1b"))
    for spec in ("dp=2", "dp=2,moe=dropless", "dp=2,moe=capacity"):
        assert ParallelPlan.parse(spec).apply_to_model(tc).moe.dispatch == \
            JPlan.parse(spec).apply_to_model(jc).moe.dispatch
    dense = treduced(tget("mula-1b"))
    assert ParallelPlan.parse("dp=2,moe=dropless").apply_to_model(dense) is dense


@pytest.mark.parametrize("spec,item,arch", [
    ("pod=2,dp=2", "item 5", "mula-7b-a1b"),
    ("pod=2,dp=2,ep=2,fsdp,rebalance=5:1.5", "item 5", "mula-7b-a1b"),
    ("dp=2,tp=2,fsdp", "item 5.10", "zamba2-7b"),
    ("dp=2,tp=2,fsdp,opt=so", "item 5.10", "falcon-mamba-7b"),
    ("dp=2,tp=2", "item 5.10", "zamba2-7b"), ("tp=2", "item 5.10", "falcon-mamba-7b"),
    ("dp=2,tiles=auto", "item 7", "mula-7b-a1b"),
    ("dp=2,tiles=64x256x256", "item 7", "mula-7b-a1b")])
def test_resolve_refuses_what_the_port_lacks(spec, item, arch):
    """pod (item 5; also with fsdp and a rebalance policy), tp for the
    state-space archs (item 5.10; also with fsdp) and explicit tiles (item
    7). fsdp with a rebalance policy or for a state-space arch resolves
    (``test_resolve_takes_fsdp``)."""
    cfg = treduced(tget(arch))
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1 {item}"):
        ParallelPlan.parse(spec).resolve(cfg, global_batch=8)


@pytest.mark.parametrize("spec,arch", [("dp=2,fsdp", "mula-7b-a1b"), ("dp=4,fsdp", "mula-1b"),
                                       ("fsdp", "mula-1b"), ("dp=2,ep=2,fsdp", "mula-7b-a1b"),
                                       ("dp=2,ep=2,fsdp,opt=epso", "mula-7b-a1b"),
                                       ("ep=2,tp=2,fsdp", "mula-7b-a1b"),
                                       ("dp=2,tp=2,fsdp", "mula-1b"),
                                       ("dp=2,pp=2,fsdp", "mula-7b-a1b"),
                                       ("dp=2,tp=2,fsdp,opt=so", "mula-7b-a1b"),
                                       ("dp=2,pp=2,ep=2,fsdp,opt=epso", "mula-7b-a1b"),
                                       ("dp=2,ep=2,fsdp,rebalance=5:1.5", "mula-7b-a1b"),
                                       ("dp=2,ep=2,tp=2,fsdp,opt=epso,rebalance=5:1.5",
                                        "mula-7b-a1b"),
                                       ("dp=2,fsdp", "zamba2-7b"),
                                       ("dp=2,fsdp,opt=so", "zamba2-7b"),
                                       ("dp=2,fsdp", "falcon-mamba-7b"),
                                       ("dp=2,fsdp,opt=so", "falcon-mamba-7b"),
                                       ("dp=2,pp=2,fsdp", "falcon-mamba-7b")])
def test_resolve_takes_fsdp(spec, arch):
    """fsdp resolves on any grid of a dense or moe model, with 'tp' and
    'pp' too, in every optimizer mode, with a ``rebalance=`` policy on
    ('data', 'ep') and ('data', 'ep', 'tp') grids, and for the ssm arch on
    'data' and ('data', 'pp') grids and the hybrid arch on 'data' grids
    (it was refused before the fsdp step was ported, with 'ep' or a sharded
    optimizer before that was, with 'tp' or 'pp' before those were, and
    with a placement or a state-space arch before those were): the grid,
    the checkpoint layout the JAX ``ResolvedPlan``'s, and the
    ParallelConfig carries ``fsdp_params`` and the mode."""
    from repro.parallel.plan import ResolvedPlan as JResolved
    r = ParallelPlan.parse(spec).resolve(treduced(tget(arch)), global_batch=8)
    dp, pp, ep, tp = r.plan.dp, r.plan.pp, r.plan.ep, r.plan.tp
    sizes = {a: n for a, n in (("data", dp), ("pp", pp), ("ep", ep), ("tp", tp)) if n > 1}
    assert (r.world, r.grid, r.axis_sizes) == (dp * pp * ep * tp, grid_spec(dp, ep, tp, pp),
                                               sizes)
    assert r.layout_signature() == JResolved(plan=JPlan.parse(spec)).layout_signature()
    assert r.layout_signature()["fsdp"] and r.parallel_config().fsdp_params
    assert r.parallel_config().optimizer_sharding == r.plan.opt_shard


@pytest.mark.parametrize("spec,world,grid,sizes", [
    ("dp=2,ep=2,tp=2", 8, (2, 2, 2), {"data": 2, "ep": 2, "tp": 2}),
    ("ep=2,tp=2,opt=epso", 4, (1, 2, 2), {"ep": 2, "tp": 2}),
    ("tp=4", 4, (1, 1, 4), {"tp": 4}), ("dp=2,tp=2,opt=so", 4, (2, 1, 2), {"data": 2, "tp": 2})])
def test_resolve_takes_tp(spec, world, grid, sizes):
    """A tp axis resolves (it was refused before tensor parallelism was
    ported): world dp * ep * tp, the grid (dp, ep, tp) for ``spawn``, the
    batch split over dp * ep alone, the checkpoint layout the JAX
    ``ResolvedPlan``'s. A tp that splits a head is refused with the reason."""
    from repro.parallel.plan import ResolvedPlan as JResolved
    cfg = treduced(tget("mula-7b-a1b"))
    r = ParallelPlan.parse(spec).resolve(cfg, global_batch=grid[0] * grid[1])
    assert (r.world, r.grid, r.batch_ranks, r.axis_sizes) == (world, grid, grid[0] * grid[1],
                                                              sizes)
    assert r.layout_signature() == JResolved(plan=JPlan.parse(spec)).layout_signature()
    if grid[0] * grid[1] > 1:
        with pytest.raises(ValueError, match="do not divide"):
            ParallelPlan.parse(spec).resolve(cfg, global_batch=grid[0] * grid[1] + 1)
    odd = dataclasses.replace(cfg, num_heads=6, num_kv_heads=3)
    with pytest.raises(NotImplementedError, match="splits attention by whole heads"):
        ParallelPlan.parse(spec).resolve(odd)


@pytest.mark.parametrize("spec,dispatch,error,match", [
    ("ep=2", "dropless", ValueError, "does not compose with stage1='a2a'"),
    ("ep=2,tp=2", "capacity", NotImplementedError, "does not compose with expert-TP")])
def test_resolve_refuses_a2a_combinations(spec, dispatch, error, match):
    """The all-to-all Stage 1 refuses dropless dispatch and a tp axis, with
    the JAX MoE block's reasons."""
    cfg = treduced(tget("mula-7b-a1b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, stage1="a2a",
                                                           dispatch=dispatch))
    with pytest.raises(error, match=match):
        ParallelPlan.parse(spec).resolve(cfg)


@pytest.mark.parametrize("spec", ["dp=2,ep=2,rebalance=50:1.25"])
def test_resolve_takes_rebalance(spec):
    """A rebalance policy resolves (it was refused before expert placement
    was ported); the live placement starts as the identity (None) and
    ``with_placement`` swaps it, as in the JAX ``ResolvedPlan``. A model
    without experts is refused with the JAX message."""
    from repro_torch.parallel.placement import ExpertPlacement
    cfg = treduced(tget("mula-7b-a1b"))
    r = ParallelPlan.parse(spec).resolve(cfg, global_batch=8)
    assert r.plan.rebalance_params() == (50, 1.25) and r.spec() == spec
    assert r.placement is None and r.grid == (2, 2)
    placed = ExpertPlacement.broadcast(tuple(reversed(range(cfg.moe.num_experts))),
                                       cfg.num_layers)
    moved = r.with_placement(placed)
    assert moved.placement == placed and r.placement is None
    assert moved.layout_signature() == r.layout_signature()
    dense = treduced(tget("mula-1b"))
    with pytest.raises(ValueError) as te:
        ParallelPlan.parse("dp=2,rebalance=50:1.25").resolve(dense)
    with pytest.raises(ValueError) as je:
        JPlan.parse("dp=2,rebalance=50:1.25").validate_model(jreduced(jget("mula-1b")))
    assert str(te.value) == str(je.value)


def test_resolve_gives_the_grid():
    cfg = treduced(tget("mula-7b-a1b"))
    r = ParallelPlan.parse("dp=2,ep=2,opt=epso,tiles=128x512x512").resolve(cfg, global_batch=8)
    assert (r.world, r.grid) == (4, (2, 2))
    assert r.axis_sizes == {"data": 2, "ep": 2} and r.opt_shard == "epso"
    assert ParallelPlan().resolve(cfg).world == 1 and ParallelPlan().resolve(cfg).axis_sizes == {}
    with pytest.raises(ValueError, match="do not divide"):
        ParallelPlan.parse("dp=2,ep=2").resolve(cfg, global_batch=6)
    naive = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, moe_impl="naive"))
    with pytest.raises(NotImplementedError, match="moe_impl='naive'"):
        ParallelPlan.parse("ep=2").resolve(naive)


@pytest.mark.parametrize("spec,world,grid,sizes", [
    ("dp=2,pp=2", 4, (2, 1, 1, 2), {"data": 2, "pp": 2}),
    ("dp=2,pp=2,ep=2,schedule=gpipe,impl=masked,mb=4", 8, (2, 2, 1, 2),
     {"data": 2, "pp": 2, "ep": 2}),
    ("pp=4,opt=epso", 4, (1, 1, 1, 4), {"pp": 4})])
def test_resolve_takes_pp(spec, world, grid, sizes):
    """A pp axis resolves (it was refused before pipeline parallelism was
    ported): world dp * pp * ep * tp, the grid (dp, ep, tp, pp) for
    ``spawn``, the batch split over dp * ep alone, the checkpoint layout
    and the ParallelConfig (stages, schedule, impl, microbatches) the JAX
    ``ResolvedPlan``'s."""
    cfg = treduced(tget("mula-7b-a1b"), layers=4)
    r = ParallelPlan.parse(spec).resolve(cfg, global_batch=8)
    assert (r.world, r.grid, r.batch_ranks, r.axis_sizes) == (world, grid, grid[0] * grid[1],
                                                              sizes)
    j = JResolved(plan=JPlan.parse(spec))
    assert r.layout_signature() == j.layout_signature() and r.spec() == j.spec()
    got, want = r.parallel_config(), j.parallel_config()
    for k in ("microbatches", "pp_stages", "pp_schedule", "pp_impl", "optimizer_sharding",
              "opt_overlap", "moe_dispatch", "remat_policy"):
        assert getattr(got, k) == getattr(want, k), k


def test_resolve_refuses_what_pp_refuses():
    """What stays refused with a pp axis: a non-uniform stack (the hybrid
    arch, the JAX step's ValueError) and a rebalance= policy (the JAX plan's
    NotImplementedError, same text). The all-to-all Stage 1 resolves under
    pp, as the JAX plan takes it (a stage runs the one-device dispatch),
    with dropless dispatch and a tp axis too; outside pp those two still
    refuse it, as the JAX MoE block does."""
    from repro.configs.base import ParallelConfig as JParallel, TrainConfig as JTrain
    from repro.train import make_train_step as jmake_train_step
    hyb, jhyb = (red(get("zamba2-7b"), layers=4) for get, red in ((tget, treduced),
                                                                   (jget, jreduced)))
    with pytest.raises(ValueError) as te:
        ParallelPlan.parse("pp=2").resolve(hyb)
    with pytest.raises(ValueError) as je:
        jmake_train_step(jhyb, JParallel(pp_stages=2), JTrain())
    assert str(te.value) == str(je.value)
    moe, jmoe = (red(get("mula-7b-a1b"), layers=4) for get, red in ((tget, treduced),
                                                                     (jget, jreduced)))
    with pytest.raises(NotImplementedError) as te:
        ParallelPlan.parse("pp=2,ep=2,rebalance=10:1.2").resolve(moe)
    with pytest.raises(NotImplementedError) as je:
        JPlan.parse("pp=2,ep=2,rebalance=10:1.2").validate_model(jmoe)
    assert str(te.value) == str(je.value)
    a2a = dataclasses.replace(moe, moe=dataclasses.replace(moe.moe, stage1="a2a"))
    assert ParallelPlan.parse("pp=2,ep=2").resolve(a2a).grid == (1, 2, 1, 2)
    dropless = dataclasses.replace(a2a, moe=dataclasses.replace(a2a.moe, dispatch="dropless"))
    assert ParallelPlan.parse("pp=2,ep=2,tp=2").resolve(dropless).world == 8
    with pytest.raises(ValueError, match="does not compose with stage1='a2a'"):
        ParallelPlan.parse("ep=2").resolve(dropless)
    with pytest.raises(NotImplementedError, match="expert-TP"):
        ParallelPlan.parse("ep=2,tp=2").resolve(a2a)
