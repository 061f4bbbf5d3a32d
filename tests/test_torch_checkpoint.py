"""PyTorch port, checkpointing (paper §4): ``repro_torch.checkpoint``
against the JAX package's ``repro.checkpoint``. The JAX package's cases
(bit-exact roundtrip, dual rotation, crash mid-write, model-only, interval
hooks, DP-scattered writers) on torch states; the files readable both
ways (a JAX-written ``TrainState`` checkpoint restores into the port's
template bit for bit, and the reverse; the MANIFEST checksums agree);
restore writes into the template's tensors in place, so float32 params go
on sharing their tensors with the master weights."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro_torch.checkpoint import (Checkpointer, broadcast_params,  # noqa: E402
                                    dp_scattered_writers, load_pytree, save_pytree)
from repro_torch.configs import TrainConfig, get_config, reduced  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.parallel import ep_shard, replicated_leaves, spawn  # noqa: E402
from repro_torch.parallel.sharding import param_placements  # noqa: E402
from repro_torch.train import TrainState, init_state  # noqa: E402
from repro_torch.tree import keyed_leaves, leaves, leaves_with_path  # noqa: E402


def state_like(v=0.0):
    return {"params": {"w": torch.full((4, 4), float(v)), "b": torch.arange(3.0)},
            "step": torch.tensor(int(v), dtype=torch.int32)}


def _equal(a, b):
    ka, kb = keyed_leaves(a), keyed_leaves(b)
    assert [k for k, _ in ka] == [k for k, _ in kb]
    for (k, x), (_, y) in zip(ka, kb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def _cfgs(name="mula-7b-a1b"):
    return jreduced(jget(name), d_model=64), reduced(get_config(name), d_model=64)


def _jax_state(name="mula-7b-a1b", bump=0.0):
    """A JAX TrainState (float32) whose moments and step are not zero."""
    jc, _ = _cfgs(name)
    s = jinit_state(jax.random.PRNGKey(3), jc, JTrain(param_dtype="float32"))
    opt = s.opt._replace(step=jnp.asarray(7, jnp.int32),
                         m=jax.tree.map(lambda x: x * 0.5 + bump, s.opt.master),
                         v=jax.tree.map(lambda x: x * x + 1e-3, s.opt.master))
    return s._replace(opt=opt)


def _port_template(name="mula-7b-a1b"):
    _, tc = _cfgs(name)
    return init_state(tc, TrainConfig(), seed=1, device="cpu")


def _port_from_jax(js, name="mula-7b-a1b"):
    _, tc = _cfgs(name)
    host = jax.tree.map(np.asarray, js)
    return TrainState(params_from_jax(host.params, tc, device="cpu"),
                      opt_state_from_jax(host.opt, device="cpu"))


def _aliased(state):
    return all(p.data_ptr() == m.data_ptr()
               for p, m in zip(leaves(state.params), leaves(state.opt.master)))


def test_roundtrip_bit_exact(tmp_path):
    s = state_like(3.5)
    save_pytree(s, str(tmp_path / "x.npz"))
    s2 = load_pytree(state_like(), str(tmp_path / "x.npz"))
    _equal(s, s2)


def test_roundtrip_train_state_bit_exact(tmp_path):
    src = _port_from_jax(_jax_state())
    save_pytree(src, str(tmp_path / "s"))            # np.savez appends .npz
    assert os.path.exists(tmp_path / "s.npz")
    _equal(src, load_pytree(_port_template(), str(tmp_path / "s")))


def test_dual_rotation(tmp_path):
    ck = Checkpointer(str(tmp_path), interval=1)
    ck.save(state_like(1), 1000)
    ck.save(state_like(2), 2000)
    ck.save(state_like(3), 3000)     # overwrites the oldest (step 1000)
    assert sorted(ck._slot_step(s) for s in ck.slots) == [2000, 3000]
    restored, step = ck.restore(state_like())
    assert step == 3000
    assert float(restored["params"]["w"].max()) == 3.0


def test_crash_during_checkpoint_keeps_valid_one(tmp_path):
    """A failure while writing one slot leaves the other restorable."""
    ck = Checkpointer(str(tmp_path), interval=1)
    ck.save(state_like(1), 1000)
    ck.save(state_like(2), 2000)
    ck.save(state_like(9), 3000, fail_after_write=True)   # no MANIFEST
    restored, step = ck.restore(state_like())
    assert step == 2000
    assert float(restored["params"]["w"].max()) == 2.0
    assert Checkpointer(str(tmp_path / "empty")).restore(state_like()) == (None, -1)


def test_model_only_persistent(tmp_path):
    ck = Checkpointer(str(tmp_path), interval=10, model_only_interval=10)
    params = state_like(5)["params"]
    for step in (10, 20, 30):
        ck.save_model_only(params, step)
    assert ck.list_model_only() == ["model-00000010.npz", "model-00000020.npz",
                                    "model-00000030.npz"]
    p = ck.restore_model_only(state_like()["params"], 20)
    assert torch.equal(p["w"], params["w"])


def test_model_only_is_smaller_than_full(tmp_path):
    """float32 params and AdamW (master, m, v): the full checkpoint is 4x
    the model-only one (the JAX package's test has bf16 params, which the
    port refuses to write, and 7x)."""
    params = {"w": torch.zeros((64, 64))}
    full = {"params": params, "master": params, "m": {"w": torch.zeros((64, 64))},
            "v": {"w": torch.zeros((64, 64))}}
    save_pytree(params, str(tmp_path / "model.npz"))
    save_pytree(full, str(tmp_path / "full.npz"))
    ratio = os.path.getsize(tmp_path / "full.npz") / os.path.getsize(tmp_path / "model.npz")
    assert 3.9 < ratio <= 4.0


def test_bf16_leaf_is_refused(tmp_path):
    with pytest.raises(ValueError, match="bfloat16"):
        save_pytree({"w": torch.zeros(4, dtype=torch.bfloat16)}, str(tmp_path / "x.npz"))


def test_maybe_save_intervals(tmp_path):
    ck = Checkpointer(str(tmp_path), interval=10, model_only_interval=5)
    for step in range(1, 21):
        ck.maybe_save(state_like(step), state_like(step)["params"], step)
    assert len(ck.list_model_only()) == 4      # 5, 10, 15, 20
    _, step = ck.restore(state_like())
    assert step == 20


def test_dp_scattered_writers():
    """Shard m is written by DP rank m % DP: spread, not concentrated."""
    assert list(dp_scattered_writers(num_model_shards=12, dp_size=12).values()) == \
        list(range(12))
    loads = np.bincount(list(dp_scattered_writers(num_model_shards=12, dp_size=4).values()))
    assert loads.max() - loads.min() == 0


@pytest.mark.parametrize("name", ["mula-7b-a1b", "mula-1b"])
def test_jax_checkpoint_restores_into_port(tmp_path, name):
    """The JAX Checkpointer writes a TrainState; the port restores it into a
    template of other values, bit for bit against the converted state."""
    js = _jax_state(name)
    JCheckpointer(str(tmp_path), interval=5).save(js, 5)
    tmpl = _port_template(name)
    restored, step = Checkpointer(str(tmp_path)).restore(tmpl)
    assert step == 5 and restored is tmpl
    _equal(_port_from_jax(js, name), restored)
    assert int(restored.opt.step) == 7


@pytest.mark.parametrize("name", ["mula-7b-a1b", "mula-1b"])
def test_port_checkpoint_restores_in_jax(tmp_path, name):
    js = _jax_state(name, bump=0.25)
    src = _port_from_jax(js, name)
    Checkpointer(str(tmp_path)).save(src, 10)
    Checkpointer(str(tmp_path)).save_model_only(src.params, 10)
    jck = JCheckpointer(str(tmp_path))
    restored, step = jck.restore(_jax_state(name))        # a template of other values
    assert step == 10
    a, b = jax.tree_util.tree_leaves_with_path(restored), jax.tree_util.tree_leaves_with_path(js)
    assert len(a) == len(b) == len(keyed_leaves(src))
    for (pa, x), (_, y) in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        assert np.array_equal(np.asarray(x), np.asarray(y)), jax.tree_util.keystr(pa)
    p = jck.restore_model_only(js.params, 10)
    for x, y in zip(jax.tree.leaves(p), jax.tree.leaves(js.params)):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_manifest_checksum_matches_jax(tmp_path):
    js = _jax_state()
    JCheckpointer(str(tmp_path / "jax")).save(js, 5)
    Checkpointer(str(tmp_path / "port")).save(_port_from_jax(js), 5)
    mj, mt = (json.loads((tmp_path / d / "ckpt-1" / "MANIFEST.json").read_text())
              for d in ("jax", "port"))
    assert sorted(mt) == sorted(mj) == ["checksum", "step", "time", "valid"]
    assert (mt["checksum"], mt["step"], mt["valid"]) == (mj["checksum"], 5, True)


def test_restore_writes_in_place_and_keeps_the_alias(tmp_path):
    """Each leaf keeps its tensor (data_ptr), and float32 params remain the
    master weights' tensors, so the next step runs on the restored values."""
    src = _port_from_jax(_jax_state())
    ck = Checkpointer(str(tmp_path))
    ck.save(src, 3)
    tmpl = _port_template()
    assert _aliased(tmpl)
    ptrs = [t.data_ptr() for _, t in keyed_leaves(tmpl)]
    restored, _ = ck.restore(tmpl)
    assert [t.data_ptr() for _, t in keyed_leaves(restored)] == ptrs
    assert _aliased(restored)
    _equal(src, restored)


def test_restore_checks_keys_and_shapes(tmp_path):
    save_pytree(state_like(1), str(tmp_path / "x.npz"))
    with pytest.raises(KeyError, match="'extra'"):
        load_pytree({**state_like(), "extra": torch.zeros(2)}, str(tmp_path / "x.npz"))
    bad = state_like()
    bad["params"]["w"] = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="shape"):
        load_pytree(bad, str(tmp_path / "x.npz"))


@pytest.mark.parametrize("extra,placed", [
    ({"placement": {"num_layers": 1, "num_experts": 2, "perm": [[1, 0]]}}, True),
    ({"plan": {"spec": "dp=2", "layout": []}}, False)])
def test_manifest_placement_raises_plan_is_ignored(tmp_path, extra, placed):
    """A MANIFEST's placement (the JAX format) round-trips into
    ``restored_placement`` (it raised before expert placement was ported);
    a plan is ignored by a Checkpointer without one."""
    from repro_torch.parallel.placement import ExpertPlacement
    ck = Checkpointer(str(tmp_path))
    slot = ck.save(state_like(2), 4)
    man = os.path.join(slot, "MANIFEST.json")
    with open(man) as f:
        m = json.load(f)
    with open(man, "w") as f:
        json.dump({**m, **extra}, f)
    restored, step = ck.restore(state_like())
    assert step == 4
    _equal(restored, state_like(2))
    if placed:
        assert ck.restored_placement == ExpertPlacement(1, 2, ((1, 0),))
        again = Checkpointer(str(tmp_path / "again"))
        again.placement = ck.restored_placement
        with open(os.path.join(again.save(state_like(3), 5), "MANIFEST.json")) as f:
            assert json.load(f)["placement"] == extra["placement"]
    else:
        assert ck.restored_placement is None


def test_broadcast_params():
    """Without a group the identity; over 2 gloo ranks whose leaves differ,
    rank 0's value of every replicated leaf reaches rank 1, and each rank
    keeps its own tiles: the expert slices and the tables' vocab rows."""
    _, tc = _cfgs()
    params = init_state(tc, TrainConfig(), seed=0, device="cpu").params
    assert broadcast_params(params) is params
    place = param_placements(params, {"ep": 2})
    out = spawn(ranks.broadcast_rank, 2, args=(params,), device="cpu", timeout_s=120)
    for r, got in enumerate(out):
        mine = ep_shard(params, r, 2)
        for (path, g), keep, m in zip(leaves_with_path(got), replicated_leaves(place),
                                      leaves(mine)):
            assert torch.equal(g, m if keep else m + r), (r, path)
    tiles = {p for (p, _), keep in zip(leaves_with_path(params), replicated_leaves(place))
             if not keep}
    assert {"embed/table", "layers/moe/gate"} <= tiles


def test_plan_in_the_manifest_and_its_refusal_match_jax(tmp_path):
    """With a plan, both packages write the same MANIFEST ``plan`` (spec and
    layout); a checkpointer planned otherwise refuses to restore it with the
    JAX message unless ``on_plan_mismatch='reshard'``; a bad
    ``on_plan_mismatch`` is the JAX ValueError."""
    from repro.parallel.plan import ParallelPlan as JPlan, ResolvedPlan as JResolved
    from repro_torch.parallel import ParallelPlan
    _, tc = _cfgs()
    saved, other = "dp=2,ep=2,opt=epso", "dp=4,opt=so"
    roots = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    JCheckpointer(str(roots["jax"]), plan=JResolved(plan=JPlan.parse(saved))).save(
        {"w": np.zeros(3, np.float32)}, 4)
    Checkpointer(str(roots["port"]), plan=ParallelPlan.parse(saved).resolve(tc)).save(
        {"w": torch.zeros(3)}, 4)
    mj, mt = (json.loads((r / "ckpt-1" / "MANIFEST.json").read_text()) for r in roots.values())
    assert mt["plan"] == mj["plan"]
    errors = {}
    for side, root in roots.items():
        plan = ParallelPlan.parse(other).resolve(tc) if side == "port" else \
            JResolved(plan=JPlan.parse(other))
        ck = (Checkpointer if side == "port" else JCheckpointer)(str(root), plan=plan)
        tmpl = {"w": torch.ones(3)} if side == "port" else {"w": np.ones(3, np.float32)}
        with pytest.raises(ValueError) as e:
            ck.restore(tmpl)
        errors[side] = str(e.value).replace(str(root), "ROOT")
        ck = (Checkpointer if side == "port" else JCheckpointer)(
            str(root), plan=plan, on_plan_mismatch="reshard")
        assert ck.restore(tmpl)[1] == 4
    assert errors["port"] == errors["jax"]
    for cls in (Checkpointer, JCheckpointer):
        with pytest.raises(ValueError) as e:
            cls(str(tmp_path / "x"), on_plan_mismatch="ignore")
        errors[cls] = str(e.value)
    assert errors[Checkpointer] == errors[JCheckpointer]


def test_tp_checkpoint_restores_on_one_rank_and_on_dp2_so(tmp_path):
    """An ep = 2 x tp = 2 EPSO state (tp shards of attention and the expert
    stacks' d_ff, EPSO state shards over ('ep', 'tp')) saved through the
    grid Checkpointer holds whole arrays: it restores, resharding, on one
    rank and into dp = 2 'so' ranks with the same full master, m, v, step
    and params; a one-rank checkpoint restores on the tp grid, each rank
    its tiles."""
    from repro_torch.convert import opt_state_from_ranks, params_for_rank
    tc = reduced(get_config("mula-7b-a1b"), d_model=64, vocab=128, max_experts=8)
    kw = dict(device="cpu", timeout_s=120)
    tp_root, one_root = str(tmp_path / "tp"), str(tmp_path / "one")
    saved = spawn(ranks.grid_checkpoint_rank, 4, args=(tc, "ep=2,tp=2,opt=epso", tp_root, "save"),
                  grid=(1, 2, 2), **kw)
    want = opt_state_from_ranks([s.opt for s in saved], tc, dp=1, ep=2, tp=2, mode="epso")
    assert want["step"] == 7
    from repro_torch.parallel import as_grid
    from repro_torch.parallel.ep import EPGroup
    alone = as_grid(EPGroup(None, 0, 1, torch.device("cpu"), "gloo"))    # one rank, here
    for spec, grid in (("dp=2,opt=so", (2, 1)), ("dp=1", (1, 1))):
        back = spawn(ranks.grid_checkpoint_rank, 2, args=(tc, spec, tp_root, "restore"),
                     grid=grid, **kw) if grid[0] > 1 else \
            [ranks.grid_checkpoint_rank(alone, tc, spec, tp_root, "restore")]
        got = opt_state_from_ranks([r["state"].opt for r in back], tc, dp=grid[0], ep=1,
                                   mode="so" if grid[0] > 1 else "none")
        for r in back:
            assert "refusing to silently reshard" in r["error"] and r["step"] == 5
            for what in ("state", "model_only"):
                params = r[what].params if what == "state" else r[what]
                for path, p in leaves_with_path(params):
                    np.testing.assert_array_equal(p.numpy(), want["master"][path],
                                                  err_msg=f"{spec} {what} {path}")
        for what in ("master", "m", "v"):
            for path, ref in want[what].items():
                np.testing.assert_array_equal(got[what][path], ref, err_msg=f"{what} {path}")
    one = ranks.grid_checkpoint_rank(alone, tc, "dp=1", one_root, "save")
    back = spawn(ranks.grid_checkpoint_rank, 4, args=(tc, "ep=2,tp=2,opt=epso", one_root,
                                                      "restore"), grid=(1, 2, 2), **kw)
    got = opt_state_from_ranks([r["state"].opt for r in back], tc, dp=1, ep=2, tp=2, mode="epso")
    for what in ("master", "m", "v"):
        for path, ref in leaves_with_path(getattr(one.opt, what)):
            np.testing.assert_array_equal(got[what][path], ref.numpy(), err_msg=f"{what} {path}")
    for rank, r in enumerate(back):
        tiles = params_for_rank(one.params, tc, dp=1, ep=2, tp=2, rank=rank)
        for (path, p), (_, t) in zip(leaves_with_path(r["model_only"]), leaves_with_path(tiles)):
            np.testing.assert_array_equal(p.numpy(), t.numpy(), err_msg=f"rank {rank} {path}")
