"""PyTorch port, live EP rebalancing on a dp x ep process grid (CPU ranks
over gloo, ``parallel.spawn``), and the placement in checkpoints.

* A train step after ``apply_placement`` on dp = 1 x ep = 2 and dp = 2 x
  ep = 2 grids, in 'none', 'so' and 'epso' ('ring'), at top 2, dropless:
  loss, ce, grad norm, clip scale, lr, moe_counts and moe_drops equal to
  the unplaced step's (``torch.equal``) for three steps with clipping on;
  the moved tiles equal the whole init params permuted on one process; the
  state after the steps (params, master, m, v) equals the unplaced run's
  moved to the same placement.
* A checkpoint written by the port under a placement restores in the JAX
  ``Checkpointer`` with the same ``restored_placement``, and the reverse;
  model-only files hold the expert stacks in global-id order.
* Launcher runs (``launch.train.run``) on a dp = 2 x ep = 2 'epso' grid,
  reduced Mula-7B-A1B, dropless: ``--rebalance-force-at 3`` gives one event
  and the unbalanced run's losses and grad norms bit for bit; a resume
  from the step-5 checkpoint (placed arrays, the MANIFEST's placement)
  continues bit-identically, and the JAX ``Checkpointer`` reads that
  checkpoint with its placement; a hard failure at step 8 that rolls back
  across an event at step 6 re-syncs the live placement to the restored
  (identity) one and finishes bit-identically; a windowed policy from the
  plan's ``rebalance=`` token moves too.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.data import ByteTokenizer  # noqa: E402
from repro.parallel import placement as jpl  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.parallel import spawn  # noqa: E402
from repro_torch.parallel import placement as tpl  # noqa: E402
from repro_torch.train import TrainState, init_state  # noqa: E402
from repro_torch.tree import keyed_leaves  # noqa: E402

from torch_parity import batch_pair  # noqa: E402

F32 = dict(param_dtype="float32", compute_dtype="float32", grad_reduce_dtype="float32")
RUNS = [("none", "off"), ("so", "off"), ("epso", "ring")]


def _moe_cfg():
    tc = treduced(tget("mula-7b-a1b"), d_model=64, vocab=128)
    return dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, dispatch="dropless"))


@pytest.mark.parametrize("dp,ep", [(1, 2), (2, 2)])
def test_placed_grid_step_bit_identical(dp, ep):
    tc = _moe_cfg()
    assert (tc.moe.num_experts, tc.moe.experts_per_token) == (4, 2)
    train = TrainConfig(**F32, lr_peak=1e-3, lr_min=1e-4, warmup_steps=1, total_steps=3,
                        grad_clip=0.05)
    batches = [batch_pair(20 + s, vocab=tc.vocab_size)[1] for s in range(3)]
    # every rank's experts split across both EP ranks, each layer its own row
    rows = ((2, 0, 3, 1), (1, 3, 0, 2))
    res = spawn(ranks.placement_rank, dp * ep, args=(tc, train, RUNS, batches, rows),
                device="cpu", timeout_s=300, grid=(dp, ep))
    for rank, r in enumerate(res):
        for run in RUNS:
            out = r[run]
            where = (dp, ep, rank, run)
            assert out["tiles_differ"] == [] and out["sent"] > 0, where
            assert any(m["clip_scale"] < 1 for m in out["unplaced"]), where
            for s, (a, b) in enumerate(zip(out["unplaced"], out["placed"])):
                assert sorted(a) == sorted(b), where
                for k in a:
                    assert torch.equal(a[k], b[k]), (where, s, k, a[k], b[k])
            assert out["state_differ"] == [], (where, out["state_differ"])
        # the modes' losses agree to rounding; the placement changes none
        for run in RUNS[1:]:
            np.testing.assert_allclose(
                [float(m["loss"]) for m in r[run]["placed"]],
                [float(m["loss"]) for m in r[RUNS[0]]["placed"]], rtol=1e-5)


# ---------------------------------------------------------------------------
# the placement in the MANIFEST, both ways with the JAX Checkpointer
# ---------------------------------------------------------------------------

def _jax_state():
    jc = jreduced(jget("mula-7b-a1b"), d_model=64)
    s = jinit_state(jax.random.PRNGKey(3), jc, JTrain(param_dtype="float32"))
    return s._replace(opt=s.opt._replace(step=jnp.asarray(7, jnp.int32),
                                         m=jax.tree.map(lambda x: x * 0.5, s.opt.master)))


def _port_from_jax(js):
    tc = treduced(tget("mula-7b-a1b"), d_model=64)
    host = jax.tree.map(np.asarray, js)
    return TrainState(params_from_jax(host.params, tc, device="cpu"),
                      opt_state_from_jax(host.opt, device="cpu"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_placed_checkpoint_interoperates_with_jax(tmp_path, writer):
    rows = ((3, 1, 0, 2), (0, 2, 3, 1))
    tpl_placed, jpl_placed = tpl.ExpertPlacement(2, 4, rows), jpl.ExpertPlacement(2, 4, rows)
    js = _jax_state()
    if writer == "port":
        ck = Checkpointer(str(tmp_path))
        ck.placement = tpl_placed
        ck.save(_port_from_jax(js), 5)
        jck = JCheckpointer(str(tmp_path))
        restored, step = jck.restore(_jax_state()._replace(params=jax.tree.map(
            jnp.zeros_like, js.params)))
        assert step == 5 and jck.restored_placement == jpl_placed
        for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(restored),
                                  jax.tree_util.tree_leaves_with_path(js)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), jax.tree_util.keystr(p)
    else:
        JCheckpointer(str(tmp_path), interval=5, placement=jpl_placed).save(js, 5)
        ck = Checkpointer(str(tmp_path))
        tmpl = init_state(treduced(tget("mula-7b-a1b"), d_model=64), TrainConfig(), seed=1,
                          device="cpu")
        restored, step = ck.restore(tmpl)
        assert step == 5 and ck.restored_placement == tpl_placed
        for (k, a), (_, b) in zip(keyed_leaves(restored), keyed_leaves(_port_from_jax(js))):
            assert torch.equal(a, b), k
    # without a placement nothing is written, and restore gives None
    Checkpointer(str(tmp_path / "plain")).save(_port_from_jax(js), 3)
    ck = Checkpointer(str(tmp_path / "plain"))
    ck.restore(_port_from_jax(js))
    assert ck.restored_placement is None
    jck = JCheckpointer(str(tmp_path / "plain"))
    jck.restore(js)
    assert jck.restored_placement is None


# ---------------------------------------------------------------------------
# the launcher's rebalance loop on a 2 x 2 grid
# ---------------------------------------------------------------------------

KW = dict(steps=10, batch=4, seq=32, d_model=64, ckpt_interval=5, log_every=100,
          device="cpu", moe_dispatch="dropless", parallel="dp=2,ep=2", opt_shard="epso")


def _manifest(out, step):
    for slot in ("ckpt-1", "ckpt-2"):
        path = os.path.join(out, "ckpt", slot, "MANIFEST.json")
        if os.path.exists(path):
            with open(path) as f:
                m = json.load(f)
            if m.get("valid") and m["step"] == step:
                return m
    raise AssertionError(f"no valid checkpoint at step {step} in {out}")


def _summary(out):
    with open(os.path.join(out, "summary.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("rebalance")
    out = {"root": root}
    out["static"] = tlaunch.run("mula-7b-a1b", out=str(root / "static"), **KW)
    out["forced"] = tlaunch.run("mula-7b-a1b", out=str(root / "forced"), rebalance_force_at=3,
                                **KW)
    # a resume from the forced run's step-5 checkpoint, same schedule
    shutil.copytree(root / "forced" / "ckpt", root / "resumed" / "ckpt")
    out["resumed"] = tlaunch.run("mula-7b-a1b", out=str(root / "resumed"),
                                 rebalance_force_at=3, **KW)
    # a failure at step 8 rolls back to step 5, before the event at step 6
    out["rollback"] = tlaunch.run("mula-7b-a1b", out=str(root / "rollback"),
                                  rebalance_force_at=6, inject_hard_at=8, **KW)
    # a windowed policy from the plan's token: every 2 steps, any imbalance
    out["windowed"] = tlaunch.run("mula-7b-a1b", out=str(root / "windowed"),
                                  **{**KW, "parallel": "dp=2,ep=2,rebalance=2:1.0"})
    return out


def _same_steps(a, b, keys=("loss", "grad_norm", "lr", "moe_drops", "moe_load_max")):
    assert [h["step"] for h in a] == [h["step"] for h in b]
    for x, y in zip(a, b):
        assert {k: x[k] for k in keys} == {k: y[k] for k in keys}, x["step"]


def test_forced_rebalance_moves_once_bit_identically(runs):
    static, forced = runs["static"], runs["forced"]
    _same_steps(forced, static)
    assert [h["step"] for h in forced if h.get("rebalanced")] == [3]
    assert not any("moe_imbalance" in h for h in static)
    assert all(h["moe_imbalance"] >= 1.0 for h in forced)
    s = _summary(runs["root"] / "forced")
    assert (s["rebalances"], s["rebalance"]) == (1, None)
    assert s["final_imbalance"] == forced[-1]["moe_imbalance"]
    assert _summary(runs["root"] / "static")["rebalances"] == 0
    placement = _manifest(runs["root"] / "forced", 5)["placement"]
    assert placement is not None and placement["perm"] != [[0, 1, 2, 3]] * 2


def test_resume_after_the_event_is_bit_identical(runs):
    """The resumed run takes the MANIFEST's placement without moving and
    continues the forced run's steps 6-9 bit for bit; the JAX Checkpointer
    reads that checkpoint's placement."""
    resumed = runs["resumed"]
    assert [h["step"] for h in resumed] == [6, 7, 8, 9]
    assert list(resumed) == [h for h in runs["forced"] if h["step"] >= 6]
    placement = _manifest(runs["root"] / "forced", 5)["placement"]
    assert _manifest(runs["root"] / "resumed", 5)["placement"] == placement
    jc = jreduced(jget("mula-7b-a1b"), d_model=64, vocab=ByteTokenizer.VOCAB)
    jck = JCheckpointer(str(runs["root"] / "forced" / "ckpt"))
    template = jinit_state(jax.random.PRNGKey(0), jc, JTrain(param_dtype="float32"))
    assert jck.restore(template)[1] == 5
    assert jck.restored_placement == jpl.ExpertPlacement.from_manifest(placement)


def test_rollback_across_the_event_resyncs_the_placement(runs):
    rollback = runs["rollback"]
    assert rollback.relaunches == 1
    _same_steps(rollback, runs["static"])
    assert [h["step"] for h in rollback if h.get("rebalanced")] == [6]
    # the event ran twice: before the failure and on the replay
    assert _summary(runs["root"] / "rollback")["rebalances"] == 2
    assert "placement" not in _manifest(runs["root"] / "rollback", 5)


def test_model_only_files_hold_global_order(runs, tmp_path):
    """A model-only file has no MANIFEST, so its expert stacks are written
    in global-id order under any placement: the forced run's step-5 file
    (placed since step 3, gathered whole from the 2 x 2 grid) equals the
    unbalanced run's bit for bit; on one device a moved state's params,
    saved and restored, are the unplaced params."""
    with np.load(runs["root"] / "forced" / "ckpt" / "model-00000005.npz") as a, \
            np.load(runs["root"] / "static" / "ckpt" / "model-00000005.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    tc = _moe_cfg()
    L, E = tc.num_layers, tc.moe.num_experts
    state = init_state(tc, TrainConfig(**F32), seed=0, device="cpu")
    want = {k: t.clone() for k, t in keyed_leaves(state.params)}
    placed = tpl.ExpertPlacement(L, E, ((2, 0, 3, 1), (1, 3, 0, 2)))
    tpl.apply_placement(state, tpl.ExpertPlacement.identity(L, E), placed)
    moved = [k for k, t in keyed_leaves(state.params) if not torch.equal(t, want[k])]
    assert sorted(k.rsplit("'", 2)[-2] for k in moved) == ["down", "gate", "up"], moved
    ck = Checkpointer(str(tmp_path))
    ck.placement = placed
    ck.save_model_only(state.params, 4)
    template = init_state(tc, TrainConfig(**F32), seed=1, device="cpu").params
    ck.restore_model_only(template, 4)
    for k, t in keyed_leaves(template):
        assert torch.equal(t, want[k]), k


def test_placed_checkpoint_resumes_only_under_a_plan(runs, tmp_path):
    """The placement rides on the run's parallel plan: a run without
    ``--parallel`` refuses the forced run's placed step-5 checkpoint
    before any step (under the plan it was written with, it resumes:
    ``test_resume_after_the_event_is_bit_identical``)."""
    kw = {k: v for k, v in KW.items() if k not in ("parallel", "opt_shard")}
    shutil.copytree(runs["root"] / "forced" / "ckpt", tmp_path / "plain" / "ckpt")
    with pytest.raises(ValueError, match="resume it under the plan it was written with"):
        tlaunch.run("mula-7b-a1b", out=str(tmp_path / "plain"), **kw)
    assert not (tmp_path / "plain" / "history.json").exists()


def test_windowed_policy_rebalances(runs):
    windowed = runs["windowed"]
    _same_steps(windowed, runs["static"])
    s = _summary(runs["root"] / "windowed")
    assert s["rebalance"] == "2:1.0" and s["rebalances"] >= 1
    assert s["rebalances"] == sum(bool(h.get("rebalanced")) for h in windowed)
