"""PyTorch port, fault tolerance (paper §4): the JAX package's
``test_ft.py`` loop cases on ``repro_torch.ft``, with the state kinds the
port meets: numpy leaves a step replaces (as in the JAX tests) and torch
tensors a step updates in place (as the port's AdamW does). A failure
before the first checkpoint must restart from the true initial state, not
from tensors that already carry the failed steps' updates."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.ft import (ClusterManager, NaNMonitor, NodeFailure,  # noqa: E402
                            restore_into, run_with_failure_handling, snapshot)
from repro_torch.optim import AdamWState  # noqa: E402
from repro_torch.train import TrainState  # noqa: E402


def _state(kind):
    if kind == "numpy":
        return {"p": {"w": np.zeros(2)}}
    w = torch.zeros(2)                                    # params alias the master weights
    return TrainState({"w": w}, AdamWState(torch.zeros((), dtype=torch.int32), {"w": w},
                                           {"w": torch.zeros(2)}, {"w": torch.zeros(2)}))


def _w(state):
    return state["p"]["w"] if isinstance(state, dict) else state.params["w"]


def _add_one(state):
    """One step: a new numpy state, or the torch state updated in place."""
    if isinstance(state, dict):
        return {"p": {"w": state["p"]["w"] + 1.0}}
    state.opt.master["w"].add_(1.0)
    state.opt.m["w"].add_(0.5)
    return TrainState(state.opt.master, state.opt._replace(step=state.opt.step + 1))


def test_nan_monitor_flags_rank():
    mon = NaNMonitor()
    mon.check([1.0, 2.0, 0.5])
    with pytest.raises(NodeFailure) as e:
        mon.check([1.0, float("nan"), 0.5])
    assert e.value.node_id == 1 and e.value.kind == "soft"
    with pytest.raises(NodeFailure):
        mon.check([1.0, 1.0], per_rank_grad_norms=[1.0, float("inf")])


def test_cluster_replace_uses_buffers():
    cm = ClusterManager(n_active=4, n_buffer=2)
    assert cm.replace(2).node_id == 4
    assert [n.node_id for n in cm.active] == [0, 1, 4, 3]
    cm.replace(0)
    assert not cm.buffers
    with pytest.raises(RuntimeError):
        cm.replace(1)


@pytest.mark.parametrize("kind", ["numpy", "torch_in_place"])
def test_run_recovers_from_soft_and_hard_failures(tmp_path, kind):
    """A hard failure at step 7 and a soft (NaN) one at step 12 are both
    recovered through buffer nodes and the last valid checkpoint; the end
    state is the uninterrupted run's."""
    ck = Checkpointer(str(tmp_path), interval=5)
    cluster = ClusterManager(n_active=4, n_buffer=2)
    calls = {"hard_done": False, "soft_done": False}

    def train_one_step(state, step):
        if step == 7 and not calls["hard_done"]:
            calls["hard_done"] = True
            raise NodeFailure(3, "hard")
        state = _add_one(state)
        if step == 12 and not calls["soft_done"]:
            calls["soft_done"] = True
            return state, {"per_rank_losses": [1.0, float("nan")]}
        return state, {"loss": 1.0, "per_rank_losses": [1.0, 1.0]}

    state, step, relaunches = run_with_failure_handling(
        train_one_step, state=_state(kind), checkpointer=ck, cluster=cluster, num_steps=20)
    assert step == 20 and relaunches == 2
    assert cluster.replaced == [(3, 4), (1, 5)]
    assert calls["hard_done"] and calls["soft_done"]
    assert float(_w(state)[0]) == 20.0
    if kind != "numpy":
        assert int(state.opt.step) == 20 and float(state.opt.m["w"][0]) == 10.0


@pytest.mark.parametrize("kind", ["numpy", "torch_in_place"])
def test_failure_before_first_checkpoint_resets_to_initial(tmp_path, kind):
    """With no valid checkpoint yet, the restart begins from the initial
    state: steps 0-1 replayed, not stacked (4.0, not 6.0), although the
    in-place step already wrote them into the state's tensors."""
    ck = Checkpointer(str(tmp_path), interval=5)
    cluster = ClusterManager(n_active=2, n_buffer=1)
    calls = {"done": False}

    def train_one_step(state, step):
        if step == 2 and not calls["done"]:
            calls["done"] = True
            raise NodeFailure(0, "hard")
        return _add_one(state), {"loss": 1.0}

    state0 = _state(kind)
    state, step, relaunches = run_with_failure_handling(
        train_one_step, state=state0, checkpointer=ck, cluster=cluster, num_steps=4)
    assert step == 4 and relaunches == 1
    assert float(_w(state)[0]) == 4.0
    if kind != "numpy":
        assert _w(state).data_ptr() == _w(state0).data_ptr()
        assert float(state.opt.m["w"][0]) == 2.0 and int(state.opt.step) == 4


def test_fallback_writes_into_the_live_state(tmp_path):
    """A caller's ``fallback`` replaces the host copy; it gets the live
    state, and the loop restarts at ``start_step`` from what it returns."""
    seen = []

    def fallback(live):
        seen.append(float(_w(live)[0]))
        return restore_into(live, snapshot(_state("torch_in_place")))

    calls = {"done": False}

    def train_one_step(state, step):
        if step == 4 and not calls["done"]:
            calls["done"] = True
            raise NodeFailure(1, "hard")
        return _add_one(state), {"loss": 1.0}

    state, step, _ = run_with_failure_handling(
        train_one_step, state=_state("torch_in_place"), start_step=2,
        checkpointer=Checkpointer(str(tmp_path), interval=100),
        cluster=ClusterManager(n_active=2, n_buffer=1), num_steps=6, fallback=fallback)
    assert seen == [2.0] and step == 6
    assert float(_w(state)[0]) == 4.0          # restarted at step 2 from zeros


def test_snapshot_is_a_host_copy():
    s = _state("torch_in_place")
    snap = snapshot(s)
    assert sorted(snap) == sorted([".params['w']", ".opt.step", ".opt.master['w']",
                                   ".opt.m['w']", ".opt.v['w']"])
    _add_one(s)
    assert float(snap[".params['w']"][0]) == 0.0
    restore_into(s, snap)
    assert float(_w(s)[0]) == 0.0 and int(s.opt.step) == 0
    with pytest.raises(KeyError):
        restore_into(s, {})
