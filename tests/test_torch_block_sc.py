"""PyTorch port, the 'block_sc' remat policy (the JAX package's
``block_remat``: the block rematerialised, the outputs of its collectives
saved, so the recompute does not run the block's TP/EP collectives again),
float32:

* three ``make_train_step`` steps of reduced Mula-7B-A1B and Mula-1B under
  'block_sc' against the JAX step under 'block_sc', atol = rtol = 1e-4
  (the JAX side's kernels in interpret mode, as in test_torch_train.py);
* 'block_sc' changes no arithmetic: ``loss_fn`` and every gradient, and
  the pipelined one-process step, bit for bit 'block''s on one device;
  through the launcher (``--sac block_sc``) the same history as 'block';
* on an ep = 2 x tp = 2 grid of CPU ranks over gloo one step's metrics
  and params bit for bit 'block''s, with fewer ``gloo:*`` calls by exactly
  the forward collectives that 'block''s recompute runs again. That
  recompute stops at the block's last saved activation
  (``torch.utils.checkpoint``'s early stop), the combine's inputs, so it
  re-runs the collectives before it: attention's tp all-reduce and the
  Stage 1's three all-gathers (weights, tokens, ids), four a layer and
  microbatch (the model has no shared expert). The tp all-reduce of the
  experts' output, the reduce-scatter, the aux all-reduce and the counts'
  all-gather come after it and run once in either policy.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.checkpoint import checkpoint  # noqa: E402

import jax  # noqa: E402

from repro.configs.base import ParallelConfig as JParallel  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.parallel.plan import use_kernel_plan  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from repro_torch.models import init_params, loss_fn  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.parallel import ep, spawn  # noqa: E402
from repro_torch.train import TrainState, init_state, make_train_step  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path, unflatten  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402
from test_torch_train import F32, PLAN, TOL, _cfgs  # noqa: E402
from torch_parity import assert_leaves_close, batch_pair  # noqa: E402

TRAIN = dict(seq_len=16, global_batch=4, warmup_steps=1, total_steps=10, lr_peak=1e-2,
             lr_min=1e-3, **F32)


@pytest.mark.parametrize("name", ["mula-7b-a1b", "mula-1b"])
def test_block_sc_steps_match_jax(name):
    jc, tc = _cfgs(name)
    jtrain, ttrain = JTrain(**TRAIN), TrainConfig(**TRAIN)
    jstate = jinit_state(jax.random.PRNGKey(0), jc, jtrain)
    tstate = TrainState(params_from_jax(jax.tree.map(np.asarray, jstate.params), tc,
                                        device="cpu"),
                        opt_state_from_jax(jax.tree.map(np.asarray, jstate.opt), device="cpu"))
    with use_kernel_plan(PLAN):
        jstep = jax.jit(jmake_train_step(jc, JParallel(remat_policy="block_sc"), jtrain))
        tstep = make_train_step(tc, ParallelConfig(remat_policy="block_sc"), ttrain)
        for i in range(3):
            jb, tb = batch_pair(20 + i)
            jstate, jm = jstep(jstate, jb)
            tstate, tm = tstep(tstate, tb)
            assert sorted(tm) == sorted(jm)
            for k in jm:
                np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), **TOL,
                                           err_msg=f"step {i} {k}")
    assert_leaves_close(dict(leaves_with_path(tstate.params)), jstate.params, "params")


@pytest.mark.parametrize("name", ["mula-7b-a1b", "mula-1b"])
def test_block_sc_is_block_bit_for_bit_on_one_device(name):
    """``loss_fn``'s value, metrics and every gradient, then two pipelined
    one-process steps (the stage forward's block remat), equal 'block''s
    exactly."""
    _, tc = _cfgs(name)
    params = init_params(tc, seed=1, device="cpu")
    _, tb = batch_pair(5)
    got = {}
    for sac in ("block", "block_sc"):
        leaf = [p.detach().clone().requires_grad_() for p in leaves(params)]
        loss, m = loss_fn(unflatten(params, leaf), tb, tc, sac=sac, compute_dtype=torch.float32)
        got[sac] = (loss, m, torch.autograd.grad(loss, leaf))
    (la, ma, ga), (lb, mb, gb) = got["block"], got["block_sc"]
    assert torch.equal(la, lb) and all(torch.equal(ma[k], mb[k]) for k in ma
                                       if torch.is_tensor(ma[k]))
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
    train = TrainConfig(**TRAIN)
    runs = {}
    for sac in ("block", "block_sc"):
        state = init_state(tc, train, seed=2, device="cpu")
        step = make_train_step(tc, ParallelConfig(pp_stages=2, microbatches=2,
                                                  remat_policy=sac), train)
        runs[sac] = []
        for i in range(2):
            state, m = step(state, batch_pair(30 + i)[1])
            runs[sac].append(m)
        runs[sac].append(leaves(state.params))
    for a, b in zip(runs["block"][:2], runs["block_sc"][:2]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(runs["block"][2], runs["block_sc"][2]))


def test_launcher_takes_block_sc(tmp_path):
    """``--sac block_sc`` through the launcher's config: the history of a
    one-device MoE run equals the same run's under 'block'."""
    kw = dict(device="cpu", steps=3, batch=2, seq=32, d_model=64, log_every=1)
    hist = {sac: run("mula-7b-a1b", sac=sac, out=str(tmp_path / sac), **kw)
            for sac in ("block", "block_sc")}
    assert len(hist["block"]) == 3 and "loss" in hist["block"][0]
    assert list(hist["block"]) == list(hist["block_sc"])


def test_block_sc_on_ep_tp_grid_saves_the_recomputed_collectives():
    _, tc = _cfgs("mula-7b-a1b")
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, dispatch="dropless"))
    assert tc.moe.num_shared_experts == 0 and tc.num_layers == 2
    train = TrainConfig(**dict(TRAIN, global_batch=2))
    params = init_params(tc, seed=0, device="cpu")
    t = torch.from_numpy(np.random.default_rng(7).integers(0, 128, (2, TRAIN["seq_len"] + 1)))
    batch = {"tokens": t[:, :-1].long(), "labels": t[:, 1:].long()}
    got = spawn(ranks.remat_collectives_rank, 4, device="cpu", timeout_s=240, grid=(1, 2, 2),
                args=(tc, train, params, adamw_init(params), batch, ("block", "block_sc")))
    saved = tc.num_layers * 1 * (1 + 3)      # layers x microbatches x (tp all-reduce + Stage 1)
    for r in got:
        block, sc = r["block"], r["block_sc"]
        assert all(torch.equal(block["metrics"][k], sc["metrics"][k]) for k in ranks.KEYS)
        assert all(torch.equal(block["params"][k], sc["params"][k]) for k in block["params"])
        assert sum(block["events"].values()) - sum(sc["events"].values()) == saved, \
            (block["events"], sc["events"])
        assert block["events"]["gloo:all_gather"] - sc["events"]["gloo:all_gather"] == \
            3 * tc.num_layers
        # each block's tape learned that its recompute replays those four
        assert sc["replayed"] == [1 + 3], sc["replayed"]


class _Twice(torch.autograd.Function):
    """A stand-in collective: 2 x through ``parallel.ep._taped``, counted."""
    calls = 0

    @staticmethod
    def forward(ctx, x):
        return ep._taped(_twice, x)

    @staticmethod
    def backward(ctx, g):
        return 2 * g


def _twice(x):
    _Twice.calls += 1
    return 2 * x


def test_collective_tape_keeps_what_the_recompute_replays(monkeypatch):
    """A checkpointed function calls three collectives, of which only the
    first output feeds a saved activation, so the recompute stops after
    replaying it: the first run keeps all three (the replay depth is not
    known yet), later runs keep one; no replay communicates, every tape is
    empty after its backward, and the gradients are the plain function's."""
    monkeypatch.setattr(ep.CollectiveTape, "_replayed", {})

    def fn(x):
        b = _Twice.apply(x).sin()
        c = _Twice.apply(b) + 1
        return _Twice.apply(c) * 3

    x = torch.linspace(-1, 1, 7, requires_grad=True)
    want = torch.autograd.grad(fn(x).sum(), x)[0]
    for kept in (3, 1, 1):
        tape = ep.CollectiveTape()
        _Twice.calls = 0
        y = checkpoint(tape.run, fn, x, use_reentrant=False)
        assert len(tape.outs) == kept and _Twice.calls == 3
        got = torch.autograd.grad(y.sum(), x)[0]
        assert _Twice.calls == 3 and tape.outs == []
        assert torch.equal(got, want)
    assert list(ep.CollectiveTape._replayed.values()) == [1]
