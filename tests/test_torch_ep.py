"""PyTorch port, expert parallelism (EP): the Stage 2-5 dispatch of one EP
shard, the EP MoE block and the EP train step against the JAX package's
single-device math, on the same numpy inputs, float32, atol = rtol = 1e-4.

The EP ranks are processes on the CPU over ``gloo`` (``parallel.spawn``,
a FileStore rendezvous in a temporary directory; each run has a hard
timeout). The one-shard dispatch test runs the JAX side's Pallas kernels
in interpret mode with ``tile_m`` equal to the port's ``gmm_align()``; the
block and train-step tests run its default lowering (``KernelPlan()``: XLA,
the dropless dispatch through its ragged grouped matmul), the same math at
a fifth of the time.

Two oracles follow from the JAX package's EP semantics (``moe_fsmoe_ep``):
its aux loss is the mean over the ranks of each rank's aux loss, so the
block test's oracle averages the JAX router's aux over the ranks' token
blocks; and a train step of ``world`` ranks with ``n`` microbatches each is
the JAX single-device step with ``world * n`` microbatches, microbatch
``r * n + j`` being rank r's j-th, when every such block holds the same
number of unmasked labels (the JAX step averages per-microbatch means,
EP takes the mean over the global tokens). The global token mean itself is
checked on a batch with masked labels against the JAX loss over the whole
batch."""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.configs.base import ParallelConfig as JParallel  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core.router import route as jroute  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.core.router import RouterOut  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.parallel import ep_shard, replicated_leaves, spawn  # noqa: E402
from repro_torch.parallel.sharding import param_placements, tile_slices  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402

PLAN = KernelPlan(backend="pallas", attn_impl="blockwise", interpret=True,
                  tile_m=ops.gmm_align(), tile_k=64, tile_n=32)
XLA = KernelPlan()
TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(param_dtype="float32", compute_dtype="float32", grad_reduce_dtype="float32")
TIMEOUT_S = 120


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(experts=8, **moe_kw):
    """Reduced Mula-7B-A1B (2 layers, d_model 64, vocab 128) with
    ``experts`` experts, top-(experts // 2)."""
    out = []
    for get, red in ((jget, jreduced), (tget, treduced)):
        c = red(get("mula-7b-a1b"), d_model=64, vocab=128, max_experts=experts)
        out.append(dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe_kw)))
    return out


def _block_params(jc):
    p = _np(jmoe.init_moe_block(jax.random.PRNGKey(0), jc))
    return p, {k: _t(v) for k, v in p.items()}


def _spawn_with(oracle, fn, world, args):
    """``spawn(fn, world, args)`` on the CPU while this process computes
    ``oracle()`` (the ranks' start-up overlaps the JAX side's compile):
    (oracle's result, the ranks' results)."""
    with ThreadPoolExecutor(1) as pool:
        res = pool.submit(spawn, fn, world, args=args, device="cpu", timeout_s=TIMEOUT_S)
        return oracle(), res.result()


# ----------------------------------------------------------------------------
# (b) one EP shard's Stage 2-5 dispatch, single process
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch", ["capacity", "dropless"])
@pytest.mark.parametrize("world", [2, 4])
def test_ep_shard_dispatch_matches_jax(world, dispatch):
    """Rank r's ``dispatch_compute_combine`` (expert offset r * EL, its EL
    experts) on the gathered tokens equals the JAX package's: partial
    output, plan counts, group sizes and drops. Capacity factor 0.8 makes
    the capacity pools overflow; the dropless partials sum to the JAX
    single-device dropless block."""
    jc, tc = _cfgs(capacity_factor=0.8)
    p, tp = _block_params(jc)
    x = np.random.default_rng(world).standard_normal((256, 64)).astype(np.float32)
    r = jroute(jnp.asarray(x), jnp.asarray(p["router"]), num_experts=8,
               top_k=jc.moe.experts_per_token)
    tr = RouterOut(_t(r.weights), _t(r.indices).long(), None, None)
    EL = jc.moe.num_experts // world
    dropless = dispatch == "dropless"
    total, drops = 0, 0
    for rank in range(world):
        sl = slice(rank * EL, (rank + 1) * EL)
        with use_kernel_plan(PLAN):
            jout, jplan = jax.jit(lambda g, u, d, x, r, off=rank * EL: (
                jmoe.dispatch_compute_combine(g, u, d, x, r, jc.moe, expert_offset=off,
                                              local_experts=EL, backend="pallas",
                                              dropless=dropless)))(
                *(jnp.asarray(p[k][sl]) for k in ("gate", "up", "down")), jnp.asarray(x), r)
        tout, tplan = tmoe.dispatch_compute_combine(
            *(tp[k][sl] for k in ("gate", "up", "down")), _t(x), tr, tc.moe,
            expert_offset=rank * EL, local_experts=EL, dropless=dropless)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL, err_msg=f"rank {rank}")
        for field in ("counts", "group_sizes", "drops"):
            np.testing.assert_array_equal(getattr(tplan, field).numpy(),
                                          np.asarray(getattr(jplan, field)), err_msg=field)
        assert tplan.pool_rows == jplan.pool_rows
        total = total + tout
        drops += int(tplan.drops)
    if dropless:
        with use_kernel_plan(PLAN):
            ref, _, _ = jax.jit(lambda p, x: jmoe._moe_dense(p, x, jc.moe, backend="pallas",
                                                             dropless=True))(p, jnp.asarray(x))
        np.testing.assert_allclose(total.numpy(), np.asarray(ref), **TOL)
        assert drops == 0
    else:
        assert drops > 0


# ----------------------------------------------------------------------------
# (c, e) the EP MoE block over gloo
# ----------------------------------------------------------------------------

def _run_block(world, experts, ep_aux, tc=None):
    """The port's EP block on ``world`` gloo ranks and the JAX dropless
    block on the concatenated tokens, with ``jax.grad`` of the same loss;
    ``ep_aux``: the JAX aux is the mean over the ranks' token blocks (the EP
    path) rather than the global batch's (the dense fallback). ``tc``: the
    port's config, when not the dropless one."""
    jc, dropless = _cfgs(experts=experts, moe_impl="fsmoe", dispatch="dropless")
    tc = dropless if tc is None else tc
    p, tp = _block_params(jc)
    rng = np.random.default_rng(7)
    B, S, d = 8, 4, 64
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    ct = rng.standard_normal((B, S, d)).astype(np.float32)
    kw = dict(num_experts=experts, top_k=jc.moe.experts_per_token)

    def jf(p, x):
        out, aux, z, stats = jmoe.sparse_moe_block(p, x, jc)
        if ep_aux:
            aux = jnp.mean(jnp.stack([jroute(xb.reshape(-1, d), p["router"], **kw).aux_loss
                                      for xb in jnp.split(x, world)]))
        return (out * ct).sum() + ranks.AUX * aux + ranks.Z * z, (out, aux, z, stats)

    def oracle():
        with use_kernel_plan(XLA):
            (_, (jout, jaux, jz, jstats)), (jgp, jgx) = jax.jit(jax.value_and_grad(
                jf, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        return jout, jaux, jz, jstats, jgp, jgx

    want, res = _spawn_with(oracle, ranks.block_rank, world, (tc, tp, _t(x), _t(ct)))
    return jc, want, res


@pytest.mark.parametrize("world", [2, 4])
def test_ep_block_matches_jax(world):
    """Output rows, aux, z, stats and the gradients of x, the router (summed
    over ranks: each rank holds a copy) and each rank's expert slice."""
    jc, (jout, jaux, jz, jstats, jgp, jgx), res = _run_block(world, 8, ep_aux=True)
    EL = 8 // world
    np.testing.assert_allclose(torch.cat([r["out"] for r in res]).numpy(), np.asarray(jout),
                               **TOL)
    np.testing.assert_allclose(torch.cat([r["grads"]["x"] for r in res]).numpy(),
                               np.asarray(jgx), **TOL)
    np.testing.assert_allclose(sum(r["grads"]["router"] for r in res).numpy(),
                               np.asarray(jgp["router"]), **TOL)
    for rank, r in enumerate(res):
        np.testing.assert_allclose(r["aux"].item(), float(jaux), **TOL)
        np.testing.assert_allclose(r["z"].item(), float(jz), **TOL)
        np.testing.assert_array_equal(r["counts"].numpy(), np.asarray(jstats.counts))
        assert r["drops"].item() == 0 == float(jstats.drops)
        for k in ("gate", "up", "down"):
            np.testing.assert_allclose(r["grads"][k].numpy(),
                                       np.asarray(jgp[k])[rank * EL:(rank + 1) * EL], **TOL,
                                       err_msg=f"rank {rank} {k}")


def test_ep_falls_back_to_dense_when_experts_do_not_divide():
    """6 experts on 4 ranks: ``ep_shard`` keeps the stacks whole and the
    block runs the dense path on each rank's tokens, with the global
    batch's aux, z and stats, as the JAX package's auto-sharded fallback;
    every gradient but x's is summed over the ranks."""
    world = 4
    _, tc = _cfgs(experts=6, moe_impl="fsmoe")
    assert not tmoe.uses_ep(tc.moe, world) and tmoe.uses_ep(tc.moe, 2)
    jc, (jout, jaux, jz, jstats, jgp, jgx), res = _run_block(world, 6, ep_aux=False)
    np.testing.assert_allclose(torch.cat([r["out"] for r in res]).numpy(), np.asarray(jout),
                               **TOL)
    np.testing.assert_allclose(torch.cat([r["grads"]["x"] for r in res]).numpy(),
                               np.asarray(jgx), **TOL)
    for k in ("router", "gate", "up", "down"):
        np.testing.assert_allclose(sum(r["grads"][k] for r in res).numpy(), np.asarray(jgp[k]),
                                   **TOL, err_msg=k)
    for r in res:
        assert r["grads"]["gate"].shape[0] == 6
        np.testing.assert_allclose(r["aux"].item(), float(jaux), **TOL)
        np.testing.assert_allclose(r["z"].item(), float(jz), **TOL)
        np.testing.assert_array_equal(r["counts"].numpy(), np.asarray(jstats.counts))


def test_expert_shard_layout():
    """Rank r holds experts [r * E / world, (r + 1) * E / world) of each
    routed stack and vocab rows [r * V / world, (r + 1) * V / world) of the
    embedding and head tables (the JAX 'ep' role splits them too); the
    router and attention stay whole; a stack whose E does not divide stays
    whole."""
    _, tc = _cfgs()
    from repro_torch.models import init_params
    p = init_params(tc, seed=0, device="cpu")
    s = ep_shard(p, 1, 4)
    assert torch.equal(s["layers"]["moe"]["up"], p["layers"]["moe"]["up"][:, 2:4])
    assert s["layers"]["moe"]["router"] is p["layers"]["moe"]["router"]
    for t in ("embed", "head"):
        assert torch.equal(s[t]["table"], p[t]["table"][64:128]), t
    assert ep_shard(p, 1, 3)["layers"]["moe"]["gate"] is p["layers"]["moe"]["gate"]
    rep = dict(zip((k for k, _ in leaves_with_path(s)),
                   replicated_leaves(param_placements(p, {"ep": 4}))))
    assert [k for k, v in rep.items() if not v] == ["embed/table", "head/table",
                                                     "layers/moe/down", "layers/moe/gate",
                                                     "layers/moe/up"]


# ----------------------------------------------------------------------------
# (d) the EP train step over gloo
# ----------------------------------------------------------------------------

def _jleaves(tree):
    return {jax.tree_util.keystr(p).replace("['", "").replace("']", "/").rstrip("/"):
            np.asarray(x) for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _batches(n, b=4, s=16, vocab=128):
    out = []
    for i in range(n):
        toks = np.random.default_rng(10 + i).integers(0, vocab, size=(b, s + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
def test_ep_train_steps_match_jax(microbatches):
    """Three steps of 2 EP ranks (reduced Mula MoE, 8 experts, dropless)
    against three JAX single-device steps of 2 * microbatches microbatches,
    from the same params and AdamW state: every metric on every rank, then
    the params and both moments, each rank's tiles (its expert slices,
    its vocab rows of the tables) against the JAX arrays' tiles.
    warmup_steps=1: step 0 does not clip, steps 1-2
    do."""
    world = 2
    jc, tc = _cfgs(dispatch="dropless")
    kw = dict(seq_len=16, global_batch=4, warmup_steps=1, total_steps=10, lr_peak=1e-2,
              lr_min=1e-3, **F32)
    jtrain, ttrain = JTrain(**kw), TrainConfig(**kw)
    jstate = jinit_state(jax.random.PRNGKey(0), jc, jtrain)
    params = params_from_jax(_np(jstate.params), tc, device="cpu")
    opt = opt_state_from_jax(_np(jstate.opt), device="cpu")
    batches = _batches(3)

    def oracle(jstate=jstate):
        with use_kernel_plan(XLA):
            jstep = jax.jit(jmake_train_step(jc, JParallel(microbatches=world * microbatches),
                                             jtrain))
            jms = []
            for b in batches:
                jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
                jms.append(jm)
        return jstate, jms

    (jstate, jms), res = _spawn_with(
        oracle, ranks.train_rank, world,
        (tc, ttrain, microbatches, params, opt,
         [{k: _t(v).long() for k, v in b.items()} for b in batches]))
    assert float(jms[0]["clip_scale"]) == 1.0 and float(jms[2]["clip_scale"]) < 1.0
    for i, jm in enumerate(jms):
        for k in ranks.KEYS:
            for rank, r in enumerate(res):
                np.testing.assert_allclose(r["metrics"][i][k].numpy(), np.asarray(jm[k]), **TOL,
                                           err_msg=f"step {i} rank {rank} {k}")
            assert torch.equal(res[0]["metrics"][i][k], res[1]["metrics"][i][k]), k
    place = dict(leaves_with_path(param_placements(params, {"ep": world})))
    for what, jtree in (("params", jstate.params), ("m", jstate.opt.m), ("v", jstate.opt.v)):
        jl = _jleaves(jtree)
        for rank, r in enumerate(res):
            assert sorted(r[what]) == sorted(jl)
            for path, leaf in r[what].items():
                ref = jl[path][tile_slices(place[path], jl[path].shape, {"ep": rank},
                                           {"ep": world})]
                np.testing.assert_allclose(leaf.numpy(), ref, **TOL,
                                           err_msg=f"{what} rank {rank} {path}")
    assert all(r["step"] == 3 for r in res)


def test_ep_loss_is_the_global_token_mean():
    """With masked labels on one rank only, the EP ce and token count are
    the JAX loss's over the whole batch (not a mean of the ranks' means),
    the same on both ranks, and the routing counts are the whole batch's."""
    jc, tc = _cfgs(dispatch="dropless")
    jp = _np(jinit_state(jax.random.PRNGKey(0), jc, JTrain()).params)
    toks = np.random.default_rng(3).integers(0, 128, size=(4, 17)).astype(np.int32)
    toks[0, -5:] = -100
    batch = {"tokens": np.maximum(toks[:, :-1], 0), "labels": toks[:, 1:]}
    def oracle():
        with use_kernel_plan(XLA):
            return jax.jit(lambda p, b: jloss_fn(p, b, jc, compute_dtype=jnp.float32))(
                jp, {k: jnp.asarray(v) for k, v in batch.items()})[1]

    jm, res = _spawn_with(oracle, ranks.loss_rank, 2,
                          (tc, params_from_jax(jp, tc, device="cpu"),
                           {k: _t(v).long() for k, v in batch.items()}))
    for r in res:
        np.testing.assert_allclose(r["ce"].item(), float(jm["ce"]), **TOL)
        assert r["ntok"].item() == int(jm["ntok"]) == 4 * 16 - 5
        np.testing.assert_array_equal(r["moe_counts"].numpy(), np.asarray(jm["moe_counts"]))
    np.testing.assert_allclose(sum(r["share"].item() for r in res), res[0]["loss"].item(),
                               **TOL)


def test_ep_rank_failure_raises_and_stops_every_rank():
    """A rank that raises makes ``spawn`` raise with its traceback, and the
    rank left waiting in a collective is killed, within the timeout."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        spawn(ranks.fail_on_rank_1, 2, device="cpu", timeout_s=TIMEOUT_S)



def test_ep_group_needs_a_device(monkeypatch, tmp_path):
    """Without a card and without device='cpu', joining an EP group raises
    before any rendezvous."""
    from repro_torch.parallel import init_ep_group
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_ep_group(1, 0, backend="gloo", init_method=f"file://{tmp_path / 'store'}")
