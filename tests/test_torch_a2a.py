"""PyTorch port, the all-to-all Stage 1 (``MoEConfig.stage1 = 'a2a'``,
``core/moe.py::_fsmoe_a2a``) against the JAX package's single-device math,
on the same numpy inputs, float32.

* The uniform-capacity dispatch plan (the a2a's outer plan, sorting a
  rank's pairs into per-destination send groups) against the JAX
  ``make_dispatch_plan(..., uniform_capacity=True)``, bit for bit, and its
  inverse map against the JAX a2a body's scatter.
* The a2a block on 2 and 4 CPU ranks over gloo against the JAX dropless
  fsmoe block on the whole batch (the EP aux semantics: the mean of the
  ranks' aux losses), where the a2a drops nothing: outputs, aux, z, stats
  and gradients at atol = rtol = 1e-4.
* Drop counts under a tight capacity against a numpy restatement of the
  JAX send-side (Cd rows a destination, stable order) and receive-side
  (count-aligned groups in the inner pool) rules.
* The refusals the JAX package makes: dropless dispatch and a 'tp' group.
* A placed a2a block (top 2) bit-identical to the unplaced one.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import moe as jmoe  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.core.router import route  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.parallel import EPGroup, ParallelPlan, spawn  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402
from test_torch_ep import TIMEOUT_S, TOL, _block_params, _cfgs, _run_block, _t  # noqa: E402


# ----------------------------------------------------------------------------
# the uniform-capacity plan
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("T,K,ep,cf", [(16, 4, 2, 1.25), (16, 4, 4, 0.5), (64, 8, 2, 1.0),
                                       (33, 2, 4, 4.0)])
def test_uniform_plan_matches_jax(T, K, ep, cf):
    """The outer plan of the a2a (destination ranks as keys, ep groups of
    Cd rows): slot, valid, counts, group sizes and drops exactly the JAX
    plan's, and the inverse map (pool row -> pair) the JAX body's scatter
    ``inv_tok``/``pool_valid``, at capacities that fit and that overflow."""
    rng = np.random.default_rng(T * K + ep)
    dest = rng.integers(0, ep, size=(T, K))
    Cd = tmoe.round_up(int(math.ceil(cf * T * K / ep)), 8)
    jp = jmoe.make_dispatch_plan(jnp.asarray(dest, jnp.int32), num_experts=ep,
                                 pool_rows=ep * Cd, uniform_capacity=True)
    tp = tmoe.make_dispatch_plan(torch.from_numpy(dest).long(), num_experts=ep,
                                 pool_rows=ep * Cd, uniform_capacity=True)
    for field in ("slot", "valid", "counts", "group_sizes", "drops"):
        np.testing.assert_array_equal(getattr(tp, field).numpy(), np.asarray(getattr(jp, field)),
                                      err_msg=field)
    assert (tp.group_sizes == Cd).all()
    tok = np.arange(T * K) // K
    inv_tok = np.asarray(jnp.zeros((ep * Cd,), jnp.int32).at[jp.slot].set(tok, mode="drop"))
    pool_valid = np.asarray(jnp.zeros((ep * Cd,), bool).at[jp.slot].set(jp.valid, mode="drop"))
    np.testing.assert_array_equal(tp.pool_valid.numpy(), pool_valid)
    np.testing.assert_array_equal((tp.inv_pair // K).numpy()[pool_valid], inv_tok[pool_valid])
    if cf < 1.0:
        assert int(tp.drops) > 0


# ----------------------------------------------------------------------------
# the a2a block over gloo
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_a2a_block_matches_jax(world):
    """The a2a block (capacity factor 4: the send groups and the inner pool
    hold every pair) on ``world`` ranks against the JAX dropless block on
    the concatenated tokens with the ranks' mean aux: output rows, aux, z,
    stats, and the gradients of x, the router (summed over the ranks) and
    each rank's expert slice."""
    a2a = _cfgs(experts=8, moe_impl="fsmoe", stage1="a2a", capacity_factor=4.0)[1]
    jc, (jout, jaux, jz, jstats, jgp, jgx), res = _run_block(world, 8, ep_aux=True, tc=a2a)
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


def _restated_drops(idx_by_rank, EL, K, cf, align):
    """The JAX a2a body's drops and counts in numpy: each source rank's
    pairs (flat order) go to rank ``id // EL``, the first Cd of each
    destination kept; each destination dispatches the rows it receives
    (source-rank order, then row order) among its EL experts in
    count-aligned groups of its inner pool, the running sum clamped at the
    pool's end. Returns (total drops, (E,) counts of the received rows)."""
    ep = len(idx_by_rank)
    T = idx_by_rank[0].shape[0]
    Cd = tmoe.round_up(int(math.ceil(cf * T * K / ep)), 8)
    pool = tmoe.round_up(tmoe.round_up(int(math.ceil(cf * T * K)), 8), EL * align)
    send_drops, recv = 0, [[] for _ in range(ep)]
    for idx in idx_by_rank:
        flat = idx.reshape(-1)
        for dst in range(ep):
            mine = flat[flat // EL == dst]
            send_drops += max(0, len(mine) - Cd)
            recv[dst].append(mine[:Cd])
    inner_drops, counts = 0, np.zeros(EL * ep, np.int64)
    for dst in range(ep):
        local = np.concatenate(recv[dst]) - dst * EL
        c = np.bincount(local, minlength=EL)
        counts[dst * EL:(dst + 1) * EL] = c
        aligned = -(-c // align) * align
        ends = np.minimum(np.cumsum(aligned), pool)
        sizes = ends - np.concatenate([[0], ends[:-1]])
        inner_drops += int(np.sum(c - np.minimum(c, sizes)))
    return send_drops + inner_drops, counts


@pytest.mark.parametrize("cf", [0.5, 0.75])
def test_a2a_drops_match_restatement(cf):
    """Under a tight capacity on 2 ranks: every rank's drops and counts are
    the numpy restatement's, from the routing each rank computes (the
    port's ``route`` on its rows)."""
    world = 2
    jc, tc = _cfgs(experts=8, moe_impl="fsmoe", stage1="a2a", capacity_factor=cf)
    _, p = _block_params(jc)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((8, 16, 64)).astype(np.float32)
    ct = np.zeros_like(x)
    res = spawn(ranks.block_rank, world, args=(tc, p, _t(x), _t(ct)), device="cpu",
                timeout_s=TIMEOUT_S)
    K = tc.moe.experts_per_token
    idx = [route(_t(xb).reshape(-1, 64), p["router"], num_experts=8, top_k=K).indices.numpy()
           for xb in np.split(x, world)]
    drops, counts = _restated_drops(idx, 8 // world, K, cf, ops.gmm_align())
    assert drops > 0
    for r in res:
        assert r["drops"].item() == drops
        np.testing.assert_array_equal(r["counts"].numpy(), counts)


@pytest.mark.parametrize("case", ["dropless", "tp", "plan_dropless", "plan_tp"])
def test_a2a_refusals(case):
    """The JAX package's refusals, with its reasons: the a2a's send buffers
    are capacity-bounded (no dropless dispatch), and it does not compose
    with expert-TP; the block and ``ParallelPlan.resolve`` both refuse."""
    _, tc = _cfgs(experts=8, moe_impl="fsmoe", stage1="a2a")
    cpu = torch.device("cpu")
    g2 = EPGroup(None, 0, 2, cpu, "gloo")
    p = {k: v[:4] if k != "router" else v for k, v in _block_params(_cfgs()[0])[1].items()}
    x = torch.zeros((4, 64))
    if case == "dropless":
        with pytest.raises(ValueError, match="does not compose with stage1='a2a'"):
            tmoe.moe_fsmoe_ep(p, x, tc.moe, g2, dropless=True)
    elif case == "tp":
        with pytest.raises(NotImplementedError, match="does not compose with expert-TP"):
            tmoe.moe_fsmoe_ep(p, x, tc.moe, g2, tp=g2)
    elif case == "plan_dropless":
        with pytest.raises(ValueError, match="does not compose with stage1='a2a'"):
            ParallelPlan.parse("ep=2,moe=dropless").resolve(
                ParallelPlan.parse("ep=2,moe=dropless").apply_to_model(tc))
    else:
        with pytest.raises(NotImplementedError, match="does not compose with expert-TP"):
            ParallelPlan.parse("ep=2,tp=2").resolve(tc)


def test_placed_a2a_is_bit_identical():
    """Top 2 of 4 experts on 2 ranks: the a2a block on stacks stored in a
    placement that swaps experts across the ranks, with its inverse row,
    gives the unplaced block's outputs, aux, z, stats and x and router
    gradients bit for bit, and each expert's gradient at its new home."""
    world = 2
    jc, tc = _cfgs(experts=4, moe_impl="fsmoe", stage1="a2a", capacity_factor=4.0)
    _, p = _block_params(jc)
    perm = [2, 0, 3, 1]                         # position -> global id
    inv = torch.tensor(np.argsort(perm))        # global id -> position
    placed = {k: v[perm] if k != "router" else v for k, v in p.items()}
    rng = np.random.default_rng(5)
    x, ct = (_t(rng.standard_normal((4, 8, 64)).astype(np.float32)) for _ in range(2))
    a = spawn(ranks.block_rank, world, args=(tc, p, x, ct), device="cpu", timeout_s=TIMEOUT_S)
    b = spawn(ranks.block_rank, world, args=(tc, placed, x, ct, inv), device="cpu",
              timeout_s=TIMEOUT_S)
    EL = 4 // world
    for ra, rb in zip(a, b):
        for k in ("out", "aux", "z", "counts", "drops"):
            assert torch.equal(ra[k], rb[k]), k
        for k in ("x", "router"):
            assert torch.equal(ra["grads"][k], rb["grads"][k]), k
    for k in ("gate", "up", "down"):
        whole_a = torch.cat([r["grads"][k] for r in a])
        whole_b = torch.cat([r["grads"][k] for r in b])
        assert torch.equal(whole_b, whole_a[perm]), k
        assert whole_a.shape[0] == EL * world
