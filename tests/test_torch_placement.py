"""PyTorch port, expert placement (``parallel/placement.py``) on one
process, against the JAX package.

* The host side (``ExpertPlacement``, ``rank_loads``, ``imbalance``,
  ``greedy_perm``, ``relative_to``, the MANIFEST form and
  ``RebalanceController`` sequences of ``observe``, ``propose(force=)`` and
  ``reset_window``) equals the JAX package's exactly on seeded inputs.
* ``sparse_moe_block(..., placement=)`` on stacks permuted by
  ``relative_to`` against the JAX block (Pallas kernels in interpret mode,
  ``tile_m = gmm_align()`` so that both pools are the same), dropless and
  under capacity with drops, and ``loss_fn(..., placement=rows)`` against
  the JAX ``loss_fn``, float32, atol = rtol = 1e-4; the stats' counts
  equal, in global ids.
* ``permute_expert_tree`` and ``apply_placement`` without a grid equal the
  JAX ones; ``plan_update_buckets`` is the same before and after a
  placement.
* One device: a placed train step (dropless, top 2) gives the unplaced
  one's metrics bit for bit, and moving its state back gives the unplaced
  state bit for bit. A placement that is not an ``ExpertPlacement``
  raises.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.parallel import placement as jpl  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro_torch.configs import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import init_params, loss_fn as tloss_fn  # noqa: E402
from repro_torch.optim.epso import optimizer_state_specs, plan_update_buckets  # noqa: E402
from repro_torch.parallel import placement as tpl  # noqa: E402
from repro_torch.parallel.sharding import param_placements  # noqa: E402
from repro_torch.train import TrainState, init_state, make_train_step  # noqa: E402
from repro_torch.tree import keyed_leaves, leaves, leaves_with_path  # noqa: E402

from torch_parity import batch_pair  # noqa: E402

PLAN = KernelPlan(backend="pallas", attn_impl="blockwise", interpret=True,
                  tile_m=ops.gmm_align(), tile_k=64, tile_n=32)
TOL = dict(atol=1e-4, rtol=1e-4)


def _perm_rows(rng, L, E):
    return tuple(tuple(int(v) for v in rng.permutation(E)) for _ in range(L))


# ---------------------------------------------------------------------------
# the host side, exactly the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,L,E", [(0, 1, 4), (1, 3, 8), (2, 2, 64)])
def test_placement_algebra_matches_jax(seed, L, E):
    rng = np.random.default_rng(seed)
    rows, new_rows = _perm_rows(rng, L, E), _perm_rows(rng, L, E)
    t, j = tpl.ExpertPlacement(L, E, rows), jpl.ExpertPlacement(L, E, rows)
    tn, jn = tpl.ExpertPlacement(L, E, new_rows), jpl.ExpertPlacement(L, E, new_rows)
    assert t.perm == j.perm and t.is_identity == j.is_identity is False
    np.testing.assert_array_equal(t.perm_array(), j.perm_array())
    np.testing.assert_array_equal(t.inverse_array(), j.inverse_array())
    np.testing.assert_array_equal(t.relative_to(tn), j.relative_to(jn))
    assert t.inverse_array().dtype == j.inverse_array().dtype == np.int32
    assert tpl.ExpertPlacement.identity(L, E).perm == jpl.ExpertPlacement.identity(L, E).perm
    assert tpl.ExpertPlacement.identity(L, E).is_identity
    b = tuple(int(v) for v in rng.permutation(E))
    assert tpl.ExpertPlacement.broadcast(b, L).perm == jpl.ExpertPlacement.broadcast(b, L).perm
    # the MANIFEST form is the JAX one, both ways
    assert t.to_manifest() == j.to_manifest()
    assert tpl.ExpertPlacement.from_manifest(j.to_manifest()) == t
    assert jpl.ExpertPlacement.from_manifest(t.to_manifest()) == j
    assert tpl.ExpertPlacement.from_manifest(None) is None


@pytest.mark.parametrize("seed,E,ep", [(0, 4, 2), (1, 8, 4), (2, 64, 2), (3, 64, 8)])
def test_loads_and_greedy_match_jax(seed, E, ep):
    rng = np.random.default_rng(seed)
    counts = rng.zipf(1.5, size=E).astype(np.float64) * rng.integers(1, 50, size=E)
    row = tuple(int(v) for v in rng.permutation(E))
    np.testing.assert_array_equal(tpl.rank_loads(counts, row, ep),
                                  jpl.rank_loads(counts, row, ep))
    assert tpl.imbalance(counts, row, ep) == jpl.imbalance(counts, row, ep)
    assert tpl.imbalance(np.zeros(E), row, ep) == 1.0 == jpl.imbalance(np.zeros(E), row, ep)
    greedy = tpl.greedy_perm(counts, ep)
    assert greedy == jpl.greedy_perm(counts, ep)
    assert tpl.imbalance(counts, greedy, ep) <= tpl.imbalance(counts, row, ep)
    with pytest.raises(ValueError, match="does not divide"):
        tpl.greedy_perm(counts[:-1], ep)


def test_placement_validation_matches_jax():
    for args in [(2, 4, ((0, 1, 2, 3),)), (1, 4, ((0, 1, 1, 3),))]:
        with pytest.raises(ValueError) as je:
            jpl.ExpertPlacement(*args)
        with pytest.raises(ValueError) as te:
            tpl.ExpertPlacement(*args)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="shape mismatch"):
        tpl.ExpertPlacement.identity(2, 4).relative_to(tpl.ExpertPlacement.identity(2, 8))
    for kw in (dict(interval=0, threshold=1.2), dict(interval=3, threshold=0.9)):
        with pytest.raises(ValueError) as je:
            jpl.RebalanceController(num_layers=2, num_experts=4, ep=2, **kw)
        with pytest.raises(ValueError) as te:
            tpl.RebalanceController(num_layers=2, num_experts=4, ep=2, **kw)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("seed,E,ep,interval,threshold", [
    (0, 4, 2, 2, 1.05), (1, 8, 4, 3, 1.2), (2, 64, 2, 1, 1.0), (3, 16, 4, 4, 1.5)])
def test_controller_sequences_match_jax(seed, E, ep, interval, threshold):
    """The same random sequence of observe / propose / propose(force=True) /
    reset_window on both controllers: the same imbalances, proposals,
    placements, windows and event counts after every call."""
    rng = np.random.default_rng(seed)
    kw = dict(num_layers=3, num_experts=E, ep=ep, interval=interval, threshold=threshold)
    t, j = tpl.RebalanceController(**kw), jpl.RebalanceController(**kw)
    hot = rng.permutation(E)[:max(1, E // 4)]
    for _ in range(60):
        op = rng.choice(["observe", "observe", "observe", "propose", "force", "reset"])
        if op == "observe":
            c = rng.poisson(5.0, size=E).astype(np.float64)
            c[hot] *= rng.integers(1, 8)
            assert t.observe(c) == j.observe(c)
        elif op == "reset":
            t.reset_window()
            j.reset_window()
        else:
            if op == "propose" and not t.window_full():
                assert t.window_full() == j.window_full()
                continue
            pt, pj = t.propose(force=op == "force"), j.propose(force=op == "force")
            assert (pt is None) == (pj is None)
            if pt is not None:
                assert pt.perm == pj.perm
        assert t.placement.perm == j.placement.perm
        np.testing.assert_array_equal(t.window, j.window)
        assert (t.steps_in_window, t.rebalances) == (j.steps_in_window, j.rebalances)
    assert t.rebalances == j.rebalances


# ---------------------------------------------------------------------------
# the placed MoE block and loss against the JAX package
# ---------------------------------------------------------------------------

def _block_setup(dispatch, capacity_factor):
    jc = jreduced(jget("mula-7b-a1b"), d_model=64, vocab=128)
    tc = treduced(tget("mula-7b-a1b"), d_model=64, vocab=128)
    moe_kw = dict(dispatch=dispatch, capacity_factor=capacity_factor, num_experts=8)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe_kw))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe_kw))
    p = jax.tree.map(np.asarray, jmoe.init_moe_block(jax.random.PRNGKey(0), jc))
    x = np.random.default_rng(2).standard_normal((4, 64, 64)).astype(np.float32)
    return jc, tc, p, x


@pytest.mark.parametrize("dispatch,capacity_factor", [("dropless", 1.25), ("capacity", 0.5)])
def test_placed_block_matches_jax(dispatch, capacity_factor):
    jc, tc, p, x = _block_setup(dispatch, capacity_factor)
    E = jc.moe.num_experts
    placed = tpl.ExpertPlacement.broadcast((5, 2, 7, 0, 3, 6, 1, 4), 1)
    perm = placed.perm_array()[0]
    inv = placed.inverse_array()[0]
    pp = {k: (v[perm] if k in ("gate", "up", "down") else v) for k, v in p.items()}
    with use_kernel_plan(PLAN):
        jout, jaux, jz, jst = jmoe.sparse_moe_block(jax.tree.map(jnp.asarray, pp),
                                                    jnp.asarray(x), jc, placement=jnp.asarray(inv))
        _, _, _, jst0 = jmoe.sparse_moe_block(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jc)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in pp.items()}
    tout, taux, tz, tst = tmoe.sparse_moe_block(tp, torch.from_numpy(x), tc,
                                                placement=torch.from_numpy(inv))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)
    np.testing.assert_allclose(tz.item(), float(jz), **TOL)
    # the counts in global-id order, as the unplaced block gives them
    np.testing.assert_array_equal(tst.counts.numpy(), np.asarray(jst.counts))
    np.testing.assert_array_equal(tst.counts.numpy(), np.asarray(jst0.counts))
    assert tst.drops.item() == float(jst.drops)
    if dispatch == "capacity":
        assert tst.drops.item() > 0          # the pool overflowed: drops in both
    else:
        # dropless: the same output as the unplaced block's
        tp0 = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
        tout0, *_ = tmoe.sparse_moe_block(tp0, torch.from_numpy(x), tc)
        assert torch.equal(tout, tout0)
    naive, _ = tmoe.moe_naive(tp, torch.from_numpy(x).reshape(-1, 64), tc.moe,
                              placement=torch.from_numpy(inv).long())
    jnaive, _ = jmoe.moe_naive(jax.tree.map(jnp.asarray, pp), jnp.asarray(x).reshape(-1, 64),
                               jc.moe, placement=jnp.asarray(inv))
    np.testing.assert_allclose(naive.numpy(), np.asarray(jnaive), **TOL)
    assert E == 8


def test_placed_loss_matches_jax():
    jc = jreduced(jget("mula-7b-a1b"), d_model=64, vocab=128)
    tc = treduced(tget("mula-7b-a1b"), d_model=64, vocab=128)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, dispatch="dropless"))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, dispatch="dropless"))
    L, E = jc.num_layers, jc.moe.num_experts
    rows = _perm_rows(np.random.default_rng(5), L, E)
    placed_j, placed_t = jpl.ExpertPlacement(L, E, rows), tpl.ExpertPlacement(L, E, rows)
    jp = jax.tree.map(np.asarray, jinit_state(jax.random.PRNGKey(0), jc, JTrain()).params)
    rel = jpl.ExpertPlacement.identity(L, E).relative_to(placed_j)
    jpp = jax.tree.map(np.asarray, jpl.permute_expert_tree(jp, rel, L, E))
    tp = params_from_jax(jp, tc, device="cpu")
    tpp = tpl.permute_expert_tree(tp, rel, L, E)
    # the port's permute_expert_tree is the JAX one
    for (path, t), (_, t0) in zip(leaves_with_path(params_from_jax(jpp, tc, device="cpu")),
                                  leaves_with_path(tpp)):
        assert torch.equal(t, t0), path
    jb, tb = batch_pair(3)
    inv = placed_j.inverse_array()
    with use_kernel_plan(PLAN):
        jl, jm = jloss_fn(jax.tree.map(jnp.asarray, jpp), jb, jc, sac="block",
                          compute_dtype=jnp.float32, placement=jnp.asarray(inv))
    tl, tm = tloss_fn(tpp, tb, tc, sac="block", compute_dtype=torch.float32,
                      placement=torch.from_numpy(placed_t.inverse_array()))
    tl0, tm0 = tloss_fn(tp, tb, tc, sac="block", compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    for k in ("ce", "moe_aux", "moe_z", "moe_counts", "moe_load", "moe_drops"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), **TOL, err_msg=k)
    assert torch.equal(tl, tl0)
    assert torch.equal(tm["moe_counts"], tm0["moe_counts"])


def test_permute_tree_leaves_other_leaves_and_plans_alone():
    """Only the routed stacks move (never the router or shared experts);
    a whole state moves in place (``apply_placement`` without a grid) as
    the JAX ``apply_placement`` moves it, params and master, m and v (its
    ``permute_expert_states``); the update plan and state placements read
    shapes only, so they are the same under any placement (2 x 2 grid,
    every mode)."""
    tc = treduced(tget("moonshot-v1-16b-a3b"), d_model=64, vocab=128)
    L, E = tc.num_layers, tc.moe.num_experts
    params = init_params(tc, seed=0, device="cpu")
    rel = tpl.ExpertPlacement.identity(L, E).relative_to(
        tpl.ExpertPlacement.broadcast(tuple(reversed(range(E))), L))
    moved = tpl.permute_expert_tree(params, rel, L, E)
    for (path, a), (_, b) in zip(leaves_with_path(params), leaves_with_path(moved)):
        stack = tpl.is_expert_stack(path, tuple(a.shape), L, E)
        assert stack == (path.split("/")[-2:] in (["moe", "gate"], ["moe", "up"],
                                                  ["moe", "down"])), path
        assert (b is a) != stack, path
        if stack:
            assert torch.equal(b, a.flip(1)), path
        assert jpl.is_expert_stack(path, tuple(a.shape), L, E) == stack
    jc = jreduced(jget("moonshot-v1-16b-a3b"), d_model=64, vocab=128)
    js = jinit_state(jax.random.PRNGKey(3), jc, JTrain(param_dtype="float32"))
    js = js._replace(opt=js.opt._replace(m=jax.tree.map(lambda x: x * 0.5, js.opt.master),
                                         v=jax.tree.map(lambda x: x * x, js.opt.master)))
    rows = ((3, 1, 0, 2), (0, 2, 3, 1))
    jmoved = jax.tree.map(np.asarray, jpl.apply_placement(
        js, jpl.ExpertPlacement.identity(L, E), jpl.ExpertPlacement(L, E, rows), L, E))
    host = jax.tree.map(np.asarray, js)
    state = TrainState(params_from_jax(host.params, tc, device="cpu"),
                       opt_state_from_jax(host.opt, device="cpu"))
    state, sent = tpl.apply_placement(state, tpl.ExpertPlacement.identity(L, E),
                                      tpl.ExpertPlacement(L, E, rows))
    assert sent == 0
    want = TrainState(params_from_jax(jmoved.params, tc, device="cpu"),
                      opt_state_from_jax(jmoved.opt, device="cpu"))
    for (k, a), (_, b) in zip(keyed_leaves(state), keyed_leaves(want)):
        assert torch.equal(a, b), k
    sizes = {"data": 2, "ep": 2}
    for mode in ("none", "so", "epso"):
        before = plan_update_buckets(params, param_placements(params, sizes), sizes, mode)
        after = plan_update_buckets(moved, param_placements(moved, sizes), sizes, mode)
        assert after == before
        assert leaves(optimizer_state_specs(moved, param_placements(moved, sizes), sizes,
                                            mode)) == \
            leaves(optimizer_state_specs(params, param_placements(params, sizes), sizes, mode))


# ---------------------------------------------------------------------------
# one device: a placed train step is the unplaced one, bit for bit
# ---------------------------------------------------------------------------

F32 = dict(param_dtype="float32", compute_dtype="float32", grad_reduce_dtype="float32")


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_placed_train_step_bit_identical(param_dtype):
    """Mula-7B-A1B reduced (4 experts, top 2), dropless, clipping on from
    step 1: 4 steps unplaced and 4 from the same state moved to a placement
    give the same metrics (loss, grad norm, clip scale, moe_counts in
    global ids) bit for bit; the placed run's state moved back equals the
    unplaced run's, params, master, m and v. bfloat16 params do not share
    the master's tensors, float32 ones do: both are moved once."""
    tc = treduced(tget("mula-7b-a1b"), d_model=32)
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, dispatch="dropless"))
    L, E = tc.num_layers, tc.moe.num_experts
    assert tc.moe.experts_per_token == 2
    train = TrainConfig(**{**F32, "param_dtype": param_dtype}, lr_peak=1e-3, lr_min=1e-4,
                        warmup_steps=1, total_steps=4, grad_clip=0.05)
    batches = [batch_pair(10 + s, vocab=tc.vocab_size)[1] for s in range(4)]
    ident = tpl.ExpertPlacement.identity(L, E)
    placed = tpl.ExpertPlacement.broadcast((2, 0, 3, 1), L)

    def run(placement, state):
        step = make_train_step(tc, ParallelConfig(), train, placement=placement)
        out = []
        for b in batches:
            state, m = step(state, b)
            out.append({k: v.clone() for k, v in m.items()})
        return state, out

    sa, ma = run(None, init_state(tc, train, seed=0, device="cpu"))
    s0 = init_state(tc, train, seed=0, device="cpu")
    g0 = s0.params["layers"]["moe"]["gate"].clone()
    router0 = s0.params["layers"]["moe"]["router"].clone()
    sp, sent = tpl.apply_placement(s0, ident, placed)
    assert sp is s0 and sent == 0
    assert torch.equal(sp.params["layers"]["moe"]["router"], router0)
    rel = ident.relative_to(placed)
    for layer in range(L):
        assert torch.equal(sp.params["layers"]["moe"]["gate"][layer], g0[layer][rel[layer]])
    sb, mb = run(placed, sp)
    assert any(m["clip_scale"] < 1 for m in ma)
    for a, b in zip(ma, mb):
        for k in a:
            assert torch.equal(a[k], b[k]), (k, a[k], b[k])
    tpl.apply_placement(sb, placed, ident)
    for tree in ("params", "master", "m", "v"):
        ta = sa.params if tree == "params" else getattr(sa.opt, tree)
        tb = sb.params if tree == "params" else getattr(sb.opt, tree)
        for (path, a), (_, b) in zip(leaves_with_path(ta), leaves_with_path(tb)):
            assert torch.equal(a, b), (tree, path)


def test_make_train_step_checks_the_placement():
    tc = treduced(tget("mula-7b-a1b"), d_model=32)
    L, E = tc.num_layers, tc.moe.num_experts
    with pytest.raises(TypeError, match="ExpertPlacement"):
        make_train_step(tc, ParallelConfig(), TrainConfig(), placement=(0, 1, 2, 3))
    with pytest.raises(ValueError, match="placement of"):
        make_train_step(tc, ParallelConfig(), TrainConfig(),
                        placement=tpl.ExpertPlacement.identity(L + 1, E))
    dense = treduced(tget("mula-1b"), d_model=32)
    with pytest.raises(ValueError, match="no experts"):
        make_train_step(dense, ParallelConfig(), TrainConfig(),
                        placement=tpl.ExpertPlacement.identity(L, E))
    # the identity is the unplaced step
    make_train_step(tc, ParallelConfig(), TrainConfig(),
                    placement=tpl.ExpertPlacement.identity(L, E))
