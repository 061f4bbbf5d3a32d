"""PyTorch port, MoE Stages 2 and 3: the dispatch plan's plain version
(``ref.dispatch_plan_ref``, what the ``dispatch_plan`` kernel computes on
the card) against the JAX package's ``make_dispatch_plan`` and the inverse
map its ``dispatch_compute_combine`` builds, with exact equality; and the
gradient of the sparse MoE block through the pool gathers' Functions (whose
backward is a gather and a combine) against ``jax.grad`` of the reference
block and against autograd of the indexing ops they replace, float32, atol =
rtol = 1e-4. Inputs come from seeded numpy generators."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
# the port's group alignment (the CUDA gmm's row tile) on both sides, so the
# two pools hold the same rows and drop the same pairs
PLAN = KernelPlan(backend="pallas", attn_impl="pallas", interpret=True,
                  tile_m=ops.gmm_align(), tile_k=64, tile_n=32)


def _routing(kind, T, K, E, seed):
    """(T, K) int32 expert ids: distinct random top-K ids per token, every
    pair on one expert, or forced uniform routing (FUR)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return np.stack([rng.choice(E, size=K, replace=False) for _ in range(T)]).astype(np.int32)
    if kind == "one":
        return np.full((T, K), 21 % E, np.int32)
    t, k = np.arange(T)[:, None], np.arange(K)[None, :]
    return ((t * K + k) % E).astype(np.int32)


def _pool(rows, T, K, E, EL):
    if rows == "capacity":
        return jmoe.round_up(jmoe.pool_size(T, K, E, EL, 1.25, 16), EL * 16)
    if rows == "dropless":
        return jmoe.dropless_pool_rows(T, K, EL, 16)
    return rows


@pytest.mark.parametrize("kind,T,K,E,EL,offset,rows,align", [
    ("random", 37, 8, 64, 64, 0, "capacity", 16),          # random top-8, one device
    ("one", 37, 8, 64, 64, 0, 128, 16),                     # every pair on one expert: drops
    ("random", 64, 8, 64, 16, 16, "capacity", 16),          # EP rank 1 of 4
    ("random", 64, 8, 64, 16, 48, "capacity", 16),          # EP rank 3 of 4
    ("one", 64, 8, 64, 16, 16, 64, 16),                     # EP: one local expert, drops
    ("fur", 40, 8, 64, 64, 0, "capacity", 16),              # FUR: every group full at once
    ("random", 37, 8, 64, 64, 0, "dropless", 16),           # the dropless pool
    ("random", 37, 8, 64, 64, 0, 160, 16),                  # late experts get 0 rows
    ("random", 5, 3, 8, 8, 0, 40, 8),                       # T*K = 15, no multiple of 32
    ("random", 9, 7, 12, 4, 4, 24, 1),                      # F = 63, unaligned groups
])
def test_dispatch_plan_ref_matches_jax(kind, T, K, E, EL, offset, rows, align):
    idx = _routing(kind, T, K, E, seed=T * K + offset)
    rows = _pool(rows, T, K, E, EL)
    j = jmoe.make_dispatch_plan(jnp.asarray(idx), num_experts=E, pool_rows=rows, align=align,
                                expert_offset=offset, local_experts=EL)
    F = T * K
    # the inverse map as the JAX package builds it (dispatch_compute_combine)
    j_inv_pair = jnp.zeros((rows,), jnp.int32).at[j.slot].set(
        jnp.arange(F, dtype=jnp.int32), mode="drop")
    j_inv_token = jnp.zeros((rows,), jnp.int32).at[j.slot].set(
        jnp.arange(F, dtype=jnp.int32) // K, mode="drop")
    j_pool_valid = jnp.zeros((rows,), bool).at[j.slot].set(j.valid, mode="drop")

    t = ref.dispatch_plan_ref(torch.from_numpy(idx).long().reshape(-1), EL, offset, rows, align)
    slot, valid, counts, group_sizes, drops, inv_pair, pool_valid = t
    expect = {"slot": j.slot, "valid": j.valid, "counts": j.counts,
              "group_sizes": j.group_sizes, "drops": j.drops, "inv_pair": j_inv_pair,
              "pool_valid": j_pool_valid}
    got = {"slot": slot, "valid": valid, "counts": counts, "group_sizes": group_sizes,
           "drops": drops, "inv_pair": inv_pair, "pool_valid": pool_valid}
    for name, e in expect.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(e), err_msg=name)
    np.testing.assert_array_equal((inv_pair // K).numpy(), np.asarray(j_inv_token))
    assert (slot.dtype, valid.dtype, counts.dtype, group_sizes.dtype, drops.dtype,
            inv_pair.dtype, pool_valid.dtype) == (torch.int64, torch.bool, torch.int64,
                                                  torch.int32, torch.int64, torch.int64,
                                                  torch.bool)
    assert inv_pair.shape == pool_valid.shape == (rows,) and drops.shape == ()
    # the cases exercise what their names say
    if kind == "one" or rows == 160:
        assert int(drops) > 0
    if rows == 160:
        assert int(group_sizes[-1]) == 0 < int(counts[-1])
    # make_dispatch_plan on a CPU tensor is this plain version
    p = tmoe.make_dispatch_plan(torch.from_numpy(idx).long(), num_experts=E, pool_rows=rows,
                                align=align, expert_offset=offset, local_experts=EL)
    for name, e in got.items():
        assert torch.equal(getattr(p, name), e), name


def _block_setup(capacity_factor, dispatch="capacity"):
    kw = dict(d_model=64, vocab=128, max_experts=8)
    jc, tc = jreduced(jget("mula-7b-a1b"), **kw), treduced(tget("mula-7b-a1b"), **kw)
    mk = dict(capacity_factor=capacity_factor, dispatch=dispatch)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **mk))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **mk))
    p = jmoe.init_moe_block(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 64, 64)).astype(np.float32)
    ct = rng.standard_normal((2, 64, 64)).astype(np.float32)
    return jc, tc, jax.tree.map(np.asarray, p), x, ct


def _torch_grads(p, x, ct, cfg):
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux, z, stats = tmoe.sparse_moe_block(tp, tx, cfg)
    loss = (out * torch.from_numpy(ct)).sum() + 0.01 * aux + 0.001 * z
    names = ["x", *tp]
    grads = torch.autograd.grad(loss, [tx, *tp.values()])
    return out.detach(), stats, {n: g.numpy() for n, g in zip(names, grads)}


@pytest.mark.parametrize("capacity_factor,dispatch", [
    (4.0, "capacity"),         # no drops
    (0.5, "capacity"),         # drops: masked pairs and unfilled rows in both gathers
    (1.0, "dropless"),
])
def test_moe_block_grads_through_pool_gathers(capacity_factor, dispatch, monkeypatch):
    """Output and gradients (x, router, expert stacks) of sparse_moe_block
    against jax.grad of the reference block (Pallas interpret mode), and
    against autograd of the indexing ops the gather Functions replace,
    whose backward is a scatter-add."""
    jc, tc, p, x, ct = _block_setup(capacity_factor, dispatch)

    def jloss(p, x):
        out, aux, z, _ = jmoe.sparse_moe_block(p, x, jc)
        return (out * ct).sum() + 0.01 * aux + 0.001 * z

    with use_kernel_plan(PLAN):
        jout, _, _, jstats = jmoe.sparse_moe_block(p, jnp.asarray(x), jc)
        jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    out, stats, grads = _torch_grads(p, x, ct, tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert float(stats.drops) == float(jstats.drops)
    if capacity_factor < 1:
        assert float(stats.drops) > 0
    np.testing.assert_allclose(grads["x"], np.asarray(jgx), **TOL)
    for name in p:
        np.testing.assert_allclose(grads[name], np.asarray(jgp[name]), err_msg=name, **TOL)

    # the same block with the gathers as plain indexing ops
    monkeypatch.setattr(tmoe._PoolGather, "apply", staticmethod(
        lambda x, inv_pair, pool_valid, safe_slot, valid, k:
        x[inv_pair // k] * pool_valid[:, None].to(x.dtype)))
    monkeypatch.setattr(tmoe._CombineGather, "apply", staticmethod(
        lambda pool_y, safe_slot, valid, inv_pair, pool_valid:
        pool_y[safe_slot] * valid[:, None].to(pool_y.dtype)))
    old_out, _, old_grads = _torch_grads(p, x, ct, tc)
    assert torch.equal(out, old_out)
    for name, g in grads.items():
        np.testing.assert_allclose(g, old_grads[name], err_msg=name, **TOL)


def test_serving_block_skips_aux():
    """aux=False (the serving lowerings) gives the same output and computes
    no aux, z or stats; the Stage 2 histogram of the aux loss is the
    token_counts wrapper's."""
    _, tc, p, x, _ = _block_setup(4.0)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    out, aux, z, stats = tmoe.sparse_moe_block(tp, torch.from_numpy(x), tc)
    s_out, s_aux, s_z, s_stats = tmoe.sparse_moe_block(tp, torch.from_numpy(x), tc, aux=False)
    assert torch.equal(out, s_out)
    assert s_aux is None and s_z is None and s_stats is None
    assert aux is not None and z is not None
    assert float(stats.counts.sum()) == x.shape[0] * x.shape[1] * tc.moe.experts_per_token
