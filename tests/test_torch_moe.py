"""PyTorch port, MoE modules: router, dispatch plan and the sparse MoE block
against the JAX package (Pallas kernels in interpret mode) and against the
naive all-experts oracle, on the same numpy inputs, float32,
atol = rtol = 1e-4. Inputs are tie-free: ``lax.top_k`` and ``torch.topk``
may order ties differently."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core.router import route as jroute  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.core.router import route as troute  # noqa: E402

PLAN = KernelPlan(backend="pallas", attn_impl="pallas", interpret=True,
                  tile_m=8, tile_k=64, tile_n=32)
TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("forced_uniform", [False, True])
def test_route_matches_jax(forced_uniform):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((24, 32)).astype(np.float32)
    w = rng.standard_normal((32, 8)).astype(np.float32)
    j = jroute(jnp.asarray(x), jnp.asarray(w), num_experts=8, top_k=3,
               forced_uniform=forced_uniform)
    t = troute(_t(x), _t(w), num_experts=8, top_k=3, forced_uniform=forced_uniform)
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights), **TOL)
    np.testing.assert_allclose(t.aux_loss.item(), float(j.aux_loss), **TOL)
    np.testing.assert_allclose(t.z_loss.item(), float(j.z_loss), **TOL)


@pytest.mark.parametrize("pool_rows,align", [
    (96, 8),                 # roomy count-aligned pool
    (32, 8),                 # starved pool: drops
    (64, 16),                # the CUDA gmm's alignment
    (40, 1),                 # unaligned groups, no padding
])
def test_dispatch_plan_matches_jax(pool_rows, align):
    rng = np.random.default_rng(1)
    idx = np.stack([rng.choice(6, size=2, replace=False) for _ in range(20)]).astype(np.int32)
    j = jmoe.make_dispatch_plan(jnp.asarray(idx), num_experts=6, pool_rows=pool_rows,
                                align=align)
    t = tmoe.make_dispatch_plan(_t(idx), num_experts=6, pool_rows=pool_rows, align=align)
    for field in ("slot", "valid", "counts", "group_sizes", "drops"):
        np.testing.assert_array_equal(getattr(t, field).numpy(),
                                      np.asarray(getattr(j, field)), err_msg=field)
    assert t.pool_rows == j.pool_rows


def test_pool_sizes_match_jax():
    """One device (EL = E) and one EP shard of EL experts over the gathered
    tokens."""
    for T, K, E, EL, cf, align in [(8, 8, 64, 64, 8.0, 16), (512, 8, 64, 64, 8.0, 16),
                                   (5, 2, 4, 4, 1.25, 8), (8192, 8, 64, 16, 1.25, 16),
                                   (37, 4, 16, 4, 1.0, 16)]:
        assert tmoe.pool_size(T, K, E, EL, cf, align) == jmoe.pool_size(T, K, E, EL, cf, align)
    assert tmoe.dropless_pool_rows(37, 8, 64, 16) == jmoe.dropless_pool_rows(37, 8, 64, 16)
    assert tmoe.dropless_pool_rows(8192, 8, 16, 16) == jmoe.dropless_pool_rows(8192, 8, 16, 16)


def _moe_setup(name, **moe_kw):
    jc = jreduced(jget(name), d_model=64, vocab=128)
    tc = treduced(tget(name), d_model=64, vocab=128)
    # serve raises the capacity factor to E/K; keep both packages in step
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, capacity_factor=4.0,
                                                         **moe_kw))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, capacity_factor=4.0,
                                                         **moe_kw))
    p = jmoe.init_moe_block(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    return jc, tc, p, x


def _tparams(p):
    # params_from_jax checks an embedding; convert the block's leaves directly
    return {k: _tparams(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in p.items()}


@pytest.mark.parametrize("name,moe_kw", [
    ("mula-7b-a1b", {}),
    ("mula-7b-a1b", {"dispatch": "dropless"}),
    ("moonshot-v1-16b-a3b", {}),              # a shared expert
])
def test_sparse_moe_block_matches_jax_and_naive(name, moe_kw):
    jc, tc, p, x = _moe_setup(name, **moe_kw)
    with use_kernel_plan(PLAN):
        jout, jaux, jz, jstats = jmoe.sparse_moe_block(p, jnp.asarray(x), jc)
    tp = _tparams(_np(p))
    tout, taux, tz, tstats = tmoe.sparse_moe_block(tp, _t(x), tc)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)
    np.testing.assert_allclose(tz.item(), float(jz), **TOL)
    np.testing.assert_array_equal(tstats.counts.numpy(), np.asarray(jstats.counts))
    assert tstats.drops.item() == 0 == float(jstats.drops)
    naive, _ = tmoe.moe_naive(tp, _t(x).reshape(-1, 64), tc.moe)
    np.testing.assert_allclose(tout.numpy().reshape(-1, 64), naive.numpy(), **TOL)


def test_naive_impl_matches_jax():
    jc, tc, p, x = _moe_setup("mula-7b-a1b", moe_impl="naive")
    jout, _, _, jstats = jmoe.sparse_moe_block(p, jnp.asarray(x), jc)
    tout, _, _, tstats = tmoe.sparse_moe_block(_tparams(_np(p)), _t(x), tc)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_array_equal(tstats.counts.numpy(), np.asarray(jstats.counts))


def test_params_from_jax_checks_vocab():
    cfg = treduced(tget("mula-7b-a1b"), d_model=64, vocab=128)
    with pytest.raises(ValueError, match="pads its vocab"):
        params_from_jax({"embed": {"table": np.zeros((100, 64), np.float32)}}, cfg,
                        device="cpu")
