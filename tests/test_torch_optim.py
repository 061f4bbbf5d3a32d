"""PyTorch port, the optimizer: ``warmup_cosine``, ``global_norm`` (plain
and with the per-(layer, expert) ``expert_norm`` association),
``clip_scale`` and two ``adamw_update`` steps against the JAX package's
``repro.optim`` on the same numpy inputs, float32, atol = rtol = 1e-5
(elementwise math; the norms sum in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.parallel.placement import expert_leaf_mask as jexpert_leaf_mask  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
L, E = 2, 4


def _tree(seed):
    """A tree shaped like a MoE model's: expert stacks (L, E, ...), a router
    (L, d, E), a shared expert and plain leaves."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"embed": {"table": r(16, 8)},
            "layers": {"moe": {"gate": r(L, E, 8, 6), "up": r(L, E, 8, 6),
                               "down": r(L, E, 6, 8), "router": r(L, 8, E),
                               "shared": {"gate": r(L, 8, 6)}},
                       "ln1": {"scale": r(L, 8)}}}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 600, 1000, 2000])
def test_warmup_cosine_matches_jax(step):
    kw = dict(lr_peak=4e-4, lr_min=4e-5, warmup_steps=100, total_steps=1000)
    expect = float(jopt.warmup_cosine(step, **kw))
    assert topt.warmup_cosine(step, **kw).item() == pytest.approx(expect, rel=1e-6, abs=1e-12)
    t = topt.warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
    assert t.dtype == torch.float32 and t.item() == pytest.approx(expect, rel=1e-6, abs=1e-12)


def test_expert_mask_and_global_norm_match_jax():
    tree = _tree(0)
    jmask = jexpert_leaf_mask(_j(tree), L, E)
    tmask = topt.expert_leaf_mask(_t(tree), L, E)
    assert tmask == jmask and sum(tmask) == 3
    for en in (None, (tmask, None)):
        expect = float(jopt.global_norm(_j(tree), expert_norm=None if en is None
                                        else (jmask, None)))
        got = topt.global_norm(_t(tree), expert_norm=en).item()
        np.testing.assert_allclose(got, expect, **TOL)
    inv = np.array([[1, 0, 3, 2], [0, 1, 2, 3]], np.int32)
    np.testing.assert_allclose(
        topt.expert_slice_sumsq(_t(tree)["layers"]["moe"]["gate"], torch.from_numpy(inv)).item(),
        float(jopt.adamw.expert_slice_sumsq(jnp.asarray(tree["layers"]["moe"]["gate"]),
                                            jnp.asarray(inv))), **TOL)


@pytest.mark.parametrize("gnorm,clip,enabled", [(3.0, 1.0, None), (0.5, 1.0, None),
                                                (3.0, 1.0, False), (3.0, 1.0, True),
                                                (3.0, 0.0, True)])
def test_clip_scale_matches_jax(gnorm, clip, enabled):
    expect = float(jopt.clip_scale(jnp.float32(gnorm), clip,
                                   None if enabled is None else jnp.asarray(enabled)))
    got = topt.clip_scale(torch.tensor(gnorm), clip,
                          None if enabled is None else torch.tensor(enabled))
    assert got.item() == pytest.approx(expect, rel=1e-6)


def test_adamw_update_matches_jax():
    """Two updates from the same state with the expert-norm mask, the
    second clipped; params, master, moments and metrics agree."""
    params = _tree(1)
    jstate = jopt.adamw_init(_j(params))
    tstate = topt.adamw_init(_t(params))
    assert tstate.step.dtype == torch.int32
    jmask = jexpert_leaf_mask(_j(params), L, E)
    for i, (lr, clip_on) in enumerate([(1e-3, False), (5e-4, True)]):
        grads = _tree(10 + i)
        kw = dict(beta1=0.9, beta2=0.99, eps=1e-8, weight_decay=0.1, grad_clip=1.0)
        jp, jstate, jm = jopt.adamw_update(_j(grads), jstate, lr=jnp.float32(lr),
                                           clip_enabled=jnp.asarray(clip_on),
                                           expert_norm=(jmask, None), **kw)
        tp, tstate, tm = topt.adamw_update(_t(grads), tstate, lr=torch.tensor(lr),
                                           clip_enabled=torch.tensor(clip_on),
                                           expert_norm=(jmask, None), **kw)
        for k in ("grad_norm", "clip_scale"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), **TOL, err_msg=k)
        for name, tt, jt in (("params", tp, jp), ("master", tstate.master, jstate.master),
                             ("m", tstate.m, jstate.m), ("v", tstate.v, jstate.v)):
            for a, b in zip(leaves(tt), jax.tree.leaves(jt)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=name)
    assert float(tm["clip_scale"]) < 1.0
    assert tstate.step.item() == int(jstate.step) == 2
