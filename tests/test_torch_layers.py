"""PyTorch port, model layers against the JAX package on the same numpy
inputs (float32, atol = rtol = 1e-4): norms, RoPE, prefill attention
through the flash path, training attention through the blockwise path
(forward and gradients), cached decode attention (full and ring caches),
MLPs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

PLAN = KernelPlan(backend="pallas", attn_impl="pallas", interpret=True,
                  tile_m=8, tile_k=64, tile_n=32)
TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(p):
    return {k: _tree(v) if isinstance(v, dict) else _t(v) for k, v in p.items()}


def _cfgs(name, window=0):
    jc = dataclasses.replace(jreduced(jget(name), d_model=64, vocab=128),
                             sliding_window=window)
    tc = dataclasses.replace(treduced(tget(name), d_model=64, vocab=128),
                             sliding_window=window)
    return jc, tc


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    expect = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind)
    np.testing.assert_allclose(TL.apply_norm(_tree(p), _t(x), kind).numpy(),
                               np.asarray(expect), **TOL)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6, 7, 8], [40, 41, 42, 43, 44, 45, 46, 47, 48]])
    expect = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    np.testing.assert_allclose(TL.apply_rope(_t(x), _t(pos), 1e4).numpy(),
                               np.asarray(expect), **TOL)


@pytest.mark.parametrize("name,window", [("mula-7b-a1b", 0), ("mixtral-8x7b", 6)])
def test_prefill_attention_matches_jax(name, window):
    jc, tc = _cfgs(name, window)
    p = JL.init_attention(jax.random.PRNGKey(0), jc)
    x = np.random.default_rng(2).standard_normal((2, 13, 64)).astype(np.float32)
    with use_kernel_plan(PLAN):
        jout, (jk, jv) = JL.attention(p, jnp.asarray(x), jc, return_kv=True,
                                      q_block=8, kv_block=8)
    tout, (tk, tv) = TL.attention(_tree(p), _t(x), tc, return_kv=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("S,nh,nkv,window", [
    (40, 4, 4, 0),           # causal, Sq not a multiple of the block
    (37, 4, 2, 8),           # GQA + sliding window: whole kv blocks skipped
    (16, 2, 1, 0),           # one block
])
def test_blockwise_attention_and_grads_match_jax(S, nh, nkv, window):
    rng = np.random.default_rng(5)
    hd = 16
    q, k, v, cot = (rng.standard_normal((2, S, n, hd)).astype(np.float32)
                    for n in (nh, nkv, nkv, nh))

    def jfn(q, k, v):
        return JL._blockwise_attention(q, k, v, causal=True, window=window,
                                       q_block=8, kv_block=8)

    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(cot))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    tout = TL.blockwise_attention(tq, tk, tv, causal=True, window=window,
                                  q_block=8, kv_block=8)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), _t(cot))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    for name, tg, jg in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL, err_msg=f"d{name}")


def test_training_attention_matches_jax():
    """``attention(impl='blockwise')`` against the JAX attention under
    ``attn_impl='blockwise'``, and against the flash path's output."""
    jc, tc = _cfgs("mixtral-8x7b", 6)
    p = JL.init_attention(jax.random.PRNGKey(1), jc)
    x = np.random.default_rng(3).standard_normal((2, 13, 64)).astype(np.float32)
    with use_kernel_plan(KernelPlan(backend="pallas", attn_impl="blockwise", interpret=True)):
        jout = JL.attention(p, jnp.asarray(x), jc)
    tout = TL.attention(_tree(p), _t(x), tc, impl="blockwise")
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(TL.attention(_tree(p), _t(x), tc).numpy(), tout.numpy(), **TOL)
    with pytest.raises(ValueError, match="impl"):
        TL.attention(_tree(p), _t(x), tc, impl="xla")


@pytest.mark.parametrize("window,positions", [
    (0, [3, 0, 11]),          # full cache
    (0, [3, 16, 11]),         # a write past the cache end is dropped
    (4, [3, 9, 22]),          # ring cache, wrapped rows
])
def test_decode_attention_matches_jax(window, positions):
    jc, tc = _cfgs("mixtral-8x7b", window)       # GQA: 4 query heads, 1 kv head
    p = JL.init_attention(jax.random.PRNGKey(1), jc)
    rng = np.random.default_rng(3)
    S = 16 if window == 0 else window
    cache = {"k": rng.standard_normal((3, S, jc.num_kv_heads, jc.head_dim)),
             "v": rng.standard_normal((3, S, jc.num_kv_heads, jc.head_dim))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    pos = np.array(positions, np.int32)
    jout, jcache = JL.decode_attention(p, jnp.asarray(x),
                                       {k: jnp.asarray(v) for k, v in cache.items()},
                                       jnp.asarray(pos), jc)
    tcache = _tree(cache)
    tout = TL.decode_attention(_tree(p), _t(x), tcache, _t(pos), tc)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), **TOL)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp_matches_jax(activation):
    p = JL.init_mlp(jax.random.PRNGKey(2), 32, 48, activation)
    x = np.random.default_rng(4).standard_normal((2, 5, 32)).astype(np.float32)
    expect = JL.apply_mlp(p, jnp.asarray(x), activation)
    np.testing.assert_allclose(TL.apply_mlp(_tree(p), _t(x), activation).numpy(),
                               np.asarray(expect), **TOL)


def test_embed_unembed_match_jax():
    p = JL.init_embedding(jax.random.PRNGKey(3), 128, 32)
    toks = np.array([[1, 5, 127], [0, 3, 64]], np.int32)
    h = JL.embed(p, jnp.asarray(toks), jnp.float32)
    th = TL.embed(_tree(p), _t(toks).long(), torch.float32)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), **TOL)
    np.testing.assert_allclose(TL.unembed(_tree(p), th).numpy(),
                               np.asarray(JL.unembed(p, h)), **TOL)
