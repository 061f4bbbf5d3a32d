"""PyTorch port, the model slice: ``prefill_with_cache`` (last logits and
the cache) and four lockstep ``decode_step``s against the JAX package under
the Pallas-interpret kernel plan, for reduced Mula-7B-A1B (MoE), Mula-1B
(dense) and Mixtral-8x7B (GQA, sliding window 8 -> ring caches), from the
same parameters, float32, atol = rtol = 1e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import prefill_with_cache as jprefill  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro.serve.engine import dropless_cfg as jdropless  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import dropless_cfg as tdropless  # noqa: E402

PLAN = KernelPlan(backend="pallas", attn_impl="pallas", interpret=True,
                  tile_m=8, tile_k=64, tile_n=32)
TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(name, window):
    jc = jdropless(dataclasses.replace(jreduced(jget(name), d_model=64, vocab=128),
                                       sliding_window=window))
    tc = tdropless(dataclasses.replace(treduced(tget(name), d_model=64, vocab=128),
                                       sliding_window=window))
    return jc, tc


@pytest.mark.parametrize("name,window", [("mula-7b-a1b", 0), ("mula-1b", 0),
                                         ("mixtral-8x7b", 8)])
def test_prefill_and_decode_match_jax(name, window):
    jc, tc = _pair(name, window)
    jp = jinit_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(1, 127, size=(2, 16)).astype(np.int32)
    lengths = np.array([11, 16], np.int32)
    slots = np.array([2, 0], np.int32)
    with use_kernel_plan(PLAN):
        jcache = jinit_cache(jc, 3, 32, jnp.float32)
        jlast, jcache = jprefill(jp, jnp.asarray(toks), jcache, jnp.asarray(slots),
                                 jnp.asarray(lengths), jc, compute_dtype=jnp.float32)
    tcache = tm.init_cache(tc, 3, 32, device="cpu", dtype=torch.float32)
    tlast, tcache = tm.prefill_with_cache(tp, torch.from_numpy(toks).long(), tcache,
                                          slots.tolist(), lengths.tolist(), tc,
                                          compute_dtype=torch.float32)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tcache["kv"][leaf].numpy(),
                                   np.asarray(jcache["kv"][leaf]), **TOL)

    # four lockstep decode steps over all three rows (row 1 starts empty)
    pos = np.array([16, 0, 11], np.int32)
    tok = rng.integers(1, 127, size=(3, 1)).astype(np.int32)
    for _ in range(4):
        with use_kernel_plan(PLAN):
            jl, jcache = jdecode(jp, jnp.asarray(tok), jcache, jnp.asarray(pos), jc,
                                 compute_dtype=jnp.float32)
        tl, tcache = tm.decode_step(tp, torch.from_numpy(tok).long(), tcache,
                                    torch.from_numpy(pos).long(), tc,
                                    compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jnp.argmax(jl[:, 0, :jc.vocab_size], -1))[:, None].astype(np.int32)
        pos = pos + 1
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tcache["kv"][leaf].numpy(),
                                   np.asarray(jcache["kv"][leaf]), **TOL)


def test_init_params_layout_matches_jax():
    """Same tree, shapes and init scales (the values differ: each package
    draws from its own generator)."""
    jc, tc = _pair("mula-7b-a1b", 0)
    jp = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(0), jc))
    tp = tm.init_params(tc, seed=0, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jl) == len(jax.tree_util.tree_leaves(tp))
    for path, leaf in jl:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(node.float().std().item(), leaf.std(), rtol=0.2,
                                   err_msg=jax.tree_util.keystr(path))


def test_unsupported_arch_raises():
    cfg = treduced(tget("phi-3-vision-4.2b"), d_model=64, vocab=128)
    with pytest.raises(NotImplementedError, match="item 6"):
        tm.init_params(cfg, device="cpu")
