"""PyTorch port, serving: the port's ``ServeEngine`` serves the JAX engine's
greedy tokens exactly (4 requests over 3 slots, same parameters, the JAX
side under the Pallas-interpret plan); the sampling determinism contract;
slot-pool guards."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serve import SamplingParams, ServeEngine, SlotKVPool, sample_tokens  # noqa: E402
from repro_torch.serve.sampling import position_generators  # noqa: E402

PLAN = KernelPlan(backend="pallas", attn_impl="pallas", interpret=True,
                  tile_m=8, tile_k=64, tile_n=32)


def _prompts(n, seed=0, lo=3, hi=20):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 127, size=rng.randint(lo, hi)).tolist() for _ in range(n)]


@pytest.mark.parametrize("name,window", [("mula-7b-a1b", 0), ("mixtral-8x7b", 8)])
def test_engine_greedy_tokens_match_jax(name, window):
    jc = dataclasses.replace(jreduced(jget(name), d_model=64, vocab=128),
                             sliding_window=window)
    tc = dataclasses.replace(treduced(tget(name), d_model=64, vocab=128),
                             sliding_window=window)
    jp = jinit_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    prompts = _prompts(4)
    max_new = [6, 3, 8, 5]
    with use_kernel_plan(PLAN):
        jeng = JEngine(jp, jc, num_slots=3, max_len=32)
        for p, n in zip(prompts, max_new):
            jeng.submit(p, n)
        jres = jeng.run()
    teng = ServeEngine(tp, tc, num_slots=3, max_len=32, device="cpu")
    for p, n in zip(prompts, max_new):
        teng.submit(p, n)
    tres = teng.run()
    assert sorted(tres) == sorted(jres) == [0, 1, 2, 3]
    for rid in jres:
        assert tres[rid].tokens == jres[rid].tokens, rid
        assert tres[rid].finish_reason == jres[rid].finish_reason
    assert teng.prefills == 4 and teng.tokens_generated == sum(max_new)


def test_sampling_depends_only_on_seed_position_and_logits():
    """The same (seed, position, logits) row gives the same token wherever it
    sits in the batch and whoever else is in it; greedy rows take the
    argmax; a changed seed or position changes the draw."""
    g = torch.Generator().manual_seed(0)
    V = 64
    row = torch.randn(V, generator=g)
    other = torch.randn(3, V, generator=g)
    sp = dict(temperature=[0.9], top_k=[20], top_p=[0.95])

    def draw(logits, seeds, positions, temperature, top_k, top_p):
        gens = position_generators(seeds, positions, "cpu", temperature)
        return sample_tokens(logits, gens, temperature, top_k, top_p)

    alone = draw(row[None], [7], [12], **sp)
    batch = torch.cat([other[:2], row[None], other[2:]])
    mixed = draw(batch, [1, 2, 7, 3], [5, 6, 12, 9], [0.0, 1.0, 0.9, 0.0],
                 [0, 5, 20, 0], [1.0, 0.5, 0.95, 1.0])
    assert mixed[2] == alone[0]
    assert mixed[0] == other[0].argmax() and mixed[3] == other[2].argmax()
    draws = {int(draw(row[None], [s], [p], **sp)[0]) for s in range(6) for p in range(6)}
    assert len(draws) > 1


def test_top_k_one_and_tiny_top_p_are_greedy():
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(4, 32, generator=g)
    temperature = [1.0, 1.0, 2.0, 0.5]
    gens = position_generators([0, 1, 2, 3], [0, 0, 0, 0], "cpu", temperature)
    out = sample_tokens(logits, gens, temperature, [1, 0, 1, 0], [1.0, 1e-6, 0.3, 1e-9])
    assert torch.equal(out, logits.argmax(-1))


def test_slot_pool_guards():
    cfg = treduced(tget("mixtral-8x7b"), d_model=64, vocab=128)      # window 64
    with pytest.raises(ValueError, match="sliding_window"):
        SlotKVPool(cfg, 2, 16, device="cpu")
    pool = SlotKVPool(dataclasses.replace(cfg, sliding_window=0), 2, 16, device="cpu")
    a, b = pool.alloc(), pool.alloc()
    assert (a, b) == (0, 1) and pool.num_free == 0
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc()
    pool.free(b)
    with pytest.raises(ValueError, match="bad free"):
        pool.free(b)
    assert pool.alloc() == b
    assert pool.slot_bytes() == 2 * 2 * 16 * cfg.num_kv_heads * cfg.head_dim * 4


def test_engine_rejects_overlong_and_empty_prompts():
    cfg = treduced(tget("mula-7b-a1b"), d_model=64, vocab=128)
    from repro_torch.models import init_params
    eng = ServeEngine(init_params(cfg, device="cpu"), cfg, num_slots=1, max_len=16,
                      device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([], 4)
    with pytest.raises(ValueError, match="exceeds cache max_len"):
        eng.submit([1] * 10, 8)
    rid = eng.submit([1, 2, 3], 4, SamplingParams(temperature=0.7, seed=3))
    assert len(eng.run()[rid].tokens) == 4
