"""PyTorch port, serving on a plan (``ServeEngine(plan=, grid=)``,
``make_prefill_step(plan=)``, ``make_serve_step(plan=)``; the JAX
engine's ``plan=``): reduced Mula-7B-A1B, float32, on 'ep' x 'tp' grids of
four CPU ranks over gloo, ep = 2 x tp = 2, ep = 4 and tp = 4, all in one
spawn, each rank with its tiles of the same params
(``convert.params_for_rank``):

* every rank's engine serves the greedy tokens of the port's one-device
  engine and of the JAX ``ServeEngine`` without a plan (a JAX plan places
  the params and changes no math; the JAX package's mesh8 paths do not
  trace on this JAX), 4 requests over 3 slots so that admission and
  eviction run;
* the prefill into cache slots (its last-position logits), the first
  decode step after it and the forward's last logits within atol = rtol =
  1e-4 of the one-device lowerings', and the prefill's of the JAX
  ``make_prefill_step(into_cache=True)``;
* dp = 2 and pp = 2 in serving are refused, naming ROADMAP.md §1 item
  5.7b, by the plan, the engine and both lowerings.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models import init_cache as jinit_cache, init_params as jinit_params  # noqa: E402
from repro.parallel.plan import use_kernel_plan  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.train import make_prefill_step as jmake_prefill_step  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import init_cache  # noqa: E402
from repro_torch.parallel import spawn  # noqa: E402
from repro_torch.parallel.plan import ParallelPlan  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import make_prefill_step, make_serve_step  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402
from test_torch_serve import PLAN, _prompts  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
GRIDS = [(2, 2), (4, 1), (1, 4)]          # (ep, tp)
MAX_NEW = [6, 3, 8, 5]
MAX_LEN = 32


def _cfgs():
    jc = jreduced(jget("mula-7b-a1b"), d_model=64, vocab=128)
    tc = treduced(tget("mula-7b-a1b"), d_model=64, vocab=128)
    return jc, tc


def _one_device(tc, params, prompts, batch):
    """The port's one-device engine tokens and lowerings, as the rank
    function computes them on a grid."""
    eng = ServeEngine(params, tc, num_slots=3, max_len=MAX_LEN, device="cpu")
    for p, n in zip(prompts, MAX_NEW):
        eng.submit(p, n)
    tokens = {rid: r.tokens for rid, r in eng.run().items()}
    B, P = batch.shape
    cache = init_cache(tc, B, MAX_LEN, device="cpu", dtype=torch.float32)
    last, cache = make_prefill_step(tc, compute_dtype=torch.float32, into_cache=True,
                                    device="cpu")(params, batch, cache, list(range(B)), [P] * B)
    step, _ = make_serve_step(tc, compute_dtype=torch.float32, device="cpu")(
        params, last.argmax(-1)[:, None], cache, P)
    fwd = make_prefill_step(tc, compute_dtype=torch.float32, device="cpu")(
        params, {"tokens": batch})
    return {"tokens": tokens, "prefill": last, "decode": step[:, 0], "forward": fwd}


def _jax(jc, jp, prompts, batch):
    """The JAX engine's greedy tokens (no plan) and its admission prefill's
    last logits."""
    with use_kernel_plan(PLAN):
        eng = JEngine(jp, jc, num_slots=3, max_len=MAX_LEN)
        for p, n in zip(prompts, MAX_NEW):
            eng.submit(p, n)
        tokens = {rid: r.tokens for rid, r in eng.run().items()}
        B, P = batch.shape
        cache = jinit_cache(jc, B, MAX_LEN, dtype=jnp.float32)
        last, _ = jmake_prefill_step(jc, compute_dtype=jnp.float32, into_cache=True)(
            jp, jnp.asarray(batch.numpy()), cache, jnp.arange(B), jnp.full((B,), P))
    return tokens, np.asarray(last)


@pytest.fixture(scope="module")
def served():
    jc, tc = _cfgs()
    jp = jinit_params(jax.random.PRNGKey(0), jc)
    params = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    prompts = _prompts(4)
    batch = torch.from_numpy(np.random.RandomState(3).randint(1, 127, size=(2, 8))).long()
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn, ranks.serve_grid_cases_rank, 4, device="cpu", timeout_s=240,
                          args=(tc, params, prompts, MAX_NEW, batch, GRIDS))
        want = _one_device(tc, params, prompts, batch)
        jtokens, jlast = _jax(jc, jp, prompts, batch)
        got = fut.result()
    return got, want, jtokens, jlast


@pytest.mark.parametrize("index", range(len(GRIDS)), ids=[f"ep{e}tp{t}" for e, t in GRIDS])
def test_grid_serves_the_one_device_tokens_and_logits(served, index):
    got, want, jtokens, jlast = served
    assert want["tokens"] == jtokens and sorted(jtokens) == [0, 1, 2, 3]
    assert [len(jtokens[r]) for r in sorted(jtokens)] == MAX_NEW
    for r in got:
        case = r[index]
        where = f"{GRIDS[index]} {case['coords']}"
        assert case["tokens"] == want["tokens"], where
        for k in ("prefill", "decode", "forward"):
            np.testing.assert_allclose(case[k].numpy(), want[k].numpy(), **TOL,
                                       err_msg=f"{where} {k}")
        np.testing.assert_allclose(case["prefill"].numpy(), jlast, **TOL, err_msg=where)
        assert all(torch.equal(case[k], got[0][index][k]) for k in ("prefill", "decode"))


@pytest.mark.parametrize("spec", ["dp=2,ep=2", "pp=2,tp=2"])
def test_serving_refuses_dp_and_pp(spec):
    _, tc = _cfgs()
    tc = dataclasses.replace(tc, num_layers=2)
    match = "ROADMAP.md §1 item 5.7b"
    with pytest.raises(NotImplementedError, match=match):
        ParallelPlan.parse(spec).resolve(tc, serving=True)
    plan = ParallelPlan.parse(spec).resolve(tc)          # a training plan
    with pytest.raises(NotImplementedError, match=match):
        ServeEngine({}, tc, plan=plan, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        make_prefill_step(tc, plan=plan, into_cache=True, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        make_serve_step(tc, plan=plan, device="cpu")
