"""PyTorch port, the one-process pipelined train step
(``make_train_step`` with ``ParallelConfig(pp_stages=2)``) under gpipe and
under 1f1b against the JAX package's PP step off mesh (``make_train_step``
with ``ParallelConfig(pp_stages=2)``, ``pp_impl='masked'``: its masked
executor, under gpipe for two models and 1f1b for the other two: its tick
order changes no sum), from the same converted params and optimizer
state, float32:

* dense Mula-1B, Mula-7B-A1B dropless, Mula-7B-A1B under capacity
  dispatch with overflowing experts (capacity factor 0.25, 128 tokens a
  microbatch: both sides drop the same pairs), and falcon-mamba-7b (8
  tokens a row)
  (arch_type 'ssm', its bf16 scan streams patched to float32 on both sides,
  ``test_torch_mamba1.exact_streams``), 4 layers, 2 stages;
* two steps: loss and every metric at atol = rtol = 1e-4, every gradient
  of the first step and every param after the second at atol 1e-4 of the
  leaf's max|value| and rtol 1e-3 (``torch_parity.assert_leaves_close``:
  sums of many terms in another order).

Also: the PP step updates the params bit for bit as the port's own
non-PP step with the same microbatches does (the stages run back to back
are the sequential model, the gradients add up in microbatch order), 1f1b keeps at most pp stage inputs
saved on stage 0 (gpipe all of them), and what pipelines refuse. The JAX
side runs its Pallas kernels in interpret mode with ``tile_m`` equal to
the port's ``gmm_align()``, as ``test_torch_train.py`` does, where the
capacity pool decides the drops, and the default plan elsewhere."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.configs.base import ParallelConfig as JParallel  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.configs import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.train import TrainState, init_state, make_train_step  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path  # noqa: E402

from test_torch_mamba1 import exact_streams  # noqa: E402,F401
from torch_parity import assert_leaves_close  # noqa: E402

PLAN = KernelPlan(backend="pallas", attn_impl="blockwise", interpret=True,
                  tile_m=ops.gmm_align(), tile_k=64, tile_n=32)
TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(param_dtype="float32", compute_dtype="float32", grad_reduce_dtype="float32")
LAYERS, PP = 4, 2
# model name -> (arch, MoE overrides, batch rows, sequence, microbatches)
CASES = {
    "dense": ("mula-1b", None, 4, 16, 4),
    "dropless": ("mula-7b-a1b", dict(dispatch="dropless"), 4, 16, 4),
    "capacity": ("mula-7b-a1b", dict(dispatch="capacity", capacity_factor=0.25), 8, 32, 2),
    "ssm": ("falcon-mamba-7b", None, 4, 8, 2),
}


def _plan(case):
    """The JAX kernel plan: the Pallas grouped FFN (interpret mode) where
    the capacity pool's geometry decides the drops; elsewhere the default
    plan (its dropless MoE path packs the same ragged groups, and the
    dense and ssm models have no MoE block), which compiles much faster."""
    return PLAN if case == "capacity" else KernelPlan()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny models run faster on one torch thread than on every core,
    and the suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(case):
    arch, moe_kw, _, _, _ = CASES[case]
    cfgs = []
    for get, red in ((jget, jreduced), (tget, treduced)):
        c = red(get(arch), d_model=64, vocab=128, layers=LAYERS)
        if moe_kw:
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe_kw))
        cfgs.append(c)
    return cfgs


def _batches(case, n=2, vocab=128):
    _, _, b, s, _ = CASES[case]
    out = []
    for i in range(n):
        toks = np.random.default_rng(20 + i).integers(0, vocab, size=(b, s + 1)).astype(np.int32)
        toks[0, -3:] = -100                          # a few masked labels
        tokens, labels = np.maximum(toks[:, :-1], 0), toks[:, 1:]
        out.append(({"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
                    {"tokens": torch.from_numpy(tokens).long(),
                     "labels": torch.from_numpy(labels).long()}))
    return out


def _train(case):
    _, _, b, s, _ = CASES[case]
    return dict(seq_len=s, global_batch=b, warmup_steps=1, total_steps=10, lr_peak=1e-2,
                lr_min=1e-3, **F32)


# the schedule of each model's JAX run: the masked executor's tick order
# changes no sum (its gradients add up in microbatch order under either), so
# each model's JAX step is compiled once, the four runs cover both
# schedules, and both of the port's schedules are held to it
JAX_SCHEDULE = {"dense": "gpipe", "dropless": "1f1b", "capacity": "gpipe", "ssm": "1f1b"}
_JAX_RUNS = {}


def _jax_run(case, monkeypatch):
    """The JAX PP step off mesh, under the model's JAX_SCHEDULE: two steps
    from init_state(PRNGKey(0)); the first step's gradients caught on their
    way into AdamW. Computed once a model."""
    if case not in _JAX_RUNS:
        _JAX_RUNS[case] = _jax_steps(case, JAX_SCHEDULE[case], monkeypatch)
    return _JAX_RUNS[case]


def _jax_steps(case, schedule, monkeypatch):
    jc, _ = _cfgs(case)
    n_mb = CASES[case][4]
    jtrain = JTrain(**_train(case))
    jstate = jinit_state(jax.random.PRNGKey(0), jc, jtrain)
    init = jax.tree.map(np.asarray, (jstate.params, jstate.opt))
    caught = {}
    orig = jtrainer.adamw_update

    def catch(grads, *a, **kw):
        caught["grads"] = grads
        return orig(grads, *a, **kw)

    monkeypatch.setattr(jtrainer, "adamw_update", catch)
    par = JParallel(microbatches=n_mb, pp_stages=PP, pp_schedule=schedule, pp_impl="masked")
    with use_kernel_plan(_plan(case)):
        step = jmake_train_step(jc, par, jtrain)

        @jax.jit
        def run(state, batch):
            state, m = step(state, batch)
            return state, m, caught["grads"]

        out = []
        for jb, _ in _batches(case):
            jstate, jm, jg = run(jstate, jb)
            out.append((jax.tree.map(np.asarray, jm), jax.tree.map(np.asarray, jg)))
    return init, out, jax.tree.map(np.asarray, jstate.params)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("case", list(CASES))
def test_pp_step_matches_jax(case, schedule, monkeypatch, exact_streams):  # noqa: F811
    (jparams, jopt), jsteps, jfinal = _jax_run(case, monkeypatch)
    _, tc = _cfgs(case)
    n_mb = CASES[case][4]
    state = TrainState(params_from_jax(jparams, tc, device="cpu"),
                       opt_state_from_jax(jopt, device="cpu"))
    step = make_train_step(tc, ParallelConfig(microbatches=n_mb, pp_stages=PP,
                                              pp_schedule=schedule, pp_impl="masked"),
                           TrainConfig(**_train(case)))
    for i, ((_, tb), (jm, jg)) in enumerate(zip(_batches(case), jsteps)):
        if i == 0:
            _, _, grads = step.loss_and_grads(state.params, tb)
            assert_leaves_close(dict(leaves_with_path(grads)), jg, f"{case} grad")
        state, tm = step(state, tb)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k].numpy(), jm[k], **TOL, err_msg=f"{case} {i} {k}")
    if case == "capacity":
        assert float(tm["moe_drops"]) > 0          # the experts overflow
    assert_leaves_close(dict(leaves_with_path(state.params)), jfinal, f"{case} params")


def test_stage_pieces_match_jax():
    """``embed_tokens``, each stage's ``pipeline_stage_forward`` (its
    output and the MoE stage's aux, z and counts) and ``lm_head_ce``
    against the JAX pieces on the same params and tokens, at 1e-4 (the
    dropless MoE model; the dense and ssm stages run in the step tests)."""
    case = "dropless"
    from repro.models import model as jmodel
    from repro_torch.models import model as tmodel
    from repro_torch.parallel.pipeline import split_stages
    jc, tc = _cfgs(case)
    jp = jax.tree.map(np.asarray, jinit_state(jax.random.PRNGKey(0), jc, JTrain()).params)
    tp = params_from_jax(jp, tc, device="cpu")
    (jb, tb), = _batches(case, n=1)
    with use_kernel_plan(_plan(case)):
        jh = jmodel.embed_tokens(jp, jb["tokens"], jc, compute_dtype=jnp.float32)
        th = tmodel.embed_tokens(tp, tb["tokens"], tc, compute_dtype=torch.float32)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        for s, lp in enumerate(split_stages(tp["layers"], PP)):
            per = LAYERS // PP
            jlp = jax.tree.map(lambda a, s=s: a[s * per:(s + 1) * per], jp["layers"])
            jh, jaux, jz, jst = jmodel.pipeline_stage_forward(jlp, jh, jc)
            with torch.no_grad():
                th, taux, tz, tst = tmodel.pipeline_stage_forward(lp, th, tc)
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL, err_msg=f"stage {s}")
            for got, want in ((taux, jaux), (tz, jz), (tst.counts, jst.counts)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        with torch.no_grad():
            tce = tmodel.lm_head_ce(tp, th, tb["labels"], tc)
        np.testing.assert_allclose(float(tce), float(jmodel.lm_head_ce(jp, jh, jb["labels"], jc)),
                                   **TOL)
    with pytest.raises(ValueError, match="non-uniform layer stacks"):
        tmodel.pipeline_stage_forward({}, th, treduced(tget("zamba2-7b")))


@pytest.mark.parametrize("case", ["dropless", "capacity", "dense"])
def test_pp_step_is_the_non_pp_step(case):
    """From one state and batch, two PP steps (1f1b, then gpipe) and two
    non-PP steps with the same microbatches: the params equal bit for bit,
    the metrics to 1e-6 (the loss sums its terms in another order); 1f1b
    keeps at most pp stage inputs saved on stage 0, gpipe all of them."""
    _, tc = _cfgs(case)
    n_mb = CASES[case][4]
    train = TrainConfig(**_train(case))
    states = [init_state(tc, train, seed=3, device="cpu") for _ in range(2)]
    plain = make_train_step(tc, ParallelConfig(microbatches=n_mb), train)
    for schedule, (_, tb) in zip(("1f1b", "gpipe"), _batches(case)):
        piped = make_train_step(tc, ParallelConfig(microbatches=n_mb, pp_stages=PP,
                                                   pp_schedule=schedule), train)
        states[0], pm = piped(states[0], tb)
        states[1], m = plain(states[1], tb)
        assert sorted(pm) == sorted(set(m) - {"moe_aux", "moe_z", "ntok"})
        for k in pm:
            # the loss adds the same terms in another order
            np.testing.assert_allclose(pm[k].numpy(), m[k].numpy(), rtol=1e-6, atol=0,
                                       err_msg=f"{case} {schedule} {k}")
        want = {0: min(PP, n_mb) if schedule == "1f1b" else n_mb}
        assert piped.saved_peak[0] == want[0], piped.saved_peak
    for a, b in zip(leaves(states[0].params), leaves(states[1].params)):
        assert torch.equal(a, b)


def test_pp_step_refusals():
    """What a pipeline refuses, with the JAX step's errors: a non-uniform
    (hybrid) stack, a non-identity expert placement, a layer count pp does
    not divide, and an unknown schedule."""
    from repro_torch.parallel.placement import ExpertPlacement
    hyb = treduced(tget("zamba2-7b"), d_model=64, vocab=128, layers=4)
    jhyb = jreduced(jget("zamba2-7b"), d_model=64, vocab=128, layers=4)
    with pytest.raises(ValueError) as te:
        make_train_step(hyb, ParallelConfig(pp_stages=2), TrainConfig())
    with pytest.raises(ValueError) as je:
        jmake_train_step(jhyb, JParallel(pp_stages=2), JTrain())
    assert str(te.value) == str(je.value)
    _, moe = _cfgs("dropless")
    moved = ExpertPlacement.broadcast(np.roll(np.arange(moe.moe.num_experts), 1), LAYERS)
    with pytest.raises(NotImplementedError, match="rebalance requires pp=1"):
        make_train_step(moe, ParallelConfig(pp_stages=2), TrainConfig(), placement=moved)
    with pytest.raises(ValueError, match="do not divide evenly"):
        make_train_step(moe, ParallelConfig(pp_stages=3), TrainConfig())
    with pytest.raises(ValueError, match="pp_schedule"):
        make_train_step(moe, ParallelConfig(pp_stages=2, pp_schedule="zigzag"), TrainConfig())
