"""PyTorch port, Mamba-1 (``arch_type="ssm"``, reduced falcon-mamba-7b)
against the JAX package on the CPU in float32: the mixer's block and decode
step, the model's init layout, forward, decode steps, loss and per-leaf
gradients, three ``make_train_step`` steps at 1 and 2 microbatches, and
the serving lowerings with greedy tokens.

Both packages start from the same weights (``convert.params_from_jax``)
and the same numpy inputs. The reduced model has 2 layers at d_model 64
(d_inner 128, d_state 16, dt_rank 4); sequences of 40 tokens. Tolerances:
atol = rtol = 1e-4; gradients atol 1e-4 * max|grad| of the leaf and rtol
1e-3, as ``tests/test_torch_train.py`` (sums of many terms in another
order).

The scan rounds its four streams to bfloat16, in both packages. The two
packages compute the values before the rounding in float32 in another
order (their GEMMs sum in another order), so now and then one of the
~40,000 stream elements lies within that difference of a rounding
boundary and rounds one bf16 step (2^-8 relative) apart. The values
(logits, loss) stay within 1e-4; a few gradient elements do not (up to
2.6e-4 of the leaf's max|grad| measured). So the gradient and training
step comparisons run twice: with the streams' rounding dtype read as
float32 on both sides (``exact_streams``: the JAX module's ``jnp.bfloat16``
and the port's ``STREAM_DTYPE``, patched for the test only) at the
tolerances above, and with the rounding on at 1e-3 of the leaf's
max|grad|."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.configs.base import ParallelConfig as JParallel  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serve.engine import make_decode_fn as jdecode_fn  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.train.trainer import make_prefill_step as jprefill_step  # noqa: E402
from repro.train.trainer import make_serve_step as jserve_step  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.train import TrainState, make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

from torch_parity import assert_leaves_close, batch_pair  # noqa: E402

NAME = "falcon-mamba-7b"
TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(param_dtype="float32", compute_dtype="float32", grad_reduce_dtype="float32")
SEQ = 40


class _F32Streams:
    """``jax.numpy`` as ``repro.models.ssm`` sees it, with ``bfloat16`` read
    as float32: the JAX scan's streams are then not rounded."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def exact_streams(monkeypatch):
    monkeypatch.setattr(jssm, "jnp", _F32Streams())
    monkeypatch.setattr(tssm, "STREAM_DTYPE", torch.float32)


@pytest.fixture(scope="module")
def ssm():
    """(jax cfg, port cfg, jax params (numpy leaves), port params)."""
    jc = jreduced(jget(NAME), d_model=64, vocab=128)
    tc = treduced(tget(NAME), d_model=64, vocab=128)
    jp = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(0), jc))
    return jc, tc, jp, params_from_jax(jp, tc, device="cpu")


def _np(t):
    return np.asarray(t)


def _tokens(vocab, batch=2, length=SEQ, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, size=(batch, length)).astype(np.int32)


def _assert_tree_close(ttree, jtree, **tol):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        node = ttree
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node.numpy(), _np(leaf), err_msg=jax.tree_util.keystr(path),
                                   **tol)


def test_mamba1_block_and_decode_step_match_jax(ssm):
    """Layer 1's mixer: the block over 40 tokens, then six decode steps from
    a zero state: outputs and both cache leaves (float32)."""
    jc, tc, jp, tp = ssm
    jm = jax.tree.map(lambda a: jnp.asarray(a[1]), jp["layers"]["mixer"])
    tmix = {k: v[1] for k, v in tp["layers"]["mixer"].items()}
    x = np.random.default_rng(3).standard_normal((2, SEQ, jc.d_model)).astype(np.float32)
    np.testing.assert_allclose(tssm.mamba1_block(tmix, torch.from_numpy(x), tc).numpy(),
                               _np(jssm.mamba1_block(jm, jnp.asarray(x), jc)), **TOL)
    jcache = jssm.init_mamba1_cache(jc, 2)
    tcache = {k: v[0] for k, v in tssm.init_mamba1_cache(tc, 2, num_layers=1,
                                                           device="cpu").items()}
    for t in range(6):
        xt = x[:, t:t + 1]
        jo, jcache = jssm.mamba1_decode_step(jm, jnp.asarray(xt), jcache, jc)
        to, tcache = tssm.mamba1_decode_step(tmix, torch.from_numpy(xt), tcache, tc)
        assert tuple(to.shape) == jo.shape
        np.testing.assert_allclose(to.numpy(), _np(jo), **TOL)
        for leaf in ("conv", "h"):
            assert tcache[leaf].dtype == torch.float32
            np.testing.assert_allclose(tcache[leaf].numpy(), _np(jcache[leaf]), **TOL)


def test_mamba1_streams_are_rounded_to_bf16(ssm, monkeypatch):
    """The scan rounds dt, dt x, B and C to bfloat16 whatever the compute
    dtype, as the JAX package does: in float32 the block agrees with the
    JAX block at 1e-4, a scan without the rounding misses it by far more,
    and both packages without it agree again."""
    jc, tc, jp, tp = ssm
    jm = jax.tree.map(lambda a: jnp.asarray(a[0]), jp["layers"]["mixer"])
    tmix = {k: v[0] for k, v in tp["layers"]["mixer"].items()}
    x = np.random.default_rng(4).standard_normal((2, 24, jc.d_model)).astype(np.float32)
    ref = _np(jssm.mamba1_block(jm, jnp.asarray(x), jc))
    np.testing.assert_allclose(tssm.mamba1_block(tmix, torch.from_numpy(x), tc).numpy(), ref,
                               **TOL)
    monkeypatch.setattr(tssm, "STREAM_DTYPE", torch.float32)
    unrounded = tssm.mamba1_block(tmix, torch.from_numpy(x), tc).numpy()
    assert np.abs(unrounded - ref).max() > 10 * TOL["atol"]
    monkeypatch.setattr(jssm, "jnp", _F32Streams())
    np.testing.assert_allclose(unrounded, _np(jssm.mamba1_block(jm, jnp.asarray(x), jc)), **TOL)


def test_ssm_init_layout_matches_jax(ssm):
    """init_params and init_cache: the same tree, leaf shapes and cache
    dtypes as the JAX package; init scales close (values differ: each
    package draws its own)."""
    jc, tc, jp, _ = ssm
    tp = tm.init_params(tc, seed=0, device="cpu")
    assert set(tp) == {"embed", "final_norm", "head", "layers"}
    assert set(tp["layers"]) == {"ln", "mixer"}
    jcache = jinit_cache(jc, 3, 24, jnp.bfloat16)
    tcache = tm.init_cache(tc, 3, 24, device="cpu", dtype=torch.bfloat16)
    assert set(tcache) == {"ssm"}
    for jtree, ttree in ((jp, tp), (jcache, tcache)):
        jl = jax.tree_util.tree_leaves_with_path(jtree)
        assert len(jl) == len(jax.tree_util.tree_leaves(ttree))
        for path, leaf in jl:
            node = ttree
            for k in path:
                node = node[k.key]
            key = jax.tree_util.keystr(path)
            assert tuple(node.shape) == leaf.shape, key
            if ttree is tcache:
                assert str(node.dtype).split(".")[-1] == str(leaf.dtype), key
            elif leaf.std() > 0:
                np.testing.assert_allclose(node.float().std().item(), leaf.std(), rtol=0.2,
                                           err_msg=key)
            else:
                np.testing.assert_array_equal(node.numpy(), np.asarray(leaf), err_msg=key)


def test_ssm_forward_matches_jax(ssm):
    jc, tc, jp, tp = ssm
    toks = _tokens(jc.vocab_size)
    jl, _ = jforward(jax.tree.map(jnp.asarray, jp), {"tokens": jnp.asarray(toks)}, jc, sac="",
                     compute_dtype=jnp.float32)
    for sac in ("", "block"):
        tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()}, tc, sac=sac,
                             compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
        assert "moe_stats" not in aux


def test_ssm_decode_matches_jax(ssm):
    """Ten lockstep decode steps from an empty cache: logits every step,
    both cache leaves of every layer at the end."""
    jc, tc, jp, tp = ssm
    toks = _tokens(jc.vocab_size, length=10)
    jcache = jinit_cache(jc, 2, 16, jnp.float32)
    tcache = tm.init_cache(tc, 2, 16, device="cpu", dtype=torch.float32)
    step = jax.jit(lambda p, t, c, i: jdecode(p, t, c, i, jc, compute_dtype=jnp.float32))
    for t in range(10):
        jl, jcache = step(jp, jnp.asarray(toks[:, t:t + 1]), jcache, jnp.int32(t))
        tl, tcache = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]).long(), tcache, t,
                                    tc, compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    assert len(jax.tree_util.tree_leaves(jcache)) == 2
    _assert_tree_close(tcache, jcache, **TOL)


def test_forward_last_logits_equal_stepped_decode(ssm):
    """The scan over the whole sequence and the recurrent decode step
    compute the same function: relative to max|logit| <= 1e-5."""
    _, tc, _, tp = ssm
    toks = torch.from_numpy(_tokens(tc.vocab_size)).long()
    fwd, _ = tm.forward(tp, {"tokens": toks}, tc, sac="", compute_dtype=torch.float32)
    cache = tm.init_cache(tc, 2, SEQ, device="cpu", dtype=torch.float32)
    for t in range(SEQ):
        step, cache = tm.decode_step(tp, toks[:, t:t + 1], cache, t, tc,
                                     compute_dtype=torch.float32)
    last = fwd[:, -1]
    rel = float((step[:, 0] - last).abs().max() / last.abs().max())
    assert rel <= 1e-5, rel


def _loss_and_grads(ssm, sac, grad_atol):
    jc, tc, jp, _ = ssm
    jb, tb = batch_pair(1, s=SEQ)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jloss_fn(p, jb, jc, sac=sac, compute_dtype=jnp.float32), has_aux=True)(
        jax.tree.map(jnp.asarray, jp))
    tree = params_from_jax(jp, tc, device="cpu")
    paths, flat = zip(*leaves_with_path(tree))
    for x in flat:
        x.requires_grad_()
    tl, tmet = tm.loss_fn(tree, tb, tc, sac=sac, compute_dtype=torch.float32)
    grads = torch.autograd.grad(tl, flat)
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    assert sorted(tmet) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tmet[k].detach().numpy(), np.asarray(jm[k]), **TOL,
                                   err_msg=k)
    assert_leaves_close(dict(zip(paths, grads)), jg, "grad", grad_atol)


@pytest.mark.parametrize("sac", ["block", "ssm", ""])
def test_loss_and_grads_match_jax(ssm, sac, exact_streams):
    """loss_fn's value, metrics and every leaf's gradient under block remat,
    the 'ssm' SAC name and no remat, the streams unrounded on both sides."""
    _loss_and_grads(ssm, sac, 1e-4)


def test_loss_and_grads_with_bf16_streams(ssm):
    """The same with the streams rounded to bfloat16, as both packages run:
    loss and metrics at 1e-4, gradients at 1e-3 of each leaf's max|grad|
    (a few elements off by the bf16 roundings that fall apart)."""
    _loss_and_grads(ssm, "block", 1e-3)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(microbatches, exact_streams):
    """Three steps from the same params and AdamW state (warmup_steps=1:
    step 0 has lr 0 and no clipping, steps 1-2 clip), the streams
    unrounded on both sides (AdamW's normalised update turns a rounding
    flip in a near-zero gradient into a step of up to lr)."""
    jc = jreduced(jget(NAME), d_model=64, vocab=128)
    tc = treduced(tget(NAME), d_model=64, vocab=128)
    kw = dict(seq_len=SEQ, global_batch=4, warmup_steps=1, total_steps=10, lr_peak=1e-2,
              lr_min=1e-3, **F32)
    jtrain, ttrain = JTrain(**kw), TrainConfig(**kw)
    jstate = jinit_state(jax.random.PRNGKey(0), jc, jtrain)
    tstate = TrainState(params_from_jax(jax.tree.map(np.asarray, jstate.params), tc,
                                        device="cpu"),
                        opt_state_from_jax(jax.tree.map(np.asarray, jstate.opt), device="cpu"))
    jstep = jax.jit(jmake_train_step(jc, JParallel(microbatches=microbatches), jtrain))
    tstep = make_train_step(tc, ParallelConfig(microbatches=microbatches), ttrain)
    clips = []
    for i in range(3):
        jb, tb = batch_pair(10 + i, s=SEQ)
        jstate, jm = jstep(jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        assert sorted(tmet) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(tmet[k].numpy(), np.asarray(jm[k]), **TOL,
                                       err_msg=f"step {i} {k}")
        clips.append(float(jm["clip_scale"]))
    assert clips[0] == 1.0 and clips[1] < 1.0 and clips[2] < 1.0
    assert_leaves_close(dict(leaves_with_path(tstate.params)), jstate.params, "params")
    assert_leaves_close(dict(leaves_with_path(tstate.opt.v)), jstate.opt.v, "v")
    assert int(tstate.opt.step) == int(jstate.opt.step) == 3


def test_prefill_and_serve_steps_match_jax(ssm):
    """make_prefill_step's last logits; the prompt stepped through
    make_serve_step (a recurrent arch prefills so), then greedy generation,
    and the engine's sampling decode at temperature 0: logits within
    tolerance, greedy tokens identical to the JAX package's. Prefill into
    cache slots is refused by both packages."""
    jc, tc, jp, tp = ssm
    toks = _tokens(jc.vocab_size, length=20, seed=4)
    jlast = jprefill_step(jc, compute_dtype=jnp.float32)(jp, {"tokens": jnp.asarray(toks)})
    tlast = make_prefill_step(tc, compute_dtype=torch.float32, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlast.numpy(), _np(jlast), **TOL)

    jstep = jax.jit(jserve_step(jc, compute_dtype=jnp.float32))
    tstep = make_serve_step(tc, compute_dtype=torch.float32, device="cpu")
    jcache = jinit_cache(jc, 2, 32, jnp.float32)
    tcache = tm.init_cache(tc, 2, 32, device="cpu", dtype=torch.float32)
    for t in range(toks.shape[1]):
        jl, jcache = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jcache, jnp.int32(t))
        tl, tcache = tstep(tp, torch.from_numpy(toks[:, t:t + 1]), tcache, t)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    np.testing.assert_allclose(tl[:, 0].numpy(), tlast.numpy(), **TOL)
    jgen, tgen = [], []
    jtok = np.asarray(jnp.argmax(jl[:, 0, :jc.vocab_size], -1))[:, None]
    ttok = tl[:, 0, :tc.vocab_size].argmax(-1)[:, None]
    for i in range(6):
        jgen.append(jtok[:, 0].tolist())
        tgen.append(ttok[:, 0].tolist())
        pos = toks.shape[1] + i
        jl, jcache = jstep(jp, jnp.asarray(jtok, jnp.int32), jcache, jnp.int32(pos))
        tl, tcache = tstep(tp, ttok, tcache, pos)
        jtok = np.asarray(jnp.argmax(jl[:, 0, :jc.vocab_size], -1))[:, None]
        ttok = tl[:, 0, :tc.vocab_size].argmax(-1)[:, None]
    assert tgen == jgen

    pos = toks.shape[1] + 6
    jnxt, _ = jax.jit(jdecode_fn(jc, compute_dtype=jnp.float32))(
        jp, jnp.asarray(jtok, jnp.int32), jcache, jnp.full((2,), pos, jnp.int32),
        jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.float32), jnp.zeros((2,), jnp.int32),
        jnp.ones((2,), jnp.float32))
    tnxt, _ = make_serve_step(tc, compute_dtype=torch.float32, sample=True, device="cpu")(
        tp, ttok, tcache, [pos] * 2, [0] * 2, [0.0] * 2, [0] * 2, [1.0] * 2)
    assert tnxt.tolist() == np.asarray(jnxt).tolist()

    with pytest.raises(NotImplementedError):
        jprefill_step(jc, into_cache=True)(jp, jnp.asarray(toks), jcache,
                                          jnp.zeros((2,), jnp.int32),
                                          jnp.full((2,), 20, jnp.int32))
    with pytest.raises(NotImplementedError):
        make_prefill_step(tc, into_cache=True, device="cpu")(
            tp, torch.from_numpy(toks), tcache, [0, 1], [20, 20])
