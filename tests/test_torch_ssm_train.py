"""PyTorch port, hybrid (Mamba-2, reduced Zamba2-7B) training against the
JAX package on the CPU in float32: the chunked SSD's gradient, ``loss_fn``'s
value and every leaf's gradient (the shared block's summed over its
applications) under each remat policy, and three ``make_train_step`` steps
at 1 and 2 microbatches; the training path reaches neither the SSD kernel
op nor its plain version, while a forward under ``no_grad`` still runs the
kernel op.

The reduced model has 5 layers with ``shared_attn_every=2`` (2 groups of 2
Mamba-2 layers, each followed by the shared block, and 1 remaining layer)
at d_model 64, SSM heads of 32, d_state 16 and chunk 16; sequences of 40
tokens, not a multiple of the chunk, so the dt = 0 padding runs. Both
packages start from the same weights (``convert.params_from_jax``).
Tolerances: atol = rtol = 1e-4; gradients atol 1e-4 * max|grad| of the
leaf and rtol 1e-3, as ``tests/test_torch_train.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.configs.base import ParallelConfig as JParallel  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.train import TrainState, init_state, make_train_step  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

from torch_parity import assert_leaves_close, batch_pair  # noqa: E402

NAME = "zamba2-7b"
PLAN = KernelPlan(backend="pallas", attn_impl="blockwise", interpret=True)
TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(param_dtype="float32", compute_dtype="float32", grad_reduce_dtype="float32")
SEQ = 40


def _cfgs():
    return (dataclasses.replace(jreduced(jget(NAME), layers=5, d_model=64, vocab=128),
                                shared_attn_every=2),
            dataclasses.replace(treduced(tget(NAME), layers=5, d_model=64, vocab=128),
                                shared_attn_every=2))


@pytest.fixture(scope="module")
def hybrid():
    """(jax cfg, port cfg, jax params (numpy leaves))."""
    jc, tc = _cfgs()
    return jc, tc, jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(0), jc))


@pytest.mark.parametrize("S,with_h0", [(37, False), (48, True), (10, True)])
def test_ssd_chunked_grad_matches_jax(S, with_h0):
    """The chunked scan's vector-Jacobian product (chunk 16; S = 37 pads,
    S = 10 is shorter than a chunk, h0 a carried-in state) with respect to
    x, dt, B, C, A and h0, against ``jax.vjp`` of the JAX ``_ssd_chunked``,
    for random cotangents of y and of the final state."""
    rng = np.random.default_rng(S)
    B, H, P, N = 2, 4, 8, 8
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32) if with_h0 else None
    gy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    gh = rng.standard_normal((B, H, P, N)).astype(np.float32)
    args = [x, dt, Bm, Cm, A] + ([h0] if with_h0 else [])

    def jfn(*a):
        return jssm._ssd_chunked(*a[:5], 16, h0=a[5] if with_h0 else None)

    (jy, jh), vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    ty, th = tssm._ssd_chunked(*targs[:5], 16, h0=targs[5] if with_h0 else None)
    tgrads = torch.autograd.grad((ty, th), targs, (torch.from_numpy(gy), torch.from_numpy(gh)))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=2e-4, rtol=0)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), atol=2e-4, rtol=0)
    for name, t, j in zip(("x", "dt", "B", "C", "A", "h0"), tgrads, jgrads):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-3, atol=1e-4 * np.abs(j).max(),
                                   err_msg=name)


def _recurrent_scan(x, dt, Bm, Cm, A):
    """The SSM recurrence step by step (float64 here): h_t = exp(dt_t A)
    h_(t-1) + dt_t x_t B_t^T, y_t = h_t C_t. No exponent is positive."""
    h = x.new_zeros((x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1]))
    ys = []
    for t in range(x.shape[1]):
        h = (torch.exp(dt[:, t] * A)[..., None, None] * h
             + (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, 1), h


def test_ssd_grad_is_finite_where_the_decay_overflows():
    """Chunks whose masked exponent la_i - la_j (i < j) overflows exp (dt up
    to 30, A = -4: up to 1800): the port's gradient stays finite and equals
    autograd of the step-by-step recurrence in float64 (a head with A =
    -0.05 keeps a long memory beside it)."""
    rng = np.random.default_rng(7)
    B, S, H, P, N = 1, 40, 2, 4, 4
    x = rng.standard_normal((B, S, H, P))
    dt = rng.uniform(2.0, 30.0, (B, S, H))
    Bm, Cm = (rng.standard_normal((B, S, N)) for _ in range(2))
    A = np.array([-0.05, -4.0])
    ours = [torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in (x, dt, Bm, Cm, A)]
    y, h = tssm._ssd_chunked(*ours, 16)
    exact = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (x, dt, Bm, Cm, A)]
    ry, rh = _recurrent_scan(*exact)
    np.testing.assert_allclose(y.detach().numpy(), ry.detach().numpy(), rtol=1e-4,
                               atol=1e-4 * float(ry.detach().abs().max()))
    for g32, g64 in zip(torch.autograd.grad(y.sum() + h.sum(), ours),
                        torch.autograd.grad(ry.sum() + rh.sum(), exact)):
        assert torch.isfinite(g32).all()
        np.testing.assert_allclose(g32.numpy(), g64.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(g64.abs().max()))


@pytest.mark.parametrize("sac", ["block", "ssm", "attn,mlp", ""])
def test_hybrid_loss_and_grads_match_jax(hybrid, sac):
    """loss_fn's value, metrics and every leaf's gradient (groups, rem and
    the shared block, whose gradient sums its two applications) under
    block remat, the 'ssm' SAC name, the shared block's 'attn,mlp' and no
    remat."""
    jc, tc, jp = hybrid
    jb, tb = batch_pair(1, s=SEQ)
    with use_kernel_plan(PLAN):
        (jl, jm), jg = jax.value_and_grad(
            lambda p: jloss_fn(p, jb, jc, sac=sac, compute_dtype=jnp.float32), has_aux=True)(
            jax.tree.map(jnp.asarray, jp))
    tree = params_from_jax(jp, tc, device="cpu")
    paths, flat = zip(*leaves_with_path(tree))
    assert {p.split("/")[0] for p in paths} == {"embed", "final_norm", "head", "groups", "rem",
                                               "shared"}
    for t in flat:
        t.requires_grad_()
    tl, tmet = tm.loss_fn(tree, tb, tc, sac=sac, compute_dtype=torch.float32)
    grads = torch.autograd.grad(tl, flat)
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    assert sorted(tmet) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tmet[k].detach().numpy(), np.asarray(jm[k]), **TOL,
                                   err_msg=k)
    assert_leaves_close(dict(zip(paths, grads)), jg, "grad")


@pytest.mark.parametrize("microbatches", [1, 2])
def test_hybrid_train_steps_match_jax(microbatches):
    """Three steps from the same params and AdamW state (warmup_steps=1:
    step 0 has lr 0 and no clipping, steps 1-2 clip); metrics every step,
    then the params and both moments."""
    jc, tc = _cfgs()
    kw = dict(seq_len=SEQ, global_batch=4, warmup_steps=1, total_steps=10, lr_peak=1e-2,
              lr_min=1e-3, **F32)
    jtrain, ttrain = JTrain(**kw), TrainConfig(**kw)
    jstate = jinit_state(jax.random.PRNGKey(0), jc, jtrain)
    tstate = TrainState(params_from_jax(jax.tree.map(np.asarray, jstate.params), tc,
                                        device="cpu"),
                        opt_state_from_jax(jax.tree.map(np.asarray, jstate.opt), device="cpu"))
    with use_kernel_plan(PLAN):
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
    assert_leaves_close(dict(leaves_with_path(tstate.opt.m)), jstate.opt.m, "m")
    assert_leaves_close(dict(leaves_with_path(tstate.opt.v)), jstate.opt.v, "v")
    assert int(tstate.opt.step) == int(jstate.opt.step) == 3


def test_training_reaches_neither_the_kernel_op_nor_its_plain_version(hybrid, monkeypatch):
    """A train step's forward and backward take ``models.ssm._intra_chunk``:
    ``ops.ssd_intra_chunk`` and ``ref.ssd_intra_chunk_ref`` raise if called.
    A forward under no_grad calls the op once per Mamba-2 layer."""
    _, tc, _ = hybrid
    _, tb = batch_pair(3, s=SEQ)
    calls = []
    op = ops.ssd_intra_chunk

    def refuse(*a, **k):
        raise AssertionError("the training path reached the SSD kernel op or its plain version")

    monkeypatch.setattr(ops, "ssd_intra_chunk", refuse)
    monkeypatch.setattr(ref, "ssd_intra_chunk_ref", refuse)
    state = init_state(tc, TrainConfig(**F32), device="cpu")
    state, m = make_train_step(tc, ParallelConfig(), TrainConfig(**F32))(state, tb)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])

    def counted(*a):
        calls.append(1)
        return op(*a)

    monkeypatch.undo()
    monkeypatch.setattr(ops, "ssd_intra_chunk", counted)
    with torch.no_grad():
        tm.forward(state.params, {"tokens": tb["tokens"]}, tc, compute_dtype=torch.float32)
    assert len(calls) == tc.num_layers


@pytest.mark.parametrize("arch", ["zamba2-7b", "falcon-mamba-7b"])
def test_so_layout_of_the_state_space_trees_matches_jax(arch):
    """The nested hybrid tree (``groups`` stacked (n_group, every, ...),
    ``rem``, ``shared``) and the ssm ``layers`` tree on a 'data' axis of 2
    under 'so': the port's param placements (all whole: no experts), state
    placements, bytes a rank and update buckets are the JAX package's on
    its own ``param_specs``; a full AdamW state cut into the ranks' shards
    (``convert.opt_state_for_rank``) comes back whole, exactly."""
    from jax.sharding import AbstractMesh, AxisType, PartitionSpec as P

    from repro.optim import epso as jepso
    from repro.parallel.sharding import make_rules, param_specs
    from repro_torch.convert import opt_state_for_rank, opt_state_from_ranks
    from repro_torch.optim import adamw_init
    from repro_torch.optim import epso as tepso
    from repro_torch.parallel.sharding import param_placements
    from repro_torch.tree import leaves, tree_map

    kw = {"layers": 5} if arch == NAME else {}
    jc = dataclasses.replace(jreduced(jget(arch), d_model=64, vocab=128, **kw),
                             shared_attn_every=2 if arch == NAME else 0)
    tc = dataclasses.replace(treduced(tget(arch), d_model=64, vocab=128, **kw),
                             shared_attn_every=jc.shared_attn_every)
    shapes = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jc))
    rules = make_rules(jc, AbstractMesh((2,), ("data",), axis_types=(AxisType.Auto,)),
                       kind="train", global_batch=8)
    sizes = {"data": 2}
    jspecs = param_specs(shapes, rules)
    place = param_placements(tm.init_params(tc, device="meta"), sizes)

    def per_dim(spec, ndim):
        ent = [tuple(a for a in (e if isinstance(e, tuple) else (e,)) if a is not None)
               for e in spec]
        return tuple(ent[d] if d < len(ent) else () for d in range(ndim))

    is_p = dict(is_leaf=lambda s: isinstance(s, P))
    assert leaves(place) == [per_dim(s, len(x.shape)) for s, x in zip(
        jax.tree.leaves(jspecs, **is_p), jax.tree.leaves(shapes))]
    assert not any(any(p) for p in leaves(place))
    jso = jepso.optimizer_state_specs(shapes, rules, "so")
    tso = tepso.optimizer_state_specs(shapes, place, sizes, "so")
    assert leaves(tso) == [per_dim(s, len(x.shape)) for s, x in zip(
        jax.tree.leaves(jso, **is_p), jax.tree.leaves(shapes))]
    assert (tepso.state_bytes_per_device(shapes, place, sizes, "so")
            == jepso.state_bytes_per_device(shapes, rules, "so"))
    assert tuple(tepso.plan_update_buckets(shapes, place, sizes, "so")) == \
        tuple(jepso.plan_update_buckets(shapes, rules, "so"))

    opt = adamw_init(tm.init_params(tc, seed=3, device="cpu"))
    opt = opt._replace(m=tree_map(lambda t: t + 1.0, opt.m), v=tree_map(lambda t: t + 2.0, opt.v))
    states = [opt_state_for_rank(opt, tc, dp=2, ep=1, rank=r, mode="so") for r in range(2)]
    back = opt_state_from_ranks(states, tc, dp=2, ep=1, mode="so")
    for what in ("master", "m", "v"):
        for path, full in leaves_with_path(getattr(opt, what)):
            np.testing.assert_array_equal(back[what][path], full.numpy(), err_msg=path)
