"""PyTorch port, the training slice: ``loss_fn`` (value, metrics and every
parameter's gradient) and three ``make_train_step`` steps against the JAX
package, from the same converted parameters and optimizer state, for
reduced Mula-7B-A1B (MoE, at 1 and 2 microbatches) and Mula-1B (dense).
The JAX side runs its Pallas kernels in interpret mode with ``tile_m``
equal to the port's ``gmm_align()`` and its blockwise attention
(``attn_impl='blockwise'``, the training path); the port runs its plain
path on the CPU. float32 throughout (compute, params, gradient reduction),
atol = rtol = 1e-4, except the gradients: atol 1e-4 * max|grad| of the
leaf, rtol 1e-3 (sums of many terms in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.configs.base import ParallelConfig as JParallel  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import loss_fn as tloss_fn  # noqa: E402
from repro_torch.train import TrainState, make_train_step  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

from torch_parity import assert_leaves_close, batch_pair  # noqa: E402

PLAN = KernelPlan(backend="pallas", attn_impl="blockwise", interpret=True,
                  tile_m=ops.gmm_align(), tile_k=64, tile_n=32)
TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(param_dtype="float32", compute_dtype="float32", grad_reduce_dtype="float32")


def _cfgs(name):
    return (jreduced(jget(name), d_model=64, vocab=128),
            treduced(tget(name), d_model=64, vocab=128))


@pytest.mark.parametrize("name", ["mula-7b-a1b", "mula-1b"])
def test_loss_and_grads_match_jax(name):
    jc, tc = _cfgs(name)
    jp = jax.tree.map(np.asarray, jinit_state(jax.random.PRNGKey(0), jc, JTrain()).params)
    tp = params_from_jax(jp, tc, device="cpu")
    jb, tb = batch_pair(1)

    def jloss(p):
        return jloss_fn(p, jb, jc, sac="block", compute_dtype=jnp.float32)

    with use_kernel_plan(PLAN):
        (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray, jp))
    paths, flat = zip(*leaves_with_path(tp))
    for x in flat:
        x.requires_grad_()
    tl, tm = tloss_fn(tp, tb, tc, sac="block", compute_dtype=torch.float32)
    grads = torch.autograd.grad(tl, flat)
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    for k in jm:
        np.testing.assert_allclose(tm[k].detach().numpy(), np.asarray(jm[k]), **TOL,
                                   err_msg=k)
    assert_leaves_close(dict(zip(paths, grads)), jg, "grad")


@pytest.mark.parametrize("name,microbatches", [("mula-7b-a1b", 1), ("mula-7b-a1b", 2),
                                               ("mula-1b", 1)])
def test_train_steps_match_jax(name, microbatches):
    """Three steps from the same params and AdamW state; warmup_steps=1, so
    step 0 has lr 0 and no clipping, and steps 1-2 clip (their grad norm is
    above grad_clip=1)."""
    jc, tc = _cfgs(name)
    kw = dict(seq_len=16, global_batch=4, warmup_steps=1, total_steps=10, lr_peak=1e-2,
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
            jb, tb = batch_pair(10 + i)
            jstate, jm = jstep(jstate, jb)
            tstate, tm = tstep(tstate, tb)
            assert sorted(tm) == sorted(jm)
            for k in jm:
                np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), **TOL,
                                           err_msg=f"step {i} {k}")
            clips.append(float(jm["clip_scale"]))
    assert clips[0] == 1.0 and clips[1] < 1.0 and clips[2] < 1.0
    assert_leaves_close(dict(leaves_with_path(tstate.params)), jstate.params, "params")
    assert_leaves_close(dict(leaves_with_path(tstate.opt.m)), jstate.opt.m, "m")
    assert int(tstate.opt.step) == int(jstate.opt.step) == 3


def test_train_step_rejects_mesh_features():
    """Pipeline stages run (their parity: tests/test_torch_pp_train.py): a
    two-stage 1f1b step of two microbatches gives a finite loss and the JAX
    PP step's metric keys. Without a grid a sharded optimizer mode places
    every state whole (the JAX step off-mesh), and an overlap impl, which
    needs a grid with update axes, raises ValueError as the JAX step's does;
    SO/EPSO on a grid: tests/test_torch_overlap.py."""
    _, tc = _cfgs("mula-7b-a1b")
    from repro_torch.train import init_state
    train = TrainConfig(**F32)
    step = make_train_step(tc, ParallelConfig(pp_stages=2, microbatches=2), train)
    _, tb = batch_pair(3)
    _, m = step(init_state(tc, train, device="cpu"), tb)
    assert np.isfinite(float(m["loss"])) and sorted(m) == [
        "ce", "clip_scale", "grad_norm", "loss", "lr", "moe_counts", "moe_drops", "moe_load"]
    assert callable(make_train_step(tc, ParallelConfig(), TrainConfig(),
                                    opt_sharding_mode="epso"))
    with pytest.raises(ValueError, match="grid"):
        make_train_step(tc, ParallelConfig(opt_overlap="ring"), TrainConfig(),
                        opt_sharding_mode="epso")
