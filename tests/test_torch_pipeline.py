"""PyTorch port, pipeline parallelism's pure parts (``repro_torch.parallel.
pipeline``) against the JAX package's ``repro.parallel.pipeline``: the
gpipe, 1f1b and interleaved-1f1b tick tables, their masks, bubble
fractions, in-flight peaks and the microbatch guardrail, exactly equal for
pp in {2, 3, 4} and several microbatch counts; the stage split; and the
functional executor ``pipeline_train_step`` (autograd in place of
``jax.vjp``) against the JAX one on the same numpy inputs, loss and every
stage's gradients at atol = rtol = 1e-5 (float32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.parallel import pipeline as jpipe  # noqa: E402
from repro_torch.parallel import pipeline as tpipe  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = [(pp, n_mb) for pp in (2, 3, 4) for n_mb in (1, 2, 3, 4, 6, 8)]


def _rows(ticks):
    return [tuple(t) for t in ticks]


@pytest.mark.parametrize("pp,n_mb", SHAPES)
def test_tick_tables_equal_jax(pp, n_mb):
    """The gpipe and 1f1b tables tick for tick, their masks array for
    array, the bubble fraction and every stage's in-flight peak; the port's
    tables pass its own dependency check."""
    for name in ("gpipe_schedule", "one_f_one_b_schedule"):
        got, want = getattr(tpipe, name)(n_mb, pp), getattr(jpipe, name)(n_mb, pp)
        assert _rows(got) == _rows(want), name
        tpipe.validate_schedule(got, n_mb, pp)
        for s in range(pp):
            assert tpipe.peak_inflight(got, s) == jpipe.peak_inflight(want, s), (name, s)
    for schedule in ("gpipe", "1f1b"):
        got, want = tpipe.schedule_masks(schedule, n_mb, pp), jpipe.schedule_masks(
            schedule, n_mb, pp)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert tpipe.bubble_fraction(n_mb, pp) == jpipe.bubble_fraction(n_mb, pp)
    # 1f1b keeps at most pp microbatches in flight on stage 0, gpipe all of them
    one_f = tpipe.one_f_one_b_schedule(n_mb, pp)
    assert tpipe.peak_inflight(one_f, 0) == min(pp, n_mb)
    assert tpipe.peak_inflight(tpipe.gpipe_schedule(n_mb, pp), 0) == n_mb


@pytest.mark.parametrize("pp,n_mb", [(2, 2), (2, 4), (3, 3), (4, 4), (4, 8)])
def test_interleaved_tables_equal_jax(pp, n_mb):
    """Interleaved 1f1b with v = 2 chunks a device, tick for tick."""
    got = tpipe.interleaved_1f1b_schedule(n_mb, pp, 2)
    assert _rows(got) == _rows(jpipe.interleaved_1f1b_schedule(n_mb, pp, 2))
    tpipe.validate_schedule(got, n_mb, pp, 2)


@pytest.mark.parametrize("n_mb,pp", [(1, 2), (3, 2), (4, 3), (6, 4), (0, 2), (4, 2), (8, 4)])
def test_microbatch_guardrail_and_errors_equal_jax(n_mb, pp):
    """``check_pp_microbatches`` raises where the JAX one does, with its
    text; so do a bad schedule name and a layer count pp does not divide."""
    def outcome(fn, *args):
        try:
            fn(*args)
            return None
        except ValueError as e:
            return str(e)
    assert outcome(tpipe.check_pp_microbatches, n_mb, pp) == \
        outcome(jpipe.check_pp_microbatches, n_mb, pp)
    assert outcome(tpipe.schedule_masks, "zigzag", max(n_mb, 1), pp) == \
        outcome(jpipe.schedule_masks, "zigzag", max(n_mb, 1), pp)
    assert outcome(tpipe._check_stage_divisible, n_mb + pp + 1, pp, "m") == \
        outcome(jpipe._check_stage_divisible, n_mb + pp + 1, pp, "m")


def test_split_and_stack_stages_equal_jax():
    layers = {"a": np.arange(4 * 3 * 2, dtype=np.float32).reshape(4, 3, 2),
              "b": {"c": np.arange(4 * 5, dtype=np.float32).reshape(4, 5)}}
    t = {"a": torch.from_numpy(layers["a"]), "b": {"c": torch.from_numpy(layers["b"]["c"])}}
    for pp in (1, 2, 4):
        for got, want in zip(tpipe.split_stages(t, pp), jpipe.split_stages(layers, pp)):
            np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
            np.testing.assert_array_equal(got["b"]["c"].numpy(), np.asarray(want["b"]["c"]))
        got, want = tpipe.stack_stages(t, pp), jpipe.stack_stages(layers, pp)
        np.testing.assert_array_equal(got["b"]["c"].numpy(), np.asarray(want["b"]["c"]))
    with pytest.raises(ValueError, match="do not divide evenly"):
        tpipe.split_stages(t, 3, name="m")


def _stage_problem(n_stages, n_mb, d=6, b=3, seed=0):
    rng = np.random.default_rng(seed)
    params = [{"w": (rng.normal(size=(d, d)) / np.sqrt(d)).astype(np.float32),
               "b": {"v": (rng.normal(size=(d,)) * 0.1).astype(np.float32)}}
              for _ in range(n_stages)]
    mbs = [{"x": rng.normal(size=(b, d)).astype(np.float32),
            "y": rng.normal(size=(b, d)).astype(np.float32)} for _ in range(n_mb)]
    return params, mbs


@pytest.mark.parametrize("schedule,n_stages,n_mb,v", [
    ("1f1b", 2, 4, 1), ("gpipe", 3, 3, 1), ("1f1b", 4, 6, 1), ("interleaved-1f1b", 4, 4, 2)])
def test_pipeline_train_step_matches_jax(schedule, n_stages, n_mb, v):
    """The functional executor on tanh stages and a squared-error loss: the
    mean loss and every stage's gradient equal the JAX executor's."""
    params, mbs = _stage_problem(n_stages, n_mb)

    def jfwd(p, x):
        return jnp.tanh(x @ p["w"] + p["b"]["v"])

    def jloss(y, mb):
        return jnp.mean((y - mb["y"]) ** 2)

    def tfwd(p, x):
        return torch.tanh(x @ p["w"] + p["b"]["v"])

    def tloss(y, mb):
        return torch.mean((y - mb["y"]) ** 2)

    jl, jg = jpipe.pipeline_train_step(jfwd, jloss, jax.tree.map(jnp.asarray, params),
                                       jax.tree.map(jnp.asarray, mbs), schedule=schedule, v=v)
    tp = [{"w": torch.from_numpy(p["w"]), "b": {"v": torch.from_numpy(p["b"]["v"])}}
          for p in params]
    tm = [{k: torch.from_numpy(a) for k, a in mb.items()} for mb in mbs]
    tl, tg = tpipe.pipeline_train_step(tfwd, tloss, tp, tm, schedule=schedule, v=v)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert len(tg) == len(jg) == n_stages
    for s, (got, want) in enumerate(zip(tg, jg)):
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), **TOL,
                                   err_msg=f"stage {s} w")
        np.testing.assert_allclose(got["b"]["v"].numpy(), np.asarray(want["b"]["v"]), **TOL,
                                   err_msg=f"stage {s} b")
