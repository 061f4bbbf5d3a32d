"""PyTorch port, the SO/EPSO update on a dp x ep process grid
(``optim/overlap.py``, ``train.make_train_step(..., grid=...)``) against the
JAX package.

* ``resolve_opt_overlap``: the JAX package's request matrix, on the same
  requests (the port passes the mesh's axis sizes).
* The shard linearisation: ``_assemble_leaf`` equals the JAX one on the
  same gathered rows, and ``_rows`` (the reduce-scatter's layout) is its
  inverse, for every sharded leaf of the (2, 2) plan mesh's EPSO and SO
  plans.
* Training on 4 CPU ranks over gloo, float32, against the JAX
  single-device step with 4 microbatches in rank order (the oracle of
  tests/test_torch_ep.py), 3 steps from one state converted from JAX, atol
  = rtol = 1e-4 (losses, grad norms, every rank's params, the gathered
  master, m and v): a dp = 2 x ep = 2 grid with ('none', 'off'), ('so',
  'off'), ('epso', 'ring') and ('epso', 'xla') in one spawn, and dp = 1 x
  ep = 4 with ('epso', 'ring'). On the (2, 2) grid 'so' and 'epso' also
  agree with 'none' at rtol = 1e-5, every rank's state holds
  ``state_bytes_per_device`` bytes, and the replicated params are equal on
  every rank and the expert slices on the two 'data' replicas.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, AxisType  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.optim import epso as jepso  # noqa: E402
from repro.optim import overlap as joverlap  # noqa: E402
from repro.parallel.sharding import ShardingRules, param_specs  # noqa: E402
from repro_torch.configs import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.optim import overlap as toverlap  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.trainer import placements  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

from test_torch_epso import check_against_jax, run_grid_against_jax  # noqa: E402

RUNS_2X2 = [("none", "off"), ("so", "off"), ("epso", "ring"), ("epso", "xla")]


def _entries(e):
    return tuple(a for a in (e if isinstance(e, tuple) else (e,)) if a is not None)


def _mesh(shape, axes):
    return AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))


def test_resolve_matrix_matches_jax():
    """Every request of tests/test_opt_overlap.py's matrix, on a mesh with
    update axes, without a mesh and on a 'pp'-only mesh: the same impl, or a
    ValueError where the JAX package raises one."""
    meshes = [_mesh((4, 2), ("data", "model")), None, _mesh((2,), ("pp",)),
              _mesh((2, 2), ("data", "ep"))]
    for mesh in meshes:
        sizes = dict(mesh.shape) if mesh is not None else None
        for setting in (None, "auto", "off", "ring", "xla", "bogus"):
            for mode in ("none", "so", "epso"):
                try:
                    want = joverlap.resolve_opt_overlap(setting, mode, mesh)
                except ValueError:
                    with pytest.raises(ValueError):
                        toverlap.resolve_opt_overlap(setting, mode, sizes)
                    continue
                assert toverlap.resolve_opt_overlap(setting, mode, sizes) == want, \
                    (setting, mode, sizes)


@pytest.mark.parametrize("mode", ["so", "epso"])
def test_assemble_and_rows_match_jax(mode):
    """On the (2, 2) ('data', 'ep') mesh: for each sharded leaf of the plan,
    gathered rows (N, *block) assemble into the same param-local leaf in both
    packages, and the port's ``_rows`` of that leaf gives the rows back."""
    cfg = jreduced(jget("mula-7b-a1b"), d_model=64)
    shapes = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), cfg))
    mesh = _mesh((2, 2), ("data", "ep"))
    rules = ShardingRules(mesh, ("data", "ep"), None, "ep", cfg=cfg)
    sizes = dict(mesh.shape)
    plan = jepso.plan_update_buckets(shapes, rules, mode, max_bucket_bytes=1)
    pspecs = jax.tree.leaves(param_specs(shapes, rules))
    flat = jax.tree.leaves(shapes)
    rng = np.random.default_rng(0)
    seen = 0
    for bucket in plan.buckets:
        if not bucket.axes:
            continue
        for lf in bucket.leaves:
            local = list(flat[lf.index].shape)
            for d, e in enumerate(pspecs[lf.index]):
                for a in _entries(e):
                    local[d] //= sizes[a]
            blk = toverlap.block_shape(local, lf, sizes)
            n = int(np.prod([sizes[a] for a in bucket.axes]))
            seg = rng.standard_normal((n,) + blk).astype(np.float32)
            want = np.asarray(joverlap._assemble_leaf(jnp.asarray(seg), bucket.axes, lf, blk,
                                                      sizes))
            got = toverlap._assemble_leaf(torch.from_numpy(seg), bucket.axes, lf, blk, sizes)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=lf.path)
            rows = toverlap._rows(got, bucket.axes, lf, sizes)
            np.testing.assert_array_equal(rows.numpy(), seg.reshape(n, -1), err_msg=lf.path)
            seen += 1
    assert seen >= 5


def test_grid_2x2_all_modes_match_jax():
    """Reduced Mula-7B-A1B (8 experts top-4, dropless) on a dp = 2 x ep = 2
    grid in every mode: the JAX step at 1e-4; each sharded mode against
    'none' at rtol = 1e-5; state bytes; params equal across ranks."""
    dp, ep = 2, 2
    jstate, jms, res, tc = run_grid_against_jax("mula-7b-a1b", dp, ep, RUNS_2X2, experts=8)
    assert float(jms[0]["clip_scale"]) == 1.0 and float(jms[2]["clip_scale"]) < 1.0
    for run in RUNS_2X2:
        check_against_jax(jstate, jms, res, tc, dp, ep, run)
    base = RUNS_2X2[0]
    for run in RUNS_2X2[1:]:
        for rank, r in enumerate(res):
            for i, m in enumerate(r[run]["metrics"]):
                for k in ("loss", "grad_norm", "ce"):
                    np.testing.assert_allclose(m[k].numpy(), r[base]["metrics"][i][k].numpy(),
                                               rtol=1e-5, err_msg=f"{run} rank {rank} {k}")
            for path, leaf in r[run]["params"].items():
                np.testing.assert_allclose(leaf.numpy(), r[base]["params"][path].numpy(),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{run} rank {rank} {path}")
    # the replicated leaves are equal on every rank, each tile 'ep' cuts (an
    # expert slice, a table's vocab rows) on the ranks that hold it (the two
    # 'data' replicas)
    on_ep = {path for path, pl in leaves_with_path(placements(
        tc, init_params(tc, device="meta"), {"data": dp, "ep": ep})) if any("ep" in e for e in pl)}
    assert {"embed/table", "layers/moe/gate"} <= on_ep
    for run in RUNS_2X2:
        for rank, r in enumerate(res):
            twin = res[(rank + ep) % (dp * ep)][run]
            for path, leaf in r[run]["params"].items():
                other = (twin if path in on_ep else res[0][run])["params"][path]
                assert torch.equal(leaf, other), (run, rank, path)
    sizes = [res[0][run]["state_bytes"] for run in RUNS_2X2]
    assert sizes[0] == 2 * sizes[1] and sizes[2] == sizes[3] < sizes[1]


def test_grid_1x4_epso_ring_matches_jax():
    """dp = 1 x ep = 4: EPSO splits the replicated leaves' states over 'ep'
    and leaves the expert slices' states as their params (the ring runs
    over 'ep' only)."""
    run = ("epso", "ring")
    jstate, jms, res, tc = run_grid_against_jax("mula-7b-a1b", 1, 4, [run], experts=8)
    check_against_jax(jstate, jms, res, tc, 1, 4, run)


def test_grid_train_step_refuses_what_is_not_ported():
    """Pipeline stages build (pipeline parallelism is ported:
    ``tests/test_torch_pp_train.py``, ``tests/test_torch_pp_grid.py``); a
    placement that is not an ``ExpertPlacement`` a TypeError or a
    ValueError (expert placement is ported: ``tests/test_torch_placement.py``);
    an overlap impl without a sharded mode, or without a grid, a ValueError."""
    tc = treduced(tget("mula-7b-a1b"), d_model=64, vocab=128)
    assert callable(make_train_step(tc, ParallelConfig(pp_stages=2), TrainConfig(),
                                    opt_sharding_mode="epso").loss_and_grads)
    with pytest.raises((TypeError, ValueError), match="placement"):
        make_train_step(tc, ParallelConfig(), TrainConfig(), placement=object())
    with pytest.raises(ValueError, match="opt_shard"):
        make_train_step(tc, ParallelConfig(opt_overlap="ring"), TrainConfig())
    with pytest.raises(ValueError, match="grid"):
        make_train_step(tc, ParallelConfig(opt_overlap="xla"), TrainConfig(),
                        opt_sharding_mode="so")
    with pytest.raises(ValueError, match="opt_sharding_mode"):
        make_train_step(tc, ParallelConfig(), TrainConfig(), opt_sharding_mode="zero3")


def test_sharded_update_matches_none_bit_for_bit():
    """On 4 CPU ranks, one SO/EPSO update of exactly summable gradients
    equals the 'none' update bit for bit when clipping is off, on every
    rank, and the grad norms agree; after two more train steps 'ring' and
    'xla' hold identical params. (The same check runs on the card in
    tests/test_torch_cuda.py.)"""
    from test_torch_cuda import _sharded_update_runs
    runs, res = _sharded_update_runs("cpu")
    for rank, r in enumerate(res):
        base = r[runs[0]]
        for run in runs[1:]:
            for path, t in r[run]["update"].items():
                assert torch.equal(t, base["update"][path]), (run, rank, path)
            np.testing.assert_allclose(r[run]["grad_norm"].numpy(), base["grad_norm"].numpy(),
                                       rtol=1e-6)
        for path, t in r[runs[2]]["steps"].items():
            assert torch.equal(t, r[runs[3]]["steps"][path]), (rank, path)
