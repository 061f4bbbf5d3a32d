"""PyTorch port, tensor parallelism on the plan's 'tp' axis (attention and
MLP TP, expert-TP in its EP x TP and its EP = 1 forms) against the JAX
package, float32.

* ``param_placements`` (through ``train.placements``) leaf by leaf against
  the JAX ``param_specs`` on ('data', 'ep', 'tp') plan meshes for Mula-1B
  and Mula-7B-A1B at full width, ``embed/table`` and ``head/table`` (their
  vocab rows on 'tp', else 'ep') too.
* ``loss_fn`` and every leaf's gradient on (1, 1, 2), (1, 2, 2) and (2, 1,
  2) grids of CPU ranks over gloo against the JAX ``loss_fn`` on one
  device over the whole batch, atol = rtol = 1e-4: the shares of the ranks
  of one tp coordinate sum to the JAX loss, and their gradients of each
  tile to the JAX gradient's tile. The MoE model runs without its aux and
  z terms here, whose EP form (the ranks' mean) is not the one-device
  value; the train steps below hold them.
* Three ``make_train_step`` steps on (1, 2, 2) in 'none' and 'epso' and on
  (2, 1, 2) in 'so' and 'epso' (with a shared expert) against the JAX step
  with dp * ep microbatches, atol = rtol = 1e-4: metrics, every rank's
  params and the gathered master, m and v.
* The per-rank state bytes in 'none', 'so' and 'epso' equal to the JAX
  plan's on the same mesh.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, AxisType  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import loss_fn as jloss_fn  # noqa: E402
from repro.optim import epso as jepso  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro.parallel.sharding import ShardingRules, param_specs  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import epso as tepso  # noqa: E402
from repro_torch.parallel import spawn  # noqa: E402
from repro_torch.parallel.sharding import tile_slices  # noqa: E402
from repro_torch.train.trainer import placements  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402
from test_torch_epso import (TIMEOUT_S, TOL, _np, _placements, check_against_jax,  # noqa: E402
                             run_grid_against_jax)

def _plan_rules(cfg, dp, ep, tp):
    """The JAX rules of a ('data', 'ep', 'tp') plan mesh, its size-1 axes
    dropped as ``ParallelPlan.mesh_axes`` drops them."""
    axes = [(a, n) for a, n in (("data", dp), ("ep", ep), ("tp", tp)) if n > 1]
    mesh = AbstractMesh(tuple(n for _, n in axes), tuple(a for a, _ in axes),
                        axis_types=(AxisType.Auto,) * len(axes))
    batch = tuple(a for a in ("data", "ep") if a in mesh.shape)
    return ShardingRules(mesh, batch, "tp" if tp > 1 else None, "ep" if ep > 1 else None,
                         cfg=cfg), dict(mesh.shape)


MESHES = [(2, 2, 2), (1, 2, 2), (1, 1, 4), (2, 1, 2), (1, 4, 2)]


@pytest.mark.parametrize("arch", ["mula-1b", "mula-7b-a1b"])
def test_param_placements_match_jax(arch):
    """Leaf by leaf, the port's placement of every full-width leaf, the
    embedding and head tables' vocab split too, is the JAX plan's on each
    mesh (the dense model on the meshes without an 'ep' axis)."""
    jc, tc = jget(arch), tget(arch)
    shapes = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jc))
    meta = init_params(tc, device="meta")
    checked = 0
    for dp, ep, tp in MESHES:
        if ep > 1 and not tc.is_moe:
            continue
        rules, sizes = _plan_rules(jc, dp, ep, tp)
        want = leaves(_placements(param_specs(shapes, rules), shapes))
        got = leaves_with_path(placements(tc, meta, sizes))
        assert len(want) == len(got)
        for (path, g), w in zip(got, want):
            assert g == w, ((dp, ep, tp), path, g, w)
            checked += any(g)
    assert checked > 0


def _loss_cases(seed=3):
    """(jc, tc, jax params, the port's params, batch) for dense Mula-1B and
    dropless Mula-7B-A1B (8 experts) without router terms, reduced."""
    out = []
    toks = np.random.default_rng(seed).integers(0, 128, size=(4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for arch, kw in (("mula-1b", {}), ("mula-7b-a1b", {"max_experts": 8})):
        jc = jreduced(jget(arch), d_model=64, vocab=128, **kw)
        tc = treduced(tget(arch), d_model=64, vocab=128, **kw)
        if jc.moe is not None:
            mk = dict(dispatch="dropless", router_aux_coef=0.0, router_z_coef=0.0)
            jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **mk))
            tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **mk))
        jp = _np(jinit_params(jax.random.PRNGKey(1), jc))
        out.append((jc, tc, jp, params_from_jax(jp, tc, device="cpu"), batch))
    return out


@pytest.mark.parametrize("grid", [(1, 1, 2), (1, 2, 2), (2, 1, 2)])
def test_loss_and_grads_match_jax(grid):
    """Per tp coordinate: the ranks' shares sum to the JAX loss, their ce
    metric is the JAX ce, and the sum of their gradients of each tile is the
    JAX gradient's tile (a whole leaf's over the ranks splitting the batch,
    an expert slice's over its 'data' replicas)."""
    dp, ep, tp = grid
    cases = [c for c in _loss_cases() if ep == 1 or c[1].is_moe]
    args = ([(tc, p, {k: torch.from_numpy(v).long() for k, v in b.items()})
             for _, tc, _, p, b in cases],)

    def oracle():
        out = []
        with use_kernel_plan(KernelPlan()):
            for jc, _, jp, _, b in cases:
                f = jax.jit(jax.value_and_grad(lambda p, b, jc=jc: jloss_fn(
                    p, b, jc, compute_dtype=jnp.float32), has_aux=True))
                (loss, m), g = f(jax.tree.map(jnp.asarray, jp),
                                 {k: jnp.asarray(v) for k, v in b.items()})
                out.append((float(loss), float(m["ce"]), g))
        return out

    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn, ranks.tp_loss_cases_rank, dp * ep * tp, args=args,
                          device="cpu", timeout_s=TIMEOUT_S, grid=grid)
        want = oracle()
        res = fut.result()
    sizes = {a: n for a, n in zip(("data", "ep", "tp"), grid) if n > 1}
    for i, ((_, tc, _, _, _), (jloss, jce, jg)) in enumerate(zip(cases, want)):
        jgrads = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
                  for path, g in jax.tree_util.tree_leaves_with_path(jg)}
        place = dict(leaves_with_path(placements(tc, init_params(tc, device="meta"), sizes)))
        for t in range(tp):
            at = [r[i] for r in res if r[i]["coords"]["tp"] == t]
            np.testing.assert_allclose(sum(float(r["share"]) for r in at), jloss, **TOL)
            for r in at:
                np.testing.assert_allclose(float(r["metrics"]["ce"]), jce, **TOL)
            for path, G in jgrads.items():
                tiles = {}
                for r in at:
                    sl = tile_slices(place[path], G.shape, r["coords"], sizes)
                    key = tuple((s.start, s.stop) for s in sl)
                    got = r["grads"][path].numpy()
                    tiles[key] = (sl, tiles[key][1] + got if key in tiles else got)
                for sl, got in tiles.values():
                    np.testing.assert_allclose(got, G[sl], **TOL,
                                               err_msg=f"{tc.name} {grid} tp {t} {path}")


@pytest.mark.parametrize("grid,runs,moe_kw", [
    ((1, 2, 2), [("none", "off"), ("epso", "ring")], {}),
    ((2, 1, 2), [("so", "off"), ("epso", "xla")], {"num_shared_experts": 1})])
def test_train_steps_match_jax(grid, runs, moe_kw):
    """Three steps of reduced Mula-7B-A1B (8 experts, dropless) from one
    state converted from JAX, each run against the JAX single-device step
    with dp * ep microbatches."""
    dp, ep, tp = grid
    jstate, jms, res, tc = run_grid_against_jax("mula-7b-a1b", dp, ep, runs, experts=8, tp=tp,
                                                **moe_kw)
    for run in runs:
        check_against_jax(jstate, jms, res, tc, dp, ep, run, tp=tp)


@pytest.mark.parametrize("grid", [(1, 2, 2), (2, 2, 2), (1, 1, 4), (2, 1, 2)])
def test_state_bytes_match_jax_plan(grid):
    """Full-width Mula-7B-A1B at 2 layers: the per-rank bytes of master, m
    and v are the JAX plan's on the same mesh in 'none', 'so' and 'epso'
    (the tables split on the vocab over 'tp', else 'ep', in both)."""
    dp, ep, tp = grid
    jc, tc = (dataclasses.replace(get("mula-7b-a1b"), num_layers=2) for get in (jget, tget))
    shapes = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jc))
    rules, sizes = _plan_rules(jc, dp, ep, tp)
    meta = init_params(tc, device="meta")
    place = placements(tc, meta, sizes)
    for mode in ("none", "so", "epso"):
        got = tepso.state_bytes_per_device(meta, place, sizes, mode)
        assert got == jepso.state_bytes_per_device(shapes, rules, mode), (grid, mode)
