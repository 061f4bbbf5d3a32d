"""PyTorch port, the multi-rank launcher (``repro_torch.launch.train.run``
with ``parallel=``) against the JAX package's one-device launcher, on CPU
ranks over gloo (one process a rank, ``parallel.spawn``).

A run on a dp x ep grid of ``w`` ranks (rank r takes row r of each batch
of 4) is the JAX one-device run with ``microbatches = w`` (the oracle of
tests/test_torch_ep.py); on an ep = 2 x tp = 2 grid the batch splits over
the 2 ep ranks only, and the oracle takes 2 microbatches. The port's init is not JAX's, so the two meet
through checkpoints, both ways, as in tests/test_torch_launch.py: the JAX
run checkpoints at step 5 and the grid resumes steps 6-9 from it; the grid
run checkpoints at step 5 and the JAX launcher resumes from it. Losses,
grad norms, lrs and the MoE telemetry agree at atol = rtol = 1e-4; the
grid's ``summary.json`` equals the JAX one's but for ``parallel`` and
``opt_overlap``, held to the JAX plan's ``str`` and resolved overlap; its
checkpoint files hold the JAX keys, shapes and dtypes (whole arrays) and
its MANIFEST the JAX ``ResolvedPlan``'s plan. Mula-7B-A1B runs dropless
(see tests/test_torch_launch.py). While the grid's ranks run, the JAX side
runs in this process."""
import json
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

from jax.sharding import AbstractMesh, AxisType  # noqa: E402

from repro.launch import train as jlaunch  # noqa: E402
from repro.optim.overlap import resolve_opt_overlap as jresolve_overlap  # noqa: E402
from repro.parallel.plan import ParallelPlan as JPlan, ResolvedPlan as JResolved  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import opt_state_from_ranks  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.parallel import spawn  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

import torch_ep_ranks as ranks  # noqa: E402

KW = dict(steps=10, ckpt_interval=5, d_model=64, batch=4, seq=32, log_every=100)
TOL = dict(atol=1e-4, rtol=1e-4)
# (arch, --parallel, --opt-shard): the grids (2, 2), (1, 4), (4, 1) and (1, 2, 2)
GRIDS = [("mula-7b-a1b", "dp=2,ep=2", "epso"), ("mula-7b-a1b", "ep=4", "none"),
         ("mula-1b", "dp=4", "so"), ("mula-7b-a1b", "ep=2,tp=2", "epso")]
ARCH_KW = {"mula-1b": {}, "mula-7b-a1b": {"moe_dispatch": "dropless"}}


def _port(arch, out, parallel, opt_shard, **kw):
    return tlaunch.run(arch, out=str(out), device="cpu", parallel=parallel, opt_shard=opt_shard,
                       **{**KW, **ARCH_KW[arch], **kw})


def _jax(arch, out, mb=4, **kw):
    return jlaunch.run(arch, out=str(out), microbatches=mb, **{**KW, **ARCH_KW[arch], **kw})


def _batch_ranks(parallel):
    """The ranks of a --parallel spec that split the batch (dp x ep)."""
    p = JPlan.parse(parallel)
    return p.dp * p.ep


def _close(got, ref):
    assert [h["step"] for h in got] == [h["step"] for h in ref]
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r), g["step"]
        for k in r:
            np.testing.assert_allclose(g[k], r[k], **TOL, err_msg=f"step {r['step']} {k}")


def _jax_plan(arch, parallel, opt_shard):
    """The plan the JAX launcher builds from these flags."""
    return dataclasses.replace(JPlan.parse(parallel), opt_shard=opt_shard,
                               moe_dispatch=ARCH_KW[arch].get("moe_dispatch"))


@pytest.fixture(scope="module", params=GRIDS, ids=lambda g: f"{g[0]}-{g[1]}-{g[2]}")
def runs(request, tmp_path_factory):
    """One grid's runs: the grid's 10 steps beside JAX's (mb = 4); then the
    grid resuming JAX's step-5 checkpoint beside JAX resuming the grid's."""
    arch, parallel, opt_shard = request.param
    root = tmp_path_factory.mktemp(arch)
    out = {"arch": arch, "parallel": parallel, "opt_shard": opt_shard, "root": root}
    mb = _batch_ranks(parallel)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_port, arch, root / "grid", parallel, opt_shard)
        out["jax"] = _jax(arch, root / "jax", mb)
        out["grid"] = fut.result()
        shutil.copytree(root / "jax", root / "grid_resumed")
        shutil.copytree(root / "grid", root / "grid_then_jax")
        fut = pool.submit(_port, arch, root / "grid_resumed", parallel, opt_shard)
        out["grid_then_jax"] = _jax(arch, root / "grid_then_jax", mb)
        out["grid_resumed"] = fut.result()
    return out


def test_jax_checkpoint_resumes_on_the_grid(runs):
    assert [h["step"] for h in runs["grid_resumed"]] == [6, 7, 8, 9]
    _close(runs["grid_resumed"], runs["jax"][6:])


def test_grid_checkpoint_resumes_in_jax(runs):
    assert [h["step"] for h in runs["grid_then_jax"]] == [6, 7, 8, 9]
    _close(runs["grid_then_jax"], runs["grid"][6:])
    np.testing.assert_allclose([h["lr"] for h in runs["grid"]], [h["lr"] for h in runs["jax"]],
                               **TOL)
    assert runs["grid"][-1]["loss"] < runs["grid"][0]["loss"]


def test_grid_outputs_match_jax(runs):
    """summary.json; the checkpoint files' keys, shapes and dtypes (whole
    arrays); the MANIFEST's plan."""
    root, parallel, opt_shard = runs["root"], runs["parallel"], runs["opt_shard"]
    sj, st = (json.loads((root / d / "summary.json").read_text())
              for d in ("jax", "grid"))
    jplan = _jax_plan(runs["arch"], parallel, opt_shard)
    mesh = AbstractMesh(tuple(n for _, n in jplan.mesh_axes()),
                        tuple(a for a, _ in jplan.mesh_axes()),
                        axis_types=(AxisType.Auto,) * len(jplan.mesh_axes()))
    assert st["parallel"] == str(jplan) and sj["parallel"] is None
    assert st["opt_overlap"] == jresolve_overlap(None, opt_shard, mesh)
    skip = ("final_loss", "parallel", "opt_overlap", "opt_shard")
    assert {k: v for k, v in st.items() if k not in skip} == \
        {k: v for k, v in sj.items() if k not in skip}
    assert st["opt_shard"] == opt_shard
    for rel in ("ckpt/ckpt-1/state.npz", "ckpt/model-00000005.npz"):
        with np.load(root / "jax" / rel) as a, np.load(root / "grid" / rel) as b:
            assert list(a.files) == list(b.files)
            for k in a.files:
                assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
    man = json.loads((root / "grid" / "ckpt" / "ckpt-1" / "MANIFEST.json").read_text())
    jr = JResolved(plan=jplan)
    assert man["plan"] == {"spec": jr.spec(), "layout": jr.layout_signature()}


def test_fault_injection_on_a_2x2_grid_matches_its_clean_run(tmp_path):
    """A hard failure at step 7 and a soft one at step 12 reach every rank:
    two relaunches, the buffer nodes of a 4-node run swapped in, and a
    history bit-identical to the clean run's."""
    kw = dict(steps=14, ckpt_interval=5)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_port, "mula-7b-a1b", tmp_path / "clean", "dp=2,ep=2", "epso", **kw)
        faulty = _port("mula-7b-a1b", tmp_path / "faulty", "dp=2,ep=2", "epso",
                       inject_hard_at=7, inject_soft_at=12, **kw)
        clean = fut.result()
    assert clean.relaunches == 0 and faulty.relaunches == 2
    assert faulty.replaced == [(0, 4), (1, 5)]
    assert list(faulty) == list(clean) and [h["step"] for h in faulty] == list(range(14))
    summary = json.loads((tmp_path / "faulty" / "summary.json").read_text())
    assert summary["relaunches"] == 2 and summary["replaced"] == [[0, 4], [1, 5]]


def test_fault_injection_on_an_ep_tp_grid_matches_its_clean_run(tmp_path):
    """``--parallel dp=1,ep=2,tp=2 --opt-shard epso``: a hard failure at
    step 7 relaunches from the step-5 checkpoint, and the history is
    bit-identical to the clean run's."""
    kw = dict(steps=10, ckpt_interval=5)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_port, "mula-7b-a1b", tmp_path / "clean", "dp=1,ep=2,tp=2", "epso",
                          **kw)
        faulty = _port("mula-7b-a1b", tmp_path / "faulty", "dp=1,ep=2,tp=2", "epso",
                       inject_hard_at=7, **kw)
        clean = fut.result()
    assert clean.relaunches == 0 and faulty.relaunches == 1
    assert list(faulty) == list(clean) and [h["step"] for h in faulty] == list(range(10))


def test_epso_checkpoint_restores_into_so_ranks_only_when_resharding(tmp_path):
    """A (2, 2) EPSO state saved through the grid Checkpointer restores into
    (4, 1) SO ranks: refused under the default ``on_plan_mismatch`` with the
    JAX message, then with 'reshard' the same full master, m, v and step
    (``opt_state_from_ranks``) and params; the model-only checkpoint the
    same params."""
    tc = treduced(tget("mula-7b-a1b"), d_model=64, vocab=128, max_experts=8)
    root = str(tmp_path / "ck")
    saved = spawn(ranks.grid_checkpoint_rank, 4, args=(tc, "dp=2,ep=2,opt=epso", root, "save"),
                  device="cpu", grid=(2, 2), timeout_s=120)
    back = spawn(ranks.grid_checkpoint_rank, 4, args=(tc, "dp=4,opt=so", root, "restore"),
                 device="cpu", grid=(4, 1), timeout_s=120)
    for r in back:
        assert "refusing to silently reshard" in r["error"] and r["step"] == 5
    want = opt_state_from_ranks([s.opt for s in saved], tc, dp=2, ep=2, mode="epso")
    got = opt_state_from_ranks([r["state"].opt for r in back], tc, dp=4, ep=1, mode="so")
    assert want["step"] == got["step"] == 7
    for what in ("master", "m", "v"):
        for path, ref in want[what].items():
            np.testing.assert_array_equal(got[what][path], ref, err_msg=f"{what} {path}")
    for r in back:          # whole params on every (4, 1) rank
        for what in ("state", "model_only"):
            params = r[what].params if what == "state" else r[what]
            for path, p in leaves_with_path(params):
                np.testing.assert_array_equal(p.numpy(), want["master"][path],
                                              err_msg=f"{what} {path}")


def test_spawn_keeps_a_run_results_attributes():
    out = spawn(ranks.run_result_rank, 2, device="cpu", timeout_s=60)
    assert [type(r).__name__ for r in out] == ["RunResult"] * 2
    assert [(list(r), r.relaunches, r.replaced) for r in out] == \
        [([{"step": 0}], 2, [(0, 4)]), ([{"step": 1}], 3, [(0, 4)])]
