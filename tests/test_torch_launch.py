"""PyTorch port, the one-device training launcher (``repro_torch.launch.
train.run``) against the JAX package's ``repro.launch.train.run``, the
whole slice: data pipeline, model, AdamW, dual + model-only checkpoints
and the failure-handling loop. The checkpoints' interchange with the JAX
launcher, arch by arch, is in ``test_torch_launch_jax.py``, which shares
``KW``, ``ARCHS``, ``TOL`` and ``_close`` from here."""
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as jlaunch  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402

KW = dict(steps=10, ckpt_interval=5, d_model=64, batch=4, seq=32, log_every=100)
ARCHS = {"mula-1b": {}, "mula-7b-a1b": {"moe_dispatch": "dropless"}, "zamba2-7b": {"layers": 5},
         "falcon-mamba-7b": {}}
TOL = dict(atol=1e-4, rtol=1e-4)
FT = dict(steps=18, batch=4, seq=32, d_model=64, ckpt_interval=5, log_every=100)


def _close(got, ref):
    assert [h["step"] for h in got] == [h["step"] for h in ref]
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r), g["step"]
        for k in r:
            np.testing.assert_allclose(g[k], r[k], **TOL, err_msg=f"step {r['step']} {k}")


def test_fault_injection_matches_uninterrupted(tmp_path):
    """A hard failure at step 7 and a soft (NaN) one at step 12: two
    relaunches, the node swaps of the JAX run's, both slots valid at steps
    10 and 15, and a history bit-identical to the clean run's."""
    clean = tlaunch.run("mula-1b", out=str(tmp_path / "clean"), device="cpu", **FT)
    faulty = tlaunch.run("mula-1b", out=str(tmp_path / "faulty"), device="cpu",
                         inject_hard_at=7, inject_soft_at=12, **FT)
    ref = jlaunch.run("mula-1b", out=str(tmp_path / "jax"), inject_hard_at=7,
                      inject_soft_at=12, **FT)
    assert clean.relaunches == 0 and faulty.relaunches == ref.relaunches == 2
    assert faulty.replaced == ref.replaced and len(faulty.replaced) == 2
    steps = set()
    for slot in ("ckpt-1", "ckpt-2"):
        m = json.loads((tmp_path / "faulty" / "ckpt" / slot / "MANIFEST.json").read_text())
        assert m["valid"]
        steps.add(m["step"])
    assert steps == {10, 15}
    assert list(faulty) == list(clean)                    # every field, bit for bit
    assert [h["step"] for h in faulty] == list(range(18))
    summary = json.loads((tmp_path / "faulty" / "summary.json").read_text())
    assert summary["relaunches"] == 2 and summary["steps"] == 18
    assert summary["replaced"] == [list(p) for p in ref.replaced]


def test_failure_before_first_checkpoint_restarts_from_init(tmp_path, monkeypatch):
    """A hard failure at step 1, before the first checkpoint (step 5): the
    fallback rebuilds the initial state into the live tensors, so the run
    equals the clean one. The failure step comes from REPRO_INJECT_HARD_AT."""
    kw = dict(steps=6, batch=4, seq=32, d_model=64, ckpt_interval=5, log_every=100)
    clean = tlaunch.run("mula-7b-a1b", out=str(tmp_path / "clean"), device="cpu", **kw)
    monkeypatch.setenv("REPRO_INJECT_HARD_AT", "1")
    faulty = tlaunch.run("mula-7b-a1b", out=str(tmp_path / "faulty"), device="cpu", **kw)
    assert faulty.relaunches == 1 and list(faulty) == list(clean)


def test_injection_clamps_the_checkpoint_interval(tmp_path, capsys):
    res = tlaunch.run("mula-1b", out=str(tmp_path), device="cpu", steps=8, batch=2, seq=16,
                      d_model=64, ckpt_interval=50, inject_soft_at=5, log_every=100)
    assert "ckpt interval clamped to 2" in capsys.readouterr().out
    assert res.relaunches == 1 and [h["step"] for h in res] == list(range(8))


def test_resume_continues_where_the_checkpoint_left_off(tmp_path):
    out = str(tmp_path / "run")
    kw = dict(batch=4, seq=64, ckpt_interval=5, d_model=64, log_every=100, device="cpu")
    first = tlaunch.run("mula-1b", steps=10, out=out, **kw)
    second = tlaunch.run("mula-1b", steps=14, out=out, **kw)
    assert [h["step"] for h in second] == list(range(6, 14))
    # step 6 runs on the restored state, bit for bit; its lr follows the 14-step schedule
    assert (second[0]["loss"], second[0]["grad_norm"]) == (first[6]["loss"],
                                                           first[6]["grad_norm"])
    assert second[0]["lr"] != first[6]["lr"]
    assert np.isfinite([h["loss"] for h in second]).all()


@pytest.mark.parametrize("kw", [
    {"parallel": "dp=2,tp=2", "arch": "zamba2-7b"}, {"parallel": "tp=2", "arch": "falcon-mamba-7b"},
    {"parallel": "pod=2,dp=2"},
    {"parallel": "dp=2,tp=2,fsdp", "arch": "zamba2-7b"},
    {"parallel": "pod=2,dp=2,ep=2,fsdp", "rebalance_force_at": 3},
    {"parallel": "dp=2,tiles=auto"}, {"kernel_tiles": "auto"}, {"arch": "phi-3-vision-4.2b"},
    {"arch": "seamless-m4t-medium"}],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unsupported_arguments_raise(tmp_path, kw):
    kw = dict(kw)
    arch = kw.pop("arch", "mula-7b-a1b")
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item"):
        tlaunch.run(arch, out=str(tmp_path / "run"), device="cpu", steps=2, **kw)
    assert not (tmp_path / "run").exists()                # refused before any work


@pytest.mark.parametrize("kw,err,match", [
    ({"arch": "zamba2-7b", "layers": 4}, ValueError, "needs arch_type in"),
    ({"parallel": "pp=2,ep=2,rebalance=50:1.25"}, NotImplementedError,
     "not threaded through the pipeline"),
    ({"arch": "zamba2-7b", "layers": 4, "parallel": "pp=2,fsdp"}, ValueError,
     "needs arch_type in"),
    ({"parallel": "dp=2,pp=2,ep=2,fsdp,rebalance=50:1.25"}, NotImplementedError,
     "not threaded through the pipeline"),
    ({"pp_impl": "shardmap", "microbatches": 3, "batch": 6}, ValueError,
     "needs microbatches divisible by pp_stages")],
    ids=["hybrid", "rebalance", "hybrid-fsdp", "rebalance-fsdp", "ragged-waves"])
def test_pipelines_refuse_what_jax_refuses(tmp_path, kw, err, match):
    """With a pp axis, before any work, the JAX package's errors: a
    non-uniform (hybrid) stack, a rebalance= policy (both also with fsdp,
    which takes the hybrid and a placement elsewhere), and under
    pp_impl='shardmap' a microbatch count pp does not divide."""
    kw = {"parallel": "pp=2", **kw}
    arch = kw.pop("arch", "mula-7b-a1b")
    with pytest.raises(err, match=match):
        tlaunch.run(arch, out=str(tmp_path / "run"), device="cpu", steps=2, **kw)
    assert not (tmp_path / "run").exists()


PP_KW = dict(steps=6, ckpt_interval=3, d_model=64, batch=4, seq=32, layers=4, log_every=100,
             moe_dispatch="dropless")


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    """Reduced Mula-7B-A1B (4 layers, dropless) through ``--parallel pp=2``
    (2 stages, 4 microbatches by default, 1f1b): a clean run of 6 steps and
    one with a hard failure at step 5; and the JAX launcher's run of the
    same plan under its masked executor, in a child process that sees two
    CPU devices (its per-stage executor does not trace on this JAX)."""
    import os
    import subprocess
    import sys
    from repro.launch.mesh import forced_device_env
    root = tmp_path_factory.mktemp("pp")
    out = {"root": root}
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = forced_device_env(2)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    args = [f"--{k.replace('_', '-')}={v}" for k, v in PP_KW.items()]
    # the JAX run in its child process while the port's runs go on here
    with subprocess.Popen([sys.executable, "-m", "repro.launch.train", "--arch", "mula-7b-a1b",
                           "--parallel", "pp=2", "--pp-impl", "masked",
                           "--out", str(root / "jax"), *args], env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT) as jax_run:
        for name, extra in (("port", {}), ("port_ft", {"inject_hard_at": 5})):
            out[name] = tlaunch.run("mula-7b-a1b", out=str(root / name), device="cpu",
                                    parallel="pp=2", **PP_KW, **extra)
        log, _ = jax_run.communicate(timeout=300)
    assert jax_run.returncode == 0, log.decode()[-3000:]
    with open(root / "jax" / "history.json") as f:
        out["jax"] = json.load(f)
    return out


def test_pp_run_relaunches_bit_identically(pp_runs):
    """The injected failure at step 5 restores the step-3 checkpoint of the
    pp grid (its stage tiles gathered into whole arrays and sent back) and
    replays steps 4-5 bit for bit; the summary records the plan's stages,
    schedule and executor."""
    clean, ft = pp_runs["port"], pp_runs["port_ft"]
    assert ft.relaunches == 1 and [h["step"] for h in ft] == list(range(6))
    assert [(h["loss"], h["grad_norm"], h["lr"]) for h in ft] == \
        [(h["loss"], h["grad_norm"], h["lr"]) for h in clean]
    summary = json.loads((pp_runs["root"] / "port" / "summary.json").read_text())
    assert (summary["pp_stages"], summary["pp_schedule"], summary["pp_impl"],
            summary["parallel"]) == (2, "1f1b", "shardmap", "pp=2,moe=dropless,mb=4")


@pytest.mark.parametrize("reader", ["port_one_rank", "jax"])
def test_pp_grid_checkpoint_resumes_on_one_rank_and_in_jax(pp_runs, reader, tmp_path):
    """A copy of the pp grid run's directory resumes from its step-3
    checkpoint (whole (L, ...) stacks on disk) on one process, in the port
    (no plan) and in the JAX launcher, both with the same 4 microbatches:
    steps 4-5 equal the grid run's at 1e-4."""
    shutil.copytree(pp_runs["root"] / "port", tmp_path / "run")
    (tmp_path / "run" / "history.json").unlink()
    fn = jlaunch.run if reader == "jax" else tlaunch.run
    kw = {} if reader == "jax" else {"device": "cpu"}
    got = fn("mula-7b-a1b", out=str(tmp_path / "run"), microbatches=4, **PP_KW, **kw)
    assert [h["step"] for h in got] == [4, 5]
    _close(got, pp_runs["port"][4:])


def test_jax_pp_checkpoint_resumes_on_a_port_pp_grid(pp_runs, tmp_path):
    """The JAX launcher's pp=2 checkpoint (plan 'pp=2,impl=masked,...' in
    its MANIFEST) restores on the port's pp=2 grid under the same plan,
    which resumes steps 4-5 as the JAX run took them, at 1e-4."""
    shutil.copytree(pp_runs["root"] / "jax", tmp_path / "run")
    got = tlaunch.run("mula-7b-a1b", out=str(tmp_path / "run"), device="cpu", parallel="pp=2",
                      pp_impl="masked", **PP_KW)
    assert [h["step"] for h in got] == [4, 5]
    _close(got, pp_runs["jax"][4:])


@pytest.mark.parametrize("kw", [
    {"parallel": "dp=2,ep=2,rebalance=50:1.25"}, {"rebalance": "50:1.25"},
    {"rebalance_force_at": 3}],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_rebalance_arguments(tmp_path, kw):
    """The rebalance arguments, refused before expert placement was ported:
    a plan's policy runs on its grid (no window of 50 steps fills in 2);
    ``--rebalance`` without ``--parallel`` is the JAX launcher's ValueError,
    raised before any work; a forced proposal on one device (ep = 1) has
    nothing to move: the step after it is balanced, nothing is re-placed
    and the next checkpoint has no placement."""
    out = tmp_path / "run"
    if "parallel" not in kw and "rebalance" in kw:
        with pytest.raises(ValueError, match="--rebalance needs --parallel"):
            tlaunch.run("mula-7b-a1b", out=str(out), device="cpu", steps=2, **kw)
        assert not out.exists()
        return
    steps = 5 if "rebalance_force_at" in kw else 2
    res = tlaunch.run("mula-7b-a1b", out=str(out), device="cpu", steps=steps, batch=4,
                      seq=32, d_model=64, log_every=100, ckpt_interval=4, **kw)
    with open(out / "summary.json") as f:
        summary = json.load(f)
    assert [h["step"] for h in res] == list(range(steps)) and summary["rebalances"] == 0
    assert summary["rebalance"] == ("50:1.25" if "parallel" in kw else None)
    assert not any(h.get("rebalanced") for h in res)
    # one EP rank is balanced by definition
    assert all(h["moe_imbalance"] == 1.0 if "parallel" not in kw else h["moe_imbalance"] >= 1.0
               for h in res)
    if "rebalance_force_at" in kw:
        assert res[kw["rebalance_force_at"] + 1]["moe_imbalance"] == 1.0
        manifests = [json.loads(p.read_text()) for p in out.glob("ckpt/ckpt-*/MANIFEST.json")]
        assert [m["step"] for m in manifests if m.get("valid")] == [4]
        assert all("placement" not in m for m in manifests)


@pytest.mark.parametrize("kw,match", [
    ({"opt_shard": "so"}, "needs --parallel"), ({"opt_shard": "epso"}, "needs --parallel"),
    ({"mesh": "2,2", "parallel": "dp=2,ep=2"}, "mutually exclusive"),
    ({"opt_overlap": "ring"}, "needs opt_shard"), ({"parallel": "dp=3"}, "do not divide"),
    ({"parallel": "dp=2,ep=3"}, "does not divide")],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) if isinstance(kw, dict) else "")
def test_inconsistent_arguments_raise_value_error(tmp_path, kw, match):
    """The JAX launcher's ValueErrors: a sharded optimizer or the ring
    without a plan, --mesh with --parallel; and a plan whose ranks do not
    divide the batch (4 rows) or whose ep does not divide the experts."""
    with pytest.raises(ValueError, match=match):
        tlaunch.run("mula-7b-a1b", out=str(tmp_path / "run"), device="cpu", steps=2, batch=4,
                    **kw)
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("arch", ["zamba2-7b", "falcon-mamba-7b"])
def test_expert_parallelism_refuses_a_model_without_experts(tmp_path, arch):
    """The JAX plan's ValueError, before any work."""
    with pytest.raises(ValueError, match=f"plan ep=2 but {arch}-smoke has no experts"):
        tlaunch.run(arch, out=str(tmp_path / "run"), device="cpu", steps=2, batch=4,
                    parallel="dp=2,ep=2")
    assert not (tmp_path / "run").exists()


def test_hybrid_on_a_data_parallel_grid_matches_one_rank(tmp_path):
    """Reduced Zamba2-7B on ``--parallel dp=2 --opt-shard so`` (two gloo
    ranks: the 'so' placements and the grid checkpoints of the nested
    ``groups`` tree) against the same run on one rank: histories at 1e-4;
    then the grid resumes from its own step-5 checkpoint as the one-rank
    run does from its own."""
    kw = dict(KW, **ARCHS["zamba2-7b"])
    one = tlaunch.run("zamba2-7b", out=str(tmp_path / "one"), device="cpu", **kw)
    grid = tlaunch.run("zamba2-7b", out=str(tmp_path / "grid"), device="cpu",
                       parallel="dp=2", opt_shard="so", **kw)
    _close(grid, one)
    for d in ("one", "grid"):
        (tmp_path / d / "history.json").unlink()
    resumed = tlaunch.run("zamba2-7b", out=str(tmp_path / "grid"), device="cpu",
                          parallel="dp=2", opt_shard="so", **dict(kw, steps=12))
    again = tlaunch.run("zamba2-7b", out=str(tmp_path / "one"), device="cpu",
                        **dict(kw, steps=12))
    assert [h["step"] for h in resumed] == list(range(6, 12))
    _close(resumed, again)
    m = json.loads((tmp_path / "grid" / "ckpt" / "ckpt-1" / "MANIFEST.json").read_text())
    assert m["valid"]


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    tlaunch.main(["--arch", "mula-1b", "--device", "cpu", "--steps", "4", "--batch", "2",
                  "--seq", "32", "--d-model", "64", "--out", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "arch=mula-1b-smoke" in printed and "device=cpu compute_dtype=float32" in printed
    hist = json.loads((tmp_path / "history.json").read_text())
    assert [h["step"] for h in hist] == [0, 1, 2, 3]


def test_runs_on_cuda_unless_told_otherwise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.run("mula-1b", out=str(tmp_path), steps=2)
