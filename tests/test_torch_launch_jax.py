"""PyTorch port, the one-device training launcher (``repro_torch.launch.
train.run``) against the JAX package's ``repro.launch.train.run``: their
checkpoints interoperate.

A JAX run of 10 steps checkpoints at step 5; its directory is copied, and
JAX resumes steps 6-9 in one copy, the port (``device="cpu"``, float32) in
the other; then the reverse (the port writes, JAX resumes). Losses, grad
norms and lrs agree at atol = rtol = 1e-4. Mula-7B-A1B runs dropless on
both sides: the JAX launcher's default MoE backend gives every expert a
uniform capacity (pool rows / E), the port's kernel path ragged groups,
so under capacity dispatch they drop different pairs once an expert
overflows. The state-space archs run too: Zamba2-7B (hybrid) at 5 layers,
2 groups of 2 Mamba-2 layers and 1 remaining layer, and falcon-mamba-7b
(Mamba-1) at 2. The JAX launcher runs 3 times an arch (5-15 s each). The
launcher's other tests are in ``test_torch_launch.py``, whose settings
this file shares."""
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as jlaunch  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from test_torch_launch import ARCHS, KW, TOL, _close  # noqa: E402


def _port(arch, out, **kw):
    return tlaunch.run(arch, out=str(out), device="cpu", **{**KW, **ARCHS[arch], **kw})


def _jax(arch, out, **kw):
    return jlaunch.run(arch, out=str(out), **{**KW, **ARCHS[arch], **kw})


@pytest.fixture(scope="module", params=list(ARCHS))
def runs(request, tmp_path_factory):
    """One arch's runs: JAX 10 steps, resumed from step 6 by JAX and by the
    port in copies of its directory; the port 10 steps, resumed by JAX."""
    arch = request.param
    root = tmp_path_factory.mktemp(arch)
    out = {"arch": arch, "root": root, "jax": _jax(arch, root / "jax")}
    for side, fn in (("jax_resumed", _jax), ("port_resumed", _port)):
        shutil.copytree(root / "jax", root / side)
        out[side] = fn(arch, root / side)
    out["port"] = _port(arch, root / "port")
    shutil.copytree(root / "port", root / "port_then_jax")
    out["port_then_jax"] = _jax(arch, root / "port_then_jax")
    return out


def test_jax_checkpoint_resumes_in_port(runs):
    assert [h["step"] for h in runs["port_resumed"]] == [6, 7, 8, 9]
    _close(runs["port_resumed"], runs["jax_resumed"])


def test_port_checkpoint_resumes_in_jax(runs):
    assert [h["step"] for h in runs["port_then_jax"]] == [6, 7, 8, 9]
    _close(runs["port_then_jax"], runs["port"][6:])
    # the port's own init differs (JAX's PRNG is not reproduced); the schedule not
    np.testing.assert_allclose([h["lr"] for h in runs["port"]], [h["lr"] for h in runs["jax"]],
                               **TOL)
    assert runs["port"][-1]["loss"] < runs["port"][0]["loss"]


def test_outputs_match_jax(runs):
    """The same data bytes, the same summary.json fields and history.json
    records, the same checkpoint files (keys, shapes, dtypes)."""
    root = runs["root"]
    for f in (root / "jax" / "data").iterdir():
        assert (root / "port" / "data" / f.name).read_bytes() == f.read_bytes(), f.name
    sj, st = (json.loads((root / d / "summary.json").read_text())
              for d in ("jax_resumed", "port_resumed"))
    assert {k: v for k, v in st.items() if k != "final_loss"} == \
        {k: v for k, v in sj.items() if k != "final_loss"}
    np.testing.assert_allclose(st["final_loss"], sj["final_loss"], **TOL)
    hj, ht = (json.loads((root / d / "history.json").read_text())
              for d in ("jax_resumed", "port_resumed"))
    _close(ht, hj)
    for rel in ("ckpt/ckpt-1/state.npz", "ckpt/model-00000005.npz"):
        with np.load(root / "jax" / rel) as a, np.load(root / "port" / rel) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
