"""PyTorch port: config copies, import hygiene, device resolution and the
no-fallback rules of the kernel wrappers (CPU only; no card needed)."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.mark.parametrize("name", sorted(jcfg.ARCH_REGISTRY))
def test_registered_configs_match_jax(name):
    assert dataclasses.asdict(tcfg.get_config(name)) == \
        dataclasses.asdict(jcfg.get_config(name))


@pytest.mark.parametrize("name", ["mula-7b-a1b", "mula-1b", "mixtral-8x7b",
                                  "moonshot-v1-16b-a3b"])
def test_reduced_matches_jax(name):
    kw = dict(d_model=64, vocab=128)
    assert dataclasses.asdict(tcfg.reduced(tcfg.get_config(name), **kw)) == \
        dataclasses.asdict(jcfg.reduced(jcfg.get_config(name), **kw))


@pytest.mark.parametrize("cls", ["ParallelConfig", "TrainConfig"])
def test_train_configs_match_jax(cls):
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    assert dataclasses.asdict(getattr(tbase, cls)()) == dataclasses.asdict(getattr(jbase, cls)())
    with pytest.raises(ValueError, match="microbatches"):
        tbase.ParallelConfig(microbatches=0)


def test_registry_names_match():
    assert sorted(tcfg.ARCH_REGISTRY) == sorted(jcfg.ARCH_REGISTRY)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "import repro_torch.serve, repro_torch.convert, repro_torch.kernels.ops\n"
            "import repro_torch.train, repro_torch.optim, repro_torch.parallel\n"
            "import repro_torch.data, repro_torch.ft, repro_torch.checkpoint\n"
            "import repro_torch.launch.train\n"
            "import chip_smoke\n"
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
            "print('clean')")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=str(ROOT), timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "clean" in r.stdout


def test_entry_points_need_a_device(monkeypatch):
    """Without a card and without device='cpu' the entry points raise
    rather than quietly running on the CPU."""
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve import ServeEngine
    from repro_torch.train import init_state
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.reduced(tcfg.get_config("mula-7b-a1b"), d_model=64, vocab=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(cfg, tcfg.TrainConfig())
    assert init_state(cfg, tcfg.TrainConfig(), device="cpu").opt.step.item() == 0
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(params, cfg, num_slots=2, max_len=16)
    eng = ServeEngine(params, cfg, num_slots=2, max_len=16, device="cpu")
    assert eng.pool.cache["kv"]["k"].device.type == "cpu"


def test_cuda_launchers_refuse_cpu_tensors():
    """The CUDA launchers validate before touching the library: a CPU
    tensor or a wrong dtype raises (the ops wrappers send CPU tensors to
    the plain versions before ever reaching them)."""
    from repro_torch.kernels.combine import combine_bwd_cuda, combine_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.gmm import gmm_cuda, tgmm_cuda
    from repro_torch.kernels.swiglu import swiglu_bwd_cuda, swiglu_cuda
    x = torch.zeros(16, 8, dtype=torch.bfloat16)
    gs = torch.tensor([16, 0], dtype=torch.int32)
    w = torch.zeros(2, 8, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gmm_cuda(x, w, gs)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gmm_cuda(x, w, gs, trans_rhs=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgmm_cuda(x, x, gs)
    with pytest.raises(ValueError, match="CUDA tensor"):
        swiglu_cuda(x, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        swiglu_bwd_cuda(x, x, x)
    rows = torch.zeros(2, 2, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        combine_cuda(rows, x[:2, :2])
    with pytest.raises(ValueError, match="CUDA tensor"):
        combine_bwd_cuda(rows, x[:2, :2], x[:2])
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, q, q)
    from repro_torch.kernels.ssd import ssd_intra_chunk_cuda
    xs = torch.zeros(1, 1, 16, 2, 32, dtype=torch.bfloat16)
    bc = torch.zeros(1, 1, 16, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_intra_chunk_cuda(xs, torch.zeros(1, 1, 16, 2), bc, bc, torch.zeros(2))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc means a clear error, not a fallback."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_key_covers_every_source():
    from repro_torch.kernels import _build
    names = {p.name for p in _build.sources()}
    assert {"gmm.cu", "tgmm.cu", "swiglu.cu", "combine.cu", "flash_attention.cu", "ssd.cu",
            "common.cuh"} <= names
    assert _build.source_hash() == _build.source_hash()
    assert _build.library_path().name == _build.LIB_NAME


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    """chip_smoke.py has no CPU path: without a card it exits non-zero and
    prints no result line."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out
