"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The library lands
in ``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by a
hash of the sources and flags, so a fresh checkout builds it at first use
and an unchanged one reuses it. A missing ``nvcc`` or a failed build
raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", *ARCH_FLAGS]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> (argument types, return type)
_SIGNATURES = {
    "repro_gmm_block_m": ([], _I),
    "repro_gmm_tile_m": ([], _I),
    "repro_error_string": ([_I], ctypes.c_char_p),
    "repro_gmm": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "repro_tgmm": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "repro_swiglu": ([_P, _P, _P, ctypes.c_longlong, _P], _I),
    "repro_swiglu_bwd": ([_P, _P, _P, _P, _P, ctypes.c_longlong, _P], _I),
    "repro_combine": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "repro_combine_max_k": ([], _I),
    "repro_combine_bwd": ([_P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "repro_flash_attention": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _P], _I),
    "repro_ssd_intra_chunk": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, _P],
                              _I),
    "repro_token_counts": ([_P, ctypes.c_longlong, ctypes.c_longlong, _I, _P, _P], _I),
    "repro_dispatch_plan_max_local": ([], _I),
    "repro_dispatch_plan": ([_P, ctypes.c_longlong, ctypes.c_longlong, _I, ctypes.c_longlong, _I,
                             _I, _I, _I, _P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _P, _P],
                            _I),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the port's CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Compile the kernels if this source hash has not been built yet;
    returns the library's path. The compiler's output (``-Xptxas=-v``:
    registers, shared memory, spills per kernel) goes to ``build.log``
    beside the library."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        cus = [p for p in sources() if p.suffix == ".cu"]
        procs = [(src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
             "-o", str(tmp / (src.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in cus]
        logs, failed = [], []
        for src, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name} (rc {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        link = subprocess.run(
            [nvcc, "-shared", *ARCH_FLAGS, *[str(tmp / (s.stem + ".o")) for s in cus],
             "-o", str(tmp / LIB_NAME)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
        (out.parent / "build.log").write_text("\n".join(logs))
        os.replace(tmp / LIB_NAME, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check_launch(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({msg})")


def check_operand(t, name: str, ndim: int, dtype=None) -> None:
    """Validate a tensor handed to a kernel: of the kernel's dtype (bf16
    unless given), rank, contiguous, 16-byte aligned, on a CUDA device."""
    check_operands((t, name, ndim, dtype))


def check_operands(*specs) -> None:
    """``check_operand`` over several ``(tensor, name, ndim, dtype)``
    operands, the device of each checked after every other property of all
    of them, so that a fault of type or layout shows on any device."""
    for t, name, ndim, dtype in specs:
        dtype = dtype or torch.bfloat16
        if t.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
        if t.ndim != ndim:
            raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
    for t, name, _, _ in specs:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
