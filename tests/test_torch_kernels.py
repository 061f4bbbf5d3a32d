"""PyTorch port, kernel by kernel: on the CPU each wrapper of
``repro_torch.kernels.ops`` runs its plain version, held here against the
JAX package's Pallas kernel (interpret mode) on the same numpy inputs, in
float32 at atol = rtol = 1e-4. The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_cuda.py and
``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

PLAN = KernelPlan(backend="pallas", attn_impl="pallas", interpret=True,
                  tile_m=8, tile_k=64, tile_n=32)
TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("sizes", [
    [16, 0, 8, 24],          # an empty group, rows past the total
    [0, 0, 32, 0],           # one group only
    [8, 8, 8, 8, 8, 8],      # every row covered
])
def test_gmm_matches_jax(sizes):
    rng = np.random.default_rng(0)
    M, K, N = 48, 40, 24
    gs = np.array(sizes, np.int32)
    G = len(sizes)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((G, K, N)).astype(np.float32)
    with use_kernel_plan(PLAN):
        expect = np.asarray(jops.gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs)))
    out = ops.gmm(_t(x), _t(w), _t(gs)).numpy()
    np.testing.assert_allclose(out, expect, **TOL)
    assert np.all(out[int(gs.sum()):] == 0)


def test_gmm_align_is_the_kernel_tile():
    from repro_torch.kernels.gmm import BLOCK_M
    assert ops.gmm_align() == BLOCK_M == 16


def test_swiglu_matches_jax():
    rng = np.random.default_rng(1)
    g = (3 * rng.standard_normal((32, 48))).astype(np.float32)
    u = rng.standard_normal((32, 48)).astype(np.float32)
    with use_kernel_plan(PLAN):
        expect = np.asarray(jops.fused_swiglu(jnp.asarray(g), jnp.asarray(u)))
    np.testing.assert_allclose(ops.fused_swiglu(_t(g), _t(u)).numpy(), expect, **TOL)


def test_combine_matches_jax():
    rng = np.random.default_rng(2)
    rows = rng.standard_normal((24, 4, 40)).astype(np.float32)
    w = rng.random((24, 4)).astype(np.float32)
    with use_kernel_plan(PLAN):
        expect = np.asarray(jops.combine(jnp.asarray(rows), jnp.asarray(w)))
    np.testing.assert_allclose(ops.combine(_t(rows), _t(w)).numpy(), expect, **TOL)


@pytest.mark.parametrize("S,nh,nkv,window", [
    (32, 4, 4, 0),           # causal
    (40, 4, 4, 0),           # Skv not a multiple of the kv block
    (40, 4, 2, 0),           # GQA
    (37, 4, 1, 8),           # sliding window + GQA + ragged
])
def test_flash_attention_matches_jax(S, nh, nkv, window):
    rng = np.random.default_rng(3)
    hd = 16
    q = rng.standard_normal((2, S, nh, hd)).astype(np.float32)
    k = rng.standard_normal((2, S, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((2, S, nkv, hd)).astype(np.float32)
    with use_kernel_plan(PLAN):
        expect = np.asarray(jops.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=window,
            q_block=16, kv_block=16))
    out = ops.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window).numpy()
    np.testing.assert_allclose(out, expect, **TOL)


@pytest.mark.parametrize("ring", [False, True])
def test_slot_decode_attention_matches_jax(ring):
    rng = np.random.default_rng(4)
    B, S, nh, nkv, hd = 3, 12, 4, 2, 16
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, nkv, hd)).astype(np.float32)
    pos = np.array([0, 7, 30 if ring else 11], np.int32)
    expect = np.asarray(jref.slot_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos), ring=ring))
    out = ref.slot_decode_attention_ref(_t(q), _t(kc), _t(vc), _t(pos), ring=ring).numpy()
    np.testing.assert_allclose(out, expect, **TOL)


def test_cpu_wrappers_count_no_launches():
    ops.reset_launches()
    x = torch.ones(8, 16)
    ops.fused_swiglu(x, x)
    ops.gmm(x, torch.ones(1, 16, 8), torch.tensor([8], dtype=torch.int32))
    assert all(n == 0 for n in ops.launches.values())
