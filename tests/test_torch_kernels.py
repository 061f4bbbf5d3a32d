"""PyTorch port, kernel by kernel: on the CPU each wrapper of
``repro_torch.kernels.ops`` runs its plain version, held here against the
JAX package's Pallas kernel (interpret mode) on the same numpy inputs, in
float32 at atol = rtol = 1e-4: forward, the backward kernels' plain
versions, and each ``autograd.Function``'s gradients against ``jax.vjp``
of the JAX wrapper's custom VJP. The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_cuda.py and
``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import gmm as jgmm  # noqa: E402
from repro.kernels import combine as jcombine  # noqa: E402
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
    """The group alignment the dispatch honours is the kernel's BLOCK_M,
    16 rows; the kernel's wgmma row tile (TILE_M) is decoupled from it."""
    from repro_torch.kernels.gmm import BLOCK_M, TILE_M
    assert ops.gmm_align() == BLOCK_M == 16
    assert TILE_M % BLOCK_M == 0


def test_gmm_align_and_pool_rows_unchanged():
    """The redesigned kernel leaves the dispatch as it was: alignment 16 and
    the pool rows of the train (4096 tokens), EP (8192 gathered tokens, 16
    local experts) and dropless decode (8 tokens) dispatches of Mula-7B-A1B."""
    from repro_torch.configs import get_config
    from repro_torch.core import moe
    m = get_config("mula-7b-a1b").moe
    assert ops.gmm_align() == 16
    assert moe.dispatch_pool_rows(4096, m) == 41984
    assert moe.dispatch_pool_rows(8192, m, local_experts=16) == 20736
    assert moe.dispatch_pool_rows(8, m, dropless=True) == 1088


def _gmm_tile_map(sizes, M):
    """The gmm kernel's tile arithmetic (csrc/gmm.cu), mirrored in numpy:
    how often each row is stored by its group's tile, and zeroed by a spare
    tile, over the ``row_tiles(M, G)`` row tiles of the grid."""
    from repro_torch.kernels.gmm import TILE_M, row_tiles
    sizes = np.asarray(sizes, np.int64)
    G = len(sizes)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    tstarts = np.concatenate([[0], np.cumsum(-(-sizes // TILE_M))])
    total, used = int(starts[-1]), int(tstarts[-1])
    stored, zeroed = np.zeros(M, np.int64), np.zeros(M, np.int64)
    for idx in range(row_tiles(M, G)):
        g = int(np.searchsorted(tstarts[1:], idx, side="right"))
        if g < G:                            # rows [m0, group end) of the tile
            m0 = starts[g] + (idx - tstarts[g]) * TILE_M
            stored[m0:min(m0 + TILE_M, starts[g + 1], M)] += 1
        else:                                # a spare tile: its share of the tail
            r0 = total + (idx - used) * TILE_M
            zeroed[r0:min(r0 + TILE_M, M)] += 1
    return stored, zeroed, total, used


def _routed_sizes(rng, T, E, K, pool, align=16):
    """Group sizes of a random top-K dispatch, each aligned up, cut to the pool."""
    counts = np.bincount(rng.random((T, E)).argsort(1)[:, :K].ravel(), minlength=E)
    sizes = -(-counts // align) * align
    while sizes.sum() > pool:                # capacity: drop from the largest
        sizes[sizes.argmax()] -= align
    return sizes.tolist()


@pytest.mark.parametrize("case", [f"random-{i}" for i in range(16)]
                         + ["train", "ep", "decode", "empty", "one-group"])
def test_gmm_grid_covers_the_groups(case):
    """The static grid bound, ceil(M / TILE_M) + G row tiles, holds every
    group's ceil(size / TILE_M) tiles, and its spare tiles zero exactly the
    rows past the total: every row is written once, by its group's tile or
    as a zero, for random group sizes (multiples of 16, zeros, totals below
    M) and the paths' dispatches."""
    from repro_torch.kernels.gmm import TILE_M, row_tiles
    rng = np.random.default_rng(int(case.split("-")[1]) if case.startswith("random")
                                else sum(map(ord, case)))
    if case == "train":
        sizes, M = _routed_sizes(rng, 4096, 64, 8, 41984), 41984
    elif case == "ep":
        sizes, M = _routed_sizes(rng, 8192, 64, 8, 20736)[48:], 20736
    elif case == "decode":
        sizes, M = _routed_sizes(rng, 8, 64, 8, 1088), 1088
    elif case == "empty":
        sizes, M = [0] * 7, 64
    elif case == "one-group":
        sizes, M = [0, 4096, 0], 4096
    else:
        G = int(rng.integers(1, 80))
        sizes = (16 * rng.integers(0, 40, G) * (rng.random(G) < 0.7)).tolist()
        M = sum(sizes) + 16 * int(rng.integers(0, 30))
        M = max(M, 16)
    stored, zeroed, total, used = _gmm_tile_map(sizes, M)
    assert used <= row_tiles(M, len(sizes))
    assert (stored[:total] == 1).all() and (stored[total:] == 0).all()
    assert (zeroed[:total] == 0).all() and (zeroed[total:] == 1).all()
    assert row_tiles(M, len(sizes)) * TILE_M >= M


def _bf(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("args,kw,err,match", [
    ((_bf(24, 64), _bf(2, 64, 64), torch.tensor([16, 8], dtype=torch.int32)), {},
     ValueError, "M % 16"),
    ((_bf(16, 12), _bf(1, 12, 16), torch.tensor([16], dtype=torch.int32)), {},
     ValueError, "multiples of 8"),
    ((_bf(16, 64), _bf(2, 32, 16), torch.tensor([16, 0], dtype=torch.int32)), {},
     ValueError, "disagree"),
    ((_bf(16, 64), _bf(2, 64, 16), torch.tensor([16, 0], dtype=torch.int32)),
     {"trans_rhs": True}, ValueError, "disagree"),
    ((_bf(16, 64), _bf(64, 16), torch.tensor([16], dtype=torch.int32)), {},
     ValueError, "takes lhs"),
    ((_bf(16, 64, dtype=torch.float32), _bf(1, 64, 16), torch.tensor([16], dtype=torch.int32)),
     {}, TypeError, "bfloat16"),
    ((_bf(16, 64), _bf(1, 64, 16), torch.tensor([16])), {}, TypeError, "int32"),
    ((_bf(64, 16).t(), _bf(1, 64, 16), torch.tensor([16], dtype=torch.int32)), {},
     ValueError, "contiguous"),
    ((_bf(16 * 64 + 1)[1:].view(16, 64), _bf(1, 64, 16), torch.tensor([16], dtype=torch.int32)),
     {}, ValueError, "16-byte aligned"),
    ((_bf(16, 64), _bf(1, 64, 16), torch.tensor([16], dtype=torch.int32)), {},
     ValueError, "CUDA tensor"),
])
def test_gmm_wrapper_rejects_before_launch(args, kw, err, match):
    """gmm_cuda checks shapes, alignment, dtype, layout and device before it
    builds or launches anything (there is no nvcc here: reaching the
    library would fail otherwise)."""
    from repro_torch.kernels.gmm import gmm_cuda
    before = dict(ops.launches)
    with pytest.raises(err, match=match):
        gmm_cuda(*args, **kw)
    assert ops.launches == before


@pytest.mark.parametrize("q,k,v,err,match", [
    (_bf(1, 8, 4, 96), _bf(1, 8, 4, 96), _bf(1, 8, 4, 96), ValueError, "hd in"),
    (_bf(1, 8, 4, 64), _bf(1, 8, 3, 64), _bf(1, 8, 3, 64), ValueError, "nh % nkv"),
    (_bf(1, 8, 4, 64), _bf(1, 8, 4, 64), _bf(1, 9, 4, 64), ValueError, "disagree"),
    (_bf(1, 8, 4, 64), _bf(2, 8, 4, 64), _bf(2, 8, 4, 64), ValueError, "disagree"),
    (_bf(8, 4, 64), _bf(1, 8, 4, 64), _bf(1, 8, 4, 64), ValueError, "disagree"),
    (_bf(1, 8, 4, 64, dtype=torch.float16), _bf(1, 8, 4, 64), _bf(1, 8, 4, 64),
     TypeError, "bfloat16"),
    (_bf(1, 4, 8, 64).transpose(1, 2), _bf(1, 8, 4, 64), _bf(1, 8, 4, 64),
     ValueError, "contiguous"),
    (_bf(1, 8, 4, 64), _bf(1, 8, 4, 64), _bf(1, 8, 4, 64), ValueError, "CUDA tensor"),
])
def test_flash_wrapper_rejects_before_launch(q, k, v, err, match):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    before = dict(ops.launches)
    with pytest.raises(err, match=match):
        flash_attention_cuda(q, k, v)
    assert ops.launches == before


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
    x = torch.ones(8, 16, requires_grad=True)
    w = torch.ones(1, 16, 16, requires_grad=True)
    y = ops.gmm(ops.fused_swiglu(x, x), w, torch.tensor([8], dtype=torch.int32))
    ops.combine(y.reshape(4, 2, 16), torch.ones(4, 2)).sum().backward()
    ops.ssd_intra_chunk(torch.ones(1, 1, 4, 2, 8), torch.ones(1, 1, 4, 2), torch.ones(1, 1, 4, 8),
                        torch.ones(1, 1, 4, 8), -torch.ones(2))
    assert ops.token_counts(torch.tensor([[0, 3], [3, 9]]), 4).tolist() == [1, 0, 0, 2]
    slot, *_ = ops.dispatch_plan(torch.tensor([[0, 3], [3, 9]]), 4, 0, 16, 8)
    assert slot.tolist() == [0, 8, 9, 16]
    assert set(ops.launches) == {"gmm", "tgmm", "swiglu", "swiglu_bwd", "combine",
                                 "combine_bwd", "flash_attention", "ssd_intra_chunk",
                                 "token_counts", "dispatch_plan"}
    assert all(n == 0 for n in ops.launches.values())


@pytest.mark.parametrize("sizes", [
    [16, 0, 8, 24],          # an empty group, rows past the total
    [0, 0, 32, 0],           # one group only
    [8, 8, 8, 8, 8, 8],      # every row covered
])
def test_tgmm_ref_matches_jax(sizes):
    """tgmm_ref against the Pallas tgmm kernel (groups that have rows; the
    kernel leaves empty groups unwritten) and against the JAX oracle (every
    group; empty ones are zero)."""
    rng = np.random.default_rng(5)
    M, K, N = 48, 64, 32
    gs = np.array(sizes, np.int32)
    G, total = len(sizes), int(gs.sum())
    x = rng.standard_normal((M, K)).astype(np.float32)
    dy = rng.standard_normal((M, N)).astype(np.float32)
    xm, dym = x.copy(), dy.copy()
    xm[total:] = 0                       # the JAX wrapper masks rows past the total
    dym[total:] = 0
    gids = jops._tile_group_ids(jnp.asarray(gs), M // 8, 8)
    pallas = np.asarray(jgmm.tgmm_pallas(jnp.asarray(xm), jnp.asarray(dym), gids, G,
                                         tile_m=8, tile_k=32, tile_n=16, interpret=True))
    oracle = np.asarray(jref.tgmm_ref(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(gs), G))
    out = ref.tgmm_ref(_t(x), _t(dy), _t(gs), G).numpy()
    np.testing.assert_allclose(out, oracle, **TOL)
    np.testing.assert_allclose(out[gs > 0], pallas[gs > 0], **TOL)
    assert np.all(out[gs == 0] == 0)


def test_combine_bwd_ref_matches_jax():
    rng = np.random.default_rng(6)
    rows = rng.standard_normal((24, 4, 40)).astype(np.float32)
    w = rng.random((24, 4)).astype(np.float32)
    dout = rng.standard_normal((24, 40)).astype(np.float32)
    jd, jw = jcombine.combine_bwd_pallas(jnp.asarray(rows), jnp.asarray(w), jnp.asarray(dout),
                                         tile_t=8, tile_d=8, interpret=True)
    td, tw = ref.combine_bwd_ref(_t(rows), _t(w), _t(dout))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    assert tw.dtype == torch.float32


def _vjp_case(jfn, tfn, args, cot):
    """Output and input gradients of the JAX custom-VJP wrapper and the
    port's autograd.Function on the same inputs and cotangent."""
    with use_kernel_plan(PLAN):
        jout, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
        jgrads = vjp(jnp.asarray(cot))
    targs = [_t(a).requires_grad_() for a in args]
    tout = tfn(*targs)
    tgrads = torch.autograd.grad(tout, targs, _t(cot))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    for i, (tg, jg) in enumerate(zip(tgrads, jgrads)):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL, err_msg=f"grad {i}")


@pytest.mark.parametrize("sizes", [[16, 0, 8, 24], [8, 8, 8, 8, 8, 8]])
def test_gmm_grads_match_jax(sizes):
    rng = np.random.default_rng(7)
    M, K, N = 48, 40, 24
    gs = np.array(sizes, np.int32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((len(sizes), K, N)).astype(np.float32)
    dy = rng.standard_normal((M, N)).astype(np.float32)
    with use_kernel_plan(PLAN):
        jout, vjp = jax.vjp(lambda a, b: jops.gmm(a, b, jnp.asarray(gs)),
                            jnp.asarray(x), jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(dy))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    tout = ops.gmm(tx, tw, _t(gs))
    tdx, tdw = torch.autograd.grad(tout, (tx, tw), _t(dy))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), **TOL)


def test_swiglu_grads_match_jax():
    rng = np.random.default_rng(8)
    g = (3 * rng.standard_normal((32, 48))).astype(np.float32)
    u = rng.standard_normal((32, 48)).astype(np.float32)
    _vjp_case(jops.fused_swiglu, ops.fused_swiglu, (g, u),
              rng.standard_normal((32, 48)).astype(np.float32))


def test_combine_grads_match_jax():
    rng = np.random.default_rng(9)
    rows = rng.standard_normal((24, 4, 40)).astype(np.float32)
    w = rng.random((24, 4)).astype(np.float32)
    _vjp_case(jops.combine, ops.combine, (rows, w),
              rng.standard_normal((24, 40)).astype(np.float32))


@pytest.mark.parametrize("num_local", [1, 4, 16, 64, 240])
@pytest.mark.parametrize("F", [1, 7, 1000, 4099])
def test_token_counts_matches_jax(F, num_local):
    """Exact equality with the Pallas histogram over ids in [0, 256), at
    offsets inside the id range, where the local range ends at its top, and
    beyond it (no id counts); int64 ids as the router emits them."""
    ids = np.random.default_rng(F * 1000 + num_local).integers(0, 256, size=F).astype(np.int32)
    for offset in sorted({0, 16, 256 - min(num_local, 256), 300}):
        expect = np.asarray(jops.token_counts(jnp.asarray(ids), num_local, offset))
        got = ops.token_counts(_t(ids).to(torch.int64), num_local, offset)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), expect, err_msg=f"offset {offset}")
