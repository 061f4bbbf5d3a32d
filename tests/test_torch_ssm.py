"""PyTorch port, the hybrid (Mamba-2) serving slice, against the JAX
package on the CPU in float32: the plain SSD intra-chunk stage against the
Pallas kernel in interpret mode, the chunked scan, the Mamba-2 block and
decode step, and the hybrid model's forward, decode steps, caches and
serving lowerings on reduced Zamba2-7B.

The reduced model sets 7 layers and ``shared_attn_every=3`` (``reduced``
keeps a shared block every 2 layers), so that it has both ``groups`` (2 of
3 layers) and ``rem`` (1 layer); prompts of 37 tokens are not a multiple
of its 16-token chunk, so the padding runs. Tolerances: atol = rtol = 1e-4
as the earlier slices, except where a test says otherwise."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.kernels.ops import ssd_intra_chunk as jssd  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.parallel.plan import KernelPlan, use_kernel_plan  # noqa: E402
from repro.serve.engine import make_decode_fn as jdecode_fn  # noqa: E402
from repro.train.trainer import make_prefill_step as jprefill_step  # noqa: E402
from repro.train.trainer import make_serve_step as jserve_step  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.train import make_prefill_step, make_serve_step  # noqa: E402

PLAN = KernelPlan(backend="pallas", attn_impl="pallas", interpret=True,
                  tile_m=8, tile_k=64, tile_n=32)
TOL = dict(atol=1e-4, rtol=1e-4)
PROMPT = 37


def _np(t):
    return np.asarray(t)


def _ssd_inputs(rng, shape_x, shape_dt, shape_bc, H):
    """x, dt > 0, B, C and A < 0 as test_ssd_kernel.py draws them."""
    x = rng.standard_normal(shape_x).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal(shape_dt))).astype(np.float32)
    Bm = rng.standard_normal(shape_bc).astype(np.float32)
    Cm = rng.standard_normal(shape_bc).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    return x, dt, Bm, Cm, A


@pytest.mark.parametrize("B,C,L,H,P,N,of_max", [(2, 3, 16, 4, 8, 8, False),
                                                (1, 2, 32, 2, 16, 4, False),
                                                (2, 1, 8, 8, 4, 16, False),
                                                (1, 2, 256, 4, 64, 64, True)])
def test_plain_ssd_matches_pallas_kernel(B, C, L, H, P, N, of_max):
    """y and states within atol 1e-4; at L = 256 (``of_max``) within 1e-4
    of max|ref|: |y| reaches ~120 there, and the two packages' f32 cumsums
    of dt*A, taken in another order, move la and so the decays by ~1e-5
    relative. cdecay (<= 1) within 1e-5."""
    args = _ssd_inputs(np.random.default_rng(0), (B, C, L, H, P), (B, C, L, H),
                       (B, C, L, N), H)
    jy, jst, jcd = jssd(*map(jnp.asarray, args))
    ty, tst, tcd = ops.ssd_intra_chunk(*map(torch.from_numpy, args))
    for t, j in ((ty, jy), (tst, jst)):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        scale = float(np.abs(_np(j)).max()) if of_max else 1.0
        np.testing.assert_allclose(t.numpy(), _np(j), rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(tcd.numpy(), _np(jcd), rtol=0, atol=1e-5)


@pytest.mark.parametrize("S,with_h0", [(37, False), (37, True), (48, True), (10, True)])
def test_ssd_chunked_matches_jax(S, with_h0):
    """The whole chunked scan (chunk 16): S = 37 pads, S = 10 is shorter
    than a chunk, h0 is a carried-in state. atol 2e-4."""
    rng = np.random.default_rng(1)
    B, H, P, N = 2, 4, 8, 8
    args = _ssd_inputs(rng, (B, S, H, P), (B, S, H), (B, S, N), H)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32) if with_h0 else None
    jy, jh = jssm._ssd_chunked(*map(jnp.asarray, args), 16,
                               h0=None if h0 is None else jnp.asarray(h0))
    ty, th = tssm._ssd_chunked(*map(torch.from_numpy, args), 16,
                               h0=None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=2e-4, rtol=0)
    np.testing.assert_allclose(th.numpy(), _np(jh), atol=2e-4, rtol=0)


# ----------------------------------------------------------------------------
# the reduced hybrid model
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hybrid():
    """(jax cfg, port cfg, jax params, port params) of reduced Zamba2-7B."""
    jc = dataclasses.replace(jreduced(jget("zamba2-7b"), layers=7), shared_attn_every=3)
    tc = dataclasses.replace(treduced(tget("zamba2-7b"), layers=7), shared_attn_every=3)
    jp = jinit_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


def _tokens(vocab, batch=2, length=PROMPT, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, size=(batch, length)).astype(np.int32)


def _mixer(params, g, j):
    return jax.tree.map(lambda a: a[g, j], params["groups"]["mixer"])


def test_mamba2_block_and_decode_step_match_jax(hybrid):
    """One Mamba-2 mixer of the model: its prefill block over 37 tokens, and
    four decode steps from a zero state: outputs and both cache leaves."""
    jc, tc, jp, tp = hybrid
    jm = _mixer(jp, 1, 2)
    tmix = {k: v[1, 2] for k, v in tp["groups"]["mixer"].items()}
    x = np.random.default_rng(3).standard_normal((2, PROMPT, jc.d_model)).astype(np.float32)
    np.testing.assert_allclose(tssm.mamba2_block(tmix, torch.from_numpy(x), tc).numpy(),
                               _np(jssm.mamba2_block(jm, jnp.asarray(x), jc)), **TOL)
    jcache = jssm.init_mamba2_cache(jc, 2)
    tcache = {k: v[0] for k, v in tssm.init_mamba2_cache(tc, 2, num_layers=1,
                                                           device="cpu").items()}
    for t in range(4):
        xt = x[:, t:t + 1]
        jo, jcache = jssm.mamba2_decode_step(jm, jnp.asarray(xt), jcache, jc)
        to, tcache = tssm.mamba2_decode_step(tmix, torch.from_numpy(xt), tcache, tc)
        np.testing.assert_allclose(to.numpy(), _np(jo), **TOL)
        for leaf in ("conv", "h"):
            assert tcache[leaf].dtype == torch.float32
            np.testing.assert_allclose(tcache[leaf].numpy(), _np(jcache[leaf]), **TOL)


def test_hybrid_forward_matches_jax(hybrid):
    jc, tc, jp, tp = hybrid
    toks = _tokens(jc.vocab_size)
    with use_kernel_plan(PLAN):
        jl, _ = jforward(jp, {"tokens": jnp.asarray(toks)}, jc, sac="",
                         compute_dtype=jnp.float32)
    for impl in ("blockwise", "flash"):
        tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()}, tc, sac="",
                           compute_dtype=torch.float32, attn_impl=impl)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)


def _jax_step(jc):
    return jax.jit(lambda p, t, c, i: jdecode(p, t, c, i, jc, compute_dtype=jnp.float32))


def test_hybrid_decode_matches_jax(hybrid):
    """Ten lockstep decode steps from an empty cache: logits every step and
    every cache leaf at the end (groups conv/h, shared_kv k/v, rem conv/h)."""
    jc, tc, jp, tp = hybrid
    toks = _tokens(jc.vocab_size, length=10)
    jcache = jinit_cache(jc, 2, 16, jnp.float32)
    tcache = tm.init_cache(tc, 2, 16, device="cpu", dtype=torch.float32)
    step = _jax_step(jc)
    for t in range(10):
        jl, jcache = step(jp, jnp.asarray(toks[:, t:t + 1]), jcache, jnp.int32(t))
        tl, tcache = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]).long(), tcache, t,
                                    tc, compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    jleaves = jax.tree_util.tree_leaves_with_path(jcache)
    assert len(jleaves) == 6
    for path, leaf in jleaves:
        node = tcache
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node.numpy(), _np(leaf), err_msg=jax.tree_util.keystr(path),
                                   **TOL)


def test_forward_last_logits_equal_stepped_decode(hybrid):
    """The chunked SSD (the kernel's path) and the recurrent decode step
    compute the same function: the forward's last-position logits against
    stepping decode_step over the same 37 tokens, relative to max|logit|
    <= 1e-5 (the JAX package gives 2.0e-6 on this config)."""
    _, tc, _, tp = hybrid
    toks = torch.from_numpy(_tokens(tc.vocab_size)).long()
    fwd, _ = tm.forward(tp, {"tokens": toks}, tc, sac="", compute_dtype=torch.float32,
                        attn_impl="flash")
    cache = tm.init_cache(tc, 2, PROMPT, device="cpu", dtype=torch.float32)
    for t in range(PROMPT):
        step, cache = tm.decode_step(tp, toks[:, t:t + 1], cache, t, tc,
                                     compute_dtype=torch.float32)
    last = fwd[:, -1]
    rel = float((step[:, 0] - last).abs().max() / last.abs().max())
    assert rel <= 1e-5, rel


def test_prefill_and_serve_steps_match_jax(hybrid):
    """make_prefill_step's last logits, then greedy generation by
    make_serve_step (the prompt stepped through it, as recurrent archs
    prefill) and by the sampling serve step at temperature 0: logits within
    tolerance and greedy tokens identical to the JAX package's."""
    jc, tc, jp, tp = hybrid
    toks = _tokens(jc.vocab_size, length=20, seed=4)
    with use_kernel_plan(PLAN):
        jlast = jprefill_step(jc, compute_dtype=jnp.float32)(jp, {"tokens": jnp.asarray(toks)})
    tlast = make_prefill_step(tc, compute_dtype=torch.float32, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlast.numpy(), _np(jlast), **TOL)

    n_new = 6
    jstep = jax.jit(jserve_step(jc, compute_dtype=jnp.float32))
    tstep = make_serve_step(tc, compute_dtype=torch.float32, device="cpu")
    jcache = jinit_cache(jc, 2, 32, jnp.float32)
    tcache = tm.init_cache(tc, 2, 32, device="cpu", dtype=torch.float32)
    for t in range(toks.shape[1]):
        jl, jcache = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jcache, jnp.int32(t))
        tl, tcache = tstep(tp, torch.from_numpy(toks[:, t:t + 1]), tcache, t)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    jgen, tgen = [], []
    jtok = np.asarray(jnp.argmax(jl[:, 0, :jc.vocab_size], -1))[:, None]
    ttok = tl[:, 0, :tc.vocab_size].argmax(-1)[:, None]
    for i in range(n_new):
        jgen.append(jtok[:, 0].tolist())
        tgen.append(ttok[:, 0].tolist())
        pos = toks.shape[1] + i
        jl, jcache = jstep(jp, jnp.asarray(jtok, jnp.int32), jcache, jnp.int32(pos))
        tl, tcache = tstep(tp, ttok, tcache, pos)
        jtok = np.asarray(jnp.argmax(jl[:, 0, :jc.vocab_size], -1))[:, None]
        ttok = tl[:, 0, :tc.vocab_size].argmax(-1)[:, None]
    assert tgen == jgen

    # the engine's sampling decode at temperature 0 continues greedily
    pos = toks.shape[1] + n_new
    jnxt, _ = jax.jit(jdecode_fn(jc, compute_dtype=jnp.float32))(
        jp, jnp.asarray(jtok, jnp.int32), jcache, jnp.full((2,), pos, jnp.int32),
        jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.float32), jnp.zeros((2,), jnp.int32),
        jnp.ones((2,), jnp.float32))
    tnxt, _ = make_serve_step(tc, compute_dtype=torch.float32, sample=True, device="cpu")(
        tp, ttok, tcache, [pos] * 2, [0] * 2, [0.0] * 2, [0] * 2, [1.0] * 2)
    assert tnxt.tolist() == np.asarray(jnxt).tolist()

    # prefill into cache slots is for attention-KV archs only, in both packages
    with pytest.raises(NotImplementedError):
        jprefill_step(jc, into_cache=True)(jp, jnp.asarray(toks), jcache,
                                          jnp.zeros((2,), jnp.int32),
                                          jnp.full((2,), 20, jnp.int32))
    with pytest.raises(NotImplementedError):
        make_prefill_step(tc, into_cache=True, device="cpu")(
            tp, torch.from_numpy(toks), tcache, [0, 1], [20, 20])


def test_hybrid_init_layout_matches_jax(hybrid):
    """init_params and init_cache: the same tree, leaf shapes and cache
    dtypes as the JAX package (values differ: each package draws its own)."""
    jc, tc, jp, _ = hybrid
    tp = tm.init_params(tc, seed=0, device="cpu")
    jcache = jinit_cache(jc, 3, 24, jnp.bfloat16)
    tcache = tm.init_cache(tc, 3, 24, device="cpu", dtype=torch.bfloat16)
    for jtree, ttree in ((jp, tp), (jcache, tcache)):
        jl = jax.tree_util.tree_leaves_with_path(jtree)
        assert len(jl) == len(jax.tree_util.tree_leaves(ttree))
        for path, leaf in jl:
            node = ttree
            for k in path:
                node = node[k.key]
            assert tuple(node.shape) == leaf.shape, jax.tree_util.keystr(path)
            if ttree is tcache:
                assert str(node.dtype).split(".")[-1] == str(leaf.dtype), \
                    jax.tree_util.keystr(path)
    assert set(tp) == {"embed", "final_norm", "head", "groups", "rem", "shared"}


def test_ssd_is_forward_only():
    """The kernel op refuses an input that requires grad while autograd
    records (training takes the plain einsums: tests/test_torch_ssm_train.py)."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(np.random.default_rng(5), (1, 1, 16, 2, 8),
                                                     (1, 1, 16, 2), (1, 1, 16, 8), 2)]
    args[0].requires_grad_()
    with pytest.raises(NotImplementedError, match="forward only"):
        ops.ssd_intra_chunk(*args)
    with torch.no_grad():
        ops.ssd_intra_chunk(*args)


def test_hybrid_entry_points_need_a_device(hybrid, monkeypatch):
    """The serving lowerings run on cuda unless device='cpu' is asked for,
    and refuse params that live elsewhere."""
    _, tc, _, tp = hybrid
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_prefill_step, make_serve_step):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(tc)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="params live on cpu"):
        make_prefill_step(tc, device="cuda")(tp, {"tokens": torch.zeros(1, 4).long()})


def test_ssd_launcher_reads_xbc_column_slices_in_place():
    """The launcher's stride logic (CPU-reachable Python around the CUDA
    kernel): x, B and C cut from one (B, S, H*P + 2N) activation are
    addressed by its row stride without a copy; padded copies are
    contiguous; heads that are not contiguous, rows that are not 16-byte
    aligned and chunks that are not rows of one stride are refused."""
    from repro_torch.kernels.ssd import _row_stride
    B, C, L, H, P, N = 2, 3, 16, 4, 32, 16
    width = H * P + 2 * N
    xbc = torch.zeros(B, C * L, width, dtype=torch.bfloat16)
    x = xbc[..., :H * P].reshape(B, C, L, H, P)
    Bm = xbc[..., H * P:H * P + N].reshape(B, C, L, N)
    assert _row_stride(x, "x", (H, P)) == width
    assert _row_stride(Bm, "B", (N,)) == width
    assert _row_stride(torch.zeros(1, 1, 1, N, dtype=torch.bfloat16), "B", (N,)) == N
    with pytest.raises(ValueError, match="one stride"):
        _row_stride(torch.zeros(B, C, L, P, H, dtype=torch.bfloat16).transpose(3, 4), "x",
                    (H, P))
    with pytest.raises(ValueError, match="one stride"):
        _row_stride(torch.zeros(B, L, C, H, P, dtype=torch.bfloat16).transpose(1, 2), "x",
                    (H, P))
    with pytest.raises(ValueError, match="16-byte aligned"):
        _row_stride(xbc[..., 1:1 + N].reshape(B, C, L, N), "B", (N,))
