"""PyTorch port, on the card: each CUDA kernel of ``repro_torch`` against
its plain PyTorch version on the same bf16 inputs (the plain version in
float32), the launch counts, and the dtype checks. Imports no JAX, so it
runs on a machine without it:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py

Without a CUDA device every test skips (the kernels have no CPU mode; the
CPU tests hold the plain versions against the JAX package). Tolerances: max
|err| <= 1e-2 * max|plain| (bf16 output rounding, another summation order);
SwiGLU within one bf16 ulp of the plain value; the backward kernels within
2e-2 * max|plain| (their bf16 inputs are themselves rounded products)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")



def _close(out, plain, rel=1e-2):
    err = (out.float() - plain).abs().max().item()
    assert err <= rel * plain.abs().max().item(), err


def test_gmm_kernel_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    M, K, N = 160, 256, 136
    gs = torch.tensor([32, 0, 48, 16, 0], dtype=torch.int32, device=cuda)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    w = (torch.randn(5, K, N, generator=g, device=cuda) / 16).bfloat16()
    before = ops.launches["gmm"]
    out = ops.gmm(x, w, gs)
    torch.cuda.synchronize()
    assert ops.launches["gmm"] == before + 1
    _close(out, ref.gmm_ref(x.float(), w.float(), gs))
    assert (out[96:] == 0).all()


@pytest.mark.parametrize("sizes", [[32, 0, 48, 16, 0], [0, 0, 0, 96, 0], [16] * 5])
def test_gmm_transposed_and_tgmm_on_card(cuda, sizes):
    """dx = gmm(dy, w^T) without a transposed copy, and dW = tgmm(x, dy),
    with empty groups and rows past the total."""
    g = torch.Generator(device=cuda).manual_seed(4)
    M, K, N = 160, 264, 136
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    total = sum(sizes)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    dy = torch.randn(M, N, generator=g, device=cuda).bfloat16()
    w = (torch.randn(5, K, N, generator=g, device=cuda) / 16).bfloat16()
    before = dict(ops.launches)
    dx = ops.gmm_transposed(dy, w, gs)
    dw = ops.tgmm(x, dy, gs)
    torch.cuda.synchronize()
    assert ops.launches["gmm"] == before["gmm"] + 1
    assert ops.launches["tgmm"] == before["tgmm"] + 1
    _close(dx, ref.gmm_ref(dy.float(), w.float().transpose(1, 2), gs))
    assert (dx[total:] == 0).all()
    plain = ref.tgmm_ref(x.float(), dy.float(), gs, 5)
    _close(dw, plain)
    assert dw.dtype == torch.bfloat16 and tuple(dw.shape) == (5, K, N)
    empty = torch.tensor([s == 0 for s in sizes], device=cuda)
    assert (dw[empty] == 0).all()


@pytest.mark.parametrize("sizes,M,K,N", [
    ([13, 0, 51, 7, 0], 80, 264, 136),     # sizes not multiples of 16; ragged K and N
    ([400, 16], 432, 128, 256),             # a group of 7 stages of 64 rows (> one ring)
    ([100, 60], 160, 128, 256),             # the last stage borrows rows of the next group
    ([80, 48, 0], 128, 192, 264),           # ... at a multiple of 16 (48 rows of the next group)
    ([64, 0, 128, 48], 256, 2048, 1024),    # 256 tiles: the persistent walk wraps the SMs
    ([0, 0, 0], 48, 64, 64),                # no rows at all
])
def test_tgmm_groups_on_card(cuda, sizes, M, K, N):
    """dW = tgmm(x, dy) on the TMA + wgmma kernel: rows of the next group
    in a group's last stage must not be added, rows past the total (NaN
    here) are never read, empty groups are exact zeros."""
    g = torch.Generator(device=cuda).manual_seed(21)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    total = sum(sizes)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    dy = torch.randn(M, N, generator=g, device=cuda).bfloat16()
    x[total:] = float("nan")
    dy[total:] = float("nan")
    before = ops.launches["tgmm"]
    dw = ops.tgmm(x, dy, gs)
    torch.cuda.synchronize()
    assert ops.launches["tgmm"] == before + 1
    assert dw.dtype == torch.bfloat16 and tuple(dw.shape) == (len(sizes), K, N)
    assert torch.isfinite(dw.float()).all()
    plain = ref.tgmm_ref(x.float(), dy.float(), gs, len(sizes))
    if total:
        _close(dw, plain)
    empty = torch.tensor([n == 0 for n in sizes], device=cuda)
    assert (dw[empty] == 0).all()


def test_autograd_functions_on_card(cuda):
    """Gradients of gmm, fused_swiglu and combine through the kernels
    against autograd of the plain versions on the same bf16 inputs."""
    g = torch.Generator(device=cuda).manual_seed(5)
    M, K, N, T, k = 128, 64, 96, 16, 8
    gs = torch.tensor([32, 0, 64, 16], dtype=torch.int32, device=cuda)

    def rnd(*s):
        return torch.randn(s, generator=g, device=cuda).bfloat16()

    x, w, dy = rnd(M, K), rnd(4, K, N) / 8, rnd(M, N)
    gate, up, dh = rnd(M, N) * 3, rnd(M, N), rnd(M, N)
    rows, wts, dout = rnd(T, k, N), torch.rand(T, k, generator=g, device=cuda).bfloat16(), rnd(T, N)
    cases = [(ops.gmm, lambda a, b: ref.gmm_ref(a, b, gs), (x, w), dy),
             (ops.fused_swiglu, ref.swiglu_ref, (gate, up), dh),
             (ops.combine, ref.combine_ref, (rows, wts), dout)]
    for fn, plain, args, cot in cases:
        ka = [a.clone().requires_grad_() for a in args]
        pa = [a.float().requires_grad_() for a in args]
        if fn is ops.gmm:
            kg = torch.autograd.grad(fn(*ka, gs), ka, cot)
        else:
            kg = torch.autograd.grad(fn(*ka), ka, cot)
        pg = torch.autograd.grad(plain(*pa), pa, cot.float())
        for a, b in zip(kg, pg):
            assert a.dtype == torch.bfloat16
            _close(a, b, rel=2e-2)


def test_backward_kernels_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    rows = torch.randn(33, 8, 264, generator=g, device=cuda).bfloat16()
    w = torch.rand(33, 8, generator=g, device=cuda).bfloat16()
    dout = torch.randn(33, 264, generator=g, device=cuda).bfloat16()
    before = dict(ops.launches)
    drows, dw = ops.combine_bwd(rows, w, dout)
    pd, pw = ref.combine_bwd_ref(rows.float(), w.float(), dout.float())
    _close(drows, pd)
    _close(dw, pw)
    assert dw.dtype == torch.float32 and drows.dtype == torch.bfloat16
    a = (3 * torch.randn(257, 100, generator=g, device=cuda)).bfloat16()
    b = torch.randn(257, 100, generator=g, device=cuda).bfloat16()
    d = torch.randn(257, 100, generator=g, device=cuda).bfloat16()
    dg, du = ops.swiglu_bwd(a, b, d)
    pg, pu = ref.swiglu_bwd_ref(a.float(), b.float(), d.float())
    _close(dg, pg)
    _close(du, pu)
    torch.cuda.synchronize()
    assert ops.launches["combine_bwd"] == before["combine_bwd"] + 1
    assert ops.launches["swiglu_bwd"] == before["swiglu_bwd"] + 1


def test_backward_kernels_check_their_operands(cuda):
    from repro_torch.kernels.combine import combine_bwd_cuda
    from repro_torch.kernels.gmm import tgmm_cuda
    from repro_torch.kernels.swiglu import swiglu_bwd_cuda
    x = torch.zeros(32, 16, dtype=torch.bfloat16, device=cuda)
    gs = torch.tensor([16, 16], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        tgmm_cuda(x.float(), x, gs)
    with pytest.raises(ValueError, match="contiguous"):
        tgmm_cuda(x.t(), x[:16], gs)
    with pytest.raises(ValueError, match="contiguous"):
        swiglu_bwd_cuda(x, x, torch.zeros(16, 32, dtype=torch.bfloat16, device=cuda).t())
    rows = torch.zeros(4, 17, 16, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="K <="):
        combine_bwd_cuda(rows, torch.zeros(4, 17, dtype=torch.bfloat16, device=cuda), x[:4])


def test_swiglu_kernel_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    a = (3 * torch.randn(257, 100, generator=g, device=cuda)).bfloat16()
    b = torch.randn(257, 100, generator=g, device=cuda).bfloat16()
    out = ops.fused_swiglu(a, b).float()
    plain = ref.swiglu_ref(a.float(), b.float())
    _, expo = torch.frexp(plain)
    ulp = torch.ldexp(torch.ones_like(plain), expo - 8)     # bf16 ulp of each value
    assert ((out - plain).abs() <= ulp).all()


def test_combine_kernel_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    rows = torch.randn(33, 8, 264, generator=g, device=cuda).bfloat16()
    w = torch.rand(33, 8, generator=g, device=cuda).bfloat16()
    _close(ops.combine(rows, w), ref.combine_ref(rows.float(), w.float()))


@pytest.mark.parametrize("S,nh,nkv,hd,window", [(128, 4, 4, 128, 0), (100, 4, 2, 64, 0),
                                                (200, 4, 1, 128, 48), (300, 4, 4, 112, 0),
                                                (130, 4, 2, 112, 64)])
def test_flash_kernel_on_card(cuda, S, nh, nkv, hd, window):
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(2, S, nh, hd, generator=g, device=cuda).bfloat16()
    k = torch.randn(2, S, nkv, hd, generator=g, device=cuda).bfloat16()
    v = torch.randn(2, S, nkv, hd, generator=g, device=cuda).bfloat16()
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    _close(out, ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True,
                                        window=window))


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("sizes,M", [
    ([16, 0, 48, 80, 0, 144], 320),   # ragged against the 128-row tile, empty groups, tail
    ([0, 320, 0], 320),               # one group holds every row
    ([0, 0, 16, 0], 64),              # one 16-row group, most of M past the total
])
def test_gmm_row_tiles_on_card(cuda, sizes, M, trans):
    """The wgmma row tile against the 16-row group alignment: tiles cut
    from each group's start, rows of the next group loaded and discarded,
    ragged K (264) and N (136) through TMA's zero fill, and rows past the
    total exactly zero though the output's memory held NaN before."""
    g = torch.Generator(device=cuda).manual_seed(11)
    K, N = 264, 136
    G = len(sizes)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    total = sum(sizes)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    w = (torch.randn(G, K, N, generator=g, device=cuda) / 16).bfloat16()
    lhs = torch.randn(M, N, generator=g, device=cuda).bfloat16() if trans else x
    dirty = torch.full((M, K if trans else N), float("nan"), dtype=torch.bfloat16, device=cuda)
    del dirty                       # the caching allocator hands this block to the call
    out = ops.gmm_transposed(lhs, w, gs) if trans else ops.gmm(lhs, w, gs)
    torch.cuda.synchronize()
    plain = ref.gmm_ref(lhs.float(), w.float().transpose(1, 2) if trans else w.float(), gs)
    assert torch.isfinite(out[:total].float()).all()
    _close(out[:total], plain[:total])
    assert (out[total:] == 0).all()


@pytest.mark.parametrize("B,Sq,Skv,nh,nkv,hd,window", [
    (2, 100, 100, 4, 4, 64, 0),       # hd 64, B = 2 with a batch boundary inside a tile
    (1, 37, 37, 4, 1, 128, 0),        # Sq shorter than one tile, MQA
    (2, 37, 37, 4, 2, 112, 0),        # hd 112 (zero-filled columns 112-127), ragged
    (2, 500, 500, 8, 1, 112, 64),     # MQA with a window
    (2, 1000, 1000, 32, 8, 112, 0),   # 128-row query tiles (two consumer warpgroups), GQA
    (2, 1000, 1000, 32, 32, 128, 256),  # 128-row query tiles with a window
    (1, 300, 300, 16, 2, 64, 0),
])
def test_flash_tiles_on_card(cuda, B, Sq, Skv, nh, nkv, hd, window):
    g = torch.Generator(device=cuda).manual_seed(12)
    q = torch.randn(B, Sq, nh, hd, generator=g, device=cuda).bfloat16()
    k = torch.randn(B, Skv, nkv, hd, generator=g, device=cuda).bfloat16()
    v = torch.randn(B, Skv, nkv, hd, generator=g, device=cuda).bfloat16()
    before = ops.launches["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == before + 1
    _close(out, ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True,
                                        window=window))


def test_tma_kernels_in_a_fresh_thread_on_card(cuda):
    """gmm (both modes) and flash called from a thread that has made no CUDA
    call yet, as autograd's backward thread may be: the tensor-map encoder
    needs a current context, which the kernels make current themselves."""
    import threading
    g = torch.Generator(device=cuda).manual_seed(13)
    gs = torch.tensor([32, 0, 64, 16], dtype=torch.int32, device=cuda)
    x = torch.randn(128, 64, generator=g, device=cuda).bfloat16()
    w = (torch.randn(4, 64, 96, generator=g, device=cuda) / 8).bfloat16()
    dy = torch.randn(128, 96, generator=g, device=cuda).bfloat16()
    q = torch.randn(1, 100, 4, 64, generator=g, device=cuda).bfloat16()
    results = {}

    def run():
        try:
            results["out"] = (ops.gmm(x, w, gs), ops.gmm_transposed(dy, w, gs),
                              ops.flash_attention(q, q, q))
        except Exception as e:   # noqa: BLE001 -- reported by the main thread
            results["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert "error" not in results, results.get("error")
    torch.cuda.synchronize()
    out, dx, attn = results["out"]
    _close(out, ref.gmm_ref(x.float(), w.float(), gs))
    _close(dx, ref.gmm_ref(dy.float(), w.float().transpose(1, 2), gs))
    _close(attn, ref.flash_attention_ref(q.float(), q.float(), q.float()))


def test_tgmm_and_ssd_in_a_fresh_thread_on_card(cuda):
    """tgmm (which autograd's backward thread runs) and the SSD kernel
    called from a thread that has made no CUDA call yet: both encode tensor
    maps, which needs a current context."""
    import threading
    g = torch.Generator(device=cuda).manual_seed(22)
    gs = torch.tensor([32, 0, 64, 16], dtype=torch.int32, device=cuda)
    x = torch.randn(128, 64, generator=g, device=cuda).bfloat16()
    dy = torch.randn(128, 96, generator=g, device=cuda).bfloat16()
    sx, sdt, sb, sc, sa = _ssd_inputs(cuda, 1, 2, 64, 4, 64, 64, seed=23)
    results = {}

    def run():
        try:
            results["out"] = (ops.tgmm(x, dy, gs), ops.ssd_intra_chunk(sx, sdt, sb, sc, sa))
        except Exception as e:   # noqa: BLE001 -- reported by the main thread
            results["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert "error" not in results, results.get("error")
    torch.cuda.synchronize()
    dw, ssd = results["out"]
    _close(dw, ref.tgmm_ref(x.float(), dy.float(), gs, 4))
    for out, plain in zip(ssd, ref.ssd_intra_chunk_ref(sx.float(), sdt, sb.float(), sc.float(),
                                                       sa)):
        _close(out, plain)


def test_flash_refuses_grad_on_card(cuda):
    """On a CUDA tensor that requires grad the flash op raises instead of
    returning an output with no gradient; under no_grad it launches."""
    g = torch.Generator(device=cuda).manual_seed(24)
    q, k, v = (torch.randn(1, 64, 4, 64, generator=g, device=cuda).bfloat16() for _ in range(3))
    before = ops.launches["flash_attention"]
    with pytest.raises(NotImplementedError, match="blockwise"):
        ops.flash_attention(q.requires_grad_(), k, v)
    assert ops.launches["flash_attention"] == before
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == before + 1 and out.grad_fn is None
    _close(out, ref.flash_attention_ref(q.detach().float(), k.float(), v.float()))


def _ssd_inputs(cuda, B, C, L, H, P, N, seed, dt_scale=1.0, a_scale=1.0):
    """x, B and C as column slices of one (B, C*L, H*P + 2N) activation,
    as ``mamba2_block`` hands them over; dt > 0 and A < 0 in float32."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    xbc = torch.randn(B, C * L, H * P + 2 * N, generator=g, device=cuda).bfloat16()
    x = xbc[..., :H * P].reshape(B, C, L, H, P)
    Bm = xbc[..., H * P:H * P + N].reshape(B, C, L, N)
    Cm = xbc[..., H * P + N:].reshape(B, C, L, N)
    dt = torch.nn.functional.softplus(torch.randn(B, C, L, H, generator=g, device=cuda)) * dt_scale
    A = -torch.exp(torch.randn(H, generator=g, device=cuda)) * a_scale
    return x, dt, Bm, Cm, A


@pytest.mark.parametrize("B,C,L,H,P,N,dt_scale,a_scale", [
    (2, 2, 256, 4, 64, 64, 1.0, 1.0),      # Zamba2's chunk and head shape
    (1, 3, 40, 3, 32, 16, 1.0, 1.0),       # L not a multiple of 16 (padded in the block)
    (1, 2, 16, 16, 32, 16, 1.0, 1.0),      # the reduced hybrid model's shape
    (1, 1, 256, 4, 64, 64, 8.0, 8.0)])     # la falls by ~hundreds: exp overflows above i = j
def test_ssd_kernel_on_card(cuda, B, C, L, H, P, N, dt_scale, a_scale):
    """The kernel reads x, B and C in place from strided views; y, states
    and cdecay against the plain version in float32 from the same inputs."""
    x, dt, Bm, Cm, A = _ssd_inputs(cuda, B, C, L, H, P, N, seed=7, dt_scale=dt_scale,
                                   a_scale=a_scale)
    before = ops.launches["ssd_intra_chunk"]
    outs = ops.ssd_intra_chunk(x, dt, Bm, Cm, A)
    torch.cuda.synchronize()
    assert ops.launches["ssd_intra_chunk"] == before + 1
    plains = ref.ssd_intra_chunk_ref(x.float(), dt, Bm.float(), Cm.float(), A)
    for out, plain in zip(outs, plains):
        assert out.dtype == torch.float32 and out.shape == plain.shape
        assert torch.isfinite(out).all()
        _close(out, plain)


@pytest.mark.parametrize("B,C,L,H,P,N,dt_scale,a_scale", [
    (1, 2, 256, 6, 64, 64, 1.0, 1.0),      # H not a multiple of the head group
    (2, 1, 256, 5, 64, 64, 1.0, 1.0),      # ... one head in the last group
    (1, 3, 80, 4, 64, 64, 1.0, 1.0),       # L not a multiple of the 64-row tile
    (1, 2, 192, 3, 32, 32, 1.0, 1.0),      # three query tiles; P, N below the 64-column tile
    (1, 2, 256, 4, 64, 64, 40.0, 40.0),    # the decay underflows to 0 off the diagonal
])
def test_ssd_wgmma_tiles_on_card(cuda, B, C, L, H, P, N, dt_scale, a_scale):
    """The head-group tiling of the wgmma kernel, x, B and C read in place
    from column slices of one xBC activation; outputs finite and within
    1e-2 of max|plain| of the float32 plain version."""
    x, dt, Bm, Cm, A = _ssd_inputs(cuda, B, C, L, H, P, N, seed=25, dt_scale=dt_scale,
                                   a_scale=a_scale)
    assert x.stride(2) == H * P + 2 * N        # read in place, not copied
    before = ops.launches["ssd_intra_chunk"]
    outs = ops.ssd_intra_chunk(x, dt, Bm, Cm, A)
    torch.cuda.synchronize()
    assert ops.launches["ssd_intra_chunk"] == before + 1
    plains = ref.ssd_intra_chunk_ref(x.float(), dt, Bm.float(), Cm.float(), A)
    for out, plain in zip(outs, plains):
        assert out.dtype == torch.float32 and out.shape == plain.shape
        assert torch.isfinite(out).all()
        _close(out, plain)


def test_ssd_chunked_on_card_matches_cpu(cuda):
    """The whole chunked scan (kernel + inter-chunk recurrence) with a
    prompt that is not a multiple of the chunk and an initial state, on the
    card in bf16 against the CPU plain path in float32."""
    from repro_torch.models.ssm import _ssd_chunked
    B, S, H, P, N = 2, 1000, 4, 64, 64
    x, dt, Bm, Cm, A = _ssd_inputs(cuda, B, 1, S, H, P, N, seed=8)
    x, dt, Bm, Cm = x[:, 0], dt[:, 0], Bm[:, 0], Cm[:, 0]
    h0 = torch.randn(B, H, P, N, generator=torch.Generator(device=cuda).manual_seed(9),
                     device=cuda)
    before = ops.launches["ssd_intra_chunk"]
    y, h = _ssd_chunked(x, dt, Bm, Cm, A, 256, h0=h0)
    assert ops.launches["ssd_intra_chunk"] == before + 1
    cpu = [t.float().cpu() for t in (x, dt, Bm, Cm, A, h0)]
    yc, hc = _ssd_chunked(*cpu[:5], 256, h0=cpu[5])
    assert y.shape == (B, S, H, P)
    _close(y.cpu(), yc)
    _close(h.cpu(), hc)


def test_ssd_kernel_refuses_grad_and_bad_operands(cuda):
    from repro_torch.kernels.ssd import ssd_intra_chunk_cuda
    x, dt, Bm, Cm, A = _ssd_inputs(cuda, 1, 1, 32, 2, 32, 16, seed=1)
    with pytest.raises(NotImplementedError, match="forward only"):
        ops.ssd_intra_chunk(x, dt.requires_grad_(), Bm, Cm, A)
    dt = dt.detach()
    with pytest.raises(TypeError, match="bfloat16"):
        ssd_intra_chunk_cuda(x.float(), dt, Bm, Cm, A)
    heads_apart = torch.zeros(1, 1, 32, 32, 2, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="one stride"):
        ssd_intra_chunk_cuda(heads_apart.transpose(3, 4), dt, Bm, Cm, A)


def test_kernels_refuse_other_dtypes_on_card(cuda):
    x = torch.ones(16, 8, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.fused_swiglu(x, x)


def test_gmm_rejects_rows_not_a_multiple_of_the_tile(cuda):
    x = torch.zeros(24, 64, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(2, 64, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="M % 16"):
        ops.gmm(x, w, torch.tensor([16, 8], dtype=torch.int32, device=cuda))


def _small_moe_cfg():
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.serve.engine import dropless_cfg
    cfg = reduced(get_config("mula-7b-a1b"), d_model=256, max_experts=64)   # hd 64
    # forced uniform routing: bf16 noise cannot flip an expert choice
    return dropless_cfg(dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, forced_uniform_routing=True)))


def test_small_model_on_card_matches_cpu(cuda):
    """Prefill + decode through the kernels (bf16) against the CPU plain
    path (float32) from the same weights: logits within 3e-2 of max|ref|."""
    from repro_torch.models import decode_step, init_cache, init_params, prefill_with_cache
    cfg = _small_moe_cfg()
    pg = init_params(cfg, seed=0, device=cuda, dtype=torch.bfloat16)

    def cpu(t):
        return {k: cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.float().cpu()

    pc = cpu(pg)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(0))
    cg = init_cache(cfg, 2, 64, device=cuda, dtype=torch.bfloat16)
    cc = init_cache(cfg, 2, 64, device="cpu", dtype=torch.float32)
    lg, cg = prefill_with_cache(pg, toks.to(cuda), cg, [0, 1], [32, 20], cfg)
    lc, cc = prefill_with_cache(pc, toks, cc, [0, 1], [32, 20], cfg, compute_dtype=torch.float32)
    assert (lg.float().cpu() - lc).abs().max() <= 3e-2 * lc.abs().max()
    pos = torch.tensor([32, 20])
    tok = lc[:, :cfg.vocab_size].argmax(-1)[:, None]
    lg, cg = decode_step(pg, tok.to(cuda), cg, pos.to(cuda), cfg)
    lc, cc = decode_step(pc, tok, cc, pos, cfg, compute_dtype=torch.float32)
    assert (lg.float().cpu() - lc).abs().max() <= 3e-2 * lc.abs().max()


def test_engine_on_card_launch_counts(cuda):
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine
    cfg = _small_moe_cfg()
    eng = ServeEngine(init_params(cfg, seed=0, device=cuda, dtype=torch.bfloat16), cfg,
                      num_slots=2, max_len=64, cache_dtype=torch.bfloat16,
                      compute_dtype=torch.bfloat16, device=cuda)
    ops.reset_launches()
    for n in (5, 30, 17):
        eng.submit(list(range(1, n + 1)), 6)
    res = eng.run()
    assert all(len(r.tokens) == 6 for r in res.values())
    fwd = eng.prefills + eng.decode_steps
    assert ops.launches == {"gmm": 3 * cfg.num_layers * fwd, "swiglu": cfg.num_layers * fwd,
                            "combine": cfg.num_layers * fwd,
                            "dispatch_plan": cfg.num_layers * fwd, "token_counts": 0,
                            "flash_attention": cfg.num_layers * eng.prefills,
                            "tgmm": 0, "swiglu_bwd": 0, "combine_bwd": 0, "ssd_intra_chunk": 0}


def test_small_hybrid_on_card_matches_cpu(cuda):
    """Reduced Zamba2-7B (2 groups of 3 Mamba-2 layers and 1 more, chunk
    16): the prefill step over 37 tokens (not a multiple of the chunk) and
    the prompt stepped through the serve step, on the card (bf16, through
    the SSD and flash kernels) against the CPU plain path (float32) from
    the same weights: logits within 3e-2 of max|ref|, and exact launch
    counts (one SSD launch per Mamba-2 layer and one flash launch per
    shared block in the prefill, none in a decode step)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_cache, init_params
    from repro_torch.train import make_prefill_step, make_serve_step
    cfg = dataclasses.replace(reduced(get_config("zamba2-7b"), layers=7), shared_attn_every=3)
    pg = init_params(cfg, seed=0, device=cuda, dtype=torch.bfloat16)

    def cpu(t):
        return {k: cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.float().cpu()

    pc = cpu(pg)
    toks = torch.randint(0, cfg.vocab_size, (2, 37), generator=torch.Generator().manual_seed(0))
    ops.reset_launches()
    lg = make_prefill_step(cfg, device=cuda)(pg, {"tokens": toks})
    assert ops.launches["ssd_intra_chunk"] == 7 and ops.launches["flash_attention"] == 2
    lc = make_prefill_step(cfg, compute_dtype=torch.float32, device="cpu")(pc, {"tokens": toks})
    assert (lg.float().cpu() - lc).abs().max() <= 3e-2 * lc.abs().max()
    sg = make_serve_step(cfg, device=cuda)
    sc = make_serve_step(cfg, compute_dtype=torch.float32, device="cpu")
    cg = init_cache(cfg, 2, 40, device=cuda, dtype=torch.bfloat16)
    cc = init_cache(cfg, 2, 40, device="cpu", dtype=torch.float32)
    ops.reset_launches()
    for t in range(37):
        dg, cg = sg(pg, toks[:, t:t + 1], cg, t)
        dc, cc = sc(pc, toks[:, t:t + 1], cc, t)
    assert all(n == 0 for n in ops.launches.values())
    assert (dg.float().cpu() - dc).abs().max() <= 3e-2 * dc.abs().max()


@pytest.mark.parametrize("F,num_local,offset,ids", [
    (1, 1, 0, "random"), (7, 4, 2, "random"), (65536, 16, 16, "random"),
    (65536, 16, 48, "random"), (65536, 16, 16, "one"), (100_003, 240, 0, "random"),
    (1 << 20, 240, 0, "one"), (4099, 12288, 0, "random"), (4099, 16, 300, "random")])
def test_token_counts_kernel_on_card(cuda, F, num_local, offset, ids):
    """Exact equality with the plain version, int64 ids: every id one expert
    (all the atomics on one bin), the most bins the kernel takes, a range
    past every id, lengths that are no multiple of a block."""
    from repro_torch.kernels.token_counts import MAX_LOCAL
    assert MAX_LOCAL >= 240
    g = torch.Generator(device=cuda).manual_seed(F)
    t = (torch.full((F,), offset + num_local // 2, device=cuda) if ids == "one" else
         torch.randint(0, 256, (F,), generator=g, device=cuda))
    before = ops.launches["token_counts"]
    out = ops.token_counts(t, num_local, offset)
    torch.cuda.synchronize()
    assert ops.launches["token_counts"] == before + 1
    assert out.dtype == torch.int32
    assert torch.equal(out, ref.token_counts_ref(t, num_local, offset))


def test_token_counts_kernel_checks_its_operands(cuda):
    from repro_torch.kernels.token_counts import token_counts_cuda
    ids = torch.zeros(8, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int64"):
        token_counts_cuda(ids.float(), 4, 0)
    with pytest.raises(TypeError, match="int64"):
        token_counts_cuda(ids.int(), 4, 0)
    with pytest.raises(ValueError, match="num_local"):
        token_counts_cuda(ids, 0, 0)
    with pytest.raises(ValueError, match="1-D"):
        token_counts_cuda(ids.reshape(2, 4), 4, 0)


def _plan_ids(kind, F, E, K, gen, device):
    """F int64 expert ids in flat (token, k) order: top-K routing of
    ceil(F / K) tokens cut to F, uniform random ids, every id one expert, or
    forced uniform routing."""
    T = -(-F // K)
    if kind == "topk":
        return torch.rand((T, E), generator=gen, device=device).topk(K, dim=-1).indices.reshape(
            -1)[:F].contiguous()
    if kind == "random":
        return torch.randint(0, E, (F,), generator=gen, device=device)
    if kind == "one":
        return torch.full((F,), 21 % E, dtype=torch.int64, device=device)
    return torch.arange(F, device=device) % E


@pytest.mark.parametrize("F,E,EL,offset,kind,rows,shows", [
    (1, 64, 64, 0, "random", "capacity", ""),
    (64, 64, 64, 0, "topk", "capacity", ""),          # a decode step of 8 tokens
    (64, 64, 64, 0, "one", 32, "drops"),              # one expert over a small pool
    (8000, 64, 64, 0, "topk", "dropless", ""),        # a 1000-token prefill
    (8000, 64, 64, 0, "fur", "capacity", ""),         # FUR: every group full at once
    (2048, 1024, 1024, 0, "random", 1024, "drops"),   # one block, the most experts
    (2049, 64, 64, 0, "topk", "capacity", ""),        # the first plan of three launches
    (8191, 1024, 1024, 0, "random", 2048, "drops"),   # three launches, the most experts
    (32768, 64, 64, 0, "topk", "capacity", ""),       # a train microbatch
    (32768, 64, 64, 0, "one", "capacity", ""),        # every pair on one expert
    (65536, 64, 16, 16, "topk", "capacity", ""),      # EP's gathered ids, rank 1 of 4
    (65536, 64, 16, 48, "topk", "capacity", ""),      # ... rank 3 of 4
    (65536, 64, 16, 16, "fur", "capacity", ""),
    (100003, 1024, 1024, 0, "random", "capacity", ""),  # the most experts, F % 32 != 0
    (100003, 256, 240, 16, "random", 4096, "empty groups"),  # late experts get 0 rows
])
def test_dispatch_plan_kernel_on_card(cuda, F, E, EL, offset, kind, rows, shows):
    """Every output bit-equal to the plain version (run on the CPU), two
    runs bit-equal, one launch count per plan. ``shows``: what the case
    must exercise (drops; local experts with pairs but no rows)."""
    from repro_torch.core.moe import dropless_pool_rows, pool_size, round_up
    from repro_torch.kernels._build import library
    from repro_torch.kernels.dispatch_plan import MAX_LOCAL
    assert MAX_LOCAL == library().repro_dispatch_plan_max_local()
    K, align = 8, ops.gmm_align()
    T = -(-F // K)
    if rows == "capacity":
        rows = round_up(pool_size(T, K, E, EL, 1.25, align), EL * align)
    elif rows == "dropless":
        rows = dropless_pool_rows(T, K, EL, align)
    ids = _plan_ids(kind, F, E, K, torch.Generator(device=cuda).manual_seed(F), cuda)
    before = ops.launches["dispatch_plan"]
    out = ops.dispatch_plan(ids, EL, offset, rows, align)
    again = ops.dispatch_plan(ids, EL, offset, rows, align)
    torch.cuda.synchronize()
    assert ops.launches["dispatch_plan"] == before + 2
    plain = ref.dispatch_plan_ref(ids.cpu(), EL, offset, rows, align)
    names = ("slot", "valid", "counts", "group_sizes", "drops", "inv_pair", "pool_valid")
    for name, a, b, p in zip(names, out, again, plain):
        assert a.dtype == p.dtype and a.shape == p.shape, name
        assert torch.equal(a.cpu(), p), name
        assert torch.equal(a, b), name
    if shows:
        assert int(plain[4]) > 0
    if shows == "empty groups":
        assert int(plain[3][-1]) == 0 < int(plain[2][-1])


def test_dispatch_plan_on_card_never_runs_the_plain_chain(cuda, monkeypatch):
    """make_dispatch_plan on a CUDA tensor launches the kernel (the plain
    version is not reached) and raises where the kernel refuses."""
    from repro_torch.core.moe import make_dispatch_plan

    def refuse(*_):
        raise AssertionError("the plain chain ran on a CUDA tensor")

    monkeypatch.setattr(ref, "dispatch_plan_ref", refuse)
    ids = torch.randint(0, 64, (512, 8), device=cuda)
    before = ops.launches["dispatch_plan"]
    plan = make_dispatch_plan(ids, num_experts=64, pool_rows=6144, align=16)
    torch.cuda.synchronize()
    assert ops.launches["dispatch_plan"] == before + 1
    assert int(plan.valid.sum()) == 4096 and int(plan.pool_valid.sum()) == 4096
    with pytest.raises(ValueError, match="num_local"):
        make_dispatch_plan(torch.randint(0, 2048, (4, 8), device=cuda), num_experts=2048,
                           pool_rows=64, align=16)
    assert ops.launches["dispatch_plan"] == before + 1


def test_dispatch_plan_kernel_checks_its_operands(cuda):
    from repro_torch.kernels.dispatch_plan import dispatch_plan_cuda
    ids = torch.zeros(8, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int64"):
        dispatch_plan_cuda(ids.float(), 4, 0, 16, 8)
    with pytest.raises(TypeError, match="int64"):
        dispatch_plan_cuda(ids.int(), 4, 0, 16, 8)
    with pytest.raises(ValueError, match="num_local"):
        dispatch_plan_cuda(ids, 0, 0, 16, 8)
    with pytest.raises(ValueError, match="num_local"):
        dispatch_plan_cuda(ids, 1025, 0, 16, 8)
    with pytest.raises(ValueError, match="align"):
        dispatch_plan_cuda(ids, 4, 0, 16, 0)
    with pytest.raises(ValueError, match="1-D"):
        dispatch_plan_cuda(ids.reshape(2, 4), 4, 0, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        dispatch_plan_cuda(ids.cpu(), 4, 0, 16, 8)


def test_ep_block_on_card_matches_one_process(cuda):
    """Two EP ranks that share the card over gloo (parallel.spawn): the MoE
    block's output and the gradients of x, the router (summed over the
    ranks) and each rank's expert slice, bf16 through the kernels, against
    the same block in one process on the card; 3e-2 of max|ref| (each rank
    rounds its partial output to bf16 and the partials are summed in bf16).
    Forced uniform routing with 64 * 8 pairs per rank, a multiple of the 16
    experts: each rank routes its tokens as one process would."""
    import dataclasses

    import torch_ep_ranks as ranks
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.moe import init_moe_block, sparse_moe_block
    from repro_torch.parallel import spawn
    cfg = reduced(get_config("mula-7b-a1b"), d_model=256, max_experts=16)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, forced_uniform_routing=True, dispatch="dropless"))
    gen = torch.Generator().manual_seed(0)
    p = {k: v[0] for k, v in init_moe_block(cfg, num_layers=1, generator=gen, device="cpu",
                                             dtype=torch.bfloat16).items()}
    x, ct = (torch.randn((2, 64, 256), generator=gen).bfloat16() for _ in range(2))
    res = spawn(ranks.block_rank, 2, args=(cfg, p, x, ct), backend="gloo", device="cuda",
                timeout_s=300)
    pc = {k: v.to(cuda).requires_grad_() for k, v in p.items()}
    xc = x.to(cuda).requires_grad_()
    out, aux, z, _ = sparse_moe_block(pc, xc, cfg)
    loss = (out * ct.to(cuda)).sum() + ranks.AUX * aux + ranks.Z * z
    grads = dict(zip(("x", "router", "gate", "up", "down"),
                     torch.autograd.grad(loss, [xc] + [pc[k] for k in
                                                      ("router", "gate", "up", "down")])))
    _close(torch.cat([r["out"] for r in res]).to(cuda), out.float(), 3e-2)
    _close(torch.cat([r["grads"]["x"] for r in res]).to(cuda), grads["x"].float(), 3e-2)
    _close(sum(r["grads"]["router"] for r in res).to(cuda), grads["router"].float(), 3e-2)
    for k in ("gate", "up", "down"):
        _close(torch.cat([r["grads"][k] for r in res]).to(cuda), grads[k].float(), 3e-2)


def _sharded_update_runs(device):
    """``torch_ep_ranks.sharded_update_rank`` on a dp = 2 x ep = 2 grid of
    ranks over gloo on ``device``, reduced Mula-7B-A1B (16 experts), bf16
    compute, clipping off: 'none', 'so'/'off', 'epso'/'ring', 'epso'/'xla'."""
    import torch_ep_ranks as ranks
    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.parallel import spawn
    cfg = reduced(get_config("mula-7b-a1b"), d_model=256, vocab=512, max_experts=16)
    train = TrainConfig(seq_len=64, global_batch=4, grad_clip=0.0)
    toks = torch.randint(0, 512, (4, 65), generator=torch.Generator().manual_seed(0))
    runs = [("none", "off"), ("so", "off"), ("epso", "ring"), ("epso", "xla")]
    res = spawn(ranks.sharded_update_rank, 4,
                args=(cfg, train, runs, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}),
                backend="gloo", device=device, timeout_s=300, grid=(2, 2))
    return runs, res


def test_sharded_update_on_card_matches_none_bit_for_bit(cuda):
    """On the card (4 ranks sharing it over gloo), one SO/EPSO update of
    exactly summable gradients equals the 'none' update bit for bit when
    clipping is off (AdamW is elementwise; only the layout and the
    collectives differ), on every rank; after two more train steps 'ring'
    and 'xla' hold identical params (the gathers only move data)."""
    runs, res = _sharded_update_runs("cuda")
    for rank, r in enumerate(res):
        base = r[runs[0]]["update"]
        for run in runs[1:]:
            for path, t in r[run]["update"].items():
                assert torch.equal(t, base[path]), (run, rank, path)
        assert r[runs[2]]["impl"] == "ring" and r[runs[3]]["impl"] == "xla"
        for path, t in r[runs[2]]["steps"].items():
            assert torch.equal(t, r[runs[3]]["steps"][path]), (rank, path)


def test_train_state_checkpoint_in_place_on_card(cuda, tmp_path):
    """A CUDA TrainState after one bf16 step through the kernels: saved
    (each leaf moved to the host as it is written), then restored into a
    state of other values in place, bit for bit, every tensor kept and the
    float32 params still the master weights."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ParallelConfig, TrainConfig, get_config, reduced
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import keyed_leaves, leaves
    cfg = reduced(get_config("mula-7b-a1b"), d_model=256)
    train = TrainConfig(seq_len=64, global_batch=2, warmup_steps=1, total_steps=10)
    state = init_state(cfg, train, seed=0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1].to(cuda), "labels": toks[:, 1:].to(cuda)}
    state, _ = make_train_step(cfg, ParallelConfig(), train)(state, batch)
    ck = Checkpointer(str(tmp_path))
    ck.save(state, 1)
    other = init_state(cfg, train, seed=1, device=cuda)
    ptrs = [t.data_ptr() for _, t in keyed_leaves(other)]
    restored, step = ck.restore(other)
    assert step == 1 and restored is other
    assert [t.data_ptr() for _, t in keyed_leaves(restored)] == ptrs
    for (k, a), (_, b) in zip(keyed_leaves(restored), keyed_leaves(state)):
        assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b), k
    assert all(p.data_ptr() == m.data_ptr()
               for p, m in zip(leaves(restored.params), leaves(restored.opt.master)))


@pytest.mark.parametrize("arch", ["mula-7b-a1b", "mula-1b"])
def test_launcher_fault_injection_on_card(cuda, tmp_path, arch):
    """run(device="cuda") in bf16 with a hard failure at step 7 and a soft
    one at step 12: two relaunches, and a history bit-identical to the
    clean run's (the MoE model through the kernels)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run
    kw = dict(steps=18, batch=4, seq=64, d_model=256, ckpt_interval=5, log_every=100,
              device="cuda", compute_dtype="bfloat16")
    ops.reset_launches()
    clean = run(arch, out=str(tmp_path / "clean"), **kw)
    faulty = run(arch, out=str(tmp_path / "faulty"), inject_hard_at=7, inject_soft_at=12, **kw)
    assert faulty.relaunches == 2 and len(faulty.replaced) == 2
    assert list(faulty) == list(clean)
    assert (ops.launches["gmm"] > 0) == (arch == "mula-7b-a1b")
