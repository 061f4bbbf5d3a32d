"""PyTorch port: ``ops.flash_attention`` is forward only, as the JAX
package's flash kernel is (it has no VJP). While autograd records and any
of q, k, v requires grad it raises, on the CPU as on the card, instead of
handing back an output that carries no gradient; under ``no_grad`` and on
tensors that do not require grad it computes as before. Training attention
goes through ``impl="blockwise"``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _qkv(seed=0, B=2, S=24, nh=4, nkv=2, hd=16):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, S, nh, hd, generator=g), torch.randn(B, S, nkv, hd, generator=g),
            torch.randn(B, S, nkv, hd, generator=g))


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_raises_under_grad_when_an_input_requires_grad(which):
    args = list(_qkv())
    args[which].requires_grad_()
    before = dict(ops.launches)
    with pytest.raises(NotImplementedError, match="blockwise"):
        ops.flash_attention(*args, causal=True)
    assert ops.launches == before


@pytest.mark.parametrize("window", [0, 8])
def test_flash_serves_unchanged_under_no_grad(window):
    q, k, v = (t.requires_grad_() for t in _qkv(seed=1))
    with torch.no_grad():
        out = ops.flash_attention(q, k, v, causal=True, window=window)
    assert out.grad_fn is None
    torch.testing.assert_close(out, ref.flash_attention_ref(q.detach(), k.detach(), v.detach(),
                                                            causal=True, window=window),
                               atol=0.0, rtol=0.0)
    # inputs that do not require grad need no no_grad
    plain = ops.flash_attention(q.detach(), k.detach(), v.detach(), causal=True, window=window)
    torch.testing.assert_close(plain, out, atol=0.0, rtol=0.0)


def test_forward_with_flash_refuses_to_train():
    """``forward(..., attn_impl="flash")`` on parameters that require grad
    raises before ``loss.backward()`` can run with the attention weights
    cut off; the blockwise path trains, and both give the same logits under
    no_grad."""
    cfg = dataclasses.replace(reduced(get_config("mula-1b"), d_model=64, vocab=128),
                              sliding_window=0)
    params = tm.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)

    def leaves(t):
        return [x for v in t.values() for x in leaves(v)] if isinstance(t, dict) else [t]

    for p in leaves(params):
        p.requires_grad_()
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks}
    with pytest.raises(NotImplementedError, match="forward only"):
        logits, _ = tm.forward(params, batch, cfg, sac="", compute_dtype=torch.float32,
                               attn_impl="flash")
        logits.float().square().mean().backward()
    logits, _ = tm.forward(params, batch, cfg, sac="", compute_dtype=torch.float32,
                           attn_impl="blockwise")
    logits.float().square().mean().backward()
    wq = [p for p in leaves(params) if p.grad is not None]
    assert wq and all(torch.isfinite(p.grad).all() for p in wq)
    with torch.no_grad():
        flash, _ = tm.forward(params, batch, cfg, sac="", compute_dtype=torch.float32,
                              attn_impl="flash")
    torch.testing.assert_close(flash, logits.detach(), atol=1e-4, rtol=1e-4)
