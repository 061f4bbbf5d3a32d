"""Model stack (dense, moe and hybrid): training forward and loss, serving."""
from .model import (decode_step, forward, init_cache, init_params, loss_fn, masked_ce,
                    padded_vocab, prefill_with_cache)

__all__ = ["decode_step", "forward", "init_cache", "init_params", "loss_fn", "masked_ce",
           "padded_vocab", "prefill_with_cache"]
