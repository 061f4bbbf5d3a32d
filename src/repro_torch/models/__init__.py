"""Model stack for the serving path (dense and moe)."""
from .model import (decode_step, init_cache, init_params, padded_vocab,
                    prefill_with_cache)

__all__ = ["decode_step", "init_cache", "init_params", "padded_vocab",
           "prefill_with_cache"]
