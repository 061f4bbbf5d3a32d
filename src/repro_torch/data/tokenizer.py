"""Byte-level tokenizer (offline container — no external tokenizer deps).

Vocabulary: 256 byte values + special tokens. The data pipeline (paper §4)
is tokenizer-agnostic; swapping in a BPE tokenizer changes only this file.
A copy of the JAX package's ``data/tokenizer.py``.
"""
from __future__ import annotations

import numpy as np


class ByteTokenizer:
    EOS = 256
    PAD = 257
    VOCAB = 258

    @property
    def vocab_size(self) -> int:
        return self.VOCAB

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(
            np.int32)

    def decode(self, ids) -> str:
        ids = np.asarray(ids)
        ids = ids[(ids >= 0) & (ids < 256)]
        return bytes(ids.astype(np.uint8)).decode("utf-8", errors="replace")
