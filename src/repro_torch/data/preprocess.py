"""Offline data preprocessing (paper §4 "Data preprocessing"):

  1. **Tokenization** — each data file D_i becomes a token array T_i by
     tokenizing its documents and joining them with EOS.
  2. **Shuffling** — a permutation P over the N = Σ N_i training instances
     (N_i = len(T_i) // C for context size C), seeded and reproducible.
  3. **Sharding** — instances are gathered in permutation order and written
     to shard files loaded later in mmap mode; every DP rank then reads a
     *contiguous* region of one file (minimal token-consumption overhead).

Output layout:  out_dir/shard_{k:05d}.npy  (int32, [n_k, C])
                out_dir/meta.json          {context, num_instances, shards,...}

A copy of the JAX package's ``data/preprocess.py``: for the same corpus,
context and seed it writes byte-identical shard files and ``meta.json``.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from .tokenizer import ByteTokenizer


def tokenize_files(doc_files: Sequence[Sequence[str]], tokenizer=None):
    """Step 1: doc_files = list of 'data files', each a list of documents.
    Returns one token array per data file (documents joined by EOS)."""
    tok = tokenizer or ByteTokenizer()
    arrays = []
    for docs in doc_files:
        parts = []
        for doc in docs:
            parts.append(tok.encode(doc))
            parts.append(np.array([tok.EOS], np.int32))
        arrays.append(np.concatenate(parts) if parts
                      else np.zeros((0,), np.int32))
    return arrays


def preprocess_corpus(doc_files: Sequence[Sequence[str]], out_dir: str, *,
                      context: int = 256, shard_instances: int = 1024,
                      seed: int = 0, tokenizer=None) -> dict:
    """Full pipeline: tokenize -> shuffle -> shard. Returns the meta dict."""
    os.makedirs(out_dir, exist_ok=True)
    token_arrays = tokenize_files(doc_files, tokenizer)

    # instances per file: N_i = len(T_i) // (context+1) (inputs + next-token)
    step = context + 1
    instances = []
    for t in token_arrays:
        n = len(t) // step
        if n:
            instances.append(t[:n * step].reshape(n, step))
    if not instances:
        raise ValueError("corpus too small for one training instance")
    all_inst = np.concatenate(instances, axis=0)
    N = all_inst.shape[0]

    # step 2: permutation over all instances
    perm = np.random.default_rng(seed).permutation(N)
    all_inst = all_inst[perm]

    # step 3: shard files
    shards = []
    for k, start in enumerate(range(0, N, shard_instances)):
        path = os.path.join(out_dir, f"shard_{k:05d}.npy")
        np.save(path, all_inst[start:start + shard_instances])
        shards.append(os.path.basename(path))

    meta = {"context": context, "num_instances": int(N), "shards": shards,
            "seed": seed, "shard_instances": shard_instances,
            "vocab_size": (tokenizer or ByteTokenizer()).vocab_size}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return meta
