"""PyTorch port, the data pipeline (paper §4): ``repro_torch.data`` is a
numpy copy of the JAX package's ``repro.data``. The same corpus, context
and seed give byte-identical shard files and ``meta.json``; the two
loaders serve equal batches, across an epoch wrap and split over DP ranks;
and the JAX package's own data cases hold on the port."""
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import data as jdata  # noqa: E402
from repro_torch.data import ByteTokenizer, ShardedDataLoader, preprocess_corpus  # noqa: E402


@pytest.fixture
def corpus():
    rng = np.random.default_rng(0)
    return [[f"document {i}-{j} " + "x" * int(rng.integers(10, 90))
             for j in range(20)] for i in range(3)]


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("context,shard_instances,seed", [(32, 1024, 7), (16, 7, 0)])
def test_preprocess_byte_identical_to_jax(tmp_path, corpus, context, shard_instances, seed):
    kw = dict(context=context, shard_instances=shard_instances, seed=seed)
    mj = jdata.preprocess_corpus(corpus, str(tmp_path / "jax"), **kw)
    mt = preprocess_corpus(corpus, str(tmp_path / "port"), **kw)
    assert mt == mj
    fj, ft = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(ft) == sorted(fj) and len(ft) == len(mj["shards"]) + 1
    assert ft == fj                                   # every byte, meta.json too


def test_tokenizer_matches_jax():
    s = "hello Aurora 🙂"
    tok, jtok = ByteTokenizer(), jdata.ByteTokenizer()
    assert tok.decode(tok.encode(s)) == s
    assert np.array_equal(tok.encode(s), jtok.encode(s))
    assert (tok.EOS, tok.PAD, tok.vocab_size) == (jtok.EOS, jtok.PAD, jtok.vocab_size) == (
        256, 257, 258)


@pytest.mark.parametrize("dp_size", [1, 2])
def test_loader_batches_match_jax_across_epoch_wrap(tmp_path, corpus, dp_size):
    preprocess_corpus(corpus, str(tmp_path / "d"), context=16, seed=0, shard_instances=5)
    for rank in range(dp_size):
        kw = dict(global_batch=4, dp_rank=rank, dp_size=dp_size)
        tl = ShardedDataLoader(str(tmp_path / "d"), **kw)
        jl = jdata.ShardedDataLoader(str(tmp_path / "d"), **kw)
        n = tl.steps_per_epoch
        assert n == jl.steps_per_epoch and n > 1
        ti, ji = iter(tl), iter(jl)
        for step in range(2 * n + 2):                 # two epoch wraps
            tb, jb = next(ti), next(ji)
            assert tb.keys() == jb.keys()
            for k in tb:
                assert tb[k].dtype == jb[k].dtype == np.int32
                assert np.array_equal(tb[k], jb[k]), (rank, step, k)
        assert np.array_equal(tl.batch(n)["tokens"], tl.batch(0)["tokens"])
        assert tl.state_dict() == jl.state_dict() == {"step": 2 * n + 2}


def test_preprocess_deterministic(tmp_path, corpus):
    m1 = preprocess_corpus(corpus, str(tmp_path / "a"), context=32, seed=7)
    m2 = preprocess_corpus(corpus, str(tmp_path / "b"), context=32, seed=7)
    a = np.load(tmp_path / "a" / m1["shards"][0])
    b = np.load(tmp_path / "b" / m2["shards"][0])
    assert np.array_equal(a, b)
    m3 = preprocess_corpus(corpus, str(tmp_path / "c"), context=32, seed=8)
    c = np.load(tmp_path / "c" / m3["shards"][0])
    assert not np.array_equal(a, c)          # different shuffle


def test_instances_cover_corpus_once(tmp_path, corpus):
    """The shuffle is a permutation: every instance appears exactly once."""
    meta = preprocess_corpus(corpus, str(tmp_path / "d"), context=16, seed=0,
                             shard_instances=7)
    loaded = np.concatenate([np.load(tmp_path / "d" / s) for s in meta["shards"]])
    assert loaded.shape == (meta["num_instances"], 17)
    from repro_torch.data.preprocess import tokenize_files
    rows = []
    for t in tokenize_files(corpus):
        n = len(t) // 17
        rows.append(t[:n * 17].reshape(n, 17))
    ref = np.concatenate(rows)
    assert sorted(map(tuple, loaded.tolist())) == sorted(map(tuple, ref.tolist()))


def test_loader_contiguous_dp_reads(tmp_path, corpus):
    """DP ranks read disjoint contiguous slices covering each step's batch."""
    preprocess_corpus(corpus, str(tmp_path / "e"), context=16, seed=0, shard_instances=5)
    full = ShardedDataLoader(str(tmp_path / "e"), global_batch=8)
    parts = [ShardedDataLoader(str(tmp_path / "e"), global_batch=8, dp_rank=r, dp_size=4)
             for r in range(4)]
    for step in (0, 1, full.steps_per_epoch - 1):
        whole = full.batch(step)["tokens"]
        stitched = np.concatenate([p.batch(step)["tokens"] for p in parts])
        assert np.array_equal(whole, stitched)
    with pytest.raises(ValueError, match="DP ranks"):
        ShardedDataLoader(str(tmp_path / "e"), global_batch=8, dp_size=3)


def test_loader_mmap_mode(tmp_path, corpus):
    preprocess_corpus(corpus, str(tmp_path / "f"), context=16, seed=0)
    dl = ShardedDataLoader(str(tmp_path / "f"), global_batch=4)
    assert isinstance(dl._mmaps[0], np.memmap)   # lazy mmap loading
    b = dl.batch(0)
    assert b["tokens"].shape == (4, 16)
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_loader_resume_replays_exact_batch_sequence(tmp_path, corpus):
    """A loader restarted through start_step / load_state_dict serves the
    batches an uninterrupted iterator would, never batch 0 again."""
    preprocess_corpus(corpus, str(tmp_path / "g"), context=16, seed=0)
    straight = ShardedDataLoader(str(tmp_path / "g"), global_batch=4)
    it = iter(straight)
    ref = [next(it) for _ in range(6)]
    assert straight.state_dict() == {"step": 6}

    resumed = ShardedDataLoader(str(tmp_path / "g"), global_batch=4)
    it2 = iter(resumed)
    for _ in range(3):
        next(it2)                                 # "crash" after step 2
    resumed2 = ShardedDataLoader(str(tmp_path / "g"), global_batch=4)
    resumed2.load_state_dict(resumed.state_dict())
    it3 = iter(resumed2)
    for k in range(3, 6):
        assert np.array_equal(next(it3)["tokens"], ref[k]["tokens"]), k

    fresh = ShardedDataLoader(str(tmp_path / "g"), global_batch=4, start_step=4)
    assert np.array_equal(next(iter(fresh))["tokens"], ref[4]["tokens"])
