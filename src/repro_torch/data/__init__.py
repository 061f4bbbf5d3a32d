"""The data pipeline (paper §4): byte tokenizer, offline tokenize -> shuffle
-> shard into mmap files, and the sharded loader. A numpy copy of the JAX
package's ``data`` package (the port imports nothing of it): the same
corpus, context and seed give byte-identical shard files and ``meta.json``.
The loader serves numpy batches; the launcher moves them to the device."""
from .tokenizer import ByteTokenizer
from .preprocess import preprocess_corpus
from .loader import ShardedDataLoader

__all__ = ["ByteTokenizer", "preprocess_corpus", "ShardedDataLoader"]
