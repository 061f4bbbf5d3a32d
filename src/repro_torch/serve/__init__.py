"""Continuous-batching serving engine of the port.

    SamplingParams / sample_tokens   per-request sampling   (sampling.py)
    SlotKVPool                       slot-indexed cache     (kv_pool.py)
    Request / FIFOScheduler          admission control      (scheduler.py)
    ServeEngine / GenResult          the engine             (engine.py)
"""
from .sampling import SamplingParams, sample_tokens
from .kv_pool import SlotKVPool
from .scheduler import Request, FIFOScheduler
from .engine import ServeEngine, GenResult, make_decode_fn, make_prefill_fn
