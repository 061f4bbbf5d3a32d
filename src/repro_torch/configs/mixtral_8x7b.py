"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 (per-expert) vocab=32000.
[arXiv:2401.04088 — Mixtral of Experts]. SWA window 4096 => long_500k decode
runs with a ring-buffer KV cache. E=8 < 16-way model axis, so experts are
sharded with expert-tensor-parallelism (d_ff split across the model axis) —
see DESIGN §6 Arch-applicability.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", arch_type="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=0, vocab_size=32000,
    moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff_expert=14336,
                  moe_impl="fsmoe"),
    sliding_window=4096,
    citation="arXiv:2401.04088")
