"""moonshot-v1-16b-a3b: fine-grained MoE (Moonlight-16B-A3B family).

48L d_model=2048 16H (kv=16) d_ff=1408 (per-expert) vocab=163840,
MoE 64 experts top-6. [hf:moonshotai/Moonlight-16B-A3B]. DeepSeek-V3-style
fine-grained experts with 2 shared experts; SwiGLU, RMSNorm, RoPE.
This is exactly the many-small-experts regime FastSparseMoE targets.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", arch_type="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=163840,
    moe=MoEConfig(num_experts=64, experts_per_token=6, d_ff_expert=1408,
                  num_shared_experts=2, moe_impl="fsmoe"),
    citation="hf:moonshotai/Moonlight-16B-A3B")
