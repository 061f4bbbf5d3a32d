"""dbrx-132b [moe]: 16 experts, top-4, fine-grained.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per-expert) vocab=100352.
[hf:databricks/dbrx-base]. SwiGLU experts, GQA, RoPE. EP degree 16 on the
production mesh (1 expert per model-axis device).
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b", arch_type="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=0, vocab_size=100352,
    moe=MoEConfig(num_experts=16, experts_per_token=4, d_ff_expert=10752,
                  moe_impl="fsmoe"),
    rope_theta=5e5,
    citation="hf:databricks/dbrx-base")
