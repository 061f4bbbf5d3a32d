"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64.
[arXiv:2411.15242 — Zamba2 technical report]

Structure (adapted): 81 Mamba2 layers; a single *shared-weight*
attention+MLP block is applied every 6 layers (Zamba2 interleaves shared
transformer blocks among Mamba2 blocks; we model the shared-weight pattern
with period 6 ≈ 13 applications over 81 layers).
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", arch_type="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000,
    ssm=SSMConfig(variant="mamba2", d_state=64, d_conv=4, expand=2,
                  headdim=64, chunk=256),
    shared_attn_every=6,
    citation="arXiv:2411.15242")
