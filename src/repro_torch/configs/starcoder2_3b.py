"""starcoder2-3b [dense]: GQA (kv=2), RoPE, sliding-window 4096.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
[arXiv:2402.19173 — StarCoder2]. StarCoder2 uses GELU MLP + LayerNorm and
sliding-window attention (window 4096), which lets it run long_500k decode.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", arch_type="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2, head_dim=128,
    d_ff=12288, vocab_size=49152,
    sliding_window=4096, mlp_activation="gelu", norm="layernorm",
    rope_theta=1e5,
    citation="arXiv:2402.19173")
