"""llama3-405b [dense]: 126L GQA, 128k vocab.

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
[arXiv:2407.21783 — The Llama 3 Herd of Models]. SwiGLU + RMSNorm + RoPE
(theta 5e5). 405B params require FSDP-style two-axis parameter sharding
(see DESIGN §6/§7); long_500k skipped (full attention).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", arch_type="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8, head_dim=128,
    d_ff=53248, vocab_size=128256,
    rope_theta=5e5,
    citation="arXiv:2407.21783")
