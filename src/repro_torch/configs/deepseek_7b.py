"""deepseek-7b [dense]: llama-architecture decoder.

30L d_model=4096 32H (kv=32, i.e. MHA) d_ff=11008 vocab=102400.
[arXiv:2401.02954 — DeepSeek LLM]. SwiGLU + RMSNorm + RoPE.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", arch_type="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=102400,
    citation="arXiv:2401.02954")
