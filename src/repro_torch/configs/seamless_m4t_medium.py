"""seamless-m4t-medium [audio]: encoder-decoder multimodal backbone.

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
[arXiv:2308.11596 — SeamlessM4T]. We implement the transformer backbone
(12 encoder + 12 decoder layers, cross-attention, GELU, LayerNorm). The
speech frontend (mel-spectrogram + conformer feature extractor) is a STUB
per spec: input_specs() supplies precomputed frame embeddings (B, frames,
d_model) to the encoder.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", arch_type="audio",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
    is_encoder_decoder=True, num_encoder_layers=12,
    num_prefix_embeds=1,  # encoder consumes stub frame embeddings
    mlp_activation="gelu", norm="layernorm",
    citation="arXiv:2308.11596")
