"""phi-3-vision-4.2b [vlm]: phi3-mini decoder + CLIP vision tower (stubbed).

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.
[hf:microsoft/Phi-3-vision-128k-instruct]. The CLIP ViT + projector is a
STUB per spec: input_specs() supplies precomputed patch embeddings
(B, patches, d_model) spliced before the text tokens. The language decoder
(SwiGLU, RMSNorm, RoPE) is implemented fully. long_500k skipped (full attn).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", arch_type="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
    num_prefix_embeds=576,   # 24x24 patch grid from the stub vision tower
    citation="hf:microsoft/Phi-3-vision-128k-instruct")
