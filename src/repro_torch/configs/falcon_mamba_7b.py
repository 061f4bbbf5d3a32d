"""falcon-mamba-7b [ssm]: attention-free Mamba-1 architecture.

64L d_model=4096 (attn-free) d_ff=0 vocab=65024, ssm_state=16.
[arXiv:2410.05355 — Falcon Mamba]. Pure Mamba-1 blocks (d_inner=2*d_model,
dt_rank=d_model/16, depthwise conv4). EP/FSMOE inapplicable (no experts);
long_500k decode runs with O(1) recurrent state.
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", arch_type="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=65024,
    ssm=SSMConfig(variant="mamba1", d_state=16, d_conv=4, expand=2),
    citation="arXiv:2410.05355")
