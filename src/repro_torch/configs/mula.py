"""Paper Table 1: Mula model family (OLMo / OLMoE architecture).

Mula models use: RMSNorm... the OLMo/OLMoE family uses non-parametric
LayerNorm + SwiGLU + RoPE; we follow OLMoE (rmsnorm variant via QK-norm is
omitted) with SwiGLU MLPs/experts. head_size 128 throughout (paper Table 1).
"""
from .base import ModelConfig, MoEConfig

_CITE = "Vooturi et al., Scalable Pretraining of Large MoE LMs on Aurora, 2026 (Table 1)"


def _moe(num_experts: int, d_ff_expert: int) -> MoEConfig:
    return MoEConfig(
        num_experts=num_experts, experts_per_token=8, d_ff_expert=d_ff_expert,
        router_aux_coef=0.01, router_z_coef=0.001, moe_impl="fsmoe")


MULA_1B = ModelConfig(
    name="mula-1b", arch_type="dense",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=8192, vocab_size=50304, citation=_CITE)

MULA_7B_A1B = ModelConfig(
    name="mula-7b-a1b", arch_type="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=50304, moe=_moe(64, 1024), citation=_CITE)

MULA_20B_A2B = ModelConfig(
    name="mula-20b-a2b", arch_type="moe",
    num_layers=32, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=50304, moe=_moe(96, 1024), citation=_CITE)

MULA_100B_A7B = ModelConfig(
    name="mula-100b-a7b", arch_type="moe",
    num_layers=48, d_model=3072, num_heads=24, num_kv_heads=24, head_dim=128,
    d_ff=0, vocab_size=50304, moe=_moe(144, 1536), citation=_CITE)

MULA_220B_A10B = ModelConfig(
    name="mula-220b-a10b", arch_type="moe",
    num_layers=64, d_model=3072, num_heads=24, num_kv_heads=24, head_dim=128,
    d_ff=0, vocab_size=50304, moe=_moe(240, 1536), citation=_CITE)
