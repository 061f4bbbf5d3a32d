"""Config registry for the PyTorch port: ``get_config(arch_id)`` /
``ARCH_REGISTRY``, a copy of the JAX package's registry (the port imports
nothing of that package, so it keeps its own copies of the config modules).
"""
from .base import ModelConfig, MoEConfig, ParallelConfig, SSMConfig, TrainConfig, reduced
from . import (zamba2_7b, starcoder2_3b, falcon_mamba_7b, deepseek_7b,
               seamless_m4t_medium, dbrx_132b, llama3_405b,
               phi_3_vision_4_2b, mixtral_8x7b, moonshot_v1_16b_a3b)
from . import mula

ARCH_REGISTRY = {
    # assigned pool
    "zamba2-7b": zamba2_7b.CONFIG,
    "starcoder2-3b": starcoder2_3b.CONFIG,
    "falcon-mamba-7b": falcon_mamba_7b.CONFIG,
    "deepseek-7b": deepseek_7b.CONFIG,
    "seamless-m4t-medium": seamless_m4t_medium.CONFIG,
    "dbrx-132b": dbrx_132b.CONFIG,
    "llama3-405b": llama3_405b.CONFIG,
    "phi-3-vision-4.2b": phi_3_vision_4_2b.CONFIG,
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.CONFIG,
    # paper Table 1
    "mula-1b": mula.MULA_1B,
    "mula-7b-a1b": mula.MULA_7B_A1B,
    "mula-20b-a2b": mula.MULA_20B_A2B,
    "mula-100b-a7b": mula.MULA_100B_A7B,
    "mula-220b-a10b": mula.MULA_220B_A10B,
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[arch_id]


__all__ = ["ModelConfig", "MoEConfig", "ParallelConfig", "SSMConfig", "TrainConfig", "reduced",
           "ARCH_REGISTRY", "get_config"]
