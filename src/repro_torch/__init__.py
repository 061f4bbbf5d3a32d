"""PyTorch/CUDA port of the JAX package ``repro`` for one NVIDIA H100.

The JAX package is the reference; this package mirrors its layout module
for module (``configs``, ``kernels``, ``core``, ``models``, ``serve``) and
imports nothing of it. Its first slice is the serving path:
``serve.ServeEngine`` -> ``models.prefill_with_cache`` / ``decode_step`` ->
``core.moe.sparse_moe_block`` -> the hand-written CUDA kernels in ``csrc/``
(grouped matmul, fused SwiGLU, weighted combine, flash attention).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a CPU tensor every kernel wrapper runs its plain PyTorch version.
"""
