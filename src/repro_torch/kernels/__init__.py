"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), their
launchers, plain PyTorch versions and public wrappers.

  ref.py              plain PyTorch versions (CPU path, on-card oracle)
  gmm.py              grouped matmul launcher          (csrc/gmm.cu)
  swiglu.py           fused SwiGLU launcher            (csrc/swiglu.cu)
  combine.py          weighted combine launcher        (csrc/combine.cu)
  flash_attention.py  flash attention launcher         (csrc/flash_attention.cu)
  ssd.py              SSD intra-chunk launcher         (csrc/ssd.cu)
  token_counts.py     Stage-2 histogram launcher       (csrc/token_counts.cu)
  dispatch_plan.py    Stages 2-3 dispatch plan launcher (csrc/dispatch_plan.cu)
  ops.py              public wrappers + launch counts
  _build.py           nvcc build + ctypes loading
"""
