// Fused SwiGLU activation, forward: out = silu(gate) * up.
//
// Replaces src/repro/kernels/swiglu.py::swiglu_pallas (_swiglu_kernel),
// reached in the JAX package through kernels/ops.py::fused_swiglu.
//
// What bounds it on an H100: bytes. Each element reads two bf16 values and
// writes one (6 bytes) for a handful of flops, far below the card's
// ops:byte ridge. The design does the one thing that helps: a single pass
// with 16-byte loads and stores (8 elements per thread per step), the
// arithmetic in float32 as in the TPU kernel, and a grid-stride loop so a
// fixed number of blocks covers any size.
#include "common.cuh"

namespace {

using repro::bf16;

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.0f + expf(-g)) * u;
}

__global__ void __launch_bounds__(256)
swiglu_kernel(const bf16* __restrict__ gate, const bf16* __restrict__ up,
              bf16* __restrict__ out, long long n) {
  const long long n8 = n / 8;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n8; i += stride) {
    float g[8], u[8], o[8];
    repro::unpack8(repro::load_vec8(gate + i * 8), g);
    repro::unpack8(repro::load_vec8(up + i * 8), u);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = silu_mul(g[j], u[j]);
    repro::store_vec8(out + i * 8, repro::pack8(o));
  }
  // tail (n % 8 elements), one thread each
  const long long t = n8 * 8 + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n)
    out[t] = __float2bfloat16_rn(silu_mul(__bfloat162float(gate[t]), __bfloat162float(up[t])));
}

}  // namespace

// gate, up, out: n bf16 elements each, on the device, 16-byte aligned.
REPRO_API int repro_swiglu(const void* gate, const void* up, void* out, long long n,
                           void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (n / 8 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  swiglu_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gate), static_cast<const bf16*>(up), static_cast<bf16*>(out), n);
  return (int)cudaGetLastError();
}
