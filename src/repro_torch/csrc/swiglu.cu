// Fused SwiGLU activation: out = silu(gate) * up, and its backward.
//
// Replaces src/repro/kernels/swiglu.py::swiglu_pallas (_swiglu_kernel),
// reached in the JAX package through kernels/ops.py::fused_swiglu. The
// backward replaces that wrapper's custom VJP (kernels/ops.py::_swiglu_bwd,
// plain JAX, not a Pallas kernel): in float32,
//   sig = sigmoid(g), silu = g * sig, dsilu = sig * (1 + g * (1 - sig)),
//   dgate = dout * up * dsilu, dup = dout * silu,
// each rounded to bf16. It reads three bf16 tensors and writes two (10
// bytes an element), so it is bound by bytes like the forward and has the
// same shape: one pass, 16-byte accesses, a grid-stride loop.
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


__device__ __forceinline__ void swiglu_grad(float g, float u, float d, float* dg, float* du) {
  const float sig = 1.0f / (1.0f + expf(-g));
  const float silu = g * sig;
  *dg = d * u * (sig * (1.0f + g * (1.0f - sig)));
  *du = d * silu;
}

__global__ void __launch_bounds__(256)
swiglu_bwd_kernel(const bf16* __restrict__ gate, const bf16* __restrict__ up,
                  const bf16* __restrict__ dout, bf16* __restrict__ dgate,
                  bf16* __restrict__ dup, long long n) {
  const long long n8 = n / 8;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n8; i += stride) {
    float g[8], u[8], d[8], dg[8], du[8];
    repro::unpack8(repro::load_vec8(gate + i * 8), g);
    repro::unpack8(repro::load_vec8(up + i * 8), u);
    repro::unpack8(repro::load_vec8(dout + i * 8), d);
#pragma unroll
    for (int j = 0; j < 8; ++j) swiglu_grad(g[j], u[j], d[j], &dg[j], &du[j]);
    repro::store_vec8(dgate + i * 8, repro::pack8(dg));
    repro::store_vec8(dup + i * 8, repro::pack8(du));
  }
  const long long t = n8 * 8 + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) {
    float dg, du;
    swiglu_grad(__bfloat162float(gate[t]), __bfloat162float(up[t]), __bfloat162float(dout[t]),
                &dg, &du);
    dgate[t] = __float2bfloat16_rn(dg);
    dup[t] = __float2bfloat16_rn(du);
  }
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

// gate, up, dout, dgate, dup: n bf16 elements each, on the device, 16-byte
// aligned.
REPRO_API int repro_swiglu_bwd(const void* gate, const void* up, const void* dout, void* dgate,
                               void* dup, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (n / 8 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  swiglu_bwd_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gate), static_cast<const bf16*>(up),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dgate), static_cast<bf16*>(dup), n);
  return (int)cudaGetLastError();
}
