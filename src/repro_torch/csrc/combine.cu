// Weighted combine of the top-k expert rows (paper Stage 5), forward:
//   out[t, d] = sum_k w[t, k] * rows[t, k, d]     accumulated in float32.
//
// Replaces src/repro/kernels/combine.py::combine_fwd_pallas
// (_combine_fwd_kernel), reached through kernels/ops.py::combine.
//
// What bounds it on an H100: bytes. It reads T*K*D bf16 rows and writes
// T*D, with two flops per row element. One block owns one token: its
// threads walk the D axis in 16-byte vectors and reduce over the K rows
// in registers, so every row byte is read once and every output byte is
// written once (the paper's GPU kernel maps one thread per (t, d); this is
// that mapping, eight elements wide).
#include "common.cuh"

namespace {

using repro::bf16;

__global__ void __launch_bounds__(256)
combine_kernel(const bf16* __restrict__ rows, const bf16* __restrict__ w,
               bf16* __restrict__ out, int T, int K, int D) {
  const int t = blockIdx.x;
  const int nvec = D / 8;
  const bf16* rt = rows + (size_t)t * K * D;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < K; ++k) {
      const float wk = __bfloat162float(w[(size_t)t * K + k]);
      float r[8];
      repro::unpack8(repro::load_vec8(rt + (size_t)k * D + v * 8), r);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(wk, r[j], acc[j]);
    }
    repro::store_vec8(out + (size_t)t * D + v * 8, repro::pack8(acc));
  }
}

}  // namespace

// rows (T, K, D), w (T, K), out (T, D): bf16 on the device, contiguous,
// 16-byte aligned; D % 8 == 0.
REPRO_API int repro_combine(const void* rows, const void* w, void* out, int T, int K, int D,
                            void* stream) {
  if (D % 8 != 0 || K < 1) return (int)cudaErrorInvalidValue;
  if (T == 0 || D == 0) return (int)cudaSuccess;
  int threads = D / 8;
  if (threads > 256) threads = 256;
  threads = (threads + 31) / 32 * 32;
  combine_kernel<<<T, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(rows), static_cast<const bf16*>(w), static_cast<bf16*>(out), T,
      K, D);
  return (int)cudaGetLastError();
}
