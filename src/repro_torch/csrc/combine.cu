// Weighted combine of the top-k expert rows (paper Stage 5), forward and
// backward:
//   out[t, d] = sum_k w[t, k] * rows[t, k, d]     accumulated in float32;
//   drows[t, k, d] = w[t, k] * dout[t, d],
//   dw[t, k] = sum_d rows[t, k, d] * dout[t, d]   (float32), in one pass.
//
// Replaces src/repro/kernels/combine.py::combine_fwd_pallas
// (_combine_fwd_kernel) and combine_bwd_pallas (_combine_bwd_kernel), reached
// through kernels/ops.py::combine and its custom VJP.
//
// What bounds it on an H100: bytes. It reads T*K*D bf16 rows and writes
// T*D, with two flops per row element. One block owns one token: its
// threads walk the D axis in 16-byte vectors and reduce over the K rows
// in registers, so every row byte is read once and every output byte is
// written once (the paper's GPU kernel maps one thread per (t, d); this is
// that mapping, eight elements wide).
//
// The backward is bound by bytes too: it reads rows and dout and writes
// drows (2 * T*K*D + T*D bf16) for four flops per row element. It keeps the
// paper's fusion: one block per token reads each row vector and dout vector
// once, writes its drows vector and adds rows * dout into one float32
// partial per (thread, k); the K partials are reduced across the block
// (warp shuffles, then one shared-memory pass) into dw[t, :]. The TPU
// kernel accumulates dw across its sequential d-tiles; here the block owns
// the whole D axis, so nothing crosses blocks.
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


constexpr int BWD_THREADS = 256;
constexpr int MAX_K = 16;   // top-k bound of the backward's per-thread partials

__global__ void __launch_bounds__(BWD_THREADS)
combine_bwd_kernel(const bf16* __restrict__ rows, const bf16* __restrict__ w,
                   const bf16* __restrict__ dout, bf16* __restrict__ drows,
                   float* __restrict__ dw, int T, int K, int D) {
  __shared__ float red[BWD_THREADS / 32][MAX_K];
  const int t = blockIdx.x;
  const int nvec = D / 8;
  const bf16* rt = rows + (size_t)t * K * D;
  bf16* drt = drows + (size_t)t * K * D;
  float part[MAX_K];
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) part[k] = 0.f;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    float d[8];
    repro::unpack8(repro::load_vec8(dout + (size_t)t * D + v * 8), d);
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      if (k >= K) break;
      const float wk = __bfloat162float(w[(size_t)t * K + k]);
      float r[8], o[8];
      repro::unpack8(repro::load_vec8(rt + (size_t)k * D + v * 8), r);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j] = wk * d[j];
        part[k] = fmaf(r[j], d[j], part[k]);
      }
      repro::store_vec8(drt + (size_t)k * D + v * 8, repro::pack8(o));
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) {
    if (k >= K) break;
    float s = part[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(repro::kFullMask, s, o);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i][threadIdx.x];
    dw[(size_t)t * K + threadIdx.x] = s;
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

REPRO_API int repro_combine_max_k() { return MAX_K; }

// rows (T, K, D), w (T, K), dout (T, D), drows (T, K, D): bf16; dw (T, K):
// float32; all on the device, contiguous, 16-byte aligned; D % 8 == 0,
// 1 <= K <= MAX_K.
REPRO_API int repro_combine_bwd(const void* rows, const void* w, const void* dout, void* drows,
                                void* dw, int T, int K, int D, void* stream) {
  if (D % 8 != 0 || K < 1 || K > MAX_K) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  int threads = D / 8;
  if (threads > BWD_THREADS) threads = BWD_THREADS;
  threads = threads < 32 ? 32 : (threads + 31) / 32 * 32;
  combine_bwd_kernel<<<T, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(rows), static_cast<const bf16*>(w),
      static_cast<const bf16*>(dout), static_cast<bf16*>(drows), static_cast<float*>(dw), T,
      K, D);
  return (int)cudaGetLastError();
}
