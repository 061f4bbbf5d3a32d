// Transposed grouped matrix multiply: the MoE expert FFN's weight gradient
// (paper Stage 4, backward).
//
// Replaces src/repro/kernels/gmm.py::tgmm_pallas (_tgmm_kernel), reached in
// the JAX package through kernels/ops.py::gmm's custom VJP (dW = tgmm(x, dy)).
//
//   out[g] = lhs[rows of g]^T @ rhs[rows of g]    lhs (M, K), rhs (M, N) bf16
//                                                 -> out (G, K, N) bf16
//
// Rows are grouped by expert as for gmm (group g owns rows
// [sum(gs[:g]), sum(gs[:g+1]))); the sum is taken in float32 and rounded to
// bf16 once. A group with no rows writes zeros; rows past sum(group_sizes)
// are never read (the JAX wrapper zeroes them before the kernel).
//
// The TPU kernel walks its grid in order and lets a group's consecutive
// m-tiles accumulate into one output block. CUDA blocks run in any order,
// so here each block owns one (g, k-tile, n-tile) of the output and loops
// over its group's rows itself, BR rows per step: deterministic, no
// atomics, no second pass. The block finds its group's row range with a
// warp prefix sum over group_sizes, as gmm.cu does.
//
// What bounds it on an H100: operations. For Mula-7B-A1B's gate projection
// at a 4096-token microbatch it does 2 * 32768 * 2048 * 1024 = 137 GFLOP
// (the routed rows; the pool's padding rows are not read) against ~0.5 GB
// of bytes, above the card's ops:byte ridge. The design is the simple one:
// tensor cores through WMMA (bf16 x bf16 -> f32), lhs staged in shared
// memory and read as a col_major A fragment (the transpose costs nothing),
// a 64 x 128 output tile per block of 8 warps; no cp.async/TMA pipeline and
// no wgmma yet.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using repro::bf16;

constexpr int TK = 64;     // output rows (K) per block
constexpr int TN = 128;    // output columns (N) per block
constexpr int BR = 32;     // group rows reduced per shared-memory stage
constexpr int WARPS = 8;   // 2 (K) x 4 (N) warps, 32 x 32 outputs each
constexpr int THREADS = WARPS * 32;
constexpr int LDA = TK + 8;    // padded leading dims (multiples of 8 elements)
constexpr int LDB = TN + 8;

__global__ void __launch_bounds__(THREADS)
tgmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
            const int* __restrict__ group_sizes, bf16* __restrict__ out, int K, int N,
            int G) {
  __shared__ __align__(128) bf16 sA[BR * LDA];      // BR rows of lhs: A^T, row-major
  __shared__ __align__(128) bf16 sB[BR * LDB];      // BR rows of rhs
  __shared__ __align__(128) float sC[WARPS][16 * 16];
  __shared__ int s_start, s_end;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * TN;
  const int k0 = blockIdx.y * TK;
  const int g = blockIdx.z;

  // row range of group g: [sum(gs[:g]), sum(gs[:g]) + gs[g])
  if (warp == 0) {
    int before = 0;
    for (int j = lane; j < g; j += 32) before += group_sizes[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(repro::kFullMask, before, o);
    if (lane == 0) {
      s_start = before;
      s_end = before + group_sizes[g];
    }
  }
  __syncthreads();
  const int start = s_start, end = s_end;

  const int wk = warp / 4;   // 0..1: rows wk*32 .. +32 of the tile
  const int wn = warp % 4;   // 0..3: cols wn*32 .. +32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  constexpr int VA = TK / 8, VB = TN / 8;   // 16-byte vectors per staged row
  for (int m0 = start; m0 < end; m0 += BR) {
    for (int i = tid; i < BR * VA; i += THREADS) {
      const int r = i / VA, c = (i % VA) * 8;
      uint4 v = repro::zero_vec8();
      if (m0 + r < end && k0 + c < K) v = repro::load_vec8(lhs + (size_t)(m0 + r) * K + k0 + c);
      repro::store_vec8(&sA[r * LDA + c], v);
    }
    for (int i = tid; i < BR * VB; i += THREADS) {
      const int r = i / VB, c = (i % VB) * 8;
      uint4 v = repro::zero_vec8();
      if (m0 + r < end && n0 + c < N) v = repro::load_vec8(rhs + (size_t)(m0 + r) * N + n0 + c);
      repro::store_vec8(&sB[r * LDB + c], v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      // A = lhs^T: element (k, m) sits at sA[m * LDA + k] -> col_major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sA + kk * LDA + wk * 32 + i * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, sB + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue: each warp rounds its four 16 x 16 tiles through shared memory;
  // lane l writes row l / 2, columns (l % 2) * 8 .. +8 as one 16-byte store
  bf16* og = out + (size_t)g * K * N;
  float* c = sC[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(c, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = k0 + wk * 32 + i * 16 + lane / 2;
      const int col = n0 + wn * 32 + j * 16 + (lane % 2) * 8;
      if (r < K && col < N)
        repro::store_vec8(og + (size_t)r * N + col, repro::pack8(c + (lane / 2) * 16 + (lane % 2) * 8));
      __syncwarp();
    }
  }
}

}  // namespace

// lhs (M, K), rhs (M, N), group_sizes (G,) int32, out (G, K, N); all on the
// device, bf16 (group_sizes int32), contiguous, 16-byte aligned.
// Requires K % 8 == 0, N % 8 == 0 and sum(group_sizes) <= M.
REPRO_API int repro_tgmm(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                         int M, int K, int N, int G, void* stream) {
  if (K % 8 != 0 || N % 8 != 0 || G < 1 || M < 0) return (int)cudaErrorInvalidValue;
  if (K == 0 || N == 0) return (int)cudaSuccess;
  dim3 grid((N + TN - 1) / TN, (K + TK - 1) / TK, G);
  tgmm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs),
      static_cast<const int*>(group_sizes), static_cast<bf16*>(out), K, N, G);
  return (int)cudaGetLastError();
}
