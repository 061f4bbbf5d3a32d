// Grouped matrix multiply for the MoE expert FFN (paper Stage 4).
//
// Replaces src/repro/kernels/gmm.py::gmm_pallas (_gmm_kernel), reached in the
// JAX package through kernels/ops.py::gmm, forward and in its custom VJP.
//
//   out[m, :] = lhs[m, :] @ rhs[g(m)]       lhs (M, K), rhs (G, K, N), bf16
//   out[m, :] = lhs[m, :] @ rhs[g(m)]^T     trans_rhs: rhs (G, N, K)
//
// The transposed mode is the input gradient dx = dy @ w^T: the JAX wrapper
// materialises swapaxes(w, 1, 2) (a 268 MB copy of each expert stack of
// Mula-7B-A1B per backward); here the B tile is read from w as stored,
// 16 bytes at a time along K, and fed to the tensor cores as a col_major
// fragment, so no transposed copy is made.
//
// Rows are grouped by expert and every group is padded to a multiple of
// BM rows by the dispatch (core/moe.py aligns to kernels.ops.gmm_align()),
// so each BM-row tile belongs to exactly one group. Rows past
// sum(group_sizes) are written as zeros, as the JAX wrapper masks them.
//
// What bounds it on an H100: at a decode step the pool holds a handful of
// rows per expert, so the kernel is bound by the bytes of expert weights it
// must stream (up to G*K*N*2 bytes, e.g. 268 MB for Mula-7B-A1B's gate
// projection, >= 80 us at 3.35 TB/s). At a 512-token prefill each expert
// sees ~64 rows and the work is still below the card's ops:byte ridge.
// The design follows that: BM is small (16, one tensor-core tile), so a
// decode step reads each active expert's weights once and wastes little
// compute on padding rows; a block whose tile starts at or past the total
// writes zeros and exits without touching the weights, which matters
// because the capacity pool is mostly padding. Each block finds its own
// group with a warp prefix sum over group_sizes (the TPU kernel's scalar
// prefetched tile->group map has no counterpart: blocks run in any order).
// Tensor cores through WMMA (bf16 x bf16 -> f32), tiles staged in shared
// memory; no TMA/wgmma pipeline yet.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using repro::bf16;

constexpr int BM = 16;    // rows per tile == group alignment (gmm_align)
constexpr int BN = 128;   // output columns per block (4 warps x 32)
constexpr int BK = 64;    // reduction depth per shared-memory stage
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LDA = BK + 8;   // padded leading dims (multiples of 8 elements)
constexpr int LDB = BN + 8;
constexpr int LDBT = BK + 8;  // transposed B tile: BN rows of BK
constexpr int SB_ELEMS = BK * LDB > BN * LDBT ? BK * LDB : BN * LDBT;
constexpr int LDC = BN + 4;

template <bool TRANS>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
           const int* __restrict__ group_sizes, bf16* __restrict__ out,
           int M, int K, int N, int G) {
  __shared__ __align__(128) bf16 sA[BM * LDA];
  __shared__ __align__(128) bf16 sB[SB_ELEMS];
  __shared__ __align__(128) float sC[BM * LDC];
  __shared__ int s_gid, s_total;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // Group of this tile: first g with m0 < cumsum(group_sizes)[g].
  if (warp == 0) {
    int base = 0;
    int gid = -1;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + lane;
      int v = g < G ? group_sizes[g] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(repro::kFullMask, v, o);
        if (lane >= o) v += t;
      }
      const int end = base + v;
      const unsigned hit = __ballot_sync(repro::kFullMask, g < G && m0 < end);
      if (gid < 0 && hit) gid = g0 + __ffs(hit) - 1;
      base = __shfl_sync(repro::kFullMask, end, 31);
    }
    if (lane == 0) {
      s_gid = gid;
      s_total = base;
    }
  }
  __syncthreads();
  const int gid = s_gid;
  constexpr int VN = BN / 8;  // 16-byte vectors per output row of the tile

  if (gid < 0 || m0 >= s_total) {
    for (int i = tid; i < BM * VN; i += THREADS) {
      const int r = i / VN, c = (i % VN) * 8;
      if (n0 + c < N) repro::store_vec8(out + (size_t)(m0 + r) * N + n0 + c, repro::zero_vec8());
    }
    return;
  }

  const bf16* A = lhs + (size_t)m0 * K;
  const bf16* B = rhs + (size_t)gid * K * N;   // (K, N), or (N, K) if TRANS

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  constexpr int VK = BK / 8;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * VK; i += THREADS) {
      const int r = i / VK, c = (i % VK) * 8;
      uint4 v = repro::zero_vec8();
      if (k0 + c < K) v = repro::load_vec8(A + (size_t)r * K + k0 + c);
      repro::store_vec8(&sA[r * LDA + c], v);
    }
    if (TRANS) {
      // sB holds the tile as BN rows of BK (n-major): B^T as stored
      for (int i = tid; i < BN * VK; i += THREADS) {
        const int r = i / VK, c = (i % VK) * 8;
        uint4 v = repro::zero_vec8();
        if (n0 + r < N && k0 + c < K) v = repro::load_vec8(B + (size_t)(n0 + r) * K + k0 + c);
        repro::store_vec8(&sB[r * LDBT + c], v);
      }
    } else {
      for (int i = tid; i < BK * VN; i += THREADS) {
        const int r = i / VN, c = (i % VN) * 8;
        uint4 v = repro::zero_vec8();
        if (k0 + r < K && n0 + c < N) v = repro::load_vec8(B + (size_t)(k0 + r) * N + n0 + c);
        repro::store_vec8(&sB[r * LDB + c], v);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (TRANS) {
          // element (k, n) of the B tile sits at sB[n * LDBT + k]
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, sB + (warp * 32 + j * 16) * LDBT + kk, LDBT);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, sB + kk * LDB + warp * 32 + j * 16, LDB);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(sC + warp * 32 + j * 16, acc[j], LDC, wmma::mem_row_major);
  __syncthreads();

  for (int i = tid; i < BM * VN; i += THREADS) {
    const int r = i / VN, c = (i % VN) * 8;
    if (n0 + c < N)
      repro::store_vec8(out + (size_t)(m0 + r) * N + n0 + c, repro::pack8(&sC[r * LDC + c]));
  }
}

}  // namespace

REPRO_API int repro_gmm_block_m() { return BM; }

// lhs (M, K), rhs (G, K, N) -- or (G, N, K) with trans_rhs -- group_sizes
// (G,) int32, out (M, N); all on the device, bf16, contiguous, 16-byte
// aligned. Requires M % BM == 0, K % 8 == 0, N % 8 == 0 and every group
// size a multiple of BM.
REPRO_API int repro_gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                        int M, int K, int N, int G, int trans_rhs, void* stream) {
  if (M % BM != 0 || K % 8 != 0 || N % 8 != 0 || G < 1) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  dim3 grid(M / BM, (N + BN - 1) / BN);
  auto kernel = trans_rhs ? gmm_kernel<true> : gmm_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs),
      static_cast<const int*>(group_sizes), static_cast<bf16*>(out), M, K, N, G);
  return (int)cudaGetLastError();
}

REPRO_API const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
