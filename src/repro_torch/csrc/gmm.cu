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
// Mula-7B-A1B per backward); here the B tile is read from w as stored, so no
// transposed copy is made: the forward B tile (K rows of N) is the MN-major
// operand of wgmma, the transposed one (N rows of K) its K-major operand.
//
// Rows are grouped by expert. The dispatch pads every group to a multiple
// of 16 rows (kernels.ops.gmm_align(); core/moe.py sizes the capacity pool
// with it), but this kernel's row tile is decoupled from that alignment:
// a group is cut into tiles of TILE_M rows from its own start, the last one
// ragged. A tile's A load may bring in rows of the next group; they are
// multiplied and discarded, and only the rows inside the group are stored.
// Rows past sum(group_sizes) are written as exact zeros (SwiGLU reads them,
// and the pool gather's backward multiplies their gradient by 0) by the
// spare row tiles of the grid, never by a memset of the whole output.
//
// What bounds it on an H100: at training shapes (~512 rows per expert, K and
// N 1024-2048) the work is ~2*rows*K*N flops against the expert weights and
// rows read once, above the card's ~295 ops/byte ridge: it is bound by the
// tensor cores, which only wgmma drives at full rate. At a decode step each
// active expert holds a few rows and the kernel is bound by streaming its
// weights (up to G*K*N*2 bytes).
//
// Design: one block computes a TILE_M x BN output tile (128 x 256) of one
// group. One producer warp keeps a ring of STAGES (4) shared-memory stages
// full by TMA (A: a 2-D map over (M, K), box 128 x 64; B: a 3-D map over the
// weight stack, four boxes of 64 K-rows x 64 columns (forward) or one box of
// 256 N-rows x 64 (transposed)), all 128-byte swizzled, tracked by full and
// empty mbarriers. Two consumer warpgroups (64 rows each) run wgmma
// m64n256k16 on the stages that have arrived, keeping one k-step of
// products in flight, f32 accumulators in registers (154 a thread, no
// spill; one block an SM). A warpgroup whose 64 rows all lie past its
// group's end skips the products. The 256-wide tile halves the shared-memory
// reads of A per flop against a 128-wide one, and measured faster than it at
// every main-path shape, decode included (PERF.md).
// A block finds its (group, first row) from its tile index with a warp
// prefix sum over ceil(group_sizes[g] / TILE_M); the grid is sized from
// shapes alone (ceil(M / TILE_M) + G row tiles), so the host never reads
// group_sizes and the call can be captured in a CUDA graph.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::bf16;
namespace hp = repro::hopper;

constexpr int ALIGN_M = 16;   // group alignment the dispatch honours (gmm_align)
constexpr int WG_M = 64;      // rows per consumer warpgroup (wgmma M)
constexpr int CONSUMERS = 2;  // consumer warpgroups
constexpr int TILE_M = WG_M * CONSUMERS;
constexpr int BN = 256;       // output columns per block (wgmma N)
constexpr int BK = 64;        // reduction depth per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int THREADS = CONSUMERS * 128 + 32;   // + one producer warp
constexpr int A_BYTES = TILE_M * BK * 2;
constexpr int B_BYTES = BK * BN * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 128;   // + alignment, barriers

template <bool TRANS>
__global__ void __launch_bounds__(THREADS, 1)
gmm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
           const int* __restrict__ group_sizes, bf16* __restrict__ out, int M, int N, int G,
           int k_steps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hp::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  int* info = reinterpret_cast<int*>(empty + STAGES);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * BN;
  const int idx = blockIdx.y;   // row tile index

  if (warp == 0) {
    // The group whose tiles hold tile idx: first g with idx < sum_{<=g} tiles.
    int tile_base = 0, row_base = 0, gid = -1, m0 = 0, m_end = 0;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + lane;
      const int sz = g < G ? group_sizes[g] : 0;
      const int t = (sz + TILE_M - 1) / TILE_M;
      int ti = t, ri = sz;   // inclusive prefix sums over the 32 groups
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int a = __shfl_up_sync(repro::kFullMask, ti, o);
        const int b = __shfl_up_sync(repro::kFullMask, ri, o);
        if (lane >= o) {
          ti += a;
          ri += b;
        }
      }
      const unsigned hit = __ballot_sync(repro::kFullMask, g < G && idx < tile_base + ti);
      if (gid < 0 && hit) {
        const int src = __ffs(hit) - 1;
        const int t_before = tile_base + __shfl_sync(repro::kFullMask, ti - t, src);
        const int g_start = row_base + __shfl_sync(repro::kFullMask, ri - sz, src);
        gid = g0 + src;
        m0 = g_start + (idx - t_before) * TILE_M;
        m_end = g_start + __shfl_sync(repro::kFullMask, sz, src);
      }
      tile_base += __shfl_sync(repro::kFullMask, ti, 31);
      row_base += __shfl_sync(repro::kFullMask, ri, 31);
    }
    if (lane == 0) {
      info[0] = gid;
      info[1] = m0;
      info[2] = min(m_end, M);
      info[3] = row_base;    // total routed rows
      info[4] = tile_base;   // row tiles in use
    }
  } else if (tid == 32) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], CONSUMERS);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();
  const int gid = info[0];
  const int m0 = info[1];
  const int m_end = info[2];

  if (gid < 0) {
    // A spare row tile: zero its share of the rows past the total.
    const int r0 = info[3] + (idx - info[4]) * TILE_M;
    const int r1 = min(r0 + TILE_M, M);
    constexpr int VN = BN / 8;
    for (int i = tid; i < TILE_M * VN; i += THREADS) {
      const int r = r0 + i / VN, c = n0 + (i % VN) * 8;
      if (r < r1 && c < N) repro::store_vec8(out + (size_t)r * N + c, repro::zero_vec8());
    }
    return;
  }

  if (warp == CONSUMERS * 4) {
    // Producer: one thread issues every TMA load of the ring.
    if (lane == 0) {
      hp::tma_prefetch_map(&map_a);
      hp::tma_prefetch_map(&map_b);
      for (int ks = 0; ks < k_steps; ++ks) {
        const int s = ks % STAGES;
        const int round = ks / STAGES;
        if (round > 0) hp::mbar_wait(&empty[s], (round - 1) & 1);
        unsigned char* a = smem + s * STAGE_BYTES;
        unsigned char* b = a + A_BYTES;
        hp::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        hp::tma_load_2d(a, &map_a, &full[s], ks * BK, m0);
        if (TRANS) {
          hp::tma_load_3d(b, &map_b, &full[s], ks * BK, n0, gid);
        } else {   // BN / 64 column blocks of 64 K rows each
          for (int c = 0; c < BN / 64; ++c)
            hp::tma_load_3d(b + c * BK * 128, &map_b, &full[s], n0 + 64 * c, ks * BK, gid);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64) of the
  // tile; one whose rows all lie past the group's end only recycles stages.
  const int wg = warp >> 2;
  const bool active = m0 + wg * WG_M < m_end;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int ks = 0; ks < k_steps; ++ks) {
    const int s = ks % STAGES;
    hp::mbar_wait(&full[s], (ks / STAGES) & 1);
    if (active) {
      const unsigned char* a = smem + s * STAGE_BYTES + wg * (WG_M * 128);
      const unsigned char* b = smem + s * STAGE_BYTES + A_BYTES;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = hp::sw128_desc(a + kk * 32);
        if (TRANS)   // BN rows of 64 K: advance 32 bytes per 16 K
          hp::wgmma_ss_n256<0>(acc, da, hp::sw128_desc(b + kk * 32), 1);
        else         // 64 K rows of 64 columns, column blocks BK * 128 bytes apart
          hp::wgmma_ss_n256<1>(acc, da, hp::sw128_desc(b + kk * 2048, BK * 128), 1);
      }
      hp::wgmma_commit();
      // The previous stage's products are done once at most this one is pending.
      hp::wgmma_wait<1>();
      hp::fence_regs(acc);
    }
    if (ks > 0 && (warp & 3) == 0 && lane == 0) hp::mbar_arrive(&empty[(ks - 1) % STAGES]);
  }
  hp::wgmma_wait<0>();
  hp::fence_regs(acc);
  if (!active) return;

  // Epilogue: only rows inside the group (the next group's tile owns the rest).
  const int r = m0 + wg * WG_M + (warp & 3) * 16 + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = c0 + 8 * j;
    if (c < N) {
      if (r < m_end)
        *reinterpret_cast<uint32_t*>(out + (size_t)r * N + c) =
            hp::pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
      if (r + 8 < m_end)
        *reinterpret_cast<uint32_t*>(out + (size_t)(r + 8) * N + c) =
            hp::pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

template <bool TRANS>
int launch(const void* lhs, const void* rhs, const int* group_sizes, bf16* out, int M, int K,
           int N, int G, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  const uint64_t dims_a[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t strides_a[1] = {(uint64_t)K * 2};
  const uint32_t box_a[2] = {BK, TILE_M};
  int err = repro::hopper::encode_bf16_map(&map_a, lhs, 2, dims_a, strides_a, box_a);
  if (err) return err;
  if (TRANS) {   // rhs (G, N, K): K-major boxes of BN rows x 64
    const uint64_t dims[3] = {(uint64_t)K, (uint64_t)N, (uint64_t)G};
    const uint64_t strides[2] = {(uint64_t)K * 2, (uint64_t)N * K * 2};
    const uint32_t box[3] = {BK, BN, 1};
    err = repro::hopper::encode_bf16_map(&map_b, rhs, 3, dims, strides, box);
  } else {       // rhs (G, K, N): MN-major boxes of 64 rows (K) x 64 columns (N)
    const uint64_t dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)G};
    const uint64_t strides[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
    const uint32_t box[3] = {64, BK, 1};
    err = repro::hopper::encode_bf16_map(&map_b, rhs, 3, dims, strides, box);
  }
  if (err) return err;
  // per call: the attribute belongs to the current device's context
  const cudaError_t attr = cudaFuncSetAttribute(
      gmm_kernel<TRANS>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const long long row_tiles = (M + TILE_M - 1) / TILE_M + (long long)G;
  if (row_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((N + BN - 1) / BN, (unsigned)row_tiles);
  gmm_kernel<TRANS><<<grid, THREADS, SMEM_BYTES, stream>>>(map_a, map_b, group_sizes, out, M, N,
                                                          G, (K + BK - 1) / BK);
  return (int)cudaGetLastError();
}

}  // namespace

REPRO_API int repro_gmm_block_m() { return ALIGN_M; }

REPRO_API int repro_gmm_tile_m() { return TILE_M; }

// lhs (M, K), rhs (G, K, N) -- or (G, N, K) with trans_rhs -- group_sizes
// (G,) int32 with sum <= M, out (M, N); all on the device, bf16,
// contiguous, 16-byte aligned. Requires M % 16 == 0 (the dispatch's
// alignment), K % 8 == 0 and N % 8 == 0. Launches ceil(N / 128) x
// (ceil(M / TILE_M) + G) blocks.
REPRO_API int repro_gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                        int M, int K, int N, int G, int trans_rhs, void* stream) {
  if (M % ALIGN_M != 0 || K % 8 != 0 || N % 8 != 0 || G < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const int* gs = static_cast<const int*>(group_sizes);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return trans_rhs ? launch<true>(lhs, rhs, gs, o, M, K, N, G, s)
                   : launch<false>(lhs, rhs, gs, o, M, K, N, G, s);
}

REPRO_API const char* repro_error_string(int err) {
  if (err >= repro::hopper::kEncodeError)
    return "cuTensorMapEncodeTiled refused the tensor map (CUresult = code - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
