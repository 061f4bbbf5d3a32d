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
// bf16 once. A group with no rows writes zeros with no loads; rows past
// sum(group_sizes) are never read.
//
// What bounds it on an H100: at Mula-7B-A1B's gate projection (4096 tokens,
// ~32,768 routed rows, K 2048, N 1024, 64 groups) it does 137 GFLOP (0.139
// ms at the bf16 peak) and moves 469 MB (0.140 ms at 3.35 TB/s), of which
// 268 MB is the dW it writes: operations and bytes bound it equally, so the
// output's store has to overlap the next tile's products.
//
// Design: a persistent kernel, one block per SM, that walks the output
// tiles of 128 (K) x 256 (N) in group-major order (tile t is group
// t / tiles_per_group, whose ~3 MB of x and dy then come from L2 after the
// first tile reads them). One producer warp keeps a ring of shared-memory
// stages full by TMA, running ahead into the next tile's stages while the
// consumers store; a stage is 64 rows of the group: x[m:m+64, k0:k0+128]
// (two 64 x 64 boxes) and dy[m:m+64, n0:n0+256] (four boxes), 128-byte
// swizzled. The reduction runs across the staged rows, so both operands are
// MN-major: dy's boxes are gmm forward's B layout (LBO = the 8 KB between
// boxes) and x's box is wgmma's A with the transpose bit. Two consumer
// warpgroups (64 K-rows each) run wgmma m64n256k16 with f32 accumulators in
// registers, one stage of products in flight.
//
// Ragged groups: each group's stages start at its own first row (TMA takes
// any row coordinate), so no stage mixes two groups except past the group's
// end in its last stage, where the rows of the next group lie on the
// reduction axis and would be added: the consumers zero them in shared
// memory (x and dy both, so a NaN in unused memory cannot leak) and fence
// them to the async proxy before the product, which then runs all four
// k16 steps (issuing only the steps that hold rows of the group, under a
// branch, made ptxas serialize the kernel's wgmma (its warning C7520) and
// measured ~10 % slower at training shapes; PERF.md). This
// holds for any group size, not only the dispatch's multiples of 16
// (gmm_align()). Rows past M load as zeros.
//
// Epilogue: each warpgroup rounds its 64 x 256 accumulator to bf16 into a
// 128-byte-swizzled shared buffer (conflict-free: the eight rows of a
// warp's store fall in eight different 16-byte columns) and one thread
// hands it to TMA stores of four 64 x 64 boxes, which clip at K and N. The
// store drains while the warpgroup runs the next tile's products; the
// buffer is reused only after its previous store has been read out.
// The grid comes from the shapes and the SM count alone, so the host reads
// nothing and the call can be captured in a CUDA graph.
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = repro::hopper;

constexpr int WG_K = 64;                        // output rows per consumer warpgroup
constexpr int CONSUMERS = 2;
constexpr int TILE_K = WG_K * CONSUMERS;        // 128
constexpr int TILE_N = 256;                     // wgmma N
constexpr int BM = 64;                          // group rows per stage
constexpr int BOX_BYTES = BM * 128;             // one 64-row x 64-column box
constexpr int A_BYTES = (TILE_K / 64) * BOX_BYTES;
constexpr int B_BYTES = (TILE_N / 64) * BOX_BYTES;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // 48 KB
constexpr int STAGES = 3;
constexpr int OUT_BYTES = TILE_K * TILE_N * 2;  // the epilogue's bf16 tile, 64 KB
constexpr int THREADS = CONSUMERS * 128 + 32;   // + one producer warp
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + OUT_BYTES + 1024 + 128;

__global__ void __launch_bounds__(THREADS, 1)
tgmm_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_dy,
            const __grid_constant__ CUtensorMap map_out, const int* __restrict__ group_sizes,
            int tiles_n, int tiles_per_group, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hp::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* out_buf = smem + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_buf + OUT_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == CONSUMERS * 128) {
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], CONSUMERS);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  int it = 0;   // stages through the ring so far (the same count on both sides)

  if (warp == CONSUMERS * 4) {
    // Producer: one thread issues every TMA load.
    if (lane != 0) return;
    int walked = 0, start = 0;   // the current group's first row: tiles come in order
    hp::tma_prefetch_map(&map_x);
    hp::tma_prefetch_map(&map_dy);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int g = t / tiles_per_group;
      const int r = t - g * tiles_per_group;
      const int k0 = (r / tiles_n) * TILE_K;
      const int n0 = (r % tiles_n) * TILE_N;
      while (walked < g) start += group_sizes[walked++];
      const int stages = (group_sizes[g] + BM - 1) / BM;
      for (int st = 0; st < stages; ++st, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) hp::mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        unsigned char* a = smem + s * STAGE_BYTES;
        unsigned char* b = a + A_BYTES;
        const int m = start + st * BM;
        hp::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        for (int c = 0; c < TILE_K / 64; ++c)
          hp::tma_load_2d(a + c * BOX_BYTES, &map_x, &full[s], k0 + 64 * c, m);
        for (int c = 0; c < TILE_N / 64; ++c)
          hp::tma_load_2d(b + c * BOX_BYTES, &map_dy, &full[s], n0 + 64 * c, m);
      }
    }
    return;
  }

  // Consumer warpgroup wg: output rows [k0 + 64 wg, k0 + 64 wg + 64).
  const int wg = warp >> 2;
  const int wtid = tid & 127;
  const bool leader = wtid == 0;
  unsigned char* my_out = out_buf + wg * (OUT_BYTES / CONSUMERS);
  const int row = (warp & 3) * 16 + (lane >> 2);   // this thread's rows: row, row + 8
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int g = t / tiles_per_group;
    const int r = t - g * tiles_per_group;
    const int k0 = (r / tiles_n) * TILE_K;
    const int n0 = (r % tiles_n) * TILE_N;
    const int size = group_sizes[g];
    const int stages = (size + BM - 1) / BM;

    float acc[TILE_N / 2];
#pragma unroll
    for (int i = 0; i < TILE_N / 2; ++i) acc[i] = 0.f;

    for (int st = 0; st < stages; ++st, ++it) {
      const int s = it % STAGES;
      hp::mbar_wait(&full[s], (it / STAGES) & 1);
      unsigned char* a = smem + s * STAGE_BYTES + wg * BOX_BYTES;
      unsigned char* b = smem + s * STAGE_BYTES + A_BYTES;
      const int rows = min(BM, size - st * BM);
      if (rows < BM) {
        // The group's last stage: zero its rows past the group's end (the
        // next group's, or zeros past M) in this warpgroup's x box and in the
        // dy boxes (both warpgroups write the same zeros into dy), then hand
        // them to the async proxy. Every k16 step is issued: a wgmma under a
        // branch that the compiler cannot prove uniform is serialized.
        const int lo = rows, hi = BM;
        for (int i = wtid; i < (hi - lo) * 8 * (1 + TILE_N / 64); i += 128) {
          const int box = i / ((hi - lo) * 8);
          const int rr = lo + (i / 8) % (hi - lo);
          unsigned char* base = box == 0 ? a : b + (box - 1) * BOX_BYTES;
          *reinterpret_cast<uint4*>(base + rr * 128 + (i % 8) * 16) = repro::zero_vec8();
        }
        hp::fence_proxy_async();
        hp::named_barrier(1 + wg, 128);
      }
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)   // 16 rows = 2048 bytes along the reduction
        hp::wgmma_ss_n256<1, 1>(acc, hp::sw128_desc(a + kk * 2048, BOX_BYTES),
                                hp::sw128_desc(b + kk * 2048, BOX_BYTES), 1);
      hp::wgmma_commit();
      // The previous stage's products are done once at most this one is pending.
      hp::wgmma_wait<1>();
      hp::fence_regs(acc);
      if (st > 0 && leader) hp::mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    if (stages > 0 && leader) hp::mbar_arrive(&empty[(it - 1) % STAGES]);

    // Epilogue: the buffer's previous TMA store must have read it out.
    if (leader) hp::tma_store_wait_read<0>();
    hp::named_barrier(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < TILE_N / 8; ++j) {
      // columns 8j + 2 (lane % 4): box j / 8, 16-byte column j % 8, swizzled by row
      unsigned char* box = my_out + (j / 8) * BOX_BYTES + (lane & 3) * 4;
      *reinterpret_cast<uint32_t*>(box + row * 128 + (((j & 7) ^ (row & 7)) << 4)) =
          hp::pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(box + (row + 8) * 128 + (((j & 7) ^ (row & 7)) << 4)) =
          hp::pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    hp::fence_proxy_async();
    hp::named_barrier(1 + wg, 128);
    if (leader) {
      for (int c = 0; c < TILE_N / 64; ++c)
        hp::tma_store_3d(&map_out, my_out + c * BOX_BYTES, n0 + 64 * c, k0 + wg * WG_K, g);
      hp::tma_store_commit();
    }
  }
  if (leader) hp::tma_store_wait_read<0>();
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace

// lhs (M, K), rhs (M, N), group_sizes (G,) int32, out (G, K, N); all on the
// device, bf16 (group_sizes int32), contiguous, 16-byte aligned.
// Requires K % 8 == 0, N % 8 == 0 and sum(group_sizes) <= M.
REPRO_API int repro_tgmm(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                         int M, int K, int N, int G, void* stream) {
  if (K % 8 != 0 || N % 8 != 0 || G < 1 || M < 0) return (int)cudaErrorInvalidValue;
  if (K == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0)   // every group is empty
    return (int)cudaMemsetAsync(out, 0, (size_t)G * K * N * 2, s);
  namespace hp = repro::hopper;
  CUtensorMap map_x, map_dy, map_out;
  const uint32_t box[3] = {64, BM, 1};
  const uint64_t dims_x[2] = {(uint64_t)K, (uint64_t)M}, strides_x[1] = {(uint64_t)K * 2};
  const uint64_t dims_dy[2] = {(uint64_t)N, (uint64_t)M}, strides_dy[1] = {(uint64_t)N * 2};
  const uint64_t dims_o[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)G};
  const uint64_t strides_o[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
  const uint32_t box_o[3] = {64, WG_K, 1};
  int err = hp::encode_bf16_map(&map_x, lhs, 2, dims_x, strides_x, box);
  if (!err) err = hp::encode_bf16_map(&map_dy, rhs, 2, dims_dy, strides_dy, box);
  if (!err) err = hp::encode_bf16_map(&map_out, out, 3, dims_o, strides_o, box_o);
  if (err) return err;
  // per call: the attribute belongs to the current device's context
  const cudaError_t attr = cudaFuncSetAttribute(
      tgmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const int tiles_n = (N + TILE_N - 1) / TILE_N;
  const long long per_group = (long long)((K + TILE_K - 1) / TILE_K) * tiles_n;
  const long long tiles = per_group * G;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = (int)(tiles < sms ? tiles : sms);
  tgmm_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(map_x, map_dy, map_out,
                                               static_cast<const int*>(group_sizes), tiles_n,
                                               (int)per_group, (int)tiles);
  return (int)cudaGetLastError();
}
