// Flash attention, forward: blockwise online-softmax attention with causal,
// sliding-window and kv-padding masks.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (_flash_kernel), reached through kernels/ops.py::flash_attention.
//
//   q (B, Sq, nh, hd), k/v (B, Skv, nkv, hd) -> out (B, Sq, nh, hd), bf16
//   s = q.k / sqrt(hd); masked scores are -1e30; l is clamped at 1e-30.
//
// Query head h reads kv head h / (nh / nkv): GQA is resolved by indexing,
// where the JAX wrapper repeats the kv heads in memory.
//
// What bounds it on an H100: at a prefill of P tokens the work is
// ~2*2*P*P*hd flops per head (halved by the causal mask) against P*hd*2
// bytes per tensor, so from a few hundred tokens it is bound by the tensor
// cores, which only wgmma drives at full rate, and by keeping the scores and
// the output accumulator out of shared memory.
//
// Design: one block per (query tile, b*h); the query tile is 64 rows per
// consumer warpgroup, one or two of them (two where the grid still fills
// the card). A producer warp loads the block's Q once and streams K and V
// tiles of 64 positions into a ring of STAGES stages by TMA, tracked by
// full/empty mbarriers. The tensor maps are 4-D, {hd, heads, S, B}, so a
// ragged last tile reads zeros past its own sequence, never the next
// batch's rows; hd is loaded as boxes of 64 columns (128-byte swizzle), and
// at hd 112 the second box's columns 112-127 load as zeros. Per kv tile a
// consumer warpgroup computes S = Q K^T with wgmma (K rows are hd-contiguous:
// the K-major B operand), applies the mask only on tiles that cross the
// diagonal, the window's edge or the end of the keys, runs the online
// softmax on the accumulator registers (a row's values sit in the 4 threads
// of a quad: two shuffles reduce them), converts P to bf16 in registers and
// feeds it to O += P V as wgmma's register A operand (V is the MN-major B
// operand). O and its rescaling stay in registers. kv tiles that the causal
// or window mask hides from every row of the block are not loaded; a
// warpgroup skips the products of a tile hidden from all of its rows
// (exact: they would add exp(-1e30 - m) = 0 once the row has a score).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::bf16;
namespace hp = repro::hopper;

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BKV = 64;
constexpr int STAGES = 3;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Instantiated for hd 64, 112 (Zamba2's shared attention) and 128, with one
// or two consumer warpgroups.
template <int HD, int NWG>
struct Cfg {
  static constexpr int BOXES = (HD + 63) / 64;   // 64-column boxes of hd
  static constexpr int HDP = BOXES * 64;         // P V's width (wgmma N)
  static constexpr int BQ = 64 * NWG;
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int Q_BYTES = BOXES * BQ * 128;
  static constexpr int KV_BYTES = BOXES * BKV * 128;   // one of K or V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE_BYTES + 1024 + 128;
};

template <int N>
struct PV;
template <>
struct PV<64> {
  static __device__ __forceinline__ void mma(float (&o)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
    hp::wgmma_rs_n64<1>(o, a, db, 1);
  }
};
template <>
struct PV<128> {
  static __device__ __forceinline__ void mma(float (&o)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
    hp::wgmma_rs_n128<1>(o, a, db, 1);
  }
};

template <int HD, int NWG>
__global__ void __launch_bounds__(Cfg<HD, NWG>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out, int Sq,
                 int Skv, int nh, int nkv, int causal, int window, float scale_log2) {
  using C = Cfg<HD, NWG>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hp::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sKV = smem + C::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sKV + STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;   // the longest kv ranges first
  const int bh = blockIdx.y;
  const int b = bh / nh;
  const int h = bh % nh;
  const int hk = h / (nh / nkv);

  int kv_begin = 0;
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, q0 + C::BQ);
  if (window > 0) kv_begin = max(0, q0 - window + 1) / BKV * BKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  if (tid == NWG * 128) {
    hp::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], NWG);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // Producer: Q once, then K and V tile by tile through the ring.
    if (lane == 0) {
      hp::tma_prefetch_map(&map_q);
      hp::tma_prefetch_map(&map_k);
      hp::tma_prefetch_map(&map_v);
      hp::mbar_arrive_expect_tx(qbar, C::Q_BYTES);
      for (int c = 0; c < C::BOXES; ++c)
        hp::tma_load_4d(sQ + c * C::BQ * 128, &map_q, qbar, c * 64, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int round = t / STAGES;
        if (round > 0) hp::mbar_wait(&empty[s], (round - 1) & 1);
        unsigned char* sk = sKV + s * C::STAGE_BYTES;
        unsigned char* sv = sk + C::KV_BYTES;
        const int kv0 = kv_begin + t * BKV;
        hp::mbar_arrive_expect_tx(&full[s], C::STAGE_BYTES);
        for (int c = 0; c < C::BOXES; ++c) {
          hp::tma_load_4d(sk + c * BKV * 128, &map_k, &full[s], c * 64, hk, kv0, b);
          hp::tma_load_4d(sv + c * BKV * 128, &map_v, &full[s], c * 64, hk, kv0, b);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows [q_lo, q_lo + 64); this thread holds
  // rows row0 and row0 + 8 (see the accumulator layout in hopper.cuh).
  const int wg = warp >> 2;
  const int q_lo = q0 + wg * 64;
  const int q_hi = q_lo + 63;
  const int row0 = q_lo + (warp & 3) * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const int col = 2 * (lane & 3);
  const bool signal = (warp & 3) == 0 && lane == 0;

  float o[C::HDP / 2];
#pragma unroll
  for (int i = 0; i < C::HDP / 2; ++i) o[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;   // l: this thread's partial sums

  hp::mbar_wait(qbar, 0);
  const unsigned char* q_wg = sQ + wg * 64 * 128;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const int kv0 = kv_begin + t * BKV;
    hp::mbar_wait(&full[s], (t / STAGES) & 1);
    const bool hidden =
        (causal && kv0 > q_hi) || (window > 0 && q_lo - (kv0 + BKV - 1) >= window);
    if (!hidden) {
      const unsigned char* sk = sKV + s * C::STAGE_BYTES;
      const unsigned char* sv = sk + C::KV_BYTES;
      float sc[BKV / 2];
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.f;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (kk % 4) * 32;   // 16 columns = 32 bytes along hd
        hp::wgmma_ss_n64<0>(sc, hp::sw128_desc(q_wg + (kk / 4) * C::BQ * 128 + off),
                            hp::sw128_desc(sk + (kk / 4) * BKV * 128 + off), kk > 0);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(sc);

#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) sc[i] *= scale_log2;
      const bool edge = kv0 + BKV > Skv || (causal && kv0 + BKV - 1 > q_lo) ||
                        (window > 0 && q_hi - kv0 >= window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = kv0 + 8 * j + col + e;
            bool ok0 = kpos < Skv, ok1 = kpos < Skv;
            if (causal) {
              ok0 = ok0 && row0 >= kpos;
              ok1 = ok1 && row1 >= kpos;
            }
            if (window > 0) {
              ok0 = ok0 && row0 - kpos < window;
              ok1 = ok1 && row1 - kpos < window;
            }
            if (!ok0) sc[4 * j + e] = NEG;
            if (!ok1) sc[4 * j + 2 + e] = NEG;
          }
        }
      }
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(repro::kFullMask, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(repro::kFullMask, mx1, x));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = ex2(m0 - mn0), corr1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        sc[4 * j] = ex2(sc[4 * j] - mn0);
        sc[4 * j + 1] = ex2(sc[4 * j + 1] - mn0);
        sc[4 * j + 2] = ex2(sc[4 * j + 2] - mn1);
        sc[4 * j + 3] = ex2(sc[4 * j + 3] - mn1);
        sum0 += sc[4 * j] + sc[4 * j + 1];
        sum1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int j = 0; j < C::HDP / 8; ++j) {
        o[4 * j] *= corr0;
        o[4 * j + 1] *= corr0;
        o[4 * j + 2] *= corr1;
        o[4 * j + 3] *= corr1;
      }
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        pa[kk][0] = hp::pack_bf16x2(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = hp::pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = hp::pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = hp::pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)   // 16 kv rows of V per step
        PV<C::HDP>::mma(o, pa[kk], hp::sw128_desc(sv + kk * 2048, BKV * 128));
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(o);
    }
    if (signal) hp::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(repro::kFullMask, l0, x);
    l1 += __shfl_xor_sync(repro::kFullMask, l1, x);
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
  const size_t q_stride = (size_t)nh * HD;
  bf16* base = out + ((size_t)b * Sq * nh + h) * HD;
#pragma unroll
  for (int j = 0; j < C::HDP / 8; ++j) {
    const int c = 8 * j + col;
    if (c < HD) {
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(base + (size_t)row0 * q_stride + c) =
            hp::pack_bf16x2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (row1 < Sq)
        *reinterpret_cast<uint32_t*>(base + (size_t)row1 * q_stride + c) =
            hp::pack_bf16x2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// A 4-D map {hd, heads, S, B} of a (B, S, heads, hd) tensor, box {64, 1, rows, 1}.
int encode_bshd(CUtensorMap* map, const void* p, int B, int S, int heads, int hd, int rows) {
  const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)hd * 2, (uint64_t)heads * hd * 2,
                               (uint64_t)S * heads * hd * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return repro::hopper::encode_bf16_map(map, p, 4, dims, strides, box);
}

template <int HD, int NWG>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
           int nh, int nkv, int causal, int window, float scale, cudaStream_t stream) {
  using C = Cfg<HD, NWG>;
  CUtensorMap mq, mk, mv;
  int err = encode_bshd(&mq, q, B, Sq, nh, HD, C::BQ);
  if (!err) err = encode_bshd(&mk, k, B, Skv, nkv, HD, BKV);
  if (!err) err = encode_bshd(&mv, v, B, Skv, nkv, HD, BKV);
  if (err) return err;
  // per call: the attribute belongs to the current device's context
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<HD, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Sq + C::BQ - 1) / C::BQ, B * nh);
  flash_fwd_kernel<HD, NWG><<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), Sq, Skv, nh, nkv, causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
              int nh, int nkv, int causal, int window, float scale, cudaStream_t stream) {
  // Two consumer warpgroups (128-row query tiles) once those tiles give about
  // one block per SM of an H100 (132 SMs); one (64 rows) below that, where
  // more, smaller blocks fill the card sooner.
  const long long tiles128 = (long long)((Sq + 127) / 128) * B * nh;
  return tiles128 >= 128
             ? launch<HD, 2>(q, k, v, out, B, Sq, Skv, nh, nkv, causal, window, scale, stream)
             : launch<HD, 1>(q, k, v, out, B, Sq, Skv, nh, nkv, causal, window, scale, stream);
}

}  // namespace

// q (B, Sq, nh, hd), k/v (B, Skv, nkv, hd), out (B, Sq, nh, hd): bf16 on the
// device, contiguous, 16-byte aligned; hd in {64, 112, 128}; nh % nkv == 0.
REPRO_API int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                    int B, int Sq, int Skv, int nh, int nkv, int hd, int causal,
                                    int window, float scale, void* stream) {
  if (nkv < 1 || nh % nkv != 0 || B * nh > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Skv == 0)   // nothing to attend to: every row's sum is 0, the output 0
    return (int)cudaMemsetAsync(out, 0, (size_t)B * Sq * nh * hd * 2, s);
  if (hd == 128) return launch_hd<128>(q, k, v, out, B, Sq, Skv, nh, nkv, causal, window, scale, s);
  if (hd == 112) return launch_hd<112>(q, k, v, out, B, Sq, Skv, nh, nkv, causal, window, scale, s);
  if (hd == 64) return launch_hd<64>(q, k, v, out, B, Sq, Skv, nh, nkv, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
