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
// bytes per tensor, so from a few hundred tokens it is bound by operations.
// The design keeps the P x P scores out of device memory: one block owns
// 64 query rows of one head (4 warps, 16 rows each) and walks the kv axis
// in tiles of 64, computing S = Q K^T and O += P V on the tensor cores
// (WMMA, bf16 in, f32 accumulate). The running max and sum of each row
// live in registers; the f32 output accumulator lives in shared memory so
// that it can be rescaled row by row. kv tiles that the causal or window
// mask hides from every row of the block are skipped (exact: they would
// add exp(-1e30 - m) = 0). Blocks run in any order, so each carries its
// own (m, l, acc) state through its kv loop rather than across the grid.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using repro::bf16;

constexpr float NEG = -1e30f;
constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;

// Instantiated for hd 64, 112 (Zamba2's shared attention) and 128. Every
// tile start stays 32-byte aligned and the strides meet WMMA's ldm rules
// (a multiple of 8 bf16 / 4 f32): at hd 112, LDQ = 120 and LDO = 116; a row
// is 14 16-byte vectors and a head starts every 224 bytes.
template <int HD>
struct Smem {
  static constexpr int LDQ = HD + 8;   // bf16 tiles Q, K, V
  static constexpr int LDS = BKV + 4;  // f32 scores
  static constexpr int LDP = BKV + 8;  // bf16 probabilities
  static constexpr int LDO = HD + 4;   // f32 output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(bf16) * BQ * LDQ;
  static constexpr size_t v_off = k_off + sizeof(bf16) * BKV * LDQ;
  static constexpr size_t s_off = v_off + sizeof(bf16) * BKV * LDQ;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t o_off = p_off + sizeof(bf16) * BQ * LDP;
  static constexpr size_t bytes = o_off + sizeof(float) * BQ * LDO;
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int Sq, int Skv, int nh,
                 int nkv, int causal, int window, float scale) {
  using L = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p_off);
  float* sO = reinterpret_cast<float*>(smem + L::o_off);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / nh;
  const int h = bh % nh;
  const int hk = h / (nh / nkv);

  const size_t q_stride = (size_t)nh * HD;    // between consecutive positions
  const size_t kv_stride = (size_t)nkv * HD;
  const bf16* qb = q + ((size_t)b * Sq * nh + h) * HD;
  const bf16* kb = k + ((size_t)b * Skv * nkv + hk) * HD;
  const bf16* vb = v + ((size_t)b * Skv * nkv + hk) * HD;
  bf16* ob = out + ((size_t)b * Sq * nh + h) * HD;

  constexpr int VEC = HD / 8;
  for (int i = tid; i < BQ * VEC; i += THREADS) {
    const int r = i / VEC, c = (i % VEC) * 8;
    uint4 val = repro::zero_vec8();
    if (q0 + r < Sq) val = repro::load_vec8(qb + (size_t)(q0 + r) * q_stride + c);
    repro::store_vec8(&sQ[r * L::LDQ + c], val);
  }
  for (int i = tid; i < BQ * L::LDO; i += THREADS) sO[i] = 0.f;

  // Each lane pair owns one query row of its warp's 16: lane 2r and 2r+1
  // split the row's kv columns and output columns in halves.
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int qpos = q0 + row;
  float m_i = NEG;
  float l_i = 0.f;

  int kv_begin = 0;
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, q0 + BQ);
  if (window > 0) kv_begin = max(0, q0 - window + 1) / BKV * BKV;
  __syncthreads();

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BKV) {
    for (int i = tid; i < BKV * VEC; i += THREADS) {
      const int r = i / VEC, c = (i % VEC) * 8;
      uint4 kval = repro::zero_vec8();
      uint4 vval = repro::zero_vec8();
      if (kv0 + r < Skv) {
        kval = repro::load_vec8(kb + (size_t)(kv0 + r) * kv_stride + c);
        vval = repro::load_vec8(vb + (size_t)(kv0 + r) * kv_stride + c);
      }
      repro::store_vec8(&sK[r * L::LDQ + c], kval);
      repro::store_vec8(&sV[r * L::LDQ + c], vval);
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (16 x BKV).
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BKV / 16];
#pragma unroll
      for (int n = 0; n < BKV / 16; ++n) wmma::fill_fragment(sacc[n], 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + warp * 16 * L::LDQ + kk, L::LDQ);
#pragma unroll
        for (int n = 0; n < BKV / 16; ++n) {
          // K^T as a column-major (hd x kv) operand: element (d, j) at sK[j][d]
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kt;
          wmma::load_matrix_sync(kt, sK + n * 16 * L::LDQ + kk, L::LDQ);
          wmma::mma_sync(sacc[n], a, kt, sacc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BKV / 16; ++n)
        wmma::store_matrix_sync(sS + warp * 16 * L::LDS + n * 16, sacc[n], L::LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this tile for the lane pair's row.
    {
      const float* srow = sS + row * L::LDS;
      bf16* prow = sP + row * L::LDP;
      constexpr int HALF = BKV / 2;
      const int c0 = half * HALF;
      float sv[HALF];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
        const int kpos = kv0 + c0 + j;
        bool ok = kpos < Skv;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        const float s = ok ? srow[c0 + j] * scale : NEG;
        sv[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(repro::kFullMask, mx, 1));
      const float m_new = fmaxf(m_i, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
        const float p = expf(sv[j] - m_new);
        sum += p;
        prow[c0 + j] = __float2bfloat16_rn(p);
      }
      sum += __shfl_xor_sync(repro::kFullMask, sum, 1);
      const float corr = expf(m_i - m_new);
      l_i = l_i * corr + sum;
      m_i = m_new;
      float* orow = sO + row * L::LDO + half * (HD / 2);
#pragma unroll 8
      for (int c = 0; c < HD / 2; ++c) orow[c] *= corr;
    }
    __syncwarp();

    // O += P V for this warp's 16 rows (16 x HD).
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa[BKV / 16];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wmma::load_matrix_sync(pa[kk], sP + warp * 16 * L::LDP + kk * 16, L::LDP);
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        float* optr = sO + warp * 16 * L::LDO + n * 16;
        wmma::load_matrix_sync(o, optr, L::LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, sV + kk * 16 * L::LDQ + n * 16, L::LDQ);
          wmma::mma_sync(o, pa[kk], vf, o);
        }
        wmma::store_matrix_sync(optr, o, L::LDO, wmma::mem_row_major);
      }
    }
    __syncthreads();  // sK/sV are overwritten by the next tile
  }

  if (qpos < Sq) {
    const float inv = 1.0f / fmaxf(l_i, 1e-30f);
    const float* orow = sO + row * L::LDO + half * (HD / 2);
    bf16* dst = ob + (size_t)qpos * q_stride + half * (HD / 2);
#pragma unroll
    for (int c = 0; c < HD / 2; c += 8) {
      float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = orow[c + j] * inv;
      repro::store_vec8(dst + c, repro::pack8(f));
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
           int nh, int nkv, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * nh);
  flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), Sq, Skv, nh, nkv, causal, window, scale);
  return (int)cudaGetLastError();
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
  if (hd == 128) return launch<128>(q, k, v, out, B, Sq, Skv, nh, nkv, causal, window, scale, s);
  if (hd == 112) return launch<112>(q, k, v, out, B, Sq, Skv, nh, nkv, causal, window, scale, s);
  if (hd == 64) return launch<64>(q, k, v, out, B, Sq, Skv, nh, nkv, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
