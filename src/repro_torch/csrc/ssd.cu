// Mamba-2 SSD intra-chunk stage, forward.
//
// Replaces src/repro/kernels/ssd.py::ssd_intra_chunk_pallas (_ssd_kernel),
// reached through kernels/ops.py::ssd_intra_chunk. Per (batch b, chunk c,
// head h), over the chunk's L positions:
//
//   la      = cumsum(dt * A[h])                         (L,)
//   y_diag  = ((C B^T) o tril(exp(la_i - la_j))) (dt x)  (L, P)
//   states  = (exp(la_L - la) dt x)^T B                  (P, N)
//   cdecay  = exp(la_L)
//
//   x (B, C, L, H, P) bf16, dt (B, C, L, H) f32, B/C (B, C, L, N) bf16,
//   A (H,) f32 -> y (B, C, L, H, P), states (B, C, H, P, N), cdecay (B, C, H),
//   all f32.
//
// x, B and C are addressed by a row stride per position, so the column
// slices of the (B, S, d_inner + 2N) xBC activation are read in place.
//
// What bounds it on an H100: at Zamba2's L = 256, P = N = 64 a block does
// ~10.5 MFLOP (C B^T and the decayed product over the causal half, plus
// the states) against ~112 KB of its own traffic (x in, the f32 y and
// states out; B and C are shared by the chunk's heads): on the tensor
// cores it is bound by bytes, on the f32 CUDA cores by operations. The
// design keeps the (L, L) score matrix out of memory altogether: at L = 256
// it is 256 KB in f32, more than a block's 227 KB of shared memory. One
// block of 8 warps owns one (b, c, h); B, C, dt*x and exp(la_L - la)*dt*x
// for the whole chunk sit in shared memory (~165 KB).
// Each warp walks 16-row query tiles (tiles t and T-1-t pair up, so the
// causal work is even) and, for each key tile at or below the diagonal,
// forms S = (C_i B_j^T) o exp(la_i - la_j) 16 x 16 at a time and adds
// S (dt x)_j into a 16 x P accumulator: causal attention without a softmax.
// The states are one more product over the chunk's rows.
//
// Precision: the products run on the tensor cores (WMMA, bf16 operands,
// f32 accumulation). C B^T takes the bf16 inputs as they are, so it is
// exact up to summation order. The decayed scores S, dt*x and
// exp(la_L - la)*dt*x are f32 values rounded to bf16 (relative error
// <= 2^-9 each) before their products, as flash attention rounds its
// probabilities. la, the decay factors and every sum are f32.
//
// The decay exp(la_i - la_j) is formed only for j <= i: la falls along the
// chunk (dt > 0, A < 0), so above the diagonal the exponent is positive and
// can overflow, and inf * 0 would be NaN. Rows past L (L padded to a
// multiple of 16 inside the block) have dt = 0 and x = B = C = 0, and are
// never written.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using repro::bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_L = THREADS;      // the la scan gives each thread one row
constexpr int SCR_LDF = 20;         // per-warp 16 x 16 f32 scratch
constexpr int SCR_LDH = 24;         // per-warp 16 x 16 bf16 scratch
constexpr size_t SCR_F_BYTES = sizeof(float) * 16 * SCR_LDF;
constexpr size_t SCR_BYTES = SCR_F_BYTES + sizeof(bf16) * 16 * SCR_LDH;
constexpr size_t MAX_SMEM = 232448;

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

// Dynamic shared memory of one block for LP (L padded to 16) rows.
struct Layout {
  int ldn, ldp;
  size_t b_off, c_off, x_off, xw_off, la_off, dt_off, scr_off, bytes;
};

__host__ __device__ inline Layout make_layout(int LP, int N, int P) {
  Layout s;
  s.ldn = N + 8;
  s.ldp = P + 8;
  s.b_off = 0;
  s.c_off = align128(s.b_off + sizeof(bf16) * LP * s.ldn);
  s.x_off = align128(s.c_off + sizeof(bf16) * LP * s.ldn);
  s.xw_off = align128(s.x_off + sizeof(bf16) * LP * s.ldp);
  s.la_off = align128(s.xw_off + sizeof(bf16) * LP * s.ldp);
  s.dt_off = align128(s.la_off + sizeof(float) * LP);
  s.scr_off = align128(s.dt_off + sizeof(float) * LP);
  s.bytes = s.scr_off + WARPS * SCR_BYTES;
  return s;
}

template <int P>
__global__ void __launch_bounds__(THREADS, 1)
ssd_intra_chunk_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                       const float* __restrict__ A, float* __restrict__ y,
                       float* __restrict__ states, float* __restrict__ cdecay, int C, int L,
                       int H, int N, long long x_rs, long long b_rs, long long c_rs) {
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int LP = (L + 15) & ~15;
  const Layout s = make_layout(LP, N, P);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sB = reinterpret_cast<bf16*>(smem + s.b_off);
  bf16* sC = reinterpret_cast<bf16*>(smem + s.c_off);
  bf16* sX = reinterpret_cast<bf16*>(smem + s.x_off);
  bf16* sXw = reinterpret_cast<bf16*>(smem + s.xw_off);
  float* sla = reinterpret_cast<float*>(smem + s.la_off);
  float* sdt = reinterpret_cast<float*>(smem + s.dt_off);
  __shared__ float warp_sum[WARPS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row0 = ((long long)b * C + c) * L;   // first position of the chunk

  // 1. la = cumsum(dt * A[h]): a block-wide inclusive scan, one row a thread.
  const float dt_r = tid < L ? dt[(row0 + tid) * H + h] : 0.f;
  float v = dt_r * A[h];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(repro::kFullMask, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += warp_sum[w];
  if (tid < LP) {
    sla[tid] = v;
    sdt[tid] = dt_r;
  }
  __syncthreads();
  const float la_last = sla[L - 1];

  // 2. Stage B and C as given, and dt*x and exp(la_L - la)*dt*x rounded to bf16.
  const int NV = N / 8;
  for (int i = tid; i < LP * NV; i += THREADS) {
    const int r = i / NV, col = (i % NV) * 8;
    uint4 bv = repro::zero_vec8();
    uint4 cv = repro::zero_vec8();
    if (r < L) {
      bv = repro::load_vec8(bm + (row0 + r) * b_rs + col);
      cv = repro::load_vec8(cm + (row0 + r) * c_rs + col);
    }
    repro::store_vec8(&sB[r * s.ldn + col], bv);
    repro::store_vec8(&sC[r * s.ldn + col], cv);
  }
  constexpr int PV = P / 8;
  for (int i = tid; i < LP * PV; i += THREADS) {
    const int r = i / PV, col = (i % PV) * 8;
    float f[8], g[8];
    if (r < L) {
      repro::unpack8(repro::load_vec8(x + (row0 + r) * x_rs + (long long)h * P + col), f);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.f;
    }
    const float d = sdt[r];
    const float w = expf(la_last - sla[r]);   // <= 1: la falls along the chunk
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      f[j] *= d;
      g[j] = w * f[j];
    }
    repro::store_vec8(&sX[r * s.ldp + col], repro::pack8(f));
    repro::store_vec8(&sXw[r * s.ldp + col], repro::pack8(g));
  }
  __syncthreads();

  float* scr_f = reinterpret_cast<float*>(smem + s.scr_off + warp * SCR_BYTES);
  bf16* scr_h = reinterpret_cast<bf16*>(smem + s.scr_off + warp * SCR_BYTES + SCR_F_BYTES);

  // 3. y_diag, one 16-row query tile at a time per warp.
  const int T = LP / 16;
  const int er = lane >> 1;          // the lane's row of a 16 x 16 tile
  const int ec = (lane & 1) * 8;     // and its first of 8 columns
  for (int base = 0; base < T; base += 2 * WARPS) {
    for (int k = 0; k < 2; ++k) {
      const int qt = base + (k == 0 ? warp : 2 * WARPS - 1 - warp);
      if (qt >= T) continue;
      const int i0 = qt * 16;
      const float la_i = sla[i0 + er];
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[P / 16];
#pragma unroll
      for (int n = 0; n < P / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);

      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * 16;
        // C_i B_j^T (16 x 16); B_j^T is B_j read as a column-major operand
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> cb;
        wmma::fill_fragment(cb, 0.0f);
        for (int kk = 0; kk < N; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ca;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
          wmma::load_matrix_sync(ca, sC + i0 * s.ldn + kk, s.ldn);
          wmma::load_matrix_sync(bt, sB + j0 * s.ldn + kk, s.ldn);
          wmma::mma_sync(cb, ca, bt, cb);
        }
        wmma::store_matrix_sync(scr_f, cb, SCR_LDF, wmma::mem_row_major);
        __syncwarp();
        // S = cb o exp(la_i - la_j), the exponent formed only where j <= i
        float sv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = j0 + ec + e;
          float val = 0.f;
          if (j <= i0 + er) val = scr_f[er * SCR_LDF + ec + e] * __expf(la_i - sla[j]);
          sv[e] = val;
        }
        repro::store_vec8(scr_h + er * SCR_LDH + ec, repro::pack8(sv));
        __syncwarp();
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> sa;
        wmma::load_matrix_sync(sa, scr_h, SCR_LDH);
#pragma unroll
        for (int n = 0; n < P / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> xb;
          wmma::load_matrix_sync(xb, sX + j0 * s.ldp + n * 16, s.ldp);
          wmma::mma_sync(acc[n], sa, xb, acc[n]);
        }
        __syncwarp();   // scr_f / scr_h are rewritten by the next key tile
      }

      // rows < L of y[b, c, i0:i0+16, h, :], through the scratch tile
#pragma unroll
      for (int n = 0; n < P / 16; ++n) {
        wmma::store_matrix_sync(scr_f, acc[n], SCR_LDF, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 64; e += 32) {
          const int rr = e >> 2, cc = (e & 3) * 4;
          if (i0 + rr < L) {
            *reinterpret_cast<float4*>(y + ((row0 + i0 + rr) * H + h) * P + n * 16 + cc) =
                *reinterpret_cast<const float4*>(scr_f + rr * SCR_LDF + cc);
          }
        }
        __syncwarp();
      }
    }
  }

  // 4. states = (w dt x)^T B: (P x LP)(LP x N), one 16 x 16 output tile per
  //    warp at a time; (w dt x)^T is sXw read as a column-major operand.
  float* st = states + (((long long)b * C + c) * H + h) * P * N;
  const int NT = N / 16;
  for (int t = warp; t < (P / 16) * NT; t += WARPS) {
    const int pt = t / NT, nt = t % NT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int j0 = 0; j0 < LP; j0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> xa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bb;
      wmma::load_matrix_sync(xa, sXw + j0 * s.ldp + pt * 16, s.ldp);
      wmma::load_matrix_sync(bb, sB + j0 * s.ldn + nt * 16, s.ldn);
      wmma::mma_sync(acc, xa, bb, acc);
    }
    wmma::store_matrix_sync(st + pt * 16 * N + nt * 16, acc, N, wmma::mem_row_major);
  }
  if (tid == 0) cdecay[((long long)b * C + c) * H + h] = expf(la_last);
}

}  // namespace

// x (B, C, L, H, P) bf16, position (b, c, l) at row ((b*C + c)*L + l) of
// stride x_rs elements; B/C (B, C, L, N) bf16 likewise with b_rs / c_rs;
// rows 16-byte aligned. dt (B, C, L, H) and A (H,) f32, contiguous. y, states,
// cdecay: contiguous f32 outputs. L <= 256, N a multiple of 16, P 32 or 64.
REPRO_API int repro_ssd_intra_chunk(const void* x, const void* dt, const void* bm,
                                    const void* cm, const void* A, void* y, void* states,
                                    void* cdecay, int B, int C, int L, int H, int P, int N,
                                    long long x_rs, long long b_rs, long long c_rs,
                                    void* stream) {
  if (L < 1 || L > MAX_L || N < 16 || N % 16 != 0 || (P != 32 && P != 64)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || C == 0 || H == 0) return (int)cudaSuccess;
  if (B > 65535 || C > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = make_layout((L + 15) & ~15, N, P).bytes;
  if (smem + sizeof(float) * WARPS > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = P == 64 ? &ssd_intra_chunk_kernel<64> : &ssd_intra_chunk_kernel<32>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, C, B);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), static_cast<const float*>(A), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(cdecay), C, L, H, N, x_rs, b_rs, c_rs);
  return (int)cudaGetLastError();
}
