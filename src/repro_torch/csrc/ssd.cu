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
// slices of the (B, S, d_inner + 2N) xBC activation are read in place: the
// tensor maps are {P, H, L, B*C} for x and {N, L, B*C} for B and C, with
// the row stride as the position's stride (Zamba2: 14,592 bytes).
//
// What bounds it on an H100: bytes. At Zamba2-7B's L = 256, H = 112, P = N
// = 64 a 4096-token prompt needs ~11 GFLOP (~0.011 ms on the tensor cores)
// against ~208 MB (0.062 ms at 3.35 TB/s), most of it the f32 outputs (y
// alone is 117 MB). So the products stay out of the way and the stores are
// whole 32-byte sectors.
//
// Design: one block of two warpgroups per (b, c, group of HG = 2 heads).
// C B^T does not depend on the head, only the decay does, so it is formed
// once for the group. TMA brings the chunk's B, C and the group's x into shared
// memory (128-byte swizzled, one mbarrier per 64-row tile, so the products
// of the first tiles start while the later ones land). Each warpgroup takes
// 64-row query tiles, paired (0, 3) and (1, 2) so the causal work is even;
// per key tile j <= i:
//   G = C_i B_j^T        wgmma m64n64k16, both operands K-major, f32 in
//                        registers; once for all HG heads;
//   S_h = G o exp(la_i - la_j) dt_j, formed in registers only where j <= i
//                        (above the diagonal the exponent is positive and
//                        can overflow: inf * 0 would be NaN), packed to bf16
//                        as wgmma's register A operand (the accumulator's
//                        layout is the A layout);
//   y_h += S_h x_h[j]    wgmma m64n64k16 rs, x MN-major.
// y leaves the registers as float2 stores: a quad writes 32 contiguous
// bytes of a row. Then x is scaled in place to exp(la_L - la) dt x (bf16)
// and states = (that)^T B is one more product per head, A and B both
// MN-major (A with wgmma's transpose bit).
//
// Precision: the products run on the tensor cores (bf16 operands, f32
// accumulation). C B^T takes the bf16 inputs as they are, so it is exact up
// to summation order. S (decay and dt applied in f32) and the scaled x are
// rounded to bf16 (relative error <= 2^-9 each) before their products, as
// flash attention rounds its probabilities. la, the decay factors and every
// sum are f32. Rows past L load as zeros (TMA's fill past the chunk's
// extent), have dt = 0 and are never written; P = 32 and N < 64 load their
// missing columns as zeros too.
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = repro::hopper;

constexpr int TILE = 64;                 // positions per tile: wgmma M and the key tile
constexpr int MAX_L = 256;
constexpr int MAX_T = MAX_L / TILE;
constexpr int THREADS = 256;             // two warpgroups; the la scan gives each thread one row
constexpr int BOX = TILE * 128;          // one 64-position x 64-column tile, 8 KB
constexpr float LOG2E = 1.4426950408889634f;
// Heads per block. 2 measured faster than 4 (PERF.md): at 4 the kernel
// takes 255 registers, 192 KB of shared memory and half as many blocks.
constexpr int HG = 2;

// Shared memory: B, C and the heads' x as 64-row tiles, then f32 arrays.
constexpr int B_OFF = 0;
constexpr int C_OFF = MAX_T * BOX;
constexpr int X_OFF = 2 * MAX_T * BOX;              // HG heads x MAX_T tiles
constexpr int LA_OFF = X_OFF + HG * MAX_T * BOX;    // la * log2(e), [HG][MAX_L]
constexpr int DT_OFF = LA_OFF + HG * MAX_L * 4;     // dt, [HG][MAX_L]
constexpr int SUM_OFF = DT_OFF + HG * MAX_L * 4;    // per-warp scan totals
constexpr int BAR_OFF = SUM_OFF + (THREADS / 32) * HG * 4;
constexpr int SMEM_BYTES = BAR_OFF + MAX_T * 8 + 1024;   // + alignment

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_intra_chunk_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_b,
                       const __grid_constant__ CUtensorMap map_c, const float* __restrict__ dt,
                       const float* __restrict__ A, float* __restrict__ y,
                       float* __restrict__ states, float* __restrict__ cdecay, int L, int H,
                       int P, int N) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hp::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sB = smem + B_OFF;
  unsigned char* sC = smem + C_OFF;
  unsigned char* sX = smem + X_OFF;
  float* lal = reinterpret_cast<float*>(smem + LA_OFF);
  float* sdt = reinterpret_cast<float*>(smem + DT_OFF);
  float* wsum = reinterpret_cast<float*>(smem + SUM_OFF);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + BAR_OFF);

  const int h0 = blockIdx.x * HG;
  const int bc = blockIdx.z * gridDim.y + blockIdx.y;   // b * C + c
  const int T = (L + TILE - 1) / TILE;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == 0) {
    for (int t = 0; t < T; ++t) hp::mbar_init(&bar[t], 1);
    hp::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int t = 0; t < T; ++t) {   // heads past H load as zeros
      hp::mbar_arrive_expect_tx(&bar[t], (2 + HG) * BOX);
      hp::tma_load_3d(sB + t * BOX, &map_b, &bar[t], 0, t * TILE, bc);
      hp::tma_load_3d(sC + t * BOX, &map_c, &bar[t], 0, t * TILE, bc);
      for (int h = 0; h < HG; ++h)
        hp::tma_load_4d(sX + (h * MAX_T + t) * BOX, &map_x, &bar[t], 0, h0 + h, t * TILE, bc);
    }
  }

  // 1. la = cumsum(dt * A[h]) for the group's heads: a block-wide inclusive
  //    scan, one position a thread (positions past L have dt = 0).
  float v[HG], d[HG];
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    const bool ok = tid < L && h0 + h < H;
    d[h] = ok ? dt[((long long)bc * L + tid) * H + h0 + h] : 0.f;
    v[h] = ok ? d[h] * A[h0 + h] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(repro::kFullMask, v[h], o);
      if (lane >= o) v[h] += t;
    }
    if (lane == 31) wsum[warp * HG + h] = v[h];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < HG; ++h) {
    for (int w = 0; w < warp; ++w) v[h] += wsum[w * HG + h];
    lal[h * MAX_L + tid] = v[h] * LOG2E;
    sdt[h * MAX_L + tid] = d[h];
  }
  __syncthreads();
  if (tid < HG && h0 + tid < H)
    cdecay[(long long)bc * H + h0 + tid] = exp2f(lal[tid * MAX_L + L - 1]);

  // 2. y_diag, one 64-row query tile at a time per warpgroup.
  const int wg = warp >> 2;
  const int r_in = (warp & 3) * 16 + (lane >> 2);   // this thread's rows: r_in, r_in + 8
  const int q4 = 2 * (lane & 3);                    // and its first column of each 8
  // query tiles: (0, 3) and (1, 2) at T = 4, (0, 2) and (1) at T = 3
  const int n_tiles = T <= 2 ? (wg < T ? 1 : 0) : (T - 1 - wg > wg ? 2 : 1);
  for (int qi = 0; qi < n_tiles; ++qi) {
    const int i = qi == 0 ? wg : T - 1 - wg;
    const int r0 = i * TILE + r_in, r1 = r0 + 8;
    float acc[HG][32];   // written first by a product with scale-d = 0 (j = 0)
    float la0[HG], la1[HG];
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      la0[h] = lal[h * MAX_L + r0];
      la1[h] = lal[h * MAX_L + r1];
    }
    hp::mbar_wait(&bar[i], 0);
    for (int j = 0; j <= i; ++j) {
      hp::mbar_wait(&bar[j], 0);
      float g[32];
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // 16 state columns = 32 bytes along the row
        hp::wgmma_ss_n64<0>(g, hp::sw128_desc(sC + i * BOX + kk * 32),
                            hp::sw128_desc(sB + j * BOX + kk * 32), kk > 0);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(g);
      const bool diag = j == i;
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        // S_h in the accumulator's layout, packed to bf16 pairs as the A
        // operand: k16 step kk holds the 8-column chunks 2kk and 2kk + 1.
        uint32_t pa[4][4];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          float sv[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j * TILE + 8 * jj + q4 + e;
            const float lc = lal[h * MAX_L + col];
            const float dc = sdt[h * MAX_L + col];
            sv[e] = !diag || col <= r0 ? g[4 * jj + e] * ex2(la0[h] - lc) * dc : 0.f;
            sv[2 + e] = !diag || col <= r1 ? g[4 * jj + 2 + e] * ex2(la1[h] - lc) * dc : 0.f;
          }
          pa[jj / 2][2 * (jj % 2)] = hp::pack_bf16x2(sv[0], sv[1]);
          pa[jj / 2][2 * (jj % 2) + 1] = hp::pack_bf16x2(sv[2], sv[3]);
        }
        const unsigned char* xj = sX + (h * MAX_T + j) * BOX;
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)   // 16 key positions = 2048 bytes
          hp::wgmma_rs_n64<1>(acc[h], pa[kk], hp::sw128_desc(xj + kk * 2048, BOX),
                              j > 0 || kk > 0);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(acc[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      if (h0 + h >= H) continue;
      float* y0 = y + (((long long)bc * L + r0) * H + h0 + h) * P;
      float* y1 = y0 + (long long)8 * H * P;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int p = 8 * jj + q4;
        if (p < P) {
          if (r0 < L) *reinterpret_cast<float2*>(y0 + p) = make_float2(acc[h][4 * jj], acc[h][4 * jj + 1]);
          if (r1 < L)
            *reinterpret_cast<float2*>(y1 + p) = make_float2(acc[h][4 * jj + 2], acc[h][4 * jj + 3]);
        }
      }
    }
  }

  // 3. Scale x in place to exp(la_L - la) dt x, rounded to bf16: row `tid`
  //    of every head (the swizzle keeps a row's bytes within its row).
  for (int t = 0; t < T; ++t) hp::mbar_wait(&bar[t], 0);
  __syncthreads();   // every y product has read x
  if (tid < T * TILE) {
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      const float w = exp2f(lal[h * MAX_L + L - 1] - lal[h * MAX_L + tid]) * sdt[h * MAX_L + tid];
      unsigned char* rowp = sX + (h * MAX_T + tid / TILE) * BOX + (tid % TILE) * 128;
#pragma unroll
      for (int ch = 0; ch < 8; ++ch) {
        float f[8];
        repro::unpack8(*reinterpret_cast<const uint4*>(rowp + ch * 16), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] *= w;
        *reinterpret_cast<uint4*>(rowp + ch * 16) = repro::pack8(f);
      }
    }
  }
  hp::fence_proxy_async();
  __syncthreads();

  // 4. states = (scaled x)^T B: (P x L)(L x N) per head, the heads split
  //    between the warpgroups; 16 positions = 2048 bytes per k16 step.
  for (int h = wg; h < HG; h += 2) {
    if (h0 + h >= H) break;
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    const unsigned char* xh = sX + h * MAX_T * BOX;
    hp::wgmma_fence();
    for (int kk = 0; kk < T * TILE / 16; ++kk)
      hp::wgmma_ss_n64<1, 1>(acc, hp::sw128_desc(xh + kk * 2048, BOX),
                             hp::sw128_desc(sB + kk * 2048, BOX), 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    float* st = states + ((long long)bc * H + h0 + h) * P * N;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = 8 * jj + q4;
      if (n < N) {
        if (r_in < P) *reinterpret_cast<float2*>(st + r_in * N + n) = make_float2(acc[4 * jj], acc[4 * jj + 1]);
        if (r_in + 8 < P)
          *reinterpret_cast<float2*>(st + (r_in + 8) * N + n) = make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
      }
    }
  }
}

}  // namespace

// x (B, C, L, H, P) bf16, position (b, c, l) at row ((b*C + c)*L + l) of
// stride x_rs elements; B/C (B, C, L, N) bf16 likewise with b_rs / c_rs;
// rows 16-byte aligned. dt (B, C, L, H) and A (H,) f32, contiguous. y, states,
// cdecay: contiguous f32 outputs. L <= 256, N a multiple of 16 up to 64, P 32
// or 64.
REPRO_API int repro_ssd_intra_chunk(const void* x, const void* dt, const void* bm,
                                    const void* cm, const void* A, void* y, void* states,
                                    void* cdecay, int B, int C, int L, int H, int P, int N,
                                    long long x_rs, long long b_rs, long long c_rs,
                                    void* stream) {
  if (L < 1 || L > MAX_L || N < 16 || N > 64 || N % 16 != 0 || (P != 32 && P != 64))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0 || H == 0) return (int)cudaSuccess;
  if (B > 65535 || C > 65535) return (int)cudaErrorInvalidValue;
  namespace hp = repro::hopper;
  const uint64_t chunks = (uint64_t)B * C;
  CUtensorMap mx, mb, mc;
  const uint64_t dx[4] = {(uint64_t)P, (uint64_t)H, (uint64_t)L, chunks};
  const uint64_t sx[3] = {(uint64_t)P * 2, (uint64_t)x_rs * 2, (uint64_t)x_rs * 2 * L};
  const uint32_t bx[4] = {64, 1, TILE, 1};
  int err = hp::encode_bf16_map(&mx, x, 4, dx, sx, bx);
  const uint64_t dn[3] = {(uint64_t)N, (uint64_t)L, chunks};
  const uint32_t bn[3] = {64, TILE, 1};
  const uint64_t sb[2] = {(uint64_t)b_rs * 2, (uint64_t)b_rs * 2 * L};
  const uint64_t sc[2] = {(uint64_t)c_rs * 2, (uint64_t)c_rs * 2 * L};
  if (!err) err = hp::encode_bf16_map(&mb, bm, 3, dn, sb, bn);
  if (!err) err = hp::encode_bf16_map(&mc, cm, 3, dn, sc, bn);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // per call: the attribute belongs to the current device's context
  const cudaError_t attr = cudaFuncSetAttribute(
      ssd_intra_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((H + HG - 1) / HG, C, B);
  ssd_intra_chunk_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      mx, mb, mc, static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<float*>(y), static_cast<float*>(states), static_cast<float*>(cdecay), L, H, P,
      N);
  return (int)cudaGetLastError();
}
