// MoE Stages 2 and 3 (paper §3.1) in one pass over the routed expert ids:
// the histogram of the local ids, the count-aligned groups of the slot pool,
// each (token, k) pair's stable rank among its expert's pairs, its pool slot
// and validity, and the inverse map pool row -> pair. A flag gives every
// group the same capacity instead (the uniform-capacity layout of the
// all-to-all Stage 1's send buffers: one group per destination rank).
//
// Replaces src/repro/kernels/moe_dispatch.py::token_counts_pallas (the
// Stage 2 histogram) together with the sort-based index generation that
// consumes it, src/repro/core/moe.py::make_dispatch_plan (count-aligned
// and uniform-capacity layouts), and the inverse map that
// dispatch_compute_combine builds by scatter. The TPU sorts the keys (argsort) and counts them with a one-hot
// reduction over a sequential grid; on Hopper the sort is a counting sort:
// the keys are small integers (at most kMaxLocal local experts), so each
// pair's rank within its expert is a count of the earlier pairs with the
// same key, no comparison sort needed.
//
// The rank must be stable (the pairs of an expert past its group size in
// flat order are the dropped ones), so the ids are cut into contiguous
// chunks of 32 * iters, one per warp, and every count is kept per warp:
//   1. count  each warp counts its chunk's keys into a private row of
//             shared memory (lanes holding the same key are merged first by
//             __match_any_sync) and writes the row out;
//   2. scan   one block turns the rows into each warp's base for each key
//             (an exclusive sum over the warps before it), the totals into
//             the counts, the aligned group sizes, the group offsets clamped
//             at the pool's end and the drops;
//   3. rank   each warp walks its chunk again in the same order; a pair's
//             rank is its warp's running count for its key plus the number
//             of lower lanes holding the same key (popc of the match mask
//             below the lane). It writes slot and valid, and for a valid pair
//             the inverse map's row.
// Every count is an integer and every order is fixed by the chunking, so two
// runs give the same bits. Non-local ids (the sentinel key of the TPU
// version) are counted nowhere: their slot is pool_rows, their rank unused.
//
// What bounds it on an H100: launches. The bytes are the ids (8 bytes a
// pair, read twice), 9 bytes of slot and valid a pair and 9 a pool row:
// under a microsecond at every size on the main path. So for few pairs
// (the caller sets how few) the three steps run in one block of one
// launch, with __syncthreads between them; for more, in three launches
// (count and rank over many blocks, scan in one), with no memset: the count
// launch also clears the inverse map that the rank launch fills. Nothing is
// read back to the host, so a plan can be captured in a CUDA graph.
#include "common.cuh"

namespace {

constexpr int kMaxLocal = 1024;         // local experts (keys) a plan takes
constexpr int kWarps = 8;               // warps a block of the count / rank launches
constexpr int kScanThreads = 1024;
constexpr int kSingleCountInts = 8192;  // the one-block kernel's per-warp rows: 32 KB
constexpr int kUnroll = 4;              // ids loaded ahead of their processing

__device__ __forceinline__ int load_key(const long long* __restrict__ ids, long long i,
                                        long long n, long long offset, int num_local) {
  if (i >= n) return -1;
  const long long local = __ldg(ids + i) - offset;
  return (local >= 0 && local < num_local) ? (int)local : -1;
}

// Adds the key counts of the warp's chunk [start, start + 32 * iters) into
// the warp's shared-memory row.
__device__ __forceinline__ void warp_count(const long long* __restrict__ ids, long long n,
                                           long long offset, int num_local, long long start,
                                           int iters, int* row) {
  const int lane = threadIdx.x & 31;
  for (int it = 0; it < iters; it += kUnroll) {
    int keys[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      keys[u] = it + u < iters ? load_key(ids, start + (long long)(it + u) * 32 + lane, n, offset,
                                          num_local)
                               : -1;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned peers = __match_any_sync(repro::kFullMask, keys[u]);
      if (keys[u] >= 0 && lane == __ffs(peers) - 1) atomicAdd(&row[keys[u]], __popc(peers));
    }
  }
}

// Walks the warp's chunk again: ``run`` holds the warp's base for each key
// and is advanced past the chunk's pairs. Writes slot and valid of each pair
// and, for a valid one, its pool row's inverse map.
__device__ __forceinline__ void warp_rank(const long long* __restrict__ ids, long long n,
                                          long long offset, int num_local, long long start,
                                          int iters, int* run, const long long* offs,
                                          const int* gsz, long long pool_rows,
                                          long long* __restrict__ slot,
                                          unsigned char* __restrict__ valid,
                                          long long* __restrict__ inv_pair,
                                          unsigned char* __restrict__ pool_valid) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int it = 0; it < iters; it += kUnroll) {
    int keys[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      keys[u] = it + u < iters ? load_key(ids, start + (long long)(it + u) * 32 + lane, n, offset,
                                          num_local)
                               : -1;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = keys[u];
      const unsigned peers = __match_any_sync(repro::kFullMask, key);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      // the leader's atomic returns the count of this key before this step
      // and has returned before the shuffle, so the next step sees it
      if (key >= 0 && lane == leader) base = atomicAdd(&run[key], __popc(peers));
      base = __shfl_sync(repro::kFullMask, base, leader);
      const long long i = start + (long long)(it + u) * 32 + lane;
      if (it + u < iters && i < n) {
        long long s = pool_rows;
        bool v = false;
        if (key >= 0) {
          const int pos = base + __popc(peers & below);
          v = pos < gsz[key];
          if (v) s = offs[key] + pos;
        }
        slot[i] = s;
        valid[i] = v;
        if (v) {
          inv_pair[s] = i;
          pool_valid[s] = 1;
        }
      }
    }
  }
}

// In-place exclusive prefix sum of v[0, len) in shared memory by the whole
// block (blockDim a multiple of 32). Starts and ends with a block barrier.
__device__ void block_exclusive_scan(long long* v, int len) {
  __shared__ long long warp_sum[32];
  __syncthreads();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  const int per = (len + blockDim.x - 1) / blockDim.x;
  const int lo = min(len, t * per), hi = min(len, lo + per);
  long long own = 0;
  for (int j = lo; j < hi; ++j) own += v[j];
  long long x = own;                       // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(repro::kFullMask, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < nwarps ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(repro::kFullMask, w, d);
      if (lane >= d) w += y;
    }
    warp_sum[lane] = w;                    // inclusive over the warps
  }
  __syncthreads();
  long long run = x - own + (warp ? warp_sum[warp - 1] : 0);
  for (int j = lo; j < hi; ++j) {
    const long long c = v[j];
    v[j] = run;
    run += c;
  }
  __syncthreads();
}

// From the per-key totals in cnt (shared, overwritten by the group sizes):
// the counts; the groups, each count rounded up to ``align`` and laid out
// in key order with the running sum clamped at pool_rows (offs, shared),
// or with ``uniform`` each pool_rows / num_local rows at k times that; the
// drops, the local pairs past their group's size. Writes counts,
// group_sizes, drops and, if given, the offsets to device memory. Starts
// and ends with a block barrier.
__device__ void key_phase(int* cnt, long long* offs, int num_local, long long pool_rows,
                          int align, int uniform, long long* counts, int* group_sizes,
                          long long* drops, long long* offs_out) {
  __shared__ unsigned long long dropped;
  __syncthreads();
  if (threadIdx.x == 0) dropped = 0;
  const long long cap = pool_rows / num_local;
  for (int k = threadIdx.x; k < num_local; k += blockDim.x) {
    const long long c = cnt[k];
    counts[k] = c;
    offs[k] = uniform ? cap : (c + align - 1) / align * align;
  }
  block_exclusive_scan(offs, num_local);
  unsigned long long mine = 0;
  for (int k = threadIdx.x; k < num_local; k += blockDim.x) {
    const long long c = cnt[k];
    const long long start = min(offs[k], pool_rows);
    const long long g =
        uniform ? cap : min(offs[k] + (c + align - 1) / align * align, pool_rows) - start;
    offs[k] = start;
    cnt[k] = (int)g;
    group_sizes[k] = (int)g;
    if (offs_out) offs_out[k] = start;
    mine += (unsigned long long)(c - min(c, g));
  }
  if (mine) atomicAdd(&dropped, mine);
  __syncthreads();
  if (threadIdx.x == 0) *drops = (long long)dropped;
  __syncthreads();
}

// ---- one block: the three steps with barriers between them ----------------

__global__ void __launch_bounds__(1024)
plan_single_kernel(const long long* __restrict__ ids, long long n, long long offset,
                   int num_local, long long pool_rows, int align, int uniform, int iters,
                   long long* __restrict__ slot, unsigned char* __restrict__ valid,
                   long long* __restrict__ counts, int* __restrict__ group_sizes,
                   long long* __restrict__ drops, long long* __restrict__ inv_pair,
                   unsigned char* __restrict__ pool_valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* offs = reinterpret_cast<long long*>(smem);
  int* gsz = reinterpret_cast<int*>(offs + num_local);
  int* rows = gsz + num_local;                         // [warps][num_local]
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int j = threadIdx.x; j < nwarps * num_local; j += blockDim.x) rows[j] = 0;
  for (long long r = threadIdx.x; r < pool_rows; r += blockDim.x) {
    inv_pair[r] = 0;
    pool_valid[r] = 0;
  }
  __syncthreads();
  warp_count(ids, n, offset, num_local, (long long)warp * 32 * iters, iters,
             rows + warp * num_local);
  __syncthreads();
  for (int k = threadIdx.x; k < num_local; k += blockDim.x) {
    int run = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int c = rows[w * num_local + k];
      rows[w * num_local + k] = run;
      run += c;
    }
    gsz[k] = run;
  }
  key_phase(gsz, offs, num_local, pool_rows, align, uniform, counts, group_sizes, drops,
            nullptr);
  warp_rank(ids, n, offset, num_local, (long long)warp * 32 * iters, iters,
            rows + warp * num_local, offs, gsz, pool_rows, slot, valid, inv_pair, pool_valid);
}

// ---- three launches: count, scan, rank ------------------------------------

__global__ void __launch_bounds__(kWarps * 32)
plan_count_kernel(const long long* __restrict__ ids, long long n, long long offset,
                  int num_local, int iters, long long warps, int* __restrict__ bases,
                  long long pool_rows, long long* __restrict__ inv_pair,
                  unsigned char* __restrict__ pool_valid) {
  extern __shared__ int count_rows[];                  // [kWarps][num_local]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* row = count_rows + warp * num_local;
  for (int k = lane; k < num_local; k += 32) row[k] = 0;
  // clear the inverse map, which the rank launch fills
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < pool_rows;
       r += (long long)gridDim.x * blockDim.x) {
    inv_pair[r] = 0;
    pool_valid[r] = 0;
  }
  __syncwarp();
  const long long w = (long long)blockIdx.x * kWarps + warp;
  if (w >= warps) return;
  warp_count(ids, n, offset, num_local, w * 32 * iters, iters, row);
  __syncwarp();
  for (int k = lane; k < num_local; k += 32) bases[w * num_local + k] = row[k];
}

__global__ void __launch_bounds__(kScanThreads)
plan_scan_kernel(long long warps, int num_local, long long pool_rows, int align, int uniform,
                 int* __restrict__ bases, long long* __restrict__ offs_out,
                 long long* __restrict__ counts, int* __restrict__ group_sizes,
                 long long* __restrict__ drops) {
  // the warps are cut into ``segs`` segments per key; a thread owns one
  // (segment, key) pair, so the block reads the rows in a few sweeps
  __shared__ int seg_sum[kScanThreads];
  __shared__ int cnt[kMaxLocal];
  __shared__ long long offs[kMaxLocal];
  const int segs = max(1, (int)blockDim.x / num_local);
  const long long per = (warps + segs - 1) / segs;
  for (int j = threadIdx.x; j < segs * num_local; j += blockDim.x) {
    const int k = j % num_local;
    const long long lo = (j / num_local) * per, hi = min(warps, lo + per);
    int s = 0;
    for (long long w = lo; w < hi; ++w) s += bases[w * num_local + k];
    seg_sum[j] = s;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < num_local; k += blockDim.x) {
    int run = 0;
    for (int g = 0; g < segs; ++g) {
      const int c = seg_sum[g * num_local + k];
      seg_sum[g * num_local + k] = run;
      run += c;
    }
    cnt[k] = run;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < segs * num_local; j += blockDim.x) {
    const int k = j % num_local;
    const long long lo = (j / num_local) * per, hi = min(warps, lo + per);
    int run = seg_sum[j];
    for (long long w = lo; w < hi; ++w) {
      const int c = bases[w * num_local + k];
      bases[w * num_local + k] = run;
      run += c;
    }
  }
  key_phase(cnt, offs, num_local, pool_rows, align, uniform, counts, group_sizes, drops,
            offs_out);
}

__global__ void __launch_bounds__(kWarps * 32)
plan_rank_kernel(const long long* __restrict__ ids, long long n, long long offset,
                 int num_local, int iters, long long warps, const int* __restrict__ bases,
                 const long long* __restrict__ offs_in, const int* __restrict__ gsz_in,
                 long long pool_rows, long long* __restrict__ slot,
                 unsigned char* __restrict__ valid, long long* __restrict__ inv_pair,
                 unsigned char* __restrict__ pool_valid) {
  extern __shared__ __align__(16) unsigned char rank_smem[];
  long long* offs = reinterpret_cast<long long*>(rank_smem);
  int* gsz = reinterpret_cast<int*>(offs + num_local);
  int* runs = gsz + num_local;                         // [kWarps][num_local]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < num_local; k += blockDim.x) {
    offs[k] = offs_in[k];
    gsz[k] = gsz_in[k];
  }
  const long long w = (long long)blockIdx.x * kWarps + warp;
  int* run = runs + warp * num_local;
  if (w < warps)
    for (int k = lane; k < num_local; k += 32) run[k] = bases[w * num_local + k];
  __syncthreads();
  if (w >= warps) return;
  warp_rank(ids, n, offset, num_local, w * 32 * iters, iters, run, offs, gsz, pool_rows, slot,
            valid, inv_pair, pool_valid);
}

}  // namespace

REPRO_API int repro_dispatch_plan_max_local() { return kMaxLocal; }

// ids: n int64 expert ids of the (token, k) pairs in flat order. Outputs
// (device memory, all overwritten): slot, inv_pair (int64), valid,
// pool_valid (bool as bytes), counts (num_local int64), group_sizes
// (num_local int32), drops (one int64). ``uniform``: every group holds
// pool_rows / num_local rows (``align`` unused). With ``single`` the plan is one
// launch of one block (``iters`` and the scratch unused); else three
// launches over warps of 32 * iters ids each, with ``scratch`` holding
// 2 * num_local + warps * num_local ints (the offsets as int64, then each
// warp's row of key counts). Returns a CUDA error code (invalid value for
// arguments out of range or a scratch too small).
REPRO_API int repro_dispatch_plan(const long long* ids, long long n, long long offset,
                                  int num_local, long long pool_rows, int align, int uniform,
                                  int single, int iters, int* scratch, long long scratch_ints,
                                  long long* slot, unsigned char* valid, long long* counts,
                                  int* group_sizes, long long* drops, long long* inv_pair,
                                  unsigned char* pool_valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_local < 1 || num_local > kMaxLocal || align < 1 || pool_rows < 0 || n < 0 ||
      n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (single) {
    int nwarps = kSingleCountInts / num_local;
    nwarps = nwarps > 32 ? 32 : (nwarps < 1 ? 1 : nwarps);
    const long long per_warp = (n + 32ll * nwarps - 1) / (32ll * nwarps);
    const int it = per_warp < 1 ? 1 : (int)per_warp;
    const size_t smem = sizeof(long long) * num_local + sizeof(int) * num_local
                        + sizeof(int) * (size_t)nwarps * num_local;
    plan_single_kernel<<<1, nwarps * 32, smem, s>>>(ids, n, offset, num_local, pool_rows, align,
                                                    uniform, it, slot, valid, counts,
                                                    group_sizes, drops, inv_pair, pool_valid);
    return (int)cudaGetLastError();
  }
  if (iters < 1 || n == 0) return (int)cudaErrorInvalidValue;
  const long long warps = (n + 32ll * iters - 1) / (32ll * iters);
  if (scratch_ints < 2ll * num_local + warps * num_local) return (int)cudaErrorInvalidValue;
  long long* offs = reinterpret_cast<long long*>(scratch);
  int* bases = scratch + 2 * num_local;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  plan_count_kernel<<<blocks, kWarps * 32, sizeof(int) * kWarps * num_local, s>>>(
      ids, n, offset, num_local, iters, warps, bases, pool_rows, inv_pair, pool_valid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  plan_scan_kernel<<<1, kScanThreads, 0, s>>>(warps, num_local, pool_rows, align, uniform, bases,
                                              offs, counts, group_sizes, drops);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(long long) * num_local + sizeof(int) * num_local
                      + sizeof(int) * kWarps * num_local;
  plan_rank_kernel<<<blocks, kWarps * 32, smem, s>>>(ids, n, offset, num_local, iters, warps,
                                                     bases, offs, group_sizes, pool_rows, slot,
                                                     valid, inv_pair, pool_valid);
  return (int)cudaGetLastError();
}
