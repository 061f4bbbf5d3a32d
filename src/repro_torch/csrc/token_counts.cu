// Stage-2 token counting (paper §3.1): the histogram of routed expert ids
// over one rank's local expert range [offset, offset + num_local).
//
// Replaces src/repro/kernels/moe_dispatch.py::token_counts_pallas
// (_count_kernel). The TPU has no atomics, so the Pallas kernel forms a
// one-hot (num_local x tile) matrix per grid step and adds its row sums into
// an output block revisited by the sequential grid. Hopper has fast
// shared-memory atomics and runs blocks in parallel, so this is the paper's
// GPU kernel instead: a grid-stride loop over the flat ids, per-block
// counters in shared memory, and one global atomicAdd per non-empty bin into
// the zeroed output. Integer atomics commute, so the counts are the same on
// every run. Ids outside the range count nowhere.
//
// What bounds it on an H100: bytes, and at the main path's sizes (8 to
// 65,536 ids) mostly the launch itself: the ids are read once (8 bytes each
// for the router's int64), the counts written once. Lanes of a warp that
// hold the same id are merged first (__match_any_sync), so a skewed routing,
// every id one expert at worst, costs one shared atomic per warp and id, not
// one per lane.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 4;

__global__ void __launch_bounds__(kThreads)
token_counts_kernel(const long long* __restrict__ ids, long long n, long long offset, int num_local,
                    int* __restrict__ counts) {
  extern __shared__ int bins[];
  for (int b = threadIdx.x; b < num_local; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the loop bound is uniform across the block, so every lane of a warp takes
  // every iteration and the full-mask match below is legal
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n; base += stride) {
    const long long i = base + threadIdx.x;
    int key = -1;
    if (i < n) {
      const long long local = ids[i] - offset;
      if (local >= 0 && local < num_local) key = (int)local;
    }
    const unsigned same = __match_any_sync(repro::kFullMask, key);
    if (key >= 0 && lane == __ffs(same) - 1) atomicAdd(&bins[key], __popc(same));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_local; b += blockDim.x)
    if (bins[b]) atomicAdd(&counts[b], bins[b]);
}

}  // namespace

// ids: n int64 on the device; counts: num_local int32 on the device,
// overwritten. num_local may be at most 48 KB / 4 = 12,288 (the bins fill the
// shared memory a block gets without opting in to more; the launcher checks).
// Zeroes counts, then launches.
REPRO_API int repro_token_counts(const long long* ids, long long n, long long offset,
                                 int num_local, int* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)num_local, s);
  if (err != cudaSuccess || n <= 0) return (int)err;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const size_t smem = sizeof(int) * (size_t)num_local;
  token_counts_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(ids, n, offset, num_local, counts);
  return (int)cudaGetLastError();
}
