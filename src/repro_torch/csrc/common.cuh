// Shared helpers for the port's CUDA kernels (sm_90a, bf16 in and out).
//
// Every kernel file exposes plain C entry points (REPRO_API) that launch on
// the caller's stream and return cudaGetLastError() as an int, so that the
// ctypes wrapper in kernels/_build.py raises on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

namespace repro {

using bf16 = __nv_bfloat16;

constexpr unsigned kFullMask = 0xffffffffu;

// 16-byte (8 x bf16) read-only load; the address must be 16-byte aligned.
__device__ __forceinline__ uint4 load_vec8(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void store_vec8(bf16* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ uint4 zero_vec8() { return make_uint4(0u, 0u, 0u, 0u); }

// Unpack 8 bf16 values to float.
__device__ __forceinline__ void unpack8(uint4 v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

// Round 8 floats to bf16 (round to nearest even) and pack them.
__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return v;
}

}  // namespace repro
