// Helpers shared by the port's Hopper kernels (sm_90a). Plain C interface:
// every launch function takes raw device pointers and a cudaStream_t passed
// as void*, launches on that stream, never synchronizes, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ircolor {

// PyTorch ReflectionPad index map (edge pixel excluded): -k -> k,
// n-1+k -> n-1-k. The final clamp only matters for indices that feed
// masked-out (out-of-image) outputs of a partial tile.
__device__ __forceinline__ int reflect_index(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// Two floats -> packed bf16x2, round to nearest even (as XLA's astype).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

}  // namespace ircolor
