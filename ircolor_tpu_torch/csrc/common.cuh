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

// The IN backward of one element, rounded like the plain version: every
// step is its own f32 rounding (no FMA contraction).
__device__ __forceinline__ float in_bwd(float pv, float cv, float m, float iv,
                                        float gm, float gy) {
  const float n = __fmul_rn(__fsub_rn(cv, m), iv);
  return __fmul_rn(iv, __fsub_rn(__fsub_rn(pv, gm), __fmul_rn(n, gy)));
}

// 8 consecutive per-channel parameters (32-byte aligned) into registers.
__device__ __forceinline__ void load8(const float* src, float (&dst)[8]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(src + 4));
  dst[0] = lo.x; dst[1] = lo.y; dst[2] = lo.z; dst[3] = lo.w;
  dst[4] = hi.x; dst[5] = hi.y; dst[6] = hi.z; dst[7] = hi.w;
}

// The IN backward's per-channel parameters for 8 consecutive channels.
struct InBwd8 {
  float m[8], iv[8], gm[8], gy[8];
  __device__ __forceinline__ void load(const float* m_, const float* iv_,
                                       const float* gm_, const float* gy_) {
    load8(m_, m);
    load8(iv_, iv);
    load8(gm_, gm);
    load8(gy_, gy);
  }
  // 8 bf16 of p and comp (16 bytes each) -> 8 bf16 dy. mask_p: p is the
  // cotangent after a ReLU of n, kept where comp > m (n > 0, as inv > 0).
  __device__ __forceinline__ uint4 apply(uint4 p4, uint4 c4, bool mask_p) const {
    const uint32_t pw[4] = {p4.x, p4.y, p4.z, p4.w};
    const uint32_t cw[4] = {c4.x, c4.y, c4.z, c4.w};
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 2 * e;
      const float c0 = bf16_lo(cw[e]), c1 = bf16_hi(cw[e]);
      float p0 = bf16_lo(pw[e]), p1 = bf16_hi(pw[e]);
      if (mask_p) {
        p0 = c0 > m[k] ? p0 : 0.f;
        p1 = c1 > m[k + 1] ? p1 : 0.f;
      }
      const float t0 = in_bwd(p0, c0, m[k], iv[k], gm[k], gy[k]);
      const float t1 = in_bwd(p1, c1, m[k + 1], iv[k + 1], gm[k + 1], gy[k + 1]);
      o[e] = pack_bf16x2(t0, t1);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
};

// m16n8k16 bf16 mma.sync, f32 accumulators (the dgrad's fold-line kernel).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace ircolor
