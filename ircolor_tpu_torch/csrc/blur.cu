// Fused down-stage tail of the generator for Hopper (sm_90a):
// instance-norm normalize + ReLU + ReflectionPad(1) + [1,2,1]x[1,2,1]/16
// blur-pool at stride 2.
//
// Replaces ircolor_tpu/ops/pallas_blur.py:norm_relu_blur_down_pallas
// (_kernel_norm, pallas_call at :247).
//
//   z[r, c]   = relu((x[r, c] - mean) * inv)           (f32)
//   v[i, c]   = (z[2i-1, c] + 2 z[2i, c]) + z[2i+1, c]  (row -1 reflects to 1)
//   out[i, j] = bf16(((v[i, 2j-1] + 2 v[i, 2j]) + v[i, 2j+1]) / 16)
//
// The additions run in the JAX kernel's order, so the f32 value before the
// bf16 store is the same sum. With even H and W the stride-2 window never
// reads past the bottom or right edge: only row/column -1 reflect.
//
// What bounds it on the H100: device memory. It reads the conv output once
// (2 bytes per element) and writes a quarter of that, with 13 flops per
// output element. At the flagship down1 tail that is 2.7 GB in, 0.67 GB out.
//
// Design: one thread per output pixel and 8-channel group (one 16-byte
// load per input pixel); consecutive threads take consecutive channel
// groups, so every load and store is coalesced. The nine input pixels of a
// window overlap their neighbours' and are served from L1/L2, so device
// memory sees each input byte about once. The normalize never reaches
// device memory.
#include "common.cuh"

namespace ircolor {
namespace {

constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
    norm_relu_blur_down_kernel(const __nv_bfloat16* __restrict__ x,
                               const float* __restrict__ mean,
                               const float* __restrict__ inv,
                               __nv_bfloat16* __restrict__ out, int B, int H,
                               int W, int C) {
  const int C8 = C >> 3, H2 = H >> 1, W2 = W >> 1;
  const long long total = (long long)B * H2 * W2 * C8;
  const long long idx = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (idx >= total) return;
  const int cg = (int)(idx % C8);
  long long rest = idx / C8;
  const int j = (int)(rest % W2);
  rest /= W2;
  const int i = (int)(rest % H2);
  const int b = (int)(rest / H2);
  const int c = cg * 8;

  float m[8], iv[8];
  {
    const float4* mp = reinterpret_cast<const float4*>(mean + (size_t)b * C + c);
    const float4* ip = reinterpret_cast<const float4*>(inv + (size_t)b * C + c);
    const float4 m0 = __ldg(mp), m1 = __ldg(mp + 1);
    const float4 i0 = __ldg(ip), i1 = __ldg(ip + 1);
    m[0] = m0.x; m[1] = m0.y; m[2] = m0.z; m[3] = m0.w;
    m[4] = m1.x; m[5] = m1.y; m[6] = m1.z; m[7] = m1.w;
    iv[0] = i0.x; iv[1] = i0.y; iv[2] = i0.z; iv[3] = i0.w;
    iv[4] = i1.x; iv[5] = i1.y; iv[6] = i1.z; iv[7] = i1.w;
  }
  const int rows[3] = {i == 0 ? 1 : 2 * i - 1, 2 * i, 2 * i + 1};
  const int cols[3] = {j == 0 ? 1 : 2 * j - 1, 2 * j, 2 * j + 1};
  const __nv_bfloat16* xb = x + (size_t)b * H * W * C + c;

  float v[3][8];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    float z[3][8];
#pragma unroll
    for (int rr = 0; rr < 3; ++rr) {
      const uint4 raw = ldg16(xb + ((size_t)rows[rr] * W + cols[q]) * C);
      const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        z[rr][2 * e] = fmaxf((bf16_lo(w4[e]) - m[2 * e]) * iv[2 * e], 0.f);
        z[rr][2 * e + 1] =
            fmaxf((bf16_hi(w4[e]) - m[2 * e + 1]) * iv[2 * e + 1], 0.f);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) v[q][k] = (z[0][k] + 2.f * z[1][k]) + z[2][k];
  }
  float o[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) o[k] = ((v[0][k] + 2.f * v[1][k]) + v[2][k]) * 0.0625f;
  const uint4 packed = make_uint4(pack_bf16x2(o[0], o[1]), pack_bf16x2(o[2], o[3]),
                                  pack_bf16x2(o[4], o[5]), pack_bf16x2(o[6], o[7]));
  *reinterpret_cast<uint4*>(out + (((size_t)b * H2 + i) * W2 + j) * C + c) = packed;
}

}  // namespace
}  // namespace ircolor

extern "C" int ircolor_norm_relu_blur_down(const void* x, const void* mean,
                                           const void* inv, void* out, int B,
                                           int H, int W, int C, void* stream) {
  using namespace ircolor;
  const long long total = (long long)B * (H / 2) * (W / 2) * (C / 8);
  const unsigned int blocks = (unsigned int)((total + NTHREADS - 1) / NTHREADS);
  norm_relu_blur_down_kernel<<<blocks, NTHREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(inv), static_cast<__nv_bfloat16*>(out), B, H, W,
      C);
  return (int)cudaGetLastError();
}
