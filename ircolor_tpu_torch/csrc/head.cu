// Fused 7x7 output head of the generator for Hopper (sm_90a): up2's
// instance-norm normalize + ReLU, ReflectionPad(3) and the 7x7 conv to 3
// channels with f32 accumulation. The caller adds the bias and the tanh.
// The int8 form (conv7x7_head_q_kernel) is described at its definition.
//
// Replaces ircolor_tpu/ops/pallas_head.py:conv7x7_head_pallas with
// quant=False (_kernel_head, pallas_call at :366).
//
//   z   = bf16(relu((x - mean) * inv))        (rounded as the JAX kernel does)
//   out = bf16(sum_{dy,dx,c} z[r+dy-3, c+dx-3, c] * k[dy, dx, c, co])
//
// What bounds it on the H100: the FP32 pipes. Cout = 3 fills no MMA tile,
// so each of the 196 GFLOP of the flagship head (32x512x640, 64 -> 3) is a
// scalar FMA; the input is read once (1.3 GB) and the output is 3 channels.
//
// Design: a block owns a 16 x 128 output tile of one image. Per chunk of 8
// input channels it stages the (16+6) x (128+6) input window in shared
// memory, normalized, ReLU'd and rounded to bf16, with the 3-pixel reflect
// halo built in the index map (no padded tensor exists). The whole weight
// tensor (f32) sits in shared memory and is read as warp-wide broadcasts.
// Each thread owns 8 vertically adjacent pixels of one column: for each
// (channel pair, dx) it loads a 14-row column strip once (neighbouring
// threads read neighbouring words: no bank conflicts) and reuses it for all
// seven dy taps, 336 FMAs per 14 loads.
#include "common.cuh"

namespace ircolor {
namespace {

constexpr int KS = 7;
constexpr int HALO = 3;
constexpr int TH = 16;              // output rows per block
constexpr int TWC = 128;            // output cols per block (one per thread)
constexpr int PR = TH + 2 * HALO;   // staged rows (22)
constexpr int PC = TWC + 2 * HALO;  // staged cols (134)
constexpr int CC = 8;               // input channels per chunk
constexpr int NPAIR = CC / 2;
constexpr int PIX = 8;              // output rows per thread
constexpr int NTHREADS = 256;
constexpr int TILE_BYTES = NPAIR * PR * PC * 4;
constexpr int COUT = 3;

__global__ void __launch_bounds__(NTHREADS)
    conv7x7_head_kernel(const __nv_bfloat16* __restrict__ x,
                        const float* __restrict__ mean,
                        const float* __restrict__ inv,
                        const float* __restrict__ w,  // (7, 7, C, 3)
                        __nv_bfloat16* __restrict__ out, int H, int W, int C) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem);  // [NPAIR][PR][PC] bf16x2
  float* sw = reinterpret_cast<float*>(smem + TILE_BYTES);

  const int tid = threadIdx.x, tx = tid % TWC, tg = tid / TWC;
  const int b = blockIdx.z, r0 = blockIdx.y * TH, c0 = blockIdx.x * TWC;
  const __nv_bfloat16* xb = x + (size_t)b * H * W * C;

  for (int i = tid; i < KS * KS * C * COUT; i += NTHREADS) sw[i] = w[i];

  float acc[PIX][COUT];
#pragma unroll
  for (int p = 0; p < PIX; ++p)
#pragma unroll
    for (int o = 0; o < COUT; ++o) acc[p][o] = 0.f;

  for (int k = 0; k < C / CC; ++k) {
    float m[CC], iv[CC];
#pragma unroll
    for (int e = 0; e < CC; ++e) {
      m[e] = __ldg(mean + (size_t)b * C + k * CC + e);
      iv[e] = __ldg(inv + (size_t)b * C + k * CC + e);
    }
    __syncthreads();  // the previous chunk's reads of `tile` are done
    for (int px = tid; px < PR * PC; px += NTHREADS) {
      const int pr = px / PC, pc = px - pr * PC;
      const int r = reflect_index(r0 - HALO + pr, H);
      const int c = reflect_index(c0 - HALO + pc, W);
      const uint4 raw = ldg16(xb + ((size_t)r * W + c) * C + k * CC);
      const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int q = 0; q < NPAIR; ++q) {
        const float lo = fmaxf((bf16_lo(w4[q]) - m[2 * q]) * iv[2 * q], 0.f);
        const float hi = fmaxf((bf16_hi(w4[q]) - m[2 * q + 1]) * iv[2 * q + 1], 0.f);
        tile[(q * PR + pr) * PC + pc] = pack_bf16x2(lo, hi);
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int q = 0; q < NPAIR; ++q) {
      const int ch = k * CC + 2 * q;
      const uint32_t* col = tile + (q * PR + tg * PIX) * PC + tx;
#pragma unroll 1
      for (int dx = 0; dx < KS; ++dx) {
        float2 v[PIX + KS - 1];
#pragma unroll
        for (int i = 0; i < PIX + KS - 1; ++i) {
          const uint32_t word = col[i * PC + dx];
          v[i] = make_float2(bf16_lo(word), bf16_hi(word));
        }
#pragma unroll
        for (int dy = 0; dy < KS; ++dy) {
          const float* wp = sw + ((dy * KS + dx) * C + ch) * COUT;
          const float w00 = wp[0], w01 = wp[1], w02 = wp[2];
          const float w10 = wp[3], w11 = wp[4], w12 = wp[5];
#pragma unroll
          for (int p = 0; p < PIX; ++p) {
            const float2 z = v[p + dy];
            acc[p][0] = fmaf(z.y, w10, fmaf(z.x, w00, acc[p][0]));
            acc[p][1] = fmaf(z.y, w11, fmaf(z.x, w01, acc[p][1]));
            acc[p][2] = fmaf(z.y, w12, fmaf(z.x, w02, acc[p][2]));
          }
        }
      }
    }
  }

  const int c = c0 + tx;
  if (c >= W) return;
#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    const int r = r0 + tg * PIX + p;
    if (r >= H) break;
    __nv_bfloat16* o = out + (((size_t)b * H + r) * W + c) * COUT;
#pragma unroll
    for (int co = 0; co < COUT; ++co) o[co] = __float2bfloat16_rn(acc[p][co]);
  }
}

// int8 form (kernel 4q): replaces conv7x7_head_pallas with quant=True
// (outc_head_q, ircolor_tpu/ops/pallas_head.py:445; the quant branches of
// _kernel_head, the same pallas_call at :366).
//
//   z   = relu((x - mean) * inv)                    (f32, not rounded)
//   q   = min(rint(z * 127/6), 127)                 (the fixed 127/6 grid)
//   acc = sum_{dy,dx,c} q[r+dy-3, c+dx-3, c] * kq[dy, dx, c, co]   (int32)
//   out = bf16(f32(acc) * sc[co]),  sc = 6/127 * sw[co]
// Each step is one IEEE operation, so the kernel equals its plain version
// bit for bit.
//
// What bounds it on the H100: the memory (the 64-channel bf16 input, read
// once, is ~21x the 3-channel output) -- if the integer pipes keep up: with
// Cout = 3 no MMA tile fills, so the products run on __dp4a (4 int8 MACs per
// instruction) instead of the float form's scalar FMAs.
//
// Design: the float form's (16 x 128 tiles, 8 pixels of one column a
// thread, a 14-row strip reused for all seven dy taps), on int8 words: per
// chunk of 16 input channels the block stages the (16+6) x (128+6) window
// quantized to int8, 4 channels to a 32-bit word, with the reflect halo in
// the index map; the int8 weights sit in shared memory as the same words.
constexpr int CCQ = 16;           // input channels per chunk
constexpr int NQ = CCQ / 4;       // int8x4 words per pixel and chunk
constexpr int TILE_Q_BYTES = NQ * PR * PC * 4;
constexpr float QFIXED = 127.0f / 6.0f;

__device__ __forceinline__ int quant_fixed(float v, float m, float iv) {
  const float z = fmaxf(__fmul_rn(__fsub_rn(v, m), iv), 0.f);
  return min(__float2int_rn(__fmul_rn(z, QFIXED)), 127);
}

__global__ void __launch_bounds__(NTHREADS)
    conv7x7_head_q_kernel(const __nv_bfloat16* __restrict__ x,
                          const float* __restrict__ mean,
                          const float* __restrict__ inv,
                          const int* __restrict__ wq,  // (7, 7, C/4, 3) int8x4
                          const float* __restrict__ sc,  // (3)
                          __nv_bfloat16* __restrict__ out, int H, int W, int C) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* tile = reinterpret_cast<int*>(smem);  // [NQ][PR][PC] int8x4
  int* sw = reinterpret_cast<int*>(smem + TILE_Q_BYTES);
  const int C4 = C / 4;

  const int tid = threadIdx.x, tx = tid % TWC, tg = tid / TWC;
  const int b = blockIdx.z, r0 = blockIdx.y * TH, c0 = blockIdx.x * TWC;
  const __nv_bfloat16* xb = x + (size_t)b * H * W * C;

  for (int i = tid; i < KS * KS * C4 * COUT; i += NTHREADS) sw[i] = wq[i];

  int acc[PIX][COUT];
#pragma unroll
  for (int p = 0; p < PIX; ++p)
#pragma unroll
    for (int o = 0; o < COUT; ++o) acc[p][o] = 0;

  for (int k = 0; k < C / CCQ; ++k) {
    float m[CCQ], iv[CCQ];
#pragma unroll
    for (int e = 0; e < CCQ; ++e) {
      m[e] = __ldg(mean + (size_t)b * C + k * CCQ + e);
      iv[e] = __ldg(inv + (size_t)b * C + k * CCQ + e);
    }
    __syncthreads();  // the previous chunk's reads of `tile` are done
    for (int px = tid; px < PR * PC; px += NTHREADS) {
      const int pr = px / PC, pc = px - pr * PC;
      const int r = reflect_index(r0 - HALO + pr, H);
      const int c = reflect_index(c0 - HALO + pc, W);
      const __nv_bfloat16* src = xb + ((size_t)r * W + c) * C + k * CCQ;
      const uint4 lo8 = ldg16(src), hi8 = ldg16(src + 8);
      const uint32_t w8[8] = {lo8.x, lo8.y, lo8.z, lo8.w, hi8.x, hi8.y, hi8.z, hi8.w};
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int e = 4 * q;
        const int q0 = quant_fixed(bf16_lo(w8[2 * q]), m[e], iv[e]);
        const int q1 = quant_fixed(bf16_hi(w8[2 * q]), m[e + 1], iv[e + 1]);
        const int q2 = quant_fixed(bf16_lo(w8[2 * q + 1]), m[e + 2], iv[e + 2]);
        const int q3 = quant_fixed(bf16_hi(w8[2 * q + 1]), m[e + 3], iv[e + 3]);
        tile[(q * PR + pr) * PC + pc] = q0 | (q1 << 8) | (q2 << 16) | (q3 << 24);
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int q = 0; q < NQ; ++q) {
      const int* col = tile + (q * PR + tg * PIX) * PC + tx;
#pragma unroll 1
      for (int dx = 0; dx < KS; ++dx) {
        int v[PIX + KS - 1];
#pragma unroll
        for (int i = 0; i < PIX + KS - 1; ++i) v[i] = col[i * PC + dx];
#pragma unroll
        for (int dy = 0; dy < KS; ++dy) {
          const int* wp = sw + ((dy * KS + dx) * C4 + k * NQ + q) * COUT;
          const int w0 = wp[0], w1 = wp[1], w2 = wp[2];
#pragma unroll
          for (int p = 0; p < PIX; ++p) {
            acc[p][0] = __dp4a(v[p + dy], w0, acc[p][0]);
            acc[p][1] = __dp4a(v[p + dy], w1, acc[p][1]);
            acc[p][2] = __dp4a(v[p + dy], w2, acc[p][2]);
          }
        }
      }
    }
  }

  const int c = c0 + tx;
  if (c >= W) return;
  const float s[COUT] = {sc[0], sc[1], sc[2]};
#pragma unroll
  for (int p = 0; p < PIX; ++p) {
    const int r = r0 + tg * PIX + p;
    if (r >= H) break;
    __nv_bfloat16* o = out + (((size_t)b * H + r) * W + c) * COUT;
#pragma unroll
    for (int co = 0; co < COUT; ++co) {
      o[co] = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc[p][co]), s[co]));
    }
  }
}

}  // namespace
}  // namespace ircolor

extern "C" {

int ircolor_conv7x7_head_smem_bytes(int C) {
  return ircolor::TILE_BYTES + ircolor::KS * ircolor::KS * C * ircolor::COUT * 4;
}

int ircolor_conv7x7_head_q_smem_bytes(int C) {
  return ircolor::TILE_Q_BYTES + ircolor::KS * ircolor::KS * (C / 4) * ircolor::COUT * 4;
}

// int8 form: wq is the (7, 7, C, 3) int8 kernel laid out as (7, 7, C/4, 3)
// words of 4 consecutive input channels; sc the (3,) dequant scale.
// C % 16 == 0 (checked by the Python wrapper).
int ircolor_conv7x7_head_q(const void* x, const void* mean, const void* inv,
                           const void* wq, const void* sc, void* out, int B,
                           int H, int W, int C, void* stream) {
  using namespace ircolor;
  const int smem = ircolor_conv7x7_head_q_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      conv7x7_head_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TWC - 1) / TWC, (H + TH - 1) / TH, B);
  conv7x7_head_q_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(inv), static_cast<const int*>(wq),
      static_cast<const float*>(sc), static_cast<__nv_bfloat16*>(out), H, W, C);
  return (int)cudaGetLastError();
}

int ircolor_conv7x7_head(const void* x, const void* mean, const void* inv,
                         const void* w, void* out, int B, int H, int W, int C,
                         void* stream) {
  using namespace ircolor;
  const int smem = ircolor_conv7x7_head_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      conv7x7_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TWC - 1) / TWC, (H + TH - 1) / TH, B);
  conv7x7_head_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(inv), static_cast<const float*>(w),
      static_cast<__nv_bfloat16*>(out), H, W, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
