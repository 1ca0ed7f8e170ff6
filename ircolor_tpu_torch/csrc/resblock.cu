// Fused reflect-padded 3x3 conv of the generator's resnet blocks, bf16 and
// int8, for Hopper (sm_90a).
//
// Replaces (ircolor_tpu/ops/pallas_resblock.py):
//   conv3x3_reflect_fused   (_kernel,   pallas_call at :358)  -> INT8=false
//   conv3x3_reflect_fused_q (_kernel_q, pallas_call at :1471) -> INT8=true
//
// What it computes, per image b and output channel co:
//   z   = x                                  (no stats given, bf16)
//       = relu((x - mean[c]) * inv[c])        (stats given: the previous
//                                              conv's IN + ReLU on load)
//   bf16: operand = bf16(z); int8 conv1: q = clamp(rint(x*qscale[b]),±127);
//   int8 conv2: q = min(rint(relu((x-mean)*inv) * 127/6), 127)
//   y   = ReflectPad(1) 3x3 conv, f32 (bf16) or s32 (int8) accumulation,
//         int8 dequantized by sc[b, co]
//   out = bf16(y); partial stats sum(y), sum(y^2) from the f32 value before
//         the bf16 store, one (b, tile) slot each, summed by the caller.
//
// What bounds it on the H100: the tensor cores. At the flagship bottleneck
// (32x128x160x256 -> 256) one conv is 0.77 TFLOP against 0.67 GB of
// activations in and out (~1150 flop/byte, far above the card's ridge
// point); the weights (1.2 MB) stay in L2 and are re-read by every block.
//
// Design:
// * Implicit GEMM on mma.sync (bf16 m16n8k16 / s8 m16n8k32). A block owns
//   an 8x16 output-pixel tile (M = 128) and 128 output channels (N); eight
//   warps of 32x64. K = 9 taps x C runs as chunks of 32 bytes of input
//   channels (16 bf16 / 32 int8).
// * Per chunk the block loads the (8+2)x(16+2) input patch once, with the
//   reflect halo built in the index map (row -1 = row 1, row H = row H-2,
//   same for columns: no padded tensor exists), applies normalize + ReLU or
//   the quantization while storing it to shared memory, and then runs all
//   nine taps out of it: a tap is only a shifted ldmatrix row address.
// * The byte layout of a 32-byte K row is the same for bf16 and int8, so
//   one ldmatrix.x4 address pattern feeds both mma shapes.
// * Two stages: the next chunk's weights arrive by cp.async and its patch
//   by register prefetch while the current chunk's MMAs run.
// * Stats are deterministic: per-(b, tile) partials in a fixed reduction
//   order, no float atomics.
#include <type_traits>

#include "common.cuh"

namespace ircolor {
namespace {

constexpr int TH = 8;                // output tile rows
constexpr int TW = 16;                // output tile cols (one m16 MMA row)
constexpr int PW = TW + 2;            // patch cols
constexpr int PROWS = (TH + 2) * PW;  // patch pixels (180)
constexpr int BN = 128;               // output channels per block
constexpr int ROWB = 32;              // bytes of K per shared-memory row
constexpr int NTHREADS = 256;
constexpr int PATCH_BYTES = PROWS * ROWB;
constexpr int W_BYTES = 9 * BN * ROWB;
constexpr int STAGE_BYTES = PATCH_BYTES + W_BYTES;
constexpr int SMEM_BYTES = 2 * STAGE_BYTES;
constexpr int PATCH_UNITS = PROWS * 2;  // 16-byte operand units per chunk
constexpr int UNITS_PER_THREAD = (PATCH_UNITS + NTHREADS - 1) / NTHREADS;
constexpr int W_UNITS = 9 * BN * 2;
constexpr float QFIXED = 127.0f / 6.0f;  // conv2's fixed 127/6-sigma grid

// Byte offset of 16-byte unit `chunk` (0/1) of shared row `row`. The XOR
// keeps any 8 consecutive rows of one ldmatrix on distinct banks.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * ROWB + ((chunk ^ ((row >> 2) & 1)) << 4);
}

__device__ __forceinline__ uint32_t pack_s8x4(int q0, int q1, int q2, int q3) {
  return (uint32_t)(q0 & 0xff) | ((uint32_t)(q1 & 0xff) << 8) |
         ((uint32_t)(q2 & 0xff) << 16) | ((uint32_t)(q3 & 0xff) << 24);
}

struct ConvArgs {
  const __nv_bfloat16* x;  // (B, H, W, C)
  const uint8_t* w;        // (C/KC, 9, Cout, 32 bytes)
  const float* mean;       // (B, C) or null
  const float* inv;        // (B, C) or null
  const float* qscale;     // (B,)   int8 conv1
  const float* sc;         // (B, Cout) int8 dequant scale
  __nv_bfloat16* out;      // (B, H, W, Cout)
  float* partial;          // (B, ntiles, 2, Cout)
  int B, H, W, C, Cout, ntw, ntiles;
};

template <bool INT8, bool NORM>
__global__ void __launch_bounds__(NTHREADS, 2)
    conv3x3_reflect_kernel(const ConvArgs p) {
  extern __shared__ __align__(128) uint8_t smem[];
  using Acc = typename std::conditional<INT8, int, float>::type;
  constexpr int KC = INT8 ? 32 : 16;  // input channels per chunk
  constexpr int RAW = INT8 ? 2 : 1;   // 16-byte global loads per unit

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int tile = blockIdx.x, co0 = blockIdx.y * BN, b = blockIdx.z;
  const int r0 = (tile / p.ntw) * TH, c0 = (tile % p.ntw) * TW;
  const int nchunks = p.C / KC;
  const __nv_bfloat16* xb = p.x + (size_t)b * p.H * p.W * p.C;
  float qs = 0.f;
  if constexpr (INT8 && !NORM) qs = p.qscale[b];

  // Each thread owns up to UNITS_PER_THREAD 16-byte operand units of the
  // patch: fixed pixel (reflected), fixed channel half, every chunk.
  int uoff[UNITS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < UNITS_PER_THREAD; ++i) {
    const int u = tid + i * NTHREADS;
    uoff[i] = -1;
    if (u < PATCH_UNITS) {
      const int prow = u >> 1, pr = prow / PW, pc = prow - pr * PW;
      const int r = reflect_index(r0 - 1 + pr, p.H);
      const int c = reflect_index(c0 - 1 + pc, p.W);
      uoff[i] = (r * p.W + c) * p.C + (u & 1) * (KC / 2);
    }
  }

  uint4 raw[UNITS_PER_THREAD][RAW];
  auto load_patch = [&](int j) {
#pragma unroll
    for (int i = 0; i < UNITS_PER_THREAD; ++i) {
      if (uoff[i] >= 0) {
        const __nv_bfloat16* src = xb + uoff[i] + j * KC;
        raw[i][0] = ldg16(src);
        if constexpr (INT8) raw[i][1] = ldg16(src + 8);
      }
    }
  };

  auto store_patch = [&](int j, int stage) {
    uint8_t* patch = smem + stage * STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < UNITS_PER_THREAD; ++i) {
      const int u = tid + i * NTHREADS;
      if (uoff[i] < 0) continue;
      const int cbase = j * KC + (u & 1) * (KC / 2);
      constexpr int NV = INT8 ? 16 : 8;
      float v[NV];
#pragma unroll
      for (int k = 0; k < RAW; ++k) {
        const uint32_t w4[4] = {raw[i][k].x, raw[i][k].y, raw[i][k].z,
                                raw[i][k].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[k * 8 + 2 * e] = bf16_lo(w4[e]);
          v[k * 8 + 2 * e + 1] = bf16_hi(w4[e]);
        }
      }
      if constexpr (NORM) {
        const float* mp = p.mean + (size_t)b * p.C + cbase;
        const float* ip = p.inv + (size_t)b * p.C + cbase;
#pragma unroll
        for (int e = 0; e < NV; e += 4) {
          const float4 m4 = __ldg(reinterpret_cast<const float4*>(mp + e));
          const float4 i4 = __ldg(reinterpret_cast<const float4*>(ip + e));
          v[e] = fmaxf((v[e] - m4.x) * i4.x, 0.f);
          v[e + 1] = fmaxf((v[e + 1] - m4.y) * i4.y, 0.f);
          v[e + 2] = fmaxf((v[e + 2] - m4.z) * i4.z, 0.f);
          v[e + 3] = fmaxf((v[e + 3] - m4.w) * i4.w, 0.f);
        }
      }
      uint4 o;
      if constexpr (INT8) {
        int q[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          if constexpr (NORM) {
            q[e] = min(__float2int_rn(v[e] * QFIXED), 127);
          } else {
            q[e] = max(-127, min(127, __float2int_rn(v[e] * qs)));
          }
        }
        o = make_uint4(pack_s8x4(q[0], q[1], q[2], q[3]),
                       pack_s8x4(q[4], q[5], q[6], q[7]),
                       pack_s8x4(q[8], q[9], q[10], q[11]),
                       pack_s8x4(q[12], q[13], q[14], q[15]));
      } else if constexpr (NORM) {
        o = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                       pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
      } else {
        o = raw[i][0];  // bf16 without normalize: the raw values as they are
      }
      *reinterpret_cast<uint4*>(patch + swz(u >> 1, u & 1)) = o;
    }
  };

  auto load_weights = [&](int j, int stage) {
    const uint32_t dst = smem_u32(smem + stage * STAGE_BYTES + PATCH_BYTES);
    const uint8_t* src = p.w + (size_t)j * 9 * p.Cout * ROWB;
    for (int v = tid; v < W_UNITS; v += NTHREADS) {
      const int tap = v / (BN * 2), rem = v - tap * (BN * 2);
      const int n = rem >> 1, ch = rem & 1;
      cp_async16(dst + swz(tap * BN + n, ch),
                 src + ((size_t)(tap * p.Cout + co0 + n)) * ROWB + ch * 16);
    }
    cp_async_commit();
  };

  Acc acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0;

  const int apix = (lane & 7) + ((lane >> 3) & 1) * 8;  // pixel in m16 row
  const int achunk = lane >> 4;
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bchunk = (lane >> 3) & 1;

  auto compute = [&](int stage) {
    const uint32_t pbase = smem_u32(smem + stage * STAGE_BYTES);
    const uint32_t wbase = pbase + PATCH_BYTES;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int prow = (2 * wm + mi + dy) * PW + apix + dx;
        ldmatrix_x4(a[mi], pbase + swz(prow, achunk));
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bq[4];
        const int nrow = tap * BN + wn * 64 + nj * 16 + brow;
        ldmatrix_x4(bq, wbase + swz(nrow, bchunk));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma(acc[mi][2 * nj], a[mi], bq[0], bq[1]);
          mma(acc[mi][2 * nj + 1], a[mi], bq[2], bq[3]);
        }
      }
    }
  };

  // Prologue: chunk 0 into stage 0.
  load_patch(0);
  load_weights(0, 0);
  store_patch(0, 0);
  cp_async_wait_all();
  __syncthreads();

  for (int j = 0; j < nchunks; ++j) {
    const int s = j & 1;
    const bool more = j + 1 < nchunks;
    if (more) {
      load_weights(j + 1, s ^ 1);
      load_patch(j + 1);
    }
    compute(s);
    if (more) store_patch(j + 1, s ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }

  // Epilogue: dequantize (int8), store bf16, per-tile sum / sum of squares.
  const int g = lane >> 2, t4 = lane & 3;
  float sc[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int co = co0 + wn * 64 + nt * 8 + 2 * t4;
    if constexpr (INT8) {
      sc[nt][0] = p.sc[(size_t)b * p.Cout + co];
      sc[nt][1] = p.sc[(size_t)b * p.Cout + co + 1];
    } else {
      sc[nt][0] = sc[nt][1] = 1.f;
    }
  }
  float s1[8][2], s2[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    s1[nt][0] = s1[nt][1] = s2[nt][0] = s2[nt][1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = r0 + 2 * wm + mi;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + g + 8 * h;
      const bool valid = r < p.H && c < p.W;
      const size_t obase = (((size_t)b * p.H + r) * p.W + c) * p.Cout;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int co = co0 + wn * 64 + nt * 8 + 2 * t4;
        float y0, y1;
        if constexpr (INT8) {
          y0 = (float)acc[mi][nt][2 * h] * sc[nt][0];
          y1 = (float)acc[mi][nt][2 * h + 1] * sc[nt][1];
        } else {
          y0 = acc[mi][nt][2 * h];
          y1 = acc[mi][nt][2 * h + 1];
        }
        if (valid) {
          *reinterpret_cast<uint32_t*>(p.out + obase + co) = pack_bf16x2(y0, y1);
          s1[nt][0] += y0;
          s1[nt][1] += y1;
          s2[nt][0] += y0 * y0;
          s2[nt][1] += y1 * y1;
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1[nt][e] += __shfl_xor_sync(0xffffffffu, s1[nt][e], off);
        s2[nt][e] += __shfl_xor_sync(0xffffffffu, s2[nt][e], off);
      }
  float* red = reinterpret_cast<float*>(smem);  // stages are free after the loop
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wn * 64 + nt * 8 + 2 * t4 + e;
        red[(wm * BN + col) * 2] = s1[nt][e];
        red[(wm * BN + col) * 2 + 1] = s2[nt][e];
      }
  }
  __syncthreads();
  if (tid < BN) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      a1 += red[(m * BN + tid) * 2];
      a2 += red[(m * BN + tid) * 2 + 1];
    }
    float* dst = p.partial + ((size_t)b * p.ntiles + tile) * 2 * p.Cout + co0 + tid;
    dst[0] = a1;
    dst[p.Cout] = a2;
  }
}

template <bool INT8, bool NORM>
int launch(const ConvArgs& a, cudaStream_t stream) {
  auto kernel = conv3x3_reflect_kernel<INT8, NORM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.ntiles, a.Cout / BN, a.B);
  kernel<<<grid, NTHREADS, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ircolor

extern "C" {

// Number of (b, tile) stat partials per image for an H x W plane.
int ircolor_conv3x3_num_tiles(int H, int W) {
  return ((H + ircolor::TH - 1) / ircolor::TH) *
         ((W + ircolor::TW - 1) / ircolor::TW);
}

// int8 = 0: bf16 operands (qscale, sc unused). int8 = 1: s8 operands,
// quantized on load by qscale (mean == null) or by the fixed 127/6 grid
// after normalize + ReLU (mean != null). mean/inv null: no normalize.
int ircolor_conv3x3_reflect(int int8, const void* x, const void* w,
                            const void* mean, const void* inv,
                            const void* qscale, const void* sc, void* out,
                            void* partial, int B, int H, int W, int C,
                            int Cout, void* stream) {
  using namespace ircolor;
  ConvArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const uint8_t*>(w);
  a.mean = static_cast<const float*>(mean);
  a.inv = static_cast<const float*>(inv);
  a.qscale = static_cast<const float*>(qscale);
  a.sc = static_cast<const float*>(sc);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.partial = static_cast<float*>(partial);
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.Cout = Cout;
  a.ntw = (W + TW - 1) / TW;
  a.ntiles = ircolor_conv3x3_num_tiles(H, W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool norm = mean != nullptr;
  if (int8) return norm ? launch<true, true>(a, s) : launch<true, false>(a, s);
  return norm ? launch<false, true>(a, s) : launch<false, false>(a, s);
}

}  // extern "C"
