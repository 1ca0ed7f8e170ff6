// int8 3x3 stride-1 conv of the int8 serving route outside the fused
// blocks, for Hopper (sm_90a): s8 x s8 -> s32 implicit GEMM on mma.sync
// m16n8k32 with a dequantize epilogue.
//
// Replaces the JAX package's XLA int8 conv (ircolor_tpu/ops/quant.py:
// conv2d_int8 / conv2d_int8_fixed, lax.conv_general_dilated on int8
// operands with preferred_element_type=int32) -- an XLA convolution, not a
// Pallas kernel. It runs in QuantConv (down1, down2, the unfused resnet
// blocks: ircolor_tpu/models/generator.py:207-220, 486-501) and in each
// leg of the int8 ConcatConv3x3 (up1, up2: models/common.py:176-243).
//
// What it computes, per image b, pixel (y, x) and output channel co:
//   acc = sum_{dy,dx,ci} xq[b, y+dy-1, x+dx-1, ci] * wq[dy, dx, ci, co]
//         (one pixel of zero padding, or reflect padding: row -1 = row 1,
//          row H = row H-2, the same for columns; no padded tensor exists)
//   v   = f32(acc) * sc[b, co]           (sc = sx[b] * sw[co], formed by
//                                          the caller as the JAX code does)
//   v   = addend + v                     (optional: the other concat leg)
//   v   = v + bias[co]                   (optional)
//   out = v as f32, or bf16 rounded to nearest even
// Every step is one IEEE operation (__fmul_rn / __fadd_rn: nvcc may not
// contract them into an FMA), so the kernel equals its plain version bit
// for bit.
//
// What bounds it on the H100: the int8 tensor cores at the decoder sites
// (up1 at 256x320, 384 -> 128 channels: 0.08 TOP per image, ~320 int8 ops
// per byte moved), the memory at down1 (64 -> 128 channels, the output is
// twice the input). At batch 1 every site is a few hundred blocks: launch
// and tail effects dominate, not either bound.
//
// Design: an implicit GEMM on mma.sync (s8 m16n8k32) over an int8 input
// that arrives quantized. A block owns an 8x16 output-pixel tile (M = 128)
// and BN = 128 (or 64, for Cout = 64) output channels; eight warps of
// 32 x BN/2. K = 9 taps x Cin runs as chunks of 32 input channels. Per chunk
// the (8+2)x(16+2) int8 patch arrives by cp.async (16 bytes a copy; halo
// pixels of the zero padding are zero-filled, reflect halos are read from
// their source pixel), the chunk's weights likewise, double-buffered; the
// nine taps are shifted ldmatrix row addresses into the one patch.
#include "common.cuh"

namespace ircolor {
namespace {

constexpr int TH = 8;
constexpr int TW = 16;
constexpr int PW = TW + 2;
constexpr int PROWS = (TH + 2) * PW;  // 180 patch pixels
constexpr int ROWB = 32;              // bytes of K per shared-memory row
constexpr int KC = 32;                // int8 input channels per chunk
constexpr int NTHREADS = 256;
constexpr int PATCH_BYTES = PROWS * ROWB;
constexpr int PATCH_UNITS = PROWS * 2;  // 16-byte units per chunk
constexpr int UNITS_PER_THREAD = (PATCH_UNITS + NTHREADS - 1) / NTHREADS;

__host__ __device__ constexpr int stage_bytes(int bn) {
  return PATCH_BYTES + 9 * bn * ROWB;
}

__device__ __forceinline__ int swz(int row, int chunk) {
  return row * ROWB + ((chunk ^ ((row >> 2) & 1)) << 4);
}

struct Args {
  const int8_t* x;      // (B, H, W, C)
  const uint8_t* w;     // (C/32, 9, Cout, 32 bytes)
  const float* sc;      // (B, Cout)
  const float* bias;    // (Cout) or null
  const float* addend;  // (B, H, W, Cout) or null
  void* out;            // (B, H, W, Cout) f32 or bf16
  int B, H, W, C, Cout, ntw, reflect, out_f32;
};

template <int BN>
__global__ void __launch_bounds__(NTHREADS, 2) conv3x3_int8_kernel(const Args p) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int STAGE = stage_bytes(BN);
  constexpr int WNC = BN / 2;  // output channels per warp
  constexpr int NT = WNC / 8;  // n8 MMA tiles per warp
  constexpr int W_UNITS = 9 * BN * 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int tile = blockIdx.x, co0 = blockIdx.y * BN, b = blockIdx.z;
  const int r0 = (tile / p.ntw) * TH, c0 = (tile % p.ntw) * TW;
  const int nchunks = p.C / KC;
  const int8_t* xb = p.x + (size_t)b * p.H * p.W * p.C;

  // Each thread owns up to UNITS_PER_THREAD 16-byte units of the patch:
  // fixed pixel, fixed channel half, every chunk. -1: a zero-padding halo
  // pixel (zero-filled). Pixels past the image's far edge feed only
  // masked-out outputs; reflect_index clamps them into the image.
  int uoff[UNITS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < UNITS_PER_THREAD; ++i) {
    const int u = tid + i * NTHREADS;
    uoff[i] = -2;
    if (u < PATCH_UNITS) {
      const int prow = u >> 1, pr = prow / PW, pc = prow - pr * PW;
      int r = r0 - 1 + pr, c = c0 - 1 + pc;
      if (p.reflect) {
        r = reflect_index(r, p.H);
        c = reflect_index(c, p.W);
      } else if (r < 0 || r >= p.H || c < 0 || c >= p.W) {
        uoff[i] = -1;
        continue;
      }
      uoff[i] = (r * p.W + c) * p.C + (u & 1) * 16;
    }
  }

  auto load_chunk = [&](int j, int stage) {
    uint8_t* base = smem + stage * STAGE;
#pragma unroll
    for (int i = 0; i < UNITS_PER_THREAD; ++i) {
      const int u = tid + i * NTHREADS;
      if (uoff[i] == -2) continue;
      uint8_t* dst = base + swz(u >> 1, u & 1);
      if (uoff[i] < 0) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      } else {
        cp_async16(smem_u32(dst), xb + uoff[i] + j * KC);
      }
    }
    const uint32_t wdst = smem_u32(base + PATCH_BYTES);
    const uint8_t* src = p.w + (size_t)j * 9 * p.Cout * ROWB;
    for (int v = tid; v < W_UNITS; v += NTHREADS) {
      const int tap = v / (BN * 2), rem = v - tap * (BN * 2);
      const int n = rem >> 1, ch = rem & 1;
      cp_async16(wdst + swz(tap * BN + n, ch),
                 src + ((size_t)(tap * p.Cout + co0 + n)) * ROWB + ch * 16);
    }
    cp_async_commit();
  };

  int acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0;

  const int apix = (lane & 7) + ((lane >> 3) & 1) * 8;  // pixel in m16 row
  const int achunk = lane >> 4;
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bchunk = (lane >> 3) & 1;

  auto compute = [&](int stage) {
    const uint32_t pbase = smem_u32(smem + stage * STAGE);
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
      for (int nj = 0; nj < NT / 2; ++nj) {
        uint32_t bq[4];
        const int nrow = tap * BN + wn * WNC + nj * 16 + brow;
        ldmatrix_x4(bq, wbase + swz(nrow, bchunk));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma(acc[mi][2 * nj], a[mi], bq[0], bq[1]);
          mma(acc[mi][2 * nj + 1], a[mi], bq[2], bq[3]);
        }
      }
    }
  };

  load_chunk(0, 0);
  cp_async_wait_all();
  __syncthreads();
  for (int j = 0; j < nchunks; ++j) {
    const int s = j & 1;
    if (j + 1 < nchunks) load_chunk(j + 1, s ^ 1);
    compute(s);
    cp_async_wait_all();
    __syncthreads();
  }

  // Epilogue: thread (g, t4) holds rows g and g+8 of each m16 tile (the
  // tile's columns c0+g, c0+g+8) and output channels 2*t4, 2*t4+1 of each
  // n8 tile.
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = r0 + 2 * wm + mi;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + g + 8 * h;
      if (r >= p.H || c >= p.W) continue;
      const size_t obase = (((size_t)b * p.H + r) * p.W + c) * p.Cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = co0 + wn * WNC + nt * 8 + 2 * t4;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = __fmul_rn(__int2float_rn(acc[mi][nt][2 * h + e]),
                           p.sc[(size_t)b * p.Cout + co + e]);
        }
        if (p.addend != nullptr) {
          const float2 a2 = *reinterpret_cast<const float2*>(p.addend + obase + co);
          v[0] = __fadd_rn(a2.x, v[0]);
          v[1] = __fadd_rn(a2.y, v[1]);
        }
        if (p.bias != nullptr) {
          v[0] = __fadd_rn(v[0], p.bias[co]);
          v[1] = __fadd_rn(v[1], p.bias[co + 1]);
        }
        if (p.out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + obase + co) =
              make_float2(v[0], v[1]);
        } else {
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.out) + obase + co) =
              pack_bf16x2(v[0], v[1]);
        }
      }
    }
  }
}

template <int BN>
int launch(const Args& a, int ntiles, cudaStream_t stream) {
  auto kernel = conv3x3_int8_kernel<BN>;
  constexpr int smem = 2 * stage_bytes(BN);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(ntiles, a.Cout / BN, a.B);
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ircolor

extern "C" {

// pad_reflect: 0 = one pixel of zero padding, 1 = reflect padding.
// out_f32: 1 = float32 output, 0 = bf16. bias / addend may be null.
// Cin % 32 == 0 and Cout % 64 == 0 (checked by the Python wrapper).
int ircolor_conv3x3_int8(const void* x, const void* w, const void* sc,
                         const void* bias, const void* addend, void* out,
                         int B, int H, int W, int C, int Cout, int pad_reflect,
                         int out_f32, void* stream) {
  using namespace ircolor;
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const uint8_t*>(w);
  a.sc = static_cast<const float*>(sc);
  a.bias = static_cast<const float*>(bias);
  a.addend = static_cast<const float*>(addend);
  a.out = out;
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.Cout = Cout;
  a.ntw = (W + TW - 1) / TW;
  a.reflect = pad_reflect;
  a.out_f32 = out_f32;
  const int ntiles = ((H + TH - 1) / TH) * a.ntw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return Cout % 128 == 0 ? launch<128>(a, ntiles, s) : launch<64>(a, ntiles, s);
}

}  // extern "C"
