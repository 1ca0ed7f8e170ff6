// Backward of the generator's fused resnet block, for Hopper (sm_90a): the
// block's two dgrad convs. (The weight gradient is csrc/wgrad.cu.)
//
// Replaces (ircolor_tpu/ops/pallas_resblock.py):
//   conv3x3_dgrad_fused (_kernel_dgrad, pallas_call at :818) -> dgrad kernel
//
// dgrad, per image b (p, comp: the IN's cotangent and the raw tensor it
// normalized, C channels; out: Cout channels):
//   dy  = bf16(inv*((p - gm) - n*gy)), n = (comp - m)*inv   (IN backward)
//   F   = zero-SAME 3x3 conv of dy with rot180(k) transposed in channels
//   dz  = ReflectionPad(1)'s VJP of F: F[-1] folds into row 1, F[H] into
//         row H-2, the same for columns, corners included
//   mask_stats form: out = bf16(dz * (aux > mm)), per-tile partials of
//         sum(out_f32) and sum(out_f32 * (aux - mm)*mi) from the f32 value
//   residual form:   out = bf16(dz + aux)
//   dy is also stored (bf16) when asked, for a stock weight gradient.
//
// The enc/dec segment modes (ircolor_tpu/ops/pallas_encdec.py runs this
// kernel with pad="zero", mask_p=True and no aux): the segment convs
// zero-pad, so dz is F itself (no fold); mask_p takes p = p * (comp > m) on load, before the IN backward
// (the cotangent enters after the segment's ReLU); without aux the dgrad
// stores bf16(F). The segments' dz widths (64 at down1, 384 at up1) need
// Cout % 64 == 0: a block's second 64-channel warp column idles past Cout.
//
// What bounds it on the H100: the tensor cores. At the flagship training
// bottleneck (8x128x160x256, k 3x3x256x256) each launch is 0.193 TFLOP
// against 0.25-0.34 GB of bf16 tensors, ~600 flop/byte, above the card's
// ridge point.
//
// Design:
// * dgrad is an implicit GEMM on mma.sync (the layout of csrc/resblock.cu's
//   int8 conv: 8x16 pixel tile x 128 output channels, K = 9 taps x
//   16-channel chunks, ldmatrix + m16n8k16 bf16 -> f32) with a prologue: the
//   IN backward is applied while the (8+2)x(16+2) patch goes to shared
//   memory, and pixels outside the image are stored as zeros (zero halos).
// * The reflect fold: each fold term is one more source pixel for some
//   (output pixel, tap) pair. Tiles that hold row 1, row H-2, column 1 or
//   column W-2 run extra passes in which each lane's ldmatrix row address
//   points at its fold source, or at a zero row where it has none; a warp
//   skips a pass no lane of it needs. Other tiles run no extra work.
// * dgrad statistics are per-(b, tile) partials reduced by the caller in a
//   fixed order: no float atomics, so a training step repeats bit for bit.
#include "common.cuh"

namespace ircolor {
namespace {

constexpr int NTHREADS = 256;

// ------------------------------------------------------------- dgrad ----

constexpr int TH = 8;                // output tile rows
constexpr int TW = 16;               // output tile cols (one m16 MMA row)
constexpr int PW = TW + 2;           // patch cols
constexpr int PROWS = (TH + 2) * PW; // patch pixels (180)
constexpr int BN = 128;              // output channels per block
constexpr int ROWB = 32;             // bytes of K per shared-memory row
constexpr int KC = 16;               // input channels per K chunk
constexpr int PATCH_BYTES = PROWS * ROWB;
constexpr int W_BYTES = 9 * BN * ROWB;
constexpr int STAGE_BYTES = PATCH_BYTES + W_BYTES;
constexpr int ZERO_OFF = 2 * STAGE_BYTES;          // one zero row for the fold
constexpr int DG_SMEM_BYTES = ZERO_OFF + ROWB;
constexpr int PATCH_UNITS = PROWS * 2;
constexpr int UNITS_PER_THREAD = (PATCH_UNITS + NTHREADS - 1) / NTHREADS;
constexpr int W_UNITS = 9 * BN * 2;
constexpr int NO_ALT = -(1 << 20);   // a pixel with no fold partner
static_assert(NTHREADS % 2 == 0, "a thread's patch units must share a channel half");

__device__ __forceinline__ int swz(int row, int chunk) {
  return row * ROWB + ((chunk ^ ((row >> 2) & 1)) << 4);
}

// The dgrad's epilogue forms.
enum { EPI_RESIDUAL = 0, EPI_MASK_STATS = 1, EPI_NONE = 2 };

struct DgradArgs {
  const __nv_bfloat16* p;     // (B, H, W, C) cotangent entering the IN
  const __nv_bfloat16* comp;  // (B, H, W, C) raw tensor the IN normalized
  const __nv_bfloat16* aux;   // (B, H, W, Cout) raw1 (mask), residual, or null
  const uint8_t* w;           // (C/16, 9, Cout, 32 bytes) rot180^T kernel
  const float* m;             // (B, C) IN mean, inv, E[p], E[p*n]
  const float* inv;
  const float* gm;
  const float* gy;
  const float* mm;            // (B, Cout) mask-stats form: raw1's IN stats
  const float* mi;
  __nv_bfloat16* out;         // (B, H, W, Cout)
  __nv_bfloat16* dy;          // (B, H, W, C) or null
  float* partial;             // (B, ntiles, 2, Cout) mask-stats form
  int B, H, W, C, Cout, ntw, ntiles;
  int reflect;                // 1: ReflectionPad(1) fold; 0: zero-SAME
  int mask_p;                 // 1: p masked by comp > m on load
};

template <int EPI>
__global__ void __launch_bounds__(NTHREADS, 2)
    conv3x3_dgrad_kernel(const DgradArgs a) {
  constexpr bool MASK_STATS = EPI == EPI_MASK_STATS;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int tile = blockIdx.x, co0 = blockIdx.y * BN, b = blockIdx.z;
  const int r0 = (tile / a.ntw) * TH, c0 = (tile % a.ntw) * TW;
  const int nchunks = a.C / KC;
  const size_t img = (size_t)b * a.H * a.W * a.C;
  const __nv_bfloat16* pb = a.p + img;
  const __nv_bfloat16* cb = a.comp + img;
  const float* mb = a.m + (size_t)b * a.C;
  const float* ib = a.inv + (size_t)b * a.C;
  const float* gmb = a.gm + (size_t)b * a.C;
  const float* gyb = a.gy + (size_t)b * a.C;
  const bool emit = a.dy != nullptr && blockIdx.y == 0;
  // Warp column wn holds output channels co0 + wn*64 .. +63; with Cout % 128
  // == 64 the last block's second column lies past Cout and does nothing.
  const bool wlive = co0 + wn * 64 < a.Cout;

  // Each thread owns up to UNITS_PER_THREAD 16-byte units of the patch:
  // fixed pixel, fixed channel half, every chunk. uoff -1: outside the
  // image (stored as zeros); -2: no unit.
  int uoff[UNITS_PER_THREAD];
  bool uemit[UNITS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < UNITS_PER_THREAD; ++i) {
    const int u = tid + i * NTHREADS;
    uoff[i] = -2;
    uemit[i] = false;
    if (u < PATCH_UNITS) {
      const int prow = u >> 1, pr = prow / PW, pc = prow - pr * PW;
      const int r = r0 - 1 + pr, c = c0 - 1 + pc;
      if (r >= 0 && r < a.H && c >= 0 && c < a.W) {
        uoff[i] = (r * a.W + c) * a.C + (u & 1) * (KC / 2);
        uemit[i] = emit && pr >= 1 && pr <= TH && pc >= 1 && pc <= TW;
      } else {
        uoff[i] = -1;
      }
    }
  }
  if (tid < 2) {
    *reinterpret_cast<uint4*>(smem + ZERO_OFF + tid * 16) = make_uint4(0, 0, 0, 0);
  }

  uint4 rp[UNITS_PER_THREAD], rc[UNITS_PER_THREAD];
  auto load_patch = [&](int j) {
#pragma unroll
    for (int i = 0; i < UNITS_PER_THREAD; ++i) {
      if (uoff[i] >= 0) {
        rp[i] = ldg16(pb + uoff[i] + j * KC);
        rc[i] = ldg16(cb + uoff[i] + j * KC);
      }
    }
  };

  // NTHREADS is even, so all of a thread's units hold the same channel
  // half: one parameter load per chunk serves them all.
  auto store_patch = [&](int j, int stage) {
    uint8_t* patch = smem + stage * STAGE_BYTES;
    const int cbase = j * KC + (tid & 1) * (KC / 2);
    InBwd8 prm;
    prm.load(mb + cbase, ib + cbase, gmb + cbase, gyb + cbase);
#pragma unroll
    for (int i = 0; i < UNITS_PER_THREAD; ++i) {
      const int u = tid + i * NTHREADS;
      if (uoff[i] == -2) continue;
      uint4 o = make_uint4(0, 0, 0, 0);
      if (uoff[i] >= 0) {
        o = prm.apply(rp[i], rc[i], a.mask_p != 0);
        if (uemit[i]) *reinterpret_cast<uint4*>(a.dy + img + uoff[i] + j * KC) = o;
      }
      *reinterpret_cast<uint4*>(patch + swz(u >> 1, u & 1)) = o;
    }
  };

  auto load_weights = [&](int j, int stage) {
    const uint32_t dst = smem_u32(smem + stage * STAGE_BYTES + PATCH_BYTES);
    const uint8_t* src = a.w + (size_t)j * 9 * a.Cout * ROWB;
    for (int v = tid; v < W_UNITS; v += NTHREADS) {
      const int tap = v / (BN * 2), rem = v - tap * (BN * 2);
      const int n = rem >> 1, ch = rem & 1;
      if (co0 + n >= a.Cout) continue;  // rows only idle warps would read
      cp_async16(dst + swz(tap * BN + n, ch),
                 src + ((size_t)(tap * a.Cout + co0 + n)) * ROWB + ch * 16);
    }
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

  const int apix = (lane & 7) + ((lane >> 3) & 1) * 8;  // pixel in m16 row
  const int achunk = lane >> 4;
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bchunk = (lane >> 3) & 1;

  auto mma_tap = [&](int mi, const uint32_t (&af)[4], uint32_t wbase, int tap) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      uint32_t bq[4];
      ldmatrix_x4(bq, wbase + swz(tap * BN + wn * 64 + nj * 16 + brow, bchunk));
      mma(acc[mi][2 * nj], af, bq[0], bq[1]);
      mma(acc[mi][2 * nj + 1], af, bq[2], bq[3]);
    }
  };

  auto compute = [&](int stage) {
    const uint32_t pbase = smem_u32(smem + stage * STAGE_BYTES);
    const uint32_t wbase = pbase + PATCH_BYTES;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int prow = (2 * wm + mi + dy) * PW + apix + dx;
        ldmatrix_x4(af[mi], pbase + swz(prow, achunk));
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t bq[4];
        const int nrow = tap * BN + wn * 64 + nj * 16 + brow;
        ldmatrix_x4(bq, wbase + swz(nrow, bchunk));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma(acc[mi][2 * nj], af[mi], bq[0], bq[1]);
          mma(acc[mi][2 * nj + 1], af[mi], bq[2], bq[3]);
        }
      }
    }
  };

  // Reflect-pad VJP fold. Output pixel (r, c) at tap (ty, tx) also reads dy
  // at (R-1+ty, C-1+tx) for each other pair (R, C) in {r, ra} x {c, ca},
  // where ra is the padded row reflecting onto r (-1 for r = 1, H for
  // r = H-2) and ca the same for columns; sources outside the image are 0.
  const bool edge = a.reflect &&
                    ((r0 <= 1 && 1 < r0 + TH) || (r0 <= a.H - 2 && a.H - 2 < r0 + TH) ||
                     (c0 <= 1 && 1 < c0 + TW) || (c0 <= a.W - 2 && a.W - 2 < c0 + TW));
  const uint32_t zero_addr = smem_u32(smem + ZERO_OFF) + achunk * 16;
  const int fc = c0 + apix;
  const int altc = fc == 1 ? -1 : (fc == a.W - 2 ? a.W : NO_ALT);
  auto fold = [&](int stage) {
    const uint32_t pbase = smem_u32(smem + stage * STAGE_BYTES);
    const uint32_t wbase = pbase + PATCH_BYTES;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int fr = r0 + 2 * wm + mi;
      const int altr = fr == 1 ? -1 : (fr == a.H - 2 ? a.H : NO_ALT);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int ty = tap / 3, tx = tap % 3;
#pragma unroll
        for (int kind = 0; kind < 3; ++kind) {  // row partner, col partner, both
          const int rr = kind == 1 ? fr : altr;
          const int cc = kind == 0 ? fc : altc;
          const int sr = rr - 1 + ty, sc = cc - 1 + tx;
          const bool ok = rr != NO_ALT && cc != NO_ALT && sr >= 0 && sr < a.H &&
                          sc >= 0 && sc < a.W;
          if (!__any_sync(0xffffffffu, ok)) continue;
          const uint32_t addr =
              ok ? pbase + swz((sr - r0 + 1) * PW + (sc - c0 + 1), achunk) : zero_addr;
          uint32_t af[4];
          ldmatrix_x4(af, addr);
          mma_tap(mi, af, wbase, tap);
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
    if (wlive) {
      compute(s);
      if (edge) fold(s);
    }
    if (more) store_patch(j + 1, s ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }

  // Epilogue: ReLU mask + stats (launch 1), residual add (launch 2), or the
  // bare dz (the segments).
  const int g = lane >> 2, t4 = lane & 3;
  float mmv[8][2], miv[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int co = co0 + wn * 64 + nt * 8 + 2 * t4;
    if constexpr (MASK_STATS) {
      mmv[nt][0] = a.mm[(size_t)b * a.Cout + co];
      mmv[nt][1] = a.mm[(size_t)b * a.Cout + co + 1];
      miv[nt][0] = a.mi[(size_t)b * a.Cout + co];
      miv[nt][1] = a.mi[(size_t)b * a.Cout + co + 1];
    } else {
      mmv[nt][0] = mmv[nt][1] = miv[nt][0] = miv[nt][1] = 0.f;
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
      if (r >= a.H || c >= a.W || !wlive) continue;
      const size_t obase = (((size_t)b * a.H + r) * a.W + c) * a.Cout;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int co = co0 + wn * 64 + nt * 8 + 2 * t4;
        float y0 = acc[mi][nt][2 * h], y1 = acc[mi][nt][2 * h + 1];
        if constexpr (EPI == EPI_NONE) {
          *reinterpret_cast<uint32_t*>(a.out + obase + co) = pack_bf16x2(y0, y1);
          continue;
        }
        const uint32_t av = *reinterpret_cast<const uint32_t*>(a.aux + obase + co);
        const float a0 = bf16_lo(av), a1 = bf16_hi(av);
        if constexpr (MASK_STATS) {
          y0 = a0 > mmv[nt][0] ? y0 : 0.f;
          y1 = a1 > mmv[nt][1] ? y1 : 0.f;
          s1[nt][0] += y0;
          s1[nt][1] += y1;
          s2[nt][0] += y0 * __fmul_rn(__fsub_rn(a0, mmv[nt][0]), miv[nt][0]);
          s2[nt][1] += y1 * __fmul_rn(__fsub_rn(a1, mmv[nt][1]), miv[nt][1]);
        } else {
          y0 += a0;
          y1 += a1;
        }
        *reinterpret_cast<uint32_t*>(a.out + obase + co) = pack_bf16x2(y0, y1);
      }
    }
  }
  if constexpr (MASK_STATS) {
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
    if (tid < BN && co0 + tid < a.Cout) {
      float a1 = 0.f, a2 = 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        a1 += red[(m * BN + tid) * 2];
        a2 += red[(m * BN + tid) * 2 + 1];
      }
      float* dst = a.partial + ((size_t)b * a.ntiles + tile) * 2 * a.Cout + co0 + tid;
      dst[0] = a1;
      dst[a.Cout] = a2;
    }
  }
}

template <int EPI>
int launch_dgrad(const DgradArgs& a, cudaStream_t stream) {
  auto kernel = conv3x3_dgrad_kernel<EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DG_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.ntiles, (a.Cout + BN - 1) / BN, a.B);
  kernel<<<grid, NTHREADS, DG_SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ircolor

extern "C" {

// Number of (b, tile) stat partials per image for an H x W plane.
int ircolor_conv3x3_dgrad_num_tiles(int H, int W) {
  return ((H + ircolor::TH - 1) / ircolor::TH) * ((W + ircolor::TW - 1) / ircolor::TW);
}

// mm/mi non-null: the mask-stats form (partial required); else the
// residual form, or with aux null the bare dz. dy may be null. reflect: 1
// for the blocks' ReflectionPad(1) convs, 0 for zero-SAME; mask_p: 1 to
// mask p by comp > m on load.
int ircolor_conv3x3_dgrad(const void* p, const void* comp, const void* aux,
                          const void* w, const void* m, const void* inv,
                          const void* gm, const void* gy, const void* mm,
                          const void* mi, void* out, void* dy, void* partial,
                          int B, int H, int W, int C, int Cout, int reflect, int mask_p,
                          void* stream) {
  using namespace ircolor;
  DgradArgs a;
  a.p = static_cast<const __nv_bfloat16*>(p);
  a.comp = static_cast<const __nv_bfloat16*>(comp);
  a.aux = static_cast<const __nv_bfloat16*>(aux);
  a.w = static_cast<const uint8_t*>(w);
  a.m = static_cast<const float*>(m);
  a.inv = static_cast<const float*>(inv);
  a.gm = static_cast<const float*>(gm);
  a.gy = static_cast<const float*>(gy);
  a.mm = static_cast<const float*>(mm);
  a.mi = static_cast<const float*>(mi);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.dy = static_cast<__nv_bfloat16*>(dy);
  a.partial = static_cast<float*>(partial);
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.Cout = Cout;
  a.ntw = (W + TW - 1) / TW;
  a.ntiles = ircolor_conv3x3_dgrad_num_tiles(H, W);
  a.reflect = reflect;
  a.mask_p = mask_p;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mm != nullptr) return launch_dgrad<EPI_MASK_STATS>(a, s);
  return aux != nullptr ? launch_dgrad<EPI_RESIDUAL>(a, s) : launch_dgrad<EPI_NONE>(a, s);
}

}  // extern "C"
