// Backward of the generator's fused resnet block, for Hopper (sm_90a): the
// block's two dgrad convs and its two weight-gradient contractions.
//
// Replaces (ircolor_tpu/ops/pallas_resblock.py):
//   conv3x3_dgrad_fused (_kernel_dgrad, pallas_call at :818) -> dgrad kernel
//   conv3x3_wgrad_fused (_kernel_wgrad, pallas_call at :1025) -> wgrad kernel
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
// wgrad: dk[ty, tx, ci, co] = sum_{b,p,q} Zpad[p+ty, q+tx, ci] * dy[p, q, co]
//   with Z = z or bf16(relu((z - zm)*zi)) and dy as above, both recomputed
//   on load from the tensors the forward saved; f32 accumulation.
//
// The enc/dec segment modes (ircolor_tpu/ops/pallas_encdec.py runs these
// kernels with pad="zero", mask_p=True and no aux): the segment convs
// zero-pad, so dgrad's dz is F itself (no fold) and wgrad's Zpad has zero
// halos; mask_p takes p = p * (comp > m) on load, before the IN backward
// (the cotangent enters after the segment's ReLU); without aux the dgrad
// stores bf16(F). The segments' dz widths (64 at down1, 384 at up1) need
// Cout % 64 == 0: a block's second 64-channel warp column idles past Cout.
//
// What bounds them on the H100: the tensor cores. At the flagship training
// bottleneck (8x128x160x256, k 3x3x256x256) each launch is 0.193 TFLOP
// against 0.25-0.34 GB of bf16 tensors, ~600 flop/byte, above the card's
// ridge point.
//
// Design:
// * dgrad is the forward kernel's implicit GEMM (csrc/resblock.cu: 8x16
//   pixel tile x 128 output channels, K = 9 taps x 16-channel chunks,
//   ldmatrix + mma.sync m16n8k16 bf16 -> f32) with another prologue: the
//   IN backward is applied while the (8+2)x(16+2) patch goes to shared
//   memory, and pixels outside the image are stored as zeros (zero halos).
// * The reflect fold: each fold term is one more source pixel for some
//   (output pixel, tap) pair. Tiles that hold row 1, row H-2, column 1 or
//   column W-2 run extra passes in which each lane's ldmatrix row address
//   points at its fold source, or at a zero row where it has none; a warp
//   skips a pass no lane of it needs. Other tiles run no extra work.
// * dgrad statistics are per-(b, tile) partials reduced by the caller in a
//   fixed order: no float atomics, so a training step repeats bit for bit.
// * wgrad is a GEMM per tap with M = input channels, N = output channels
//   and K = pixels. A block owns one tap row (three taps), 64 x 128 of
//   (ci, co) and a fixed group of 4x16-pixel tiles. Per tile the dy tile
//   and a 4x18 Z strip (reflect halos from the index map) are transformed
//   once on load, stored pixel-major, and serve all three taps (a tap is a
//   column shift of the strip); ldmatrix.trans turns them into the
//   operands. Each block writes its f32 partials to workspace slots
//   (groups x 9 x Cz x Co); the caller sums the slots in a fixed order.
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

// The same from shared memory (16-byte aligned).
__device__ __forceinline__ void load8_shared(const float* src, float (&dst)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
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

// ------------------------------------------------------------- wgrad ----

constexpr int WG_TR = 4;                          // pixel rows per chunk
constexpr int WG_TC = 16;                         // pixel cols per chunk (one k16 step)
constexpr int WG_PX = WG_TR * WG_TC;              // dy pixels per chunk (64)
constexpr int WG_ZC = WG_TC + 2;                  // Z cols per row: the three tx shifts
constexpr int WG_ZPX = WG_TR * WG_ZC;             // Z pixels per chunk (72)
constexpr int WG_BM = 64;                         // input channels per block
constexpr int WG_BN = 128;                        // output channels per block
constexpr int WG_ZROWB = WG_BM * 2;               // bytes of one Z pixel row
constexpr int WG_DROWB = WG_BN * 2;               // bytes of one dy pixel row
constexpr int WG_ZBYTES = WG_ZPX * WG_ZROWB;
constexpr int WG_STAGE_BYTES = WG_ZBYTES + WG_PX * WG_DROWB;
constexpr int WG_PARAM_OFF = 2 * WG_STAGE_BYTES;  // two stages, 50 KB
// Per-image parameter table: m, inv, gm, gy of the block's 128 output
// channels, then zm, zi of its 64 input channels.
constexpr int WG_PARAM_FLOATS = 4 * WG_BN + 2 * WG_BM;
constexpr int WG_SMEM_BYTES = WG_PARAM_OFF + WG_PARAM_FLOATS * 4;
constexpr int WG_ZUNITS = WG_ZPX * (WG_BM / 8);   // 16-byte units per chunk
constexpr int WG_ZUPT = (WG_ZUNITS + NTHREADS - 1) / NTHREADS;
constexpr int WG_DUPT = WG_PX * (WG_BN / 8) / NTHREADS;
static_assert(NTHREADS % 16 == 0, "a thread's units must keep their channels");

// Pixel-major rows; the XOR puts the 8 rows one ldmatrix reads (same unit,
// 8 consecutive pixels) on distinct banks.
__device__ __forceinline__ int zswz(int px, int unit) {
  return px * WG_ZROWB + ((unit ^ (px & 7)) << 4);
}
__device__ __forceinline__ int dswz(int px, int unit) {
  return px * WG_DROWB + ((unit ^ (px & 7)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

struct WgradArgs {
  const __nv_bfloat16* z;     // (B, H, W, Cz) conv input (or its raw)
  const __nv_bfloat16* p;     // (B, H, W, Co) cotangent entering the IN
  const __nv_bfloat16* comp;  // (B, H, W, Co) raw tensor the IN normalized
  const float* m;             // (B, Co) IN mean, inv, E[p], E[p*n]
  const float* inv;
  const float* gm;
  const float* gy;
  const float* zm;            // (B, Cz) z's IN stats, or null
  const float* zi;
  float* ws;                  // (groups, 9, Cz, Co) f32 partials
  int B, H, W, Cz, Co, ntr, ntc, ntiles, tpg;
  int reflect;                // 1: reflect halos; 0: zero halos
  int mask_p;                 // 1: p masked by comp > m on load
};

// One block: one tap row ty (taps ty*3 + tx, tx = 0..2), 64 input x 128
// output channels, and a group of 4x16-pixel tiles. Per tile the dy tile
// (64 pixels) and the Z strip (4 x 18 pixels: rows p+ty-1, columns c0-1 ..
// c0+16, reflected) are transformed once and serve all three taps: tap tx
// reads strip columns tx .. tx+15. Warps: 2 (32 input channels) x 4 (32
// output channels), each with 3 x 32 x 32 f32 accumulators.
template <bool ZNORM>
__global__ void __launch_bounds__(NTHREADS, 1)
    conv3x3_wgrad_kernel(const WgradArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int grp = blockIdx.x, ty = blockIdx.y;
  const int nco = a.Co / WG_BN;
  const int ci0 = (blockIdx.z / nco) * WG_BM, co0 = (blockIdx.z % nco) * WG_BN;
  const int t0 = grp * a.tpg;
  const int nchunks = max(0, min(t0 + a.tpg, a.ntiles) - t0);
  const int per_img = a.ntr * a.ntc;
  const int zcu = tid & 7, dcu = tid & 15;  // this thread's units (8 channels each)

  uint4 rz[WG_ZUPT], rp[WG_DUPT], rc[WG_DUPT];
  int img = -1;
  unsigned live = 0;  // bit i: dy unit i lies inside the image
  auto load_chunk = [&](int j) {
    const int t = t0 + j;
    img = t / per_img;
    const int rem = t - img * per_img;
    const int r0 = (rem / a.ntc) * WG_TR, c0 = (rem % a.ntc) * WG_TC;
    const size_t zimg = (size_t)img * a.H * a.W;
#pragma unroll
    for (int i = 0; i < WG_ZUPT; ++i) {
      const int zpx = (tid + i * NTHREADS) >> 3;
      if (zpx < WG_ZPX) {
        const int zr = zpx / WG_ZC, zc = zpx - zr * WG_ZC;
        int h = r0 + zr + ty - 1, w = c0 + zc - 1;
        if (a.reflect) {
          h = reflect_index(h, a.H);
          w = reflect_index(w, a.W);
        } else if (h < 0 || h >= a.H || w < 0 || w >= a.W) {
          rz[i] = make_uint4(0, 0, 0, 0);  // zero halo
          continue;
        }
        rz[i] = ldg16(a.z + (zimg + (size_t)h * a.W + w) * a.Cz + ci0 + zcu * 8);
      }
    }
    live = 0;
#pragma unroll
    for (int i = 0; i < WG_DUPT; ++i) {
      const int px = (tid + i * NTHREADS) >> 4;
      const int h = r0 + px / WG_TC, w = c0 + px % WG_TC;
      if (h < a.H && w < a.W) {  // outside the image (partial tile): dy = 0
        const size_t off = (zimg + (size_t)h * a.W + w) * a.Co + co0 + dcu * 8;
        rp[i] = ldg16(a.p + off);
        rc[i] = ldg16(a.comp + off);
        live |= 1u << i;
      }
    }
  };

  // The per-channel parameters of the current image live in a shared
  // table, rewritten when a chunk starts a new image (block-uniform), and
  // are read into registers only while a chunk is transformed.
  float* ptab = reinterpret_cast<float*>(smem + WG_PARAM_OFF);
  int pimg = -1;
  auto store_chunk = [&](int stage) {
    uint8_t* zt = smem + stage * WG_STAGE_BYTES;
    uint8_t* dt = zt + WG_ZBYTES;
    if (img != pimg) {
      pimg = img;
      if (tid < WG_BN) {
        const size_t bd = (size_t)img * a.Co + co0 + tid;
        ptab[tid] = a.m[bd];
        ptab[WG_BN + tid] = a.inv[bd];
        ptab[2 * WG_BN + tid] = a.gm[bd];
        ptab[3 * WG_BN + tid] = a.gy[bd];
      } else if (ZNORM && tid < WG_BN + WG_BM) {
        const size_t bz = (size_t)img * a.Cz + ci0 + tid - WG_BN;
        ptab[4 * WG_BN + tid - WG_BN] = a.zm[bz];
        ptab[4 * WG_BN + WG_BM + tid - WG_BN] = a.zi[bz];
      }
      __syncthreads();
    }
    if constexpr (ZNORM) {
      float zm[8], zi[8];
      load8_shared(ptab + 4 * WG_BN + zcu * 8, zm);
      load8_shared(ptab + 4 * WG_BN + WG_BM + zcu * 8, zi);
#pragma unroll
      for (int i = 0; i < WG_ZUPT; ++i) {
        const int zpx = (tid + i * NTHREADS) >> 3;
        if (zpx >= WG_ZPX) continue;
        const uint32_t zw[4] = {rz[i].x, rz[i].y, rz[i].z, rz[i].w};
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 2 * e;
          const float v0 = fmaxf(__fmul_rn(__fsub_rn(bf16_lo(zw[e]), zm[k]), zi[k]), 0.f);
          const float v1 =
              fmaxf(__fmul_rn(__fsub_rn(bf16_hi(zw[e]), zm[k + 1]), zi[k + 1]), 0.f);
          o[e] = pack_bf16x2(v0, v1);
        }
        *reinterpret_cast<uint4*>(zt + zswz(zpx, zcu)) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < WG_ZUPT; ++i) {
        const int zpx = (tid + i * NTHREADS) >> 3;
        if (zpx < WG_ZPX) *reinterpret_cast<uint4*>(zt + zswz(zpx, zcu)) = rz[i];
      }
    }
    InBwd8 prm;
    load8_shared(ptab + dcu * 8, prm.m);
    load8_shared(ptab + WG_BN + dcu * 8, prm.iv);
    load8_shared(ptab + 2 * WG_BN + dcu * 8, prm.gm);
    load8_shared(ptab + 3 * WG_BN + dcu * 8, prm.gy);
#pragma unroll
    for (int i = 0; i < WG_DUPT; ++i) {
      const int px = (tid + i * NTHREADS) >> 4;
      const uint4 od =
          (live >> i) & 1u ? prm.apply(rp[i], rc[i], a.mask_p != 0) : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dt + dswz(px, dcu)) = od;
    }
  };

  float acc[3][2][4][4];
#pragma unroll
  for (int tx = 0; tx < 3; ++tx)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[tx][mi][nt][e] = 0.f;

  const int mat = lane >> 3, mrow = lane & 7;
  auto compute = [&](int stage) {
    const uint32_t zb = smem_u32(smem + stage * WG_STAGE_BYTES);
    const uint32_t db = zb + WG_ZBYTES;
#pragma unroll
    for (int ks = 0; ks < WG_TR; ++ks) {  // one tile row = one k16 step
      // B = dy (K = pixel, N = co): matrix j holds pixel half j&1, co half j>>1.
      uint32_t bq[2][4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int row = ks * WG_TC + ((mat & 1) << 3) + mrow;
        ldmatrix_x4_trans(bq[nj], db + dswz(row, wn * 4 + nj * 2 + (mat >> 1)));
      }
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) {
        // A = Z^T (M = ci, K = pixel): matrix j holds ci half j&1, pixel half j>>1.
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          uint32_t af[4];
          const int zrow = ks * WG_ZC + tx + ((mat >> 1) << 3) + mrow;
          ldmatrix_x4_trans(af, zb + zswz(zrow, wm * 4 + mi * 2 + (mat & 1)));
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            mma(acc[tx][mi][2 * nj], af, bq[nj][0], bq[nj][1]);
            mma(acc[tx][mi][2 * nj + 1], af, bq[nj][2], bq[nj][3]);
          }
        }
      }
    }
  };

  if (nchunks > 0) {
    load_chunk(0);
    store_chunk(0);
    __syncthreads();
    for (int j = 0; j < nchunks; ++j) {
      const int s = j & 1;
      const bool more = j + 1 < nchunks;
      if (more) load_chunk(j + 1);
      compute(s);
      if (more) store_chunk(s ^ 1);
      __syncthreads();
    }
  }

  // Epilogue: this block's f32 partials into its workspace slots.
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int tx = 0; tx < 3; ++tx) {
    float* dst = a.ws + (size_t)(grp * 9 + ty * 3 + tx) * a.Cz * a.Co;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int ci = ci0 + wm * 32 + mi * 16 + g;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = co0 + wn * 32 + nt * 8 + 2 * t4;
        *reinterpret_cast<float2*>(dst + (size_t)ci * a.Co + co) =
            make_float2(acc[tx][mi][nt][0], acc[tx][mi][nt][1]);
        *reinterpret_cast<float2*>(dst + (size_t)(ci + 8) * a.Co + co) =
            make_float2(acc[tx][mi][nt][2], acc[tx][mi][nt][3]);
      }
    }
  }
}

template <bool ZNORM>
int launch_wgrad(const WgradArgs& a, int ngroups, cudaStream_t stream) {
  auto kernel = conv3x3_wgrad_kernel<ZNORM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(ngroups, 3, (a.Cz / WG_BM) * (a.Co / WG_BN));
  kernel<<<grid, NTHREADS, WG_SMEM_BYTES, stream>>>(a);
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

// Number of 4x16-pixel wgrad tiles of a (B, H, W) batch.
int ircolor_conv3x3_wgrad_num_tiles(int B, int H, int W) {
  return B * ((H + ircolor::WG_TR - 1) / ircolor::WG_TR) *
         ((W + ircolor::WG_TC - 1) / ircolor::WG_TC);
}

// zm/zi non-null: Z = relu((z - zm)*zi) on load (reflect halos only). ws
// holds ngroups slots of 9 x Cz x Co f32; group g covers tiles [g*tpg,
// min((g+1)*tpg, num_tiles)). reflect / mask_p as for the dgrad.
int ircolor_conv3x3_wgrad(const void* z, const void* p, const void* comp,
                          const void* m, const void* inv, const void* gm,
                          const void* gy, const void* zm, const void* zi,
                          void* ws, int B, int H, int W, int Cz, int Co,
                          int tpg, int ngroups, int reflect, int mask_p, void* stream) {
  using namespace ircolor;
  WgradArgs a;
  a.z = static_cast<const __nv_bfloat16*>(z);
  a.p = static_cast<const __nv_bfloat16*>(p);
  a.comp = static_cast<const __nv_bfloat16*>(comp);
  a.m = static_cast<const float*>(m);
  a.inv = static_cast<const float*>(inv);
  a.gm = static_cast<const float*>(gm);
  a.gy = static_cast<const float*>(gy);
  a.zm = static_cast<const float*>(zm);
  a.zi = static_cast<const float*>(zi);
  a.ws = static_cast<float*>(ws);
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cz = Cz;
  a.Co = Co;
  a.ntr = (H + WG_TR - 1) / WG_TR;
  a.ntc = (W + WG_TC - 1) / WG_TC;
  a.ntiles = ircolor_conv3x3_wgrad_num_tiles(B, H, W);
  a.tpg = tpg;
  a.reflect = reflect;
  a.mask_p = mask_p;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return zm != nullptr ? launch_wgrad<true>(a, ngroups, s)
                       : launch_wgrad<false>(a, ngroups, s);
}

}  // extern "C"
