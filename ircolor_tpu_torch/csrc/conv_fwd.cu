// Forward 3x3 conv (bf16 operands, f32 accumulation) of the generator's
// resnet blocks and of the JAX package's other 3x3 conv kernels, for Hopper
// (sm_90a): an operand pass where a halo or a normalize needs one, then an
// implicit GEMM on TMA + wgmma.
//
// Replaces (ircolor_tpu/ops/):
//   pallas_resblock.py:conv3x3_reflect_fused (:280, pallas_call :358)
//       reflect halos, raw or with the previous IN + ReLU on load;
//   pallas_resblock.py:conv3x3_sum_fused (:1190, pallas_call :1246)
//       zero or reflect halos, one or two input legs;
//   pallas_block.py:_run (:105, pallas_call :138), conv3x3_stats /
//       conv3x3_norm_in_stats: VALID over a pre-padded input, raw or
//       normalized on load;
//   pallas_conv.py:conv3x3_valid_pallas_v2 (:177, :234) and
//       conv3x3_valid_pallas (:256, :305): VALID, no stats.
//
//   out[b, r, c, co] = sum_{leg, ci, dy, dx} Xp[b, r+dy, c+dx, ci] * k[dy, dx, ci, co]
//
// in f32, stored once as bf16, with the per-(b, tile) sum and sum of
// squares of the f32 values (over every leg, before rounding) for the
// caller's instance norm. Xp is the reflect-padded Zp the pass wrote, the
// pre-padded input (VALID), or the unpadded input read from coordinate -1
// (zero halos: TMA fills what lies outside with zeros).
//
// What bounds it on the H100: the tensor cores. At the flagship bottleneck
// (32x128x160x256 -> 256) one conv is 0.77 TFLOP against 0.67 GB of
// activations in and out (~1150 flop/byte, far above the card's ridge
// point of ~295); at down2 (128 -> 256) and up1 (256 + 128 -> 128), 256x320,
// ~770 and ~860 flop/byte. The weights (at most 1.2 MB) and the planes'
// recent rows stay in L2, so the tile's shape decides the L2 -> shared
// traffic: a stage moves 44 KB for 6.3 MFLOP of wgmma (~0.007 byte a flop,
// ~5 TB/s at 700 TFLOP/s).
//
// Design:
// * Operand pass (tma.cuh, memory-bound): REFLECT writes the reflect-padded
//   Zp (B, H+2, W+2, C) of x or of bf16(relu((x - mean)*inv)); VALID with
//   mean/inv normalizes the padded input as it is. ZERO and VALID raw need
//   none: the GEMM reads the input itself.
// * GEMM: a block owns TH x TW = 8 x 32 output pixels (M = 256) of one
//   image and 128 output channels (N): two consumer warpgroups of 4 rows
//   (two m64 sub-tiles, 2 rows each) and one producer warp. M = 256 halves
//   the weight traffic a flop of the old 128-pixel tile.
// * A (activations) is K-major: TMA copies a box of (KC = 32 channels, TW
//   columns, TH + 2 rows, 1 image), 64-byte swizzled, one pixel a 64-byte
//   row. A stage holds one such box at column c0 + dx: tap (dy, dx) is then
//   that buffer from row dy * TW on, and with TW % 8 == 0 each tap's m64
//   starts on a swizzle atom (8 rows). A k16 step is 32 bytes along the
//   row; no shift ever falls inside an atom.
// * B (weights) is MN-major, read from HWIO as it is: a 4-D map (Cout, C,
//   3, 3) with boxes of (64 output channels, KC input channels, 1 dx, 3
//   dy), 128-byte swizzled, one row of output channels per input channel;
//   two boxes make a stage's N = 128 for its three taps. No repack.
// * A stage is (leg, KC-channel chunk, dx): 20 KB of A and 24 KB of B, 4
//   stages (a ring of 2 stages of 64 channels, 88 KB each, gave the loads
//   one stage of lead and ran slower on the H100). The producer keeps the
//   ring full
//   with mbarrier completion; each consumer runs 12 m64n128k16 wgmmas a
//   stage, keeps one stage's group in flight and frees the stage before
//   it. Legs run one after the other into the one f32 accumulator.
// * Epilogue: bf16 stored from the fragments, pixels past H or W masked;
//   the moments summed in a fixed order (thread, shuffle tree, warps in
//   order), one (b, tile) slot each, no atomics: a repeat is bit-exact.
// * Persistent grid (one wave, fixed by the shapes in the Python plan):
//   a block runs every grid-th output block, the ring running on, so the
//   next block's first loads overlap this one's epilogue. Output blocks
//   are (image, tile) major, the output-channel blocks of one tile next to
//   each other, so A comes from L2 after its first read.
#include "tma.cuh"  // the operand pass, TMA, mbarrier and wgmma helpers

namespace ircolor {
namespace {

constexpr int TH = 8;                            // output rows a block
constexpr int TW = 32;                           // output columns a block
constexpr int BN = 128;                          // output channels a block
constexpr int KC = 32;                           // input channels a stage
constexpr int CONSUMERS = 2;                     // warpgroups, TH / 2 rows each
constexpr int NTHREADS = CONSUMERS * 128 + 32;   // + the producer warp
constexpr int STAGES = 4;
constexpr int A_ROW = KC * 2;                    // one pixel: 64 bytes
constexpr int A_BYTES = (TH + 2) * TW * A_ROW;   // one dx buffer: 20 KB
constexpr int B_ATOM = KC * 128;                 // KC ci x 64 co: 4 KB
constexpr int B_HALF = 3 * B_ATOM;               // its three taps (dy)
constexpr int STAGE = A_BYTES + 2 * B_HALF;      // 44 KB
constexpr int RED_BYTES = CONSUMERS * 4 * BN * 2 * 4;  // the moments' warp partials
constexpr int SMEM = STAGES * STAGE + RED_BYTES + 2 * STAGES * 8 + 1024;  // + barriers, alignment
static_assert(TW % 8 == 0 && 64 % TW == 0, "an m64 sub-tile is whole rows on swizzle atoms");
static_assert(TH == 4 * CONSUMERS, "two m64 sub-tiles of 2 rows a warpgroup");
static_assert(A_BYTES % 1024 == 0 && STAGE % 1024 == 0, "B boxes on 1 KB atoms");

// m64n128k16, bf16 x bf16 -> f32, D += A*B: A K-major (channels contiguous
// in each pixel's row), B MN-major (output channels contiguous).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

struct FwdArgs {
  __nv_bfloat16* out;  // (B, H, W, Cout)
  float* partial;      // (B, ntiles, 2, Cout) or null (no stats)
  int H, W, Cout;      // the output plane
  int nchunk0, nchunk1;  // KC-channel chunks of leg 0 and leg 1
  int ntc, ntiles, ncob;  // tile columns, tiles an image, 128-channel blocks
  int ntasks;          // B * ntiles * ncob output blocks
  int shift;           // 1: A reads the unpadded input from -1 (zero halos)
};

// Persistent: block x runs output blocks task = x, x + gridDim.x, ...,
// task = (b * ntiles + tile) * ncob + cob. The ring runs on across tasks,
// so the producer loads a task's first stages during the last one's
// epilogue.
__global__ void __launch_bounds__(NTHREADS, 1)
    conv_fwd_gemm_kernel(const __grid_constant__ CUtensorMap ta0,
                         const __grid_constant__ CUtensorMap ta1,
                         const __grid_constant__ CUtensorMap tb0,
                         const __grid_constant__ CUtensorMap tb1, const FwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1 KB
  const uint32_t red = base + STAGES * STAGE;
  const uint32_t full0 = red + RED_BYTES, empty0 = full0 + STAGES * 8;
  const int nst = 3 * (a.nchunk0 + a.nchunk1);
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // Producer warp: one thread issues every copy. Stage j of a task: leg,
    // chunk (j / 3) and dx (j % 3); g counts stages over all tasks.
    if (lane != 0) return;
    int g = 0;
    for (int task = blockIdx.x; task < a.ntasks; task += gridDim.x) {
      const int mt = task / a.ncob, co0 = (task % a.ncob) * BN;
      const int b = mt / a.ntiles, tile = mt % a.ntiles;
      const int r0 = (tile / a.ntc) * TH, c0 = (tile % a.ntc) * TW;
      for (int j = 0; j < nst; ++j, ++g) {
        const int s = g % STAGES;
        const uint32_t full = full0 + 8 * s, dst = base + s * STAGE;
        mbar_wait(empty0 + 8 * s, ((g / STAGES) & 1) ^ 1);
        const int chunk = j / 3, dx = j % 3;
        const bool leg1 = chunk >= a.nchunk0;
        const int ci0 = (leg1 ? chunk - a.nchunk0 : chunk) * KC;
        const CUtensorMap* ta = leg1 ? &ta1 : &ta0;
        const CUtensorMap* tb = leg1 ? &tb1 : &tb0;
        mbar_expect_tx(full, STAGE);
        tma_load(dst, ta, full, ci0, c0 + dx - a.shift, r0 - a.shift, b);
        tma_load(dst + A_BYTES, tb, full, co0, ci0, dx, 0);
        tma_load(dst + A_BYTES + B_HALF, tb, full, co0 + 64, ci0, dx, 0);
      }
    }
    return;
  }

  // Consumer warpgroup wg: output rows r0 + 4 wg + [0, 4) of each task, as
  // two m64 sub-tiles of 2 rows; 128 output channels.
  const int warp = (threadIdx.x / 32) % 4;
  float* redp = reinterpret_cast<float*>(smem_raw + (red - smem_u32(smem_raw)));
  const bool stats = a.partial != nullptr;
  int g = 0;
  for (int task = blockIdx.x; task < a.ntasks; task += gridDim.x) {
    const int mt = task / a.ncob, co0 = (task % a.ncob) * BN;
    const int b = mt / a.ntiles, tile = mt % a.ntiles;
    const int r0 = (tile / a.ntc) * TH, c0 = (tile % a.ntc) * TW;
    float acc[2][64];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[t][i] = 0.f;
    for (int j = 0; j < nst; ++j, ++g) {
      const int s = g % STAGES;
      const uint32_t st = base + s * STAGE;
      mbar_wait(full0 + 8 * s, (g / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {  // k16 steps: 32 bytes of A's row, 16 rows of B
          const uint64_t db = smem_desc(st + A_BYTES + dy * B_ATOM + ks * 2048, B_HALF);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const uint32_t arow = (4 * wg + 2 * t + dy) * TW;  // first buffer row of the tap
            wgmma_n128(acc[t], smem_desc_k64(st + arow * A_ROW + ks * 32), db);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the stage before this one is done with its buffers
      if (j > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % STAGES));
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % STAGES));  // the task's last stage

    // Epilogue. Accumulator i of a thread: sub-tile row p = 16*warp +
    // lane/4 (+8 for the odd pair), column 8*(i/4) + 2*(lane%4) (+1); row p
    // of sub-tile t is output pixel (r0 + 4 wg + 2 t + p / TW, c0 + p % TW).
    bool valid[2][2];
    size_t obase[2][2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * warp + lane / 4 + 8 * h;
        const int r = r0 + 4 * wg + 2 * t + p / TW, c = c0 + p % TW;
        valid[t][h] = r < a.H && c < a.W;
        obase[t][h] = (((size_t)b * a.H + r) * a.W + c) * a.Cout + co0 + 2 * (lane % 4);
      }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y0 = acc[t][4 * i + 2 * h], y1 = acc[t][4 * i + 2 * h + 1];
          if (valid[t][h]) {
            *reinterpret_cast<uint32_t*>(a.out + obase[t][h] + 8 * i) = pack_bf16x2(y0, y1);
            s1[0] += y0;
            s1[1] += y1;
            s2[0] += y0 * y0;
            s2[1] += y1 * y1;
          }
        }
      if (!stats) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {  // the 8 lanes of one column pair
          s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], off);
          s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], off);
        }
      if (lane < 4) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * i + 2 * lane + e;
          redp[((wg * 4 + warp) * BN + col) * 2] = s1[e];
          redp[((wg * 4 + warp) * BN + col) * 2 + 1] = s2[e];
        }
      }
    }
    if (!stats) continue;
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");  // consumers only
    if (threadIdx.x < BN) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int w = 0; w < CONSUMERS * 4; ++w) {  // warps in a fixed order
        t1 += redp[(w * BN + threadIdx.x) * 2];
        t2 += redp[(w * BN + threadIdx.x) * 2 + 1];
      }
      float* dst = a.partial + ((size_t)mt * 2) * a.Cout + co0 + threadIdx.x;
      dst[0] = t1;
      dst[a.Cout] = t2;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");  // red is free again
  }
}

// HWIO weights (3, 3, C, Cout) as a 4-D map (Cout, C, 3 dx, 3 dy), boxes of
// (64 output channels, KC input channels, 1 dx, 3 dy).
int make_weight_map(CUtensorMap* map, const void* k, int C, int Cout) {
  const cuuint64_t dims[4] = {(cuuint64_t)Cout, (cuuint64_t)C, 3, 3};
  const cuuint64_t strides[3] = {(cuuint64_t)Cout * 2, (cuuint64_t)C * Cout * 2,
                                 (cuuint64_t)3 * C * Cout * 2};
  const cuuint32_t box[4] = {64, KC, 1, 3};
  return make_map_4d(map, k, dims, strides, box);
}

}  // namespace
}  // namespace ircolor

extern "C" {

// The GEMM's output tile: the Python plan must use the same.
int ircolor_conv_fwd_tile_rows() { return ircolor::TH; }
int ircolor_conv_fwd_tile_cols() { return ircolor::TW; }
// Dynamic shared memory of a GEMM block (the ring, the moments' partials,
// barriers, alignment).
int ircolor_conv_fwd_smem() { return ircolor::SMEM; }

// The operand pass: out (B, H+2*pad, W+2*pad, C) = x (B, H, W, C),
// reflect-padded by one pixel (pad = 1) or as it is (pad = 0), of
// bf16(relu((x - mean)*inv)) where mean is non-null.
int ircolor_conv_fwd_pass(const void* x, const void* mean, const void* inv, void* out, int B,
                          int H, int W, int C, int pad, void* stream) {
  using namespace ircolor;
  if (C % 8 || (pad != 0 && pad != 1)) return (int)cudaErrorInvalidValue;
  PassArgs a = {};
  a.z = static_cast<const __nv_bfloat16*>(x);
  a.zm = static_cast<const float*>(mean);
  a.zi = static_cast<const float*>(inv);
  a.zp = static_cast<__nv_bfloat16*>(out);
  a.ndy = 0;
  a.nzp = (long long)B * (H + 2 * pad) * (W + 2 * pad) * (C / 8);
  a.H = H;
  a.W = W;
  a.Cz = C;
  a.zpad = pad;
  return launch_operand_pass(a, static_cast<cudaStream_t>(stream));
}

// out (B, H, W, Cout) bf16 and, with partial non-null, partial (B, ntiles,
// 2, Cout) f32 (ntiles = ceil(H/TH) * ceil(W/TW)) of the conv of leg 0 (x0,
// k0 (3, 3, C0, Cout)) and, with x1 non-null, leg 1 (x1, k1, C1). zero = 1:
// the legs are (B, H, W, C) and read with zero halos; zero = 0: they are
// padded, (B, H+2, W+2, C). C0, C1 % 64 == 0, Cout % 128 == 0. grid:
// persistent blocks, each running every grid-th output block.
int ircolor_conv_fwd_gemm(const void* x0, const void* k0, int C0, const void* x1, const void* k1,
                          int C1, void* out, void* partial, int B, int H, int W, int Cout,
                          int zero, int grid, void* stream) {
  using namespace ircolor;
  if (C0 <= 0 || C0 % 64 || C1 % 64 || (x1 == nullptr) != (C1 == 0) || Cout % BN || B < 1 ||
      H < 1 || W < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const int pad = zero ? 0 : 2;
  CUtensorMap ta0, ta1, tb0, tb1;
  int err = make_nhwc_map(&ta0, x0, B, H + pad, W + pad, C0, TH + 2, TW, KC);
  if (err == 0) err = make_weight_map(&tb0, k0, C0, Cout);
  if (err == 0 && x1 != nullptr) err = make_nhwc_map(&ta1, x1, B, H + pad, W + pad, C1, TH + 2, TW, KC);
  if (err == 0 && x1 != nullptr) err = make_weight_map(&tb1, k1, C1, Cout);
  if (err != 0) return err;
  if (x1 == nullptr) {
    ta1 = ta0;
    tb1 = tb0;
  }
  FwdArgs a;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.partial = static_cast<float*>(partial);
  a.H = H;
  a.W = W;
  a.Cout = Cout;
  a.nchunk0 = C0 / KC;
  a.nchunk1 = C1 / KC;
  a.ntc = (W + TW - 1) / TW;
  a.ntiles = ((H + TH - 1) / TH) * a.ntc;
  a.ncob = Cout / BN;
  a.shift = zero ? 1 : 0;
  const long long tasks = (long long)B * a.ntiles * a.ncob;
  if (tasks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  a.ntasks = (int)tasks;
  cudaError_t e =
      cudaFuncSetAttribute(conv_fwd_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  conv_fwd_gemm_kernel<<<grid, NTHREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      ta0, ta1, tb0, tb1, a);
  return (int)cudaGetLastError();
}

}  // extern "C"
