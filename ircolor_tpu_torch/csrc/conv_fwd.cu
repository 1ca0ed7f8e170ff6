// 3x3 conv (bf16 operands, f32 accumulation; or s8 operands, s32
// accumulation) of the generator's resnet blocks, of the JAX package's
// other 3x3 conv kernels and of the blocks' and enc/dec segments' backward
// dgrad, for Hopper (sm_90a): an operand pass where a halo, a quantize, a
// normalize or an IN backward needs one, then an implicit GEMM on TMA +
// wgmma with an epilogue policy.
//
// Replaces (ircolor_tpu/ops/):
//   pallas_resblock.py:conv3x3_reflect_fused (:280, pallas_call :358)
//       reflect halos, raw or with the previous IN + ReLU on load;
//   pallas_resblock.py:conv3x3_reflect_fused_q (_kernel_q :1289, :1385,
//       pallas_call :1471): the int8 block conv, reflect halos, the input
//       quantized on load (conv1: by the per-sample 127/amax; conv2: IN +
//       ReLU, then the fixed 127/6 grid);
//   pallas_resblock.py:conv3x3_sum_fused (:1190, pallas_call :1246)
//       zero or reflect halos, one or two input legs;
//   pallas_block.py:_run (:105, pallas_call :138), conv3x3_stats /
//       conv3x3_norm_in_stats: VALID over a pre-padded input, raw or
//       normalized on load;
//   pallas_conv.py:conv3x3_valid_pallas_v2 (:177, :234) and
//       conv3x3_valid_pallas (:256, :305): VALID, no stats;
//   pallas_resblock.py:conv3x3_dgrad_fused (:692, pallas_call :818), also
//       run by pallas_encdec.py:113 (the segments: zero halos, p masked on
//       load, no aux): the IN backward, the dgrad conv, the ReflectionPad
//       fold, and the mask-stats / residual / plain epilogue;
//   and, not a Pallas kernel, XLA's int8 conv of the int8 route outside the
//       fused blocks (quant.py:conv2d_int8 :93 and conv2d_int8_fixed,
//       lax.conv_general_dilated on int8 operands, int32 sums): down1,
//       down2, the unfused blocks and each leg of the int8 concat convs
//       (up1, up2), on an input that arrives quantized; stride 1 or 2
//       (the no_antialias down convs), zero, reflect or VALID halos.
//
//   out[b, r, c, co] = sum_{leg, ci, dy, dx} Xp[b, r+dy, c+dx, ci] * k[dy, dx, ci, co]
//
// in f32, stored once as bf16 through the epilogue policy:
// * stats (the forward): out and the per-(b, tile) sum and sum of squares
//   of the f32 values (over every leg, before rounding) for the caller's
//   instance norm;
// * store: out alone;
// * q-stats (the int8 block conv): y = f32(s32 acc) * sc[b, co] (cvt.rn,
//   one multiply: the plain version's steps, so out is bit-identical to
//   it), then the stats policy on y;
// * q-conv (the int8 conv): the same y, then + addend[b, r, c, co] (f32)
//   and + bias[co] where given, each one IEEE add in the plain version's
//   order, stored as f32 or bf16; no stats. Its channels need not fill
//   the tile: the weights come zero-extended, A's last chunk runs into
//   TMA's zero fill past C, and the channels past Cout are masked;
// and the dgrad's, which add the fold first (see below):
// * mask-stats (the block dgrad's launch 1): out = bf16(y * [aux > mm]) and
//   per-(b, tile) sums of y_masked and y_masked * (aux - mm) * mi;
// * residual (launch 2): out = bf16(y + aux);
// * dz (the segments): out = bf16(y).
// Xp is the reflect-padded Zp the pass wrote, the pre-padded input (VALID),
// or the unpadded input read from coordinate -1 (zero halos: TMA fills what
// lies outside with zeros).
//
// The dgrad: dy = bf16(inv*((p - gm) - n*gy)), n = (comp - m)*inv (the IN
// backward; with mask_p, p is kept where comp > m) is written by the operand
// pass, bit-identical to the plain version's; then F = the zero-SAME conv of
// dy with kdg = rot180(k) transposed in channels (HWIO (3, 3, C, Cin), made
// by the wrapper) is this GEMM on one leg with zero halos. For reflect
// halos dz is F plus the ReflectionPad(1) VJP's fold: the transposed conv's
// halo entries F[-1, .] (from dy row 0 and the forward kernel's top row)
// fold onto row 1, F[H, .] (dy row H-1, bottom row) onto row H-2, F[., -1]
// and F[., W] (dy columns 0 and W-1, left and right kernel columns) onto
// columns 1 and W-2, the four corners F[-1, -1] ... each onto one pixel.
//
// What bounds it on the H100: the tensor cores. At the flagship bottleneck
// (32x128x160x256 -> 256) one forward conv is 0.77 TFLOP against 0.67 GB of
// activations in and out (~1150 flop/byte, far above the card's ridge
// point of ~295; the int8 block conv: 0.77 TOP at twice the rate, ~590 a
// byte); at down2 (128 -> 256) and up1 (256 + 128 -> 128), 256x320,
// ~770 and ~860 flop/byte; the dgrad at the b8 bottleneck 0.193 TFLOP
// against ~0.34 GB (~600 flop/byte). The int8 conv at batch 1 is bound by
// the int8 tensor cores at down2, the blocks and up1's first leg, by the
// memory where the output is wider than the input or f32 (down1, up1's
// second leg, up2); every site is a few hundred output blocks, so the
// last wave decides much of its time. The operand passes are memory-bound.
// The weights (at most 1.2 MB) and the planes' recent rows stay in L2, so
// the tile's shape decides the L2 -> shared traffic: a stage moves 44 KB for
// 6.3 MFLOP of wgmma (~0.007 byte a flop, ~5 TB/s at 700 TFLOP/s).
//
// Design:
// * Operand pass (tma.cuh, memory-bound): REFLECT writes the reflect-padded
//   Zp (B, H+2, W+2, C) of x or of bf16(relu((x - mean)*inv)); VALID with
//   mean/inv normalizes the padded input as it is; the dgrad writes dy; the
//   int8 block conv writes the reflect-padded quantized Zp as int8 (its
//   reflect index map is where a spatial shard's halo row would come in),
//   and the int8 conv's reflect sites copy their quantized input into the
//   reflect-padded Zp. ZERO and VALID raw need none: the GEMM reads the
//   input itself.
// * GEMM: a block owns TH x TW = 8 x 32 output pixels (M = 256) of one
//   image and BN = 128 output channels (N; 64 where Cout % 128 != 0, the
//   segments' dz of 64): two consumer warpgroups of 4 rows (two m64
//   sub-tiles, 2 rows each) and one producer warp, one thread of which
//   issues the copies. The dgrad's policies and q-conv take a producer
//   warpgroup in its place, which hands its registers to the consumers
//   (setmaxnreg: 40 for it, 232 for them, where a 384-thread block gets 168
//   a thread; at 168 their epilogues spilled up to 4.5 KB, q-conv's 320
//   bytes; the forward's policies ran slower as a 384-thread block).
//   M = 256 halves the weight traffic a flop of the old 128-pixel tile.
// * A (activations) is K-major: TMA copies a box of (KC = 32 channels, TW
//   columns, TH + 2 rows, 1 image), 64-byte swizzled, one pixel a 64-byte
//   row. A stage holds one such box at column c0 + dx: tap (dy, dx) is then
//   that buffer from row dy * TW on, and with TW % 8 == 0 each tap's m64
//   starts on a swizzle atom (8 rows). A k16 step is 32 bytes along the
//   row; no shift ever falls inside an atom.
// * B (weights) is MN-major, read from HWIO as it is: a 4-D map (Cout, C,
//   3, 3) with boxes of (64 output channels, KC input channels, 1 dx, 3
//   dy), 128-byte swizzled, one row of output channels per input channel;
//   BN / 64 boxes make a stage's N for its three taps. No repack.
// * The int8 form: wgmma takes s8 operands K-major only (the transposed
//   layout is for f16/bf16), so the weights come repacked as (3, 3, Cout,
//   C), C innermost (0.6 MB at the blocks), read through a 4-D map (C,
//   Cout, 3, 3) in boxes of (64 input channels, 128 output channels, 1 dx,
//   3 dy), 64-byte swizzled like A: 24 KB a stage. A stage of A holds KC_S8
//   = 64 channels, one 64-byte row a pixel: the bf16 box's bytes, so A's
//   descriptors and tap offsets are the bf16 ones, a k32 s8 step is 32
//   bytes along the row as a k16 bf16 one, and a stage does twice the MACs
//   for the same 44 KB. m64n128k32 s8 wgmmas into s32 accumulators (the
//   same registers as f32 ones; |acc| <= 127 * 127 * 9 * C < 2^31 for C
//   < 14,800: no saturation). The q-conv policy also runs N = 64
//   (m64n64k32, a 12 KB B box: 32 KB stages) where the plan picks it:
//   Cout' = 64, or a batch-1 site whose N = 128 output blocks leave a
//   short last wave on the 132 SMs.
// * A stage is (leg, KC-channel chunk, dx): 20 KB of A and 12 KB of B per
//   64 output channels, 4 stages (a ring of 2 stages of 64 channels, 88 KB
//   each, gave the loads one stage of lead and ran slower on the H100). The
//   producer keeps the ring full with mbarrier completion; each consumer
//   runs 12 m64nBNk16 wgmmas a stage, keeps one stage's group in flight and
//   frees the stage before it. Legs run one after the other into the one
//   f32 accumulator.
// * Epilogue: the fold terms added to the f32 value of the pixels on rows
//   1, H-2 and columns 1, W-2 (only where the caller passes fold lines),
//   then the policy; bf16 stored from the fragments, pixels past H or W
//   masked; the sums taken in a fixed order (thread, shuffle tree, warps in
//   order), one (b, tile) slot each, no atomics: a repeat is bit-exact.
//   Its global reads (aux, the fold terms) are read-only loads issued one
//   column group (i) ahead, and mm/mi sit in shared memory: read where
//   used, each was a round trip the idle tensor cores waited on.
// * Stride 2 (q-conv only): the int8 phase pass writes the four (row,
//   column) parity planes of the padded input, P[py][px][u, v] = Xp[2u+py,
//   2v+px], each (Ho+1) x (Wo+1), stacked as Q (B, 2(Ho+1), 2(Wo+1), C):
//   then out[i, j] reads tap (dy, dx) at Q[ro(dy) + i, co(dx) + j] with ro =
//   {0, Ho+1, 1} and co = {0, Wo+1, 1}. The column offset is the A box's
//   column; the rows are not one box's rows at offset dy (dy = 1 lies in the
//   odd plane), so a stage is (chunk, dx, row parity): the even box serves
//   dy = 0 and 2 at row offsets 0 and 1, the odd box dy = 1. Six stages a
//   chunk, the same wgmmas as stride 1; A's L2 reads double, B's box is the
//   stride-1 one (its unused tap rides along). The pass adds a read and a
//   write of the input (TMA elementStrides of 2 would avoid both; not
//   taken: this form reuses the stride-1 stage and the VALID halo mode as
//   they are).
// * Persistent grid (one wave, fixed by the shapes in the Python plan):
//   a block runs every grid-th output block, the ring running on, so the
//   next block's first loads overlap this one's epilogue. Output blocks
//   are (image, tile) major, the output-channel blocks of one tile next to
//   each other, so A comes from L2 after its first read.
// * The fold lines (the dgrad with reflect halos): a small kernel computes
//   F[-1, -1..W], F[H, -1..W] (B, 2, W+2, Cin) and F[0..H-1, -1], F[0..H-1,
//   W] (B, H, 2, Cin) in f32 from dy and the forward kernel as it is (its
//   last dim, C, is K: an mma.sync B fragment is one 32-bit load): per line
//   pixel 3 taps x C on m16n8k16, both fragments read straight from L2; a
//   block is 64 line pixels x 64 channels, a warp a tap, each B fragment
//   feeding four m16 tiles. At the b8 blocks that is 4,640 line pixels, 1.8
//   GFLOP (0.9% of the GEMM's) and a 4.75 MB side buffer. A fold inside the
//   GEMM's K loop was not taken: an m64 sub-tile is 2 rows x 32 columns, so
//   a column fold needs a stage of its own per chunk (one column of 32 is
//   not zero) on the 32 of 80 tiles that hold column 1 or W-2 at the blocks
//   (+13% of the GEMM's loads and wgmmas).
#include <type_traits>

#include "tma.cuh"  // the operand pass, TMA, mbarrier and wgmma helpers

namespace ircolor {
namespace {

constexpr int TH = 8;                            // output rows a block
constexpr int TW = 32;                           // output columns a block
constexpr int KC = 32;                           // input channels a stage
constexpr int KC_S8 = 64;                        // input channels an int8 stage
constexpr int CONSUMERS = 2;                     // warpgroups, TH / 2 rows each
// Threads of a block: the consumers and a producer warp, or (the dgrad's
// policies and q-conv: see wide_producer) a producer warpgroup whose
// registers setmaxnreg hands over.
constexpr int threads_of(bool wide) { return CONSUMERS * 128 + (wide ? 128 : 32); }
constexpr int STAGES = 4;
constexpr int A_ROW = KC * 2;                    // one pixel: 64 bytes
constexpr int A_BYTES = (TH + 2) * TW * A_ROW;   // one dx buffer: 20 KB
constexpr int B_ATOM = KC * 128;                 // KC ci x 64 co: 4 KB
constexpr int B_HALF = 3 * B_ATOM;               // one 64-channel box: its three taps (dy)
static_assert(TW == 32, "an m64 sub-tile is two whole rows on swizzle atoms");
static_assert(TH == 4 * CONSUMERS, "two m64 sub-tiles of 2 rows a warpgroup");
static_assert(A_BYTES % 1024 == 0 && B_HALF % 1024 == 0, "B boxes on 1 KB atoms");
static_assert(KC_S8 == A_ROW && 3 * 128 * KC_S8 == 2 * B_HALF,
              "an int8 stage has the bf16 stage's bytes at BN 128");

// The ring and shared memory of a block with BN output channels.
template <int BN>
struct Ring {
  static constexpr int STAGE = A_BYTES + (BN / 64) * B_HALF;     // 44 KB at BN 128
  static constexpr int RED_BYTES = CONSUMERS * 4 * BN * 2 * 4;   // the sums' warp partials
  static constexpr int MASK_BYTES = 2 * BN * 4;                  // a task's mm, mi (or sc)
  static constexpr int SMEM =
      STAGES * STAGE + RED_BYTES + MASK_BYTES + 2 * STAGES * 8 + 1024;  // + barriers, alignment
};

// The epilogue policies (see the note at the top): the forward's stats and
// store; the dgrad's mask-stats, residual and dz (store), which add the
// fold; on s8 operands, the int8 block conv's q-stats and the int8 conv's
// q-conv.
enum Epi {
  EPI_STATS = 0,
  EPI_STORE = 1,
  EPI_MASK_STATS = 2,
  EPI_RESIDUAL = 3,
  EPI_DZ = 4,
  EPI_QSTATS = 5,
  EPI_QCONV = 6
};
__host__ __device__ constexpr bool is_dgrad(int epi) { return epi >= EPI_MASK_STATS && epi <= EPI_DZ; }
__host__ __device__ constexpr bool is_s8(int epi) { return epi == EPI_QSTATS || epi == EPI_QCONV; }
// The policies whose consumers need more than the 168 registers a thread of
// a 288-thread block gets (three warps share a quarter of the register
// file): q-conv's epilogue (the addend read one column group ahead) spilled
// 320 bytes at N = 128 there.
__host__ __device__ constexpr bool wide_producer(int epi) {
  return is_dgrad(epi) || epi == EPI_QCONV;
}

// Registers a thread of this warpgroup may hold from here on: the producer
// gives its share to the consumers, whose accumulators alone take 128.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Read-only loads (ld.global.nc): nothing a kernel here stores aliases
// them, so they may move ahead of the epilogue's stores.
__device__ __forceinline__ uint32_t ldg32(const void* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ float2 ldg_f2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

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

// m64n64k16, the same operands with one 64-channel B box.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// m64n128k32, s8 x s8 -> s32, D += A*B: both operands K-major (input
// channels contiguous in each pixel's and each output channel's row).
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// m64n64k32, the same operands with a 64-channel B box.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

struct FwdArgs {
  __nv_bfloat16* out;  // (B, H, W, Cout)
  float* partial;      // (B, ntiles, 2, Cout): the stats and mask-stats policies
  const __nv_bfloat16* aux;  // (B, H, W, Cout): mask-stats (raw1) and residual
  const float* mm;     // (B, Cout) mask-stats: aux's IN mean and inv
  const float* mi;
  const float* sc;     // (B, Cout) q-stats, q-conv: the dequant scale
  const float* addend; // (B, H, W, Cout) q-conv: f32 added to y, or null
  const float* bias;   // (Cout) q-conv: f32 added last, or null
  float* out_f32;      // (B, H, W, Cout) q-conv: f32 output in out's place, or null
  const float* fold;   // (B, 2, W+2, Cout) f32 fold rows, or null (no fold)
  const float* fold_cols;  // (B, H, 2, Cout) f32 fold columns
  int H, W, Cout;      // the output plane
  int nchunk0, nchunk1;  // KC-channel chunks of leg 0 and leg 1
  int ntc, ntiles, ncob;  // tile columns, tiles an image, BN-channel blocks
  int ntasks;          // B * ntiles * ncob output blocks
  int shift;           // 1: A reads the unpadded input from -1 (zero halos)
};

// One stage of a consumer warpgroup: wait for it, issue its wgmmas, keep
// them in flight and free the stage before. TAPS: the taps dy (bit dy) the
// stage's A box serves, at buffer row offset dy (stride 1: all three) or
// dy / 2 (stride 2: the even box dy 0 and 2 at rows 0 and 1, the odd box
// dy 1 at row 0).
template <int BN, bool S8, int TAPS, bool S2, typename Acc>
__device__ __forceinline__ void consume_stage(Acc (&acc)[2][BN / 2], uint32_t base,
                                              uint32_t full0, uint32_t empty0, int& g, int j,
                                              int wg, int lane) {
  const int s = g % STAGES;
  const uint32_t st = base + s * Ring<BN>::STAGE;
  mbar_wait(full0 + 8 * s, (g / STAGES) & 1);
  wgmma_fence();
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    if (!((TAPS >> dy) & 1)) continue;
#pragma unroll
    for (int ks = 0; ks < A_ROW / 32; ++ks) {  // 32 bytes of A's row: k16 bf16, k32 s8
      // bf16: 16 rows of the MN-major B; s8: 32 bytes of each K-major
      // output channel's row of tap dy.
      const uint64_t db = S8 ? smem_desc_k64(st + A_BYTES + dy * BN * KC_S8 + ks * 32)
                             : smem_desc(st + A_BYTES + dy * B_ATOM + ks * 2048, B_HALF);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        // first buffer row of the tap
        const uint32_t arow = (4 * wg + 2 * t + (S2 ? dy / 2 : dy)) * TW;
        const uint64_t da = smem_desc_k64(st + arow * A_ROW + ks * 32);
        if constexpr (S8 && BN == 128) {
          wgmma_s8_n128(acc[t], da, db);
        } else if constexpr (S8) {
          wgmma_s8_n64(acc[t], da, db);
        } else if constexpr (BN == 128) {
          wgmma_n128(acc[t], da, db);
        } else {
          wgmma_n64(acc[t], da, db);
        }
      }
    }
  }
  wgmma_commit();
  wgmma_wait<1>();  // the stage before this one is done with its buffers
  if (j > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % STAGES));
  ++g;
}

// Persistent: block x runs output blocks task = x, x + gridDim.x, ...,
// task = (b * ntiles + tile) * ncob + cob. The ring runs on across tasks,
// so the producer loads a task's first stages during the last one's
// epilogue. S2: stride 2 over the parity planes (q-conv only).
template <int BN, int EPI, bool S2 = false>
__global__ void __launch_bounds__(threads_of(wide_producer(EPI)), 1)
    conv_fwd_gemm_kernel(const __grid_constant__ CUtensorMap ta0,
                         const __grid_constant__ CUtensorMap ta1,
                         const __grid_constant__ CUtensorMap tb0,
                         const __grid_constant__ CUtensorMap tb1, const FwdArgs a) {
  constexpr int STAGE = Ring<BN>::STAGE;
  constexpr bool S8 = is_s8(EPI);  // s8 operands, s32 accumulators
  constexpr bool QCONV = EPI == EPI_QCONV;
  constexpr bool STATS = EPI == EPI_STATS || EPI == EPI_MASK_STATS || EPI == EPI_QSTATS;
  constexpr bool DGRAD = is_dgrad(EPI);
  constexpr int KCH = S8 ? KC_S8 : KC;  // input channels a stage
  constexpr int SPC = S2 ? 6 : 3;       // stages a chunk: dx (x row parity)
  static_assert(EPI != EPI_QSTATS || BN == 128, "the int8 block conv runs N = 128");
  static_assert(!S2 || QCONV, "stride 2 is the int8 conv's");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1 KB
  const uint32_t red = base + STAGES * STAGE;
  const uint32_t maskp = red + Ring<BN>::RED_BYTES;
  const uint32_t full0 = maskp + Ring<BN>::MASK_BYTES, empty0 = full0 + STAGES * 8;
  const int nst = SPC * (a.nchunk0 + a.nchunk1);
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
    // Producer warp(group): one thread issues every copy. Stage j of a task: leg,
    // chunk (j / 3) and dx (j % 3); stride 2: chunk (j / 6), dx ((j / 2) % 3)
    // and row parity (j % 2). g counts stages over all tasks.
    if constexpr (wide_producer(EPI)) setmaxnreg_dec<40>();
    if (threadIdx.x != CONSUMERS * 128) return;
    int g = 0;
    for (int task = blockIdx.x; task < a.ntasks; task += gridDim.x) {
      const int mt = task / a.ncob, co0 = (task % a.ncob) * BN;
      const int b = mt / a.ntiles, tile = mt % a.ntiles;
      const int r0 = (tile / a.ntc) * TH, c0 = (tile % a.ntc) * TW;
      for (int j = 0; j < nst; ++j, ++g) {
        const int s = g % STAGES;
        const uint32_t full = full0 + 8 * s, dst = base + s * STAGE;
        mbar_wait(empty0 + 8 * s, ((g / STAGES) & 1) ^ 1);
        const int chunk = j / SPC, dx = S2 ? (j / 2) % 3 : j % 3;
        const bool leg1 = chunk >= a.nchunk0;
        const int ci0 = (leg1 ? chunk - a.nchunk0 : chunk) * KCH;
        const CUtensorMap* ta = leg1 ? &ta1 : &ta0;
        const CUtensorMap* tb = leg1 ? &tb1 : &tb0;
        mbar_expect_tx(full, STAGE);
        if constexpr (S2) {  // the parity planes, H + 1 rows, W + 1 columns each:
          // columns {0, W + 1, 1}[dx], rows {0, H + 1}[parity]
          tma_load(dst, ta, full, ci0, c0 + (dx == 1 ? a.W + 1 : dx / 2), r0 + (j % 2) * (a.H + 1),
                   b);
        } else {
          tma_load(dst, ta, full, ci0, c0 + dx - a.shift, r0 - a.shift, b);
        }
        if constexpr (S8) {  // one K-major box: [dy][BN co][64 ci]
          tma_load(dst + A_BYTES, tb, full, ci0, co0, dx, 0);
        } else {
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)
            tma_load(dst + A_BYTES + h * B_HALF, tb, full, co0 + 64 * h, ci0, dx, 0);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: output rows r0 + 4 wg + [0, 4) of each task, as
  // two m64 sub-tiles of 2 rows; BN output channels.
  if constexpr (wide_producer(EPI)) setmaxnreg_inc<232>();
  const int warp = (threadIdx.x / 32) % 4;
  float* redp = reinterpret_cast<float*>(smem_raw + (red - smem_u32(smem_raw)));
  float* maskv = reinterpret_cast<float*>(smem_raw + (maskp - smem_u32(smem_raw)));
  int g = 0;
  for (int task = blockIdx.x; task < a.ntasks; task += gridDim.x) {
    const int mt = task / a.ncob, co0 = (task % a.ncob) * BN;
    const int b = mt / a.ntiles, tile = mt % a.ntiles;
    const int r0 = (tile / a.ntc) * TH, c0 = (tile % a.ntc) * TW;
    if constexpr (EPI == EPI_MASK_STATS || S8) {
      // The task's mm and mi (or sc, and q-conv's bias) into shared memory
      // (the last task's epilogue is done with them: it ended on the
      // consumers' barrier, which q-conv, with no sums, waits on here).
      const int x = threadIdx.x;
      if constexpr (QCONV) {
        asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
        const int co = co0 + x % BN;  // channels past Cout read as 0
        if (x < 2 * BN)
          maskv[x] = co >= a.Cout ? 0.f
                     : x < BN     ? a.sc[(size_t)b * a.Cout + co]
                                  : (a.bias != nullptr ? a.bias[co] : 0.f);
      } else if constexpr (S8) {
        if (x < BN) maskv[x] = a.sc[(size_t)b * a.Cout + co0 + x];
      } else {
        if (x < 2 * BN) maskv[x] = x < BN ? a.mm[(size_t)b * a.Cout + co0 + x]
                                          : a.mi[(size_t)b * a.Cout + co0 + x - BN];
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
    }
    using Acc = std::conditional_t<S8, int, float>;
    Acc acc[2][BN / 2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[t][i] = 0;
    for (int j = 0; j < nst;) {
      if constexpr (S2) {  // the even box (dy 0, 2), then the odd one (dy 1)
        consume_stage<BN, S8, 5, true>(acc, base, full0, empty0, g, j++, wg, lane);
        consume_stage<BN, S8, 2, true>(acc, base, full0, empty0, g, j++, wg, lane);
      } else {
        consume_stage<BN, S8, 7, false>(acc, base, full0, empty0, g, j++, wg, lane);
      }
    }
    // Epilogue. Accumulator i of a thread: sub-tile row p = 16*warp +
    // lane/4 (+8 for the odd pair), column 8*(i/4) + 2*(lane%4) (+1); row p
    // of sub-tile t is output pixel (r0 + 4 wg + 2 t + p / TW, c0 + p % TW),
    // with TW = 32: row rw + 2 t, column cw + 8 h. Indices are computed where
    // used (the accumulators leave few registers); the global reads of the
    // next i (aux, the fold's main terms) are issued one i ahead.
    const int rw = r0 + 4 * wg + warp / 2, cw = c0 + 16 * (warp % 2) + lane / 4;
    const int cl = 2 * (lane % 4);  // the thread's first channel of each i
    const size_t obase = (((size_t)b * a.H + rw) * a.W + cw) * a.Cout + co0 + cl;
    constexpr bool AUX = EPI == EPI_MASK_STATS || EPI == EPI_RESIDUAL;
    // The fold (reflect dgrad): a pixel on row 1 or H-2 reads its row line,
    // one on column 1 or W-2 its column line; one on both (four pixels an
    // image) also reads the corner and its column line (`extra`).
    const float* fmain[2][2];
    bool extra[2][2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rw + 2 * t, c = cw + 8 * h;
        const bool er = r == 1 || r == a.H - 2, ec = c == 1 || c == a.W - 2;
        fmain[t][h] = nullptr;
        extra[t][h] = er && ec;
        if (!DGRAD || a.fold == nullptr || r >= a.H || c >= a.W) continue;
        if (er)
          fmain[t][h] = a.fold + ((size_t)(2 * b + (r != 1)) * (a.W + 2) + c + 1) * a.Cout + co0 + cl;
        else if (ec)
          fmain[t][h] = a.fold_cols + (((size_t)b * a.H + r) * 2 + (c != 1)) * a.Cout + co0 + cl;
      }
    // q-conv: its addend, read like aux (channel co0 + cl < Cout always).
    const bool qadd = QCONV && a.addend != nullptr;
    uint32_t nav[2][2];
    float2 nf[2][2], nad[2][2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = rw + 2 * t < a.H && cw + 8 * h < a.W;
        const size_t o = obase + ((size_t)2 * t * a.W + 8 * h) * a.Cout;
        nav[t][h] = AUX && ok ? ldg32(a.aux + o) : 0u;
        nf[t][h] = fmain[t][h] ? ldg_f2(fmain[t][h]) : make_float2(0.f, 0.f);
        nad[t][h] = qadd && ok ? ldg_f2(a.addend + o) : make_float2(0.f, 0.f);
      }
    wgmma_wait<0>();  // the loads above overlap the task's last wgmmas
    if (lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % STAGES));  // the task's last stage
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      // q-conv: Cout % 16 == 0, so a group of 8 channels lies wholly below
      // Cout or wholly past it, for every thread alike.
      if (QCONV && co0 + 8 * i >= a.Cout) break;
      uint32_t av[2][2];
      float2 fv[2][2], adv[2][2];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          av[t][h] = nav[t][h];
          fv[t][h] = nf[t][h];
          adv[t][h] = nad[t][h];
          if (i + 1 < BN / 8) {
            const bool ok = rw + 2 * t < a.H && cw + 8 * h < a.W;
            const size_t o = obase + ((size_t)2 * t * a.W + 8 * h) * a.Cout + 8 * (i + 1);
            if (AUX && ok) nav[t][h] = ldg32(a.aux + o);
            if (fmain[t][h]) nf[t][h] = ldg_f2(fmain[t][h] + 8 * (i + 1));
            if (qadd && ok && co0 + 8 * (i + 1) < a.Cout) nad[t][h] = ldg_f2(a.addend + o);
          }
        }
      float2 mm = make_float2(0.f, 0.f), mi = mm;  // S8: mm holds sc; q-conv: mi the bias
      if constexpr (EPI == EPI_MASK_STATS || S8)
        mm = *reinterpret_cast<const float2*>(maskv + 8 * i + cl);
      if constexpr (EPI == EPI_MASK_STATS || QCONV)
        mi = *reinterpret_cast<const float2*>(maskv + BN + 8 * i + cl);
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rw + 2 * t, c = cw + 8 * h;
          if (r >= a.H || c >= a.W) continue;
          const size_t o = obase + ((size_t)2 * t * a.W + 8 * h) * a.Cout + 8 * i;
          float y0, y1;
          if constexpr (S8) {  // dequantize: cvt.rn, then one multiply
            y0 = __fmul_rn(__int2float_rn(acc[t][4 * i + 2 * h]), mm.x);
            y1 = __fmul_rn(__int2float_rn(acc[t][4 * i + 2 * h + 1]), mm.y);
          } else {
            y0 = acc[t][4 * i + 2 * h];
            y1 = acc[t][4 * i + 2 * h + 1];
          }
          if (fmain[t][h]) {  // the fold enters the f32 value before the policy
            float2 f = fv[t][h];
            if (extra[t][h]) {
              const size_t ch = co0 + cl + 8 * i;
              const float2 corner = ldg_f2(
                  a.fold + ((size_t)(2 * b + (r != 1)) * (a.W + 2) + (c == 1 ? 0 : a.W + 1)) *
                               a.Cout + ch);
              const float2 side =
                  ldg_f2(a.fold_cols + (((size_t)b * a.H + r) * 2 + (c != 1)) * a.Cout + ch);
              f.x = f.x + corner.x + side.x;
              f.y = f.y + corner.y + side.y;
            }
            y0 += f.x;
            y1 += f.y;
          }
          if constexpr (AUX) {
            const float a0 = bf16_lo(av[t][h]), a1 = bf16_hi(av[t][h]);
            if constexpr (EPI == EPI_MASK_STATS) {
              y0 = a0 > mm.x ? y0 : 0.f;
              y1 = a1 > mm.y ? y1 : 0.f;
              s1[0] += y0;
              s1[1] += y1;
              s2[0] += y0 * __fmul_rn(__fsub_rn(a0, mm.x), mi.x);
              s2[1] += y1 * __fmul_rn(__fsub_rn(a1, mm.y), mi.y);
            } else {
              y0 += a0;
              y1 += a1;
            }
          } else if constexpr (QCONV) {  // (addend + y) + bias, each one rounding
            if (qadd) {
              y0 = __fadd_rn(adv[t][h].x, y0);
              y1 = __fadd_rn(adv[t][h].y, y1);
            }
            if (a.bias != nullptr) {
              y0 = __fadd_rn(y0, mi.x);
              y1 = __fadd_rn(y1, mi.y);
            }
            if (a.out_f32 != nullptr) {
              *reinterpret_cast<float2*>(a.out_f32 + o) = make_float2(y0, y1);
              continue;
            }
          } else if constexpr (STATS) {
            s1[0] += y0;
            s1[1] += y1;
            s2[0] += y0 * y0;
            s2[1] += y1 * y1;
          }
          *reinterpret_cast<uint32_t*>(a.out + o) = pack_bf16x2(y0, y1);
        }
      if constexpr (STATS) {
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
    }
    if constexpr (STATS) {
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

// The int8 weights repacked K-major, (3, 3, Cout, C), as a 4-D map (C,
// Cout, 3 dx, 3 dy), boxes of (KC_S8 input channels, bn output channels,
// 1 dx, 3 dy): 64-byte rows, one output channel a row.
int make_q_weight_map(CUtensorMap* map, const void* k, int C, int Cout, int bn) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)Cout, 3, 3};
  const cuuint64_t strides[3] = {(cuuint64_t)C, (cuuint64_t)Cout * C, (cuuint64_t)3 * Cout * C};
  const cuuint32_t box[4] = {KC_S8, (cuuint32_t)bn, 1, 3};
  return make_map_4d(map, k, dims, strides, box, 1);
}

template <int BN, int EPI, bool S2 = false>
int launch_gemm(const CUtensorMap& ta0, const CUtensorMap& ta1, const CUtensorMap& tb0,
                const CUtensorMap& tb1, const FwdArgs& a, int grid, cudaStream_t stream) {
  auto kernel = conv_fwd_gemm_kernel<BN, EPI, S2>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<BN>::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads_of(wide_producer(EPI)), Ring<BN>::SMEM, stream>>>(ta0, ta1, tb0, tb1, a);
  return (int)cudaGetLastError();
}

// The GEMM of leg 0 (x0, k0 (3, 3, C0, Cout)) and, with x1 non-null, leg 1
// (x1, k1, C1) with a's pointers and policy: maps, tiling, launch. The s8
// policies take one int8 leg and k0 repacked K-major, (3, 3, Cout', C0'):
// q-stats with C0' = C0 % 64 == 0 and Cout' = Cout % 128 == 0; q-conv with
// C0 % 16 == 0 and Cout % 16 == 0, zero-extended to C0' (C0 rounded up to
// 64: A's last chunk reads past C0 into TMA's zero fill) and Cout' (Cout
// rounded up to bn; the epilogue masks the channels past Cout). stride 2
// (q-conv, zero = 0): x0 is the parity planes (B, 2(H+1), 2(W+1), C0).
int run_gemm(const void* x0, const void* k0, int C0, const void* x1, const void* k1, int C1,
             FwdArgs a, int B, int H, int W, int Cout, int zero, int bn, int epi, int grid,
             cudaStream_t stream, int stride = 1) {
  const bool s8 = is_s8(epi), qconv = epi == EPI_QCONV;
  const int kc = s8 ? KC_S8 : KC, esize = s8 ? 1 : 2;
  const int c0p = qconv ? (C0 + kc - 1) / kc * kc : C0;
  const int coutp = qconv ? (Cout + bn - 1) / bn * bn : Cout;
  if (C0 <= 0 || C0 % (qconv ? 16 : 64) || C1 % 64 || (x1 == nullptr) != (C1 == 0) ||
      Cout <= 0 || Cout % 16 || coutp % bn || B < 1 || H < 1 || W < 1 || grid < 1 ||
      (s8 && x1 != nullptr) || (epi == EPI_QSTATS && bn != 128) ||
      (stride != 1 && (stride != 2 || !qconv || zero)))
    return (int)cudaErrorInvalidValue;
  const int pad = zero ? 0 : 2;
  const int src_h = stride == 2 ? 2 * (H + 1) : H + pad, src_w = stride == 2 ? 2 * (W + 1) : W + pad;
  CUtensorMap ta0, ta1, tb0, tb1;
  int err = make_nhwc_map(&ta0, x0, B, src_h, src_w, C0, TH + 2, TW, kc, esize);
  if (err == 0)
    err = s8 ? make_q_weight_map(&tb0, k0, c0p, coutp, bn) : make_weight_map(&tb0, k0, C0, Cout);
  if (err == 0 && x1 != nullptr) err = make_nhwc_map(&ta1, x1, B, H + pad, W + pad, C1, TH + 2, TW, KC);
  if (err == 0 && x1 != nullptr) err = make_weight_map(&tb1, k1, C1, Cout);
  if (err != 0) return err;
  if (x1 == nullptr) {
    ta1 = ta0;
    tb1 = tb0;
  }
  a.H = H;
  a.W = W;
  a.Cout = Cout;
  a.nchunk0 = c0p / kc;
  a.nchunk1 = C1 / kc;
  a.ntc = (W + TW - 1) / TW;
  a.ntiles = ((H + TH - 1) / TH) * a.ntc;
  a.ncob = coutp / bn;
  a.shift = zero ? 1 : 0;
  const long long tasks = (long long)B * a.ntiles * a.ncob;
  if (tasks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  a.ntasks = (int)tasks;
  if (stride == 2) {
    return bn == 128 ? launch_gemm<128, EPI_QCONV, true>(ta0, ta1, tb0, tb1, a, grid, stream)
                     : launch_gemm<64, EPI_QCONV, true>(ta0, ta1, tb0, tb1, a, grid, stream);
  }
  if (bn == 128) {
    switch (epi) {
      case EPI_STATS: return launch_gemm<128, EPI_STATS>(ta0, ta1, tb0, tb1, a, grid, stream);
      case EPI_STORE: return launch_gemm<128, EPI_STORE>(ta0, ta1, tb0, tb1, a, grid, stream);
      case EPI_DZ: return launch_gemm<128, EPI_DZ>(ta0, ta1, tb0, tb1, a, grid, stream);
      case EPI_MASK_STATS:
        return launch_gemm<128, EPI_MASK_STATS>(ta0, ta1, tb0, tb1, a, grid, stream);
      case EPI_RESIDUAL: return launch_gemm<128, EPI_RESIDUAL>(ta0, ta1, tb0, tb1, a, grid, stream);
      case EPI_QSTATS: return launch_gemm<128, EPI_QSTATS>(ta0, ta1, tb0, tb1, a, grid, stream);
      case EPI_QCONV: return launch_gemm<128, EPI_QCONV>(ta0, ta1, tb0, tb1, a, grid, stream);
    }
  } else if (bn == 64) {
    switch (epi) {
      case EPI_DZ: return launch_gemm<64, EPI_DZ>(ta0, ta1, tb0, tb1, a, grid, stream);
      case EPI_MASK_STATS:
        return launch_gemm<64, EPI_MASK_STATS>(ta0, ta1, tb0, tb1, a, grid, stream);
      case EPI_RESIDUAL: return launch_gemm<64, EPI_RESIDUAL>(ta0, ta1, tb0, tb1, a, grid, stream);
      case EPI_QCONV: return launch_gemm<64, EPI_QCONV>(ta0, ta1, tb0, tb1, a, grid, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------- fold lines ----

// A block: FOLD_MT x 16 line pixels x 64 output channels; warp u runs tap
// u's K (C), and the three partials are summed in a fixed order.
constexpr int FOLD_MT = 4;
constexpr int FOLD_PX = 16 * FOLD_MT;

struct FoldArgs {
  const __nv_bfloat16* dy;  // (B, H, W, C)
  const __nv_bfloat16* k;   // the forward kernel (3, 3, Cout, C): K (C) contiguous
  float* rows;              // (B, 2, W+2, Cout)
  float* cols;              // (B, H, 2, Cout)
  int H, W, C, Cout;
};

// Line l of image b (blockIdx.x = 4 b + l): 0 F[-1, s-1] and 1 F[H, s-1]
// for s in [0, W+2); 2 F[s, -1] and 3 F[s, W] for s in [0, H). Line pixel
// s at tap u reads dy at (row 0 or H-1, column s-2+u) with the forward
// kernel's tap (0 or 2, 2-u), or dy at (s-1+u, column 0 or W-1) with tap
// (2-u, 0 or 2); sources outside the plane are zero. m16n8k16 fragments
// straight from L2: A rows g, g+8 (line pixels) and k pairs 2 t4, 2 t4 + 8;
// B column g of each n8 tile, the same k pairs (C is the kernel's last
// dim), each B fragment used by the block's FOLD_MT m16 tiles.
__global__ void __launch_bounds__(96) dgrad_fold_kernel(const FoldArgs a) {
  __shared__ float red[2][FOLD_MT * 8 * 4 * 32];  // taps 1 and 2, fragment order
  const int u = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.x / 4, line = blockIdx.x % 4;
  const int len = line < 2 ? a.W + 2 : a.H;
  const int s0 = blockIdx.z * FOLD_PX;
  if (s0 >= len) return;  // the whole block
  const int co0 = blockIdx.y * 64;
  const int ty = line < 2 ? 2 * line : 2 - u;
  const int tx = line < 2 ? 2 - u : 2 * (line - 2);
  const __nv_bfloat16* kt = a.k + ((size_t)(3 * ty + tx) * a.Cout + co0 + g) * a.C + 2 * t4;
  const __nv_bfloat16* src[FOLD_MT][2];
#pragma unroll
  for (int m = 0; m < FOLD_MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = s0 + 16 * m + g + 8 * h;
      const int r = line < 2 ? (line == 0 ? 0 : a.H - 1) : s - 1 + u;
      const int c = line < 2 ? s - 2 + u : (line == 2 ? 0 : a.W - 1);
      const bool ok = s < len && r >= 0 && r < a.H && c >= 0 && c < a.W;
      src[m][h] = ok ? a.dy + (((size_t)b * a.H + r) * a.W + c) * a.C + 2 * t4 : nullptr;
    }
  float acc[FOLD_MT][8][4];
#pragma unroll
  for (int m = 0; m < FOLD_MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
#pragma unroll 2
  for (int ci = 0; ci < a.C; ci += 16) {
    uint32_t af[FOLD_MT][4];
#pragma unroll
    for (int m = 0; m < FOLD_MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        af[m][h] = src[m][h] ? ldg32(src[m][h] + ci) : 0u;
        af[m][h + 2] = src[m][h] ? ldg32(src[m][h] + ci + 8) : 0u;
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat16* kb = kt + (size_t)8 * j * a.C + ci;
      const uint32_t b0 = ldg32(kb), b1 = ldg32(kb + 8);
#pragma unroll
      for (int m = 0; m < FOLD_MT; ++m) mma(acc[m][j], af[m], b0, b1);
    }
  }
  if (u > 0) {
#pragma unroll
    for (int m = 0; m < FOLD_MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[u - 1][((m * 8 + j) * 4 + e) * 32 + lane] = acc[m][j][e];
  }
  __syncthreads();
  if (u > 0) return;
#pragma unroll
  for (int w = 0; w < 2; ++w)  // in a fixed order: a repeat is bit-exact
#pragma unroll
    for (int m = 0; m < FOLD_MT; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] += red[w][((m * 8 + j) * 4 + e) * 32 + lane];
#pragma unroll
  for (int m = 0; m < FOLD_MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = s0 + 16 * m + g + 8 * h;
      if (s >= len) continue;
      float* dst = line < 2 ? a.rows + ((size_t)(2 * b + line) * (a.W + 2) + s) * a.Cout
                            : a.cols + (((size_t)b * a.H + s) * 2 + line - 2) * a.Cout;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(dst + co0 + 8 * j + 2 * t4) =
            make_float2(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
    }
}

// ------------------------------------------------ stride-2 phase pass ----

// q (B, 2 hp, 2 wp, C) int8: the four (row, column) parity planes of Xp,
// xq (B, H, W, C) padded by pad pixels (0 or 1; reflected where refl, else
// zeros): q[b, py hp + u, px wp + v] = Xp[2u + py, 2v + px], zero past Xp.
// Memory-bound, one 16-channel unit (16 bytes) a step, grid-stride.
struct PhaseArgs {
  const int8_t* xq;
  int8_t* q;
  long long units;
  int H, W, C, hp, wp, pad, refl;
};

__global__ void __launch_bounds__(PASS_THREADS) phase_pass_kernel(const PhaseArgs a) {
  const long long stride = (long long)gridDim.x * PASS_THREADS;
  const int cu = a.C / 16, qw = 2 * a.wp;
  const long long plane = (long long)2 * a.hp * qw;
  for (long long v = (long long)blockIdx.x * PASS_THREADS + threadIdx.x; v < a.units; v += stride) {
    const long long pix = v / cu;
    const int c16 = (int)(v - pix * cu) * 16;
    const long long b = pix / plane;
    const int rem = (int)(pix - b * plane);
    const int qr = rem / qw, qc = rem % qw;
    const int py = qr >= a.hp, px = qc >= a.wp;
    int r = 2 * (qr - py * a.hp) + py - a.pad, c = 2 * (qc - px * a.wp) + px - a.pad;
    const int lo = a.refl ? -1 : 0;  // reflect: Xp's rows -1 and H exist
    const bool inside = r >= lo && r < a.H - lo && c >= lo && c < a.W - lo;
    if (a.refl) {
      r = reflect_index(r, a.H);
      c = reflect_index(c, a.W);
    }
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (inside) val = ldg16(a.xq + (((size_t)b * a.H + r) * a.W + c) * a.C + c16);
    *reinterpret_cast<uint4*>(a.q + v * 16) = val;
  }
}

}  // namespace
}  // namespace ircolor

extern "C" {

// The GEMM's output tile: the Python plan must use the same.
int ircolor_conv_fwd_tile_rows() { return ircolor::TH; }
int ircolor_conv_fwd_tile_cols() { return ircolor::TW; }
// Dynamic shared memory of a GEMM block with bn (128 or 64) output
// channels (the ring, the sums' partials, barriers, alignment).
int ircolor_conv_fwd_smem(int bn) {
  return bn == 64 ? ircolor::Ring<64>::SMEM : ircolor::Ring<128>::SMEM;
}

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
  FwdArgs a = {};
  a.out = static_cast<__nv_bfloat16*>(out);
  a.partial = static_cast<float*>(partial);
  return run_gemm(x0, k0, C0, x1, k1, C1, a, B, H, W, Cout, zero, 128,
                  partial != nullptr ? EPI_STATS : EPI_STORE, grid,
                  static_cast<cudaStream_t>(stream));
}

// The int8 conv's operand pass: out (B, H+2, W+2, C) int8 = x (B, H, W,
// C) bf16 reflect-padded by one pixel and quantized: clamp(rint(x *
// qscale[b]), -127, 127) where mean is null, else min(rint(relu((x -
// mean)*inv) * qfixed), 127). C % 16 == 0.
int ircolor_conv_q_pass(const void* x, const void* qscale, const void* mean, const void* inv,
                        float qfixed, void* out, int B, int H, int W, int C, void* stream) {
  using namespace ircolor;
  if (C % 16 || (mean == nullptr) == (qscale == nullptr) || (mean == nullptr) != (inv == nullptr))
    return (int)cudaErrorInvalidValue;
  PassArgs a = {};
  a.z = static_cast<const __nv_bfloat16*>(x);
  a.qscale = static_cast<const float*>(qscale);
  a.zm = static_cast<const float*>(mean);
  a.zi = static_cast<const float*>(inv);
  a.qfixed = qfixed;
  a.zp = out;
  a.ndy = 0;
  a.nzp = (long long)B * (H + 2) * (W + 2) * (C / 16);
  a.H = H;
  a.W = W;
  a.Cz = C;
  a.zpad = 1;
  return launch_operand_pass(a, static_cast<cudaStream_t>(stream), true);
}

// The int8 conv's GEMM: out (B, H, W, Cout) bf16 and partial (B, ntiles,
// 2, Cout) f32 of y = f32(sum of zq (B, H+2, W+2, C) int8, padded, against
// kq (3, 3, Cout, C) int8) * sc[b, co], sc (B, Cout) f32. C % 64 == 0,
// Cout % 128 == 0.
int ircolor_conv_q_gemm(const void* zq, const void* kq, const void* sc, int C, void* out,
                        void* partial, int B, int H, int W, int Cout, int grid, void* stream) {
  using namespace ircolor;
  if (sc == nullptr || partial == nullptr) return (int)cudaErrorInvalidValue;
  FwdArgs a = {};
  a.out = static_cast<__nv_bfloat16*>(out);
  a.partial = static_cast<float*>(partial);
  a.sc = static_cast<const float*>(sc);
  return run_gemm(zq, kq, C, nullptr, nullptr, 0, a, B, H, W, Cout, 0, 128, EPI_QSTATS, grid,
                  static_cast<cudaStream_t>(stream));
}

// The int8 conv's reflect pass: out (B, H+2, W+2, C) int8 = xq (B, H, W, C)
// int8 reflect-padded by one pixel, 16 channels a unit. C % 16 == 0.
int ircolor_conv_q8_pad(const void* xq, void* out, int B, int H, int W, int C, void* stream) {
  using namespace ircolor;
  if (C % 16 || B < 1 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  PassArgs a = {};
  a.zq = static_cast<const int8_t*>(xq);
  a.zp = out;
  a.nzp = (long long)B * (H + 2) * (W + 2) * (C / 16);
  a.H = H;
  a.W = W;
  a.Cz = C;
  a.zpad = 1;
  return launch_operand_pass(a, static_cast<cudaStream_t>(stream), true);
}

// The int8 conv's stride-2 pass: q (B, 2(Ho+1), 2(Wo+1), C) int8 = the
// parity planes of xq (B, H, W, C) padded by pad (0 or 1) pixels, reflected
// where refl, else zeros (see phase_pass_kernel). C % 16 == 0.
int ircolor_conv_q8_phase(const void* xq, void* q, int B, int H, int W, int C, int Ho, int Wo,
                          int pad, int refl, void* stream) {
  using namespace ircolor;
  if (C % 16 || B < 1 || H < 2 || W < 2 || Ho < 1 || Wo < 1 || (pad != 0 && pad != 1) ||
      (refl && !pad))
    return (int)cudaErrorInvalidValue;
  PhaseArgs a;
  a.xq = static_cast<const int8_t*>(xq);
  a.q = static_cast<int8_t*>(q);
  a.units = (long long)B * 2 * (Ho + 1) * 2 * (Wo + 1) * (C / 16);
  a.H = H;
  a.W = W;
  a.C = C;
  a.hp = Ho + 1;
  a.wp = Wo + 1;
  a.pad = pad;
  a.refl = refl;
  const long long need = (a.units + PASS_THREADS - 1) / PASS_THREADS;
  const int blocks = (int)(need < PASS_MAX_BLOCKS ? need : PASS_MAX_BLOCKS);
  phase_pass_kernel<<<blocks, PASS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The int8 conv's GEMM: out (B, H, W, Cout), bf16 or (out_f32) f32, =
// ((f32(sum of xq against kq) * sc[b, co]) + addend) + bias, the addend (B,
// H, W, Cout) and bias (Cout) f32 where non-null, sc (B, Cout) f32. zero =
// 1: xq (B, H, W, C) int8, read with zero halos; zero = 0: padded, (B, H+2,
// W+2, C); stride 2 (zero = 0): xq the parity planes (B, 2(H+1), 2(W+1), C)
// of ircolor_conv_q8_phase. kq (3, 3, Cout', C') int8, zero-extended: C' is
// C rounded up to 64, Cout' Cout rounded up to bn (128 or 64). C % 16 == 0,
// Cout % 16 == 0.
int ircolor_conv_qconv_gemm(const void* xq, const void* kq, const void* sc, const void* addend,
                            const void* bias, void* out, int out_f32, int C, int B, int H, int W,
                            int Cout, int zero, int stride, int bn, int grid, void* stream) {
  using namespace ircolor;
  if (sc == nullptr || (bn != 128 && bn != 64)) return (int)cudaErrorInvalidValue;
  FwdArgs a = {};
  if (out_f32) {
    a.out_f32 = static_cast<float*>(out);
  } else {
    a.out = static_cast<__nv_bfloat16*>(out);
  }
  a.sc = static_cast<const float*>(sc);
  a.addend = static_cast<const float*>(addend);
  a.bias = static_cast<const float*>(bias);
  return run_gemm(xq, kq, C, nullptr, nullptr, 0, a, B, H, W, Cout, zero, bn, EPI_QCONV, grid,
                  static_cast<cudaStream_t>(stream), stride);
}

// The dgrad's operand pass: dy (B, H, W, C) = the IN backward of (p, comp)
// with per-(B, C) m, inv, gm, gy; mask_p: p kept where comp > m.
int ircolor_conv_dgrad_pass(const void* p, const void* comp, const void* m, const void* inv,
                            const void* gm, const void* gy, void* dy, int B, int H, int W, int C,
                            int mask_p, void* stream) {
  using namespace ircolor;
  if (C % 8) return (int)cudaErrorInvalidValue;
  PassArgs a = {};
  a.p = static_cast<const __nv_bfloat16*>(p);
  a.comp = static_cast<const __nv_bfloat16*>(comp);
  a.m = static_cast<const float*>(m);
  a.inv = static_cast<const float*>(inv);
  a.gm = static_cast<const float*>(gm);
  a.gy = static_cast<const float*>(gy);
  a.dy = static_cast<__nv_bfloat16*>(dy);
  a.ndy = (long long)B * H * W * (C / 8);
  a.nzp = 0;
  a.H = H;
  a.W = W;
  a.Co = C;
  a.mask_p = mask_p;
  return launch_operand_pass(a, static_cast<cudaStream_t>(stream));
}

// The reflect dgrad's fold lines, f32: rows (B, 2, W+2, Cout) = F[-1, -1..W]
// and F[H, -1..W], cols (B, H, 2, Cout) = F[0..H-1, -1] and F[0..H-1, W], of
// dy (B, H, W, C) and the forward kernel k (3, 3, Cout, C). C % 16 == 0,
// Cout % 64 == 0.
int ircolor_conv_dgrad_fold(const void* dy, const void* k, void* rows, void* cols, int B, int H,
                            int W, int C, int Cout, void* stream) {
  using namespace ircolor;
  if (C % 16 || Cout % 64 || B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  FoldArgs a;
  a.dy = static_cast<const __nv_bfloat16*>(dy);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.rows = static_cast<float*>(rows);
  a.cols = static_cast<float*>(cols);
  a.H = H;
  a.W = W;
  a.C = C;
  a.Cout = Cout;
  const int len = W + 2 > H ? W + 2 : H;
  const dim3 grid(4 * B, Cout / 64, (len + FOLD_PX - 1) / FOLD_PX);
  dgrad_fold_kernel<<<grid, 96, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The dgrad's GEMM: dz = the zero-SAME conv of dy (B, H, W, C) with kdg (3,
// 3, C, Cout), plus, with rows non-null, the fold lines (rows, cols) of
// ircolor_conv_dgrad_fold; then mm non-null: mask-stats (aux, mi and
// partial (B, ntiles, 2, Cout) required); else aux non-null: residual; else
// store. C % 64 == 0; Cout % 64 == 0 (N = 128 where Cout % 128 == 0, else
// 64).
int ircolor_conv_dgrad_gemm(const void* dy, const void* kdg, int C, const void* aux,
                            const void* mm, const void* mi, const void* rows, const void* cols,
                            void* out, void* partial, int B, int H, int W, int Cout, int grid,
                            void* stream) {
  using namespace ircolor;
  if (Cout % 64 || (mm != nullptr && (aux == nullptr || mi == nullptr || partial == nullptr)) ||
      (rows == nullptr) != (cols == nullptr))
    return (int)cudaErrorInvalidValue;
  FwdArgs a = {};
  a.out = static_cast<__nv_bfloat16*>(out);
  a.partial = static_cast<float*>(partial);
  a.aux = static_cast<const __nv_bfloat16*>(aux);
  a.mm = static_cast<const float*>(mm);
  a.mi = static_cast<const float*>(mi);
  a.fold = static_cast<const float*>(rows);
  a.fold_cols = static_cast<const float*>(cols);
  const int epi = mm != nullptr ? EPI_MASK_STATS : (aux != nullptr ? EPI_RESIDUAL : EPI_DZ);
  return run_gemm(dy, kdg, C, nullptr, nullptr, 0, a, B, H, W, Cout, 1, Cout % 128 ? 64 : 128,
                  epi, grid, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
