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
//   int8 conv's reflect sites copy their quantized input into the
//   reflect-padded Zp. ZERO and VALID raw need none: the GEMM reads the
//   input itself; nor does the int8 block conv, whose kernel quantizes its
//   input as it loads it (see "the int8 block conv, quantized on load"
//   below; its int8 pass, writing the reflect-padded quantized Zp, and the
//   q-stats GEMM stay as that kernel's bit-exact reference).
// * GEMM: a block owns TH x TW = 8 x 32 output pixels (M = 256) of one
//   image and BN = 128 output channels (N; 64 where Cout % 128 != 0, the
//   segments' dz of 64, and in the forward's stats and store policies
//   where the plan's wave rule picks it: a grid of a few hundred output
//   blocks, whose last round of 132 would run short at N = 128): two
//   consumer warpgroups of 4 rows (two m64
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
// * Stride 2 (q-conv only, no pass before it for zero or VALID halos):
//   out[i, j] at tap (dy, dx) reads Xp[2i + dy, 2j + dx], Xp being xq
//   zero-padded by one pixel (shift 1: xq row 2i + dy - 1) or the
//   pre-padded input (VALID, shift 0; the reflect sites run the int8
//   reflect pass first). The producer reads xq itself through tensor maps
//   with TMA elementStrides of 2 on W and H: a box traversing 2 TW columns
//   from 2 c0 + dx - shift lands the TW columns of tap dx densely, and the
//   zero halo is TMA's out-of-bounds fill, as at stride 1. A stage is
//   (chunk, dx), as at stride 1, and holds two A boxes: the TH + 1 input
//   rows 2 r0 - shift + 2u (18 KB), which serve dy = 0 and 2 at buffer row
//   offsets 0 and 1, and the TH rows 2 r0 + 1 - shift + 2u (16 KB), which
//   serve dy = 1; then the B box once. 12 wgmmas a warpgroup a stage, as at
//   stride 1; 58 KB a stage at N = 128, so 3 stages (4 at N = 64, 46 KB).
//   Each box is whole 1 KB swizzle atoms, so the tap-as-row-offset
//   descriptors hold in each box. HBM traffic is one read of xq. With one
//   or two chunks a block (the down convs: Cin 64, 128) the epilogue is a
//   third of a block's work, and its 4-byte fragment stores held the
//   consumers (without them the GEMM took 0.57 of the time): the bf16 tile
//   goes to a 32 KB shared buffer, 64 channels at a time (128-byte
//   swizzled rows, so a warp's stores hit 32 banks), and out by one TMA
//   store the consumers do not wait for; f32 output keeps the fragment
//   stores. The plan runs N = 64 (kernels/conv_int8.py:_plan).
// * Persistent grid (one wave, fixed by the shapes in the Python plan):
//   a block runs every grid-th output block, the ring running on, so the
//   next block's first loads overlap this one's epilogue. Output blocks
//   are (image, tile) major, the output-channel blocks of one tile next to
//   each other, so A comes from L2 after its first read.
// * The host: a bf16 conv is one C call (ircolor_conv_fwd: the passes,
//   the tensor maps, the GEMM), so is the int8 block conv
//   (ircolor_conv_q_fwd: its kernel, the tile sum), and a GEMM
//   instantiation's shared-memory attribute is set once a card. At the b4
//   halo shards the device works
//   ~0.07 ms a conv, about what a call's Python and launches cost.
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
#include <atomic>
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
constexpr int A_ROW = KC * 2;                    // one pixel: 64 bytes
constexpr int A_BYTES = (TH + 2) * TW * A_ROW;   // one dx buffer: 20 KB
constexpr int A2_TAPS02 = (TH + 1) * TW * A_ROW; // stride 2: the rows of dy 0, 2: 18 KB
constexpr int A2_BYTES = A2_TAPS02 + TH * TW * A_ROW;  // + the rows of dy 1: 34 KB
constexpr int B_ATOM = KC * 128;                 // KC ci x 64 co: 4 KB
constexpr int B_HALF = 3 * B_ATOM;               // one 64-channel box: its three taps (dy)
static_assert(TW == 32, "an m64 sub-tile is two whole rows on swizzle atoms");
static_assert(TH == 4 * CONSUMERS, "two m64 sub-tiles of 2 rows a warpgroup");
static_assert(A_BYTES % 1024 == 0 && B_HALF % 1024 == 0, "B boxes on 1 KB atoms");
static_assert(A2_TAPS02 % 1024 == 0 && A2_BYTES % 1024 == 0, "stride-2 boxes on 1 KB atoms");
static_assert(KC_S8 == A_ROW && 3 * 128 * KC_S8 == 2 * B_HALF,
              "an int8 stage has the bf16 stage's bytes at BN 128");

// The ring and shared memory of a block with BN output channels; S2 (BN
// 64 only): the stride-2 stage (two A boxes) and the bf16 output tile
// staged for its TMA store (no sums).
template <int BN, bool S2 = false>
struct Ring {
  static_assert(!S2 || BN == 64, "the stride-2 form runs N = 64");
  static constexpr int A = S2 ? A2_BYTES : A_BYTES;
  static constexpr int STAGE = A + (BN / 64) * B_HALF;           // 44 KB at BN 128; S2 46 KB
  static constexpr int STAGES = 4;
  static constexpr int OUT_BYTES = S2 ? TH * TW * 64 * 2 : 0;    // 32 KB, 128-byte swizzled
  static constexpr int RED_BYTES = S2 ? 0 : CONSUMERS * 4 * BN * 2 * 4;  // the sums' warp partials
  static constexpr int MASK_BYTES = 2 * BN * 4;                  // a task's mm, mi (or sc)
  static constexpr int SMEM = STAGES * STAGE + OUT_BYTES + RED_BYTES + MASK_BYTES +
                              2 * STAGES * 8 + 1024;  // + barriers, alignment
};
static_assert(Ring<64, true>::SMEM <= 232448, "the stride-2 ring fits a block's shared memory");

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
// them in flight and free the stage before. Tap dy's A operand starts at
// buffer row dy (stride 1), or (S2) at row dy / 2 of the first box (dy 0,
// 2) or row 0 of the second (dy 1).
template <int BN, bool S8, bool S2, typename Acc>
__device__ __forceinline__ void consume_stage(Acc (&acc)[2][BN / 2], uint32_t base,
                                              uint32_t full0, uint32_t empty0, int& g, int j,
                                              int wg, int lane) {
  using R = Ring<BN, S2>;
  const int s = g % R::STAGES;
  const uint32_t st = base + s * R::STAGE;
  mbar_wait(full0 + 8 * s, (g / R::STAGES) & 1);
  wgmma_fence();
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int ks = 0; ks < A_ROW / 32; ++ks) {  // 32 bytes of A's row: k16 bf16, k32 s8
      // bf16: 16 rows of the MN-major B; s8: 32 bytes of each K-major
      // output channel's row of tap dy.
      const uint64_t db = S8 ? smem_desc_k64(st + R::A + dy * BN * KC_S8 + ks * 32)
                             : smem_desc(st + A_BYTES + dy * B_ATOM + ks * 2048, B_HALF);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        // first buffer row of the tap
        const int row = 4 * wg + 2 * t;
        const uint32_t abox = S2 && dy == 1 ? st + A2_TAPS02 : st;
        const uint32_t arow = (row + (S2 ? dy / 2 : dy)) * TW;
        const uint64_t da = smem_desc_k64(abox + arow * A_ROW + ks * 32);
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
  if (j > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % R::STAGES));
  ++g;
}

// Persistent: block x runs output blocks task = x, x + gridDim.x, ...,
// task = (b * ntiles + tile) * ncob + cob. The ring runs on across tasks,
// so the producer loads a task's first stages during the last one's
// epilogue. S2: stride 2 (q-conv only), ta0 and ta1 the strided maps of
// the input's rows of taps dy 0, 2 and of dy 1; tb1 (one leg: unused as
// weights) the bf16 output's map, boxes of (64 channels, TW, TH, 1),
// where a.out_f32 is null.
template <int BN, int EPI, bool S2 = false>
__global__ void __launch_bounds__(threads_of(wide_producer(EPI)), 1)
    conv_fwd_gemm_kernel(const __grid_constant__ CUtensorMap ta0,
                         const __grid_constant__ CUtensorMap ta1,
                         const __grid_constant__ CUtensorMap tb0,
                         const __grid_constant__ CUtensorMap tb1, const FwdArgs a) {
  using R = Ring<BN, S2>;
  constexpr int STAGE = R::STAGE, STAGES = R::STAGES;
  constexpr bool S8 = is_s8(EPI);  // s8 operands, s32 accumulators
  constexpr bool QCONV = EPI == EPI_QCONV;
  constexpr bool STATS = EPI == EPI_STATS || EPI == EPI_MASK_STATS || EPI == EPI_QSTATS;
  constexpr bool DGRAD = is_dgrad(EPI);
  constexpr int KCH = S8 ? KC_S8 : KC;  // input channels a stage
  static_assert(EPI != EPI_QSTATS || BN == 128, "the int8 block conv runs N = 128");
  static_assert(!S2 || QCONV, "stride 2 is the int8 conv's");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1 KB
  const uint32_t stage_out = base + STAGES * STAGE;  // S2: the staged output
  const uint32_t red = stage_out + R::OUT_BYTES;
  const uint32_t maskp = red + R::RED_BYTES;
  const uint32_t full0 = maskp + R::MASK_BYTES, empty0 = full0 + STAGES * 8;
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
    // Producer warp(group): one thread issues every copy. Stage j of a task: leg,
    // chunk (j / 3) and dx (j % 3). g counts stages over all tasks.
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
        const int chunk = j / 3, dx = j % 3;
        const bool leg1 = chunk >= a.nchunk0;
        const int ci0 = (leg1 ? chunk - a.nchunk0 : chunk) * KCH;
        const CUtensorMap* ta = leg1 ? &ta1 : &ta0;
        const CUtensorMap* tb = leg1 ? &tb1 : &tb0;
        mbar_expect_tx(full, STAGE);
        if constexpr (S2) {  // every other input column from 2 c0 + dx - shift;
          // rows every other one from 2 r0 - shift (dy 0, 2), then from the row after (dy 1)
          const int col = 2 * c0 + dx - a.shift, row = 2 * r0 - a.shift;
          tma_load(dst, &ta0, full, ci0, col, row, b);
          tma_load(dst + A2_TAPS02, &ta1, full, ci0, col, row + 1, b);
        } else {
          tma_load(dst, ta, full, ci0, c0 + dx - a.shift, r0 - a.shift, b);
        }
        if constexpr (S8) {  // one K-major box: [dy][BN co][64 ci]
          tma_load(dst + R::A, tb, full, ci0, co0, dx, 0);
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
    for (int j = 0; j < nst; ++j) consume_stage<BN, S8, S2>(acc, base, full0, empty0, g, j, wg, lane);
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
    // S2, bf16 out: the tile goes through stage_out (its 64 channels as
    // 16-byte chunks k = i of a 128-byte row a pixel, chunk k at k ^ (row
    // % 8): TMA's 128-byte swizzle, so the 8 pixels of a warp's store hit
    // different banks), stored by one TMA store that the consumers do not
    // wait for. The last task's store has read the buffer before it is
    // written again.
    const bool staged = S2 && a.out_f32 == nullptr;
    // The thread's pixel (t, h) = (0, 0) in the staged tile: row 4 wg +
    // warp / 2, column 16 (warp % 2) + lane / 4 (so pixel % 8 = lane / 4);
    // (t, h) adds 2 t rows and 8 h columns.
    const uint32_t sbase =
        stage_out + ((4 * wg + warp / 2) * TW + 16 * (warp % 2) + lane / 4) * 128 + 2 * cl;
    if (staged) {
      if (threadIdx.x == 0) bulk_wait_all<true>();
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
    }
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
              const float2 ad = adv[t][h];
              y0 = __fadd_rn(ad.x, y0);
              y1 = __fadd_rn(ad.y, y1);
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
          if constexpr (S2) {
            if (staged) {
              const uint32_t at =
                  sbase + (2 * t * TW + 8 * h) * 128 + ((i ^ (lane / 4)) << 4);
              asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(pack_bf16x2(y0, y1))
                           : "memory");
              continue;
            }
          }
          *reinterpret_cast<uint32_t*>(a.out + o) = pack_bf16x2(y0, y1);
        }
      if constexpr (S2) {
        // The channels end: store the tile.
        if (staged && (i + 1 == BN / 8 || co0 + 8 * (i + 1) >= a.Cout)) {
          fence_proxy_async();
          asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
          if (threadIdx.x == 0) {
            tma_store(&tb1, stage_out, co0, c0, r0, b);
            bulk_commit();
          }
        }
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
  if constexpr (S2) {
    if (threadIdx.x == 0) bulk_wait_all<false>();  // the last stores are done
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

// The dynamic shared memory limit is an attribute of the function on each
// card: set once an instantiation and card (one bit a card, the first 64),
// not on every launch.
template <int BN, int EPI, bool S2 = false>
int launch_gemm(const CUtensorMap& ta0, const CUtensorMap& ta1, const CUtensorMap& tb0,
                const CUtensorMap& tb1, const FwdArgs& a, int grid, cudaStream_t stream) {
  auto kernel = conv_fwd_gemm_kernel<BN, EPI, S2>;
  constexpr int smem = Ring<BN, S2>::SMEM;
  static std::atomic<unsigned long long> set_on{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if ((set_on.load(std::memory_order_relaxed) & bit) == 0 || bit == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    set_on.fetch_or(bit, std::memory_order_relaxed);
  }
  kernel<<<grid, threads_of(wide_producer(EPI)), smem, stream>>>(ta0, ta1, tb0, tb1, a);
  return (int)cudaGetLastError();
}

// The GEMM of leg 0 (x0, k0 (3, 3, C0, Cout)) and, with x1 non-null, leg 1
// (x1, k1, C1) with a's pointers and policy: maps, tiling, launch. The s8
// policies take one int8 leg and k0 repacked K-major, (3, 3, Cout', C0'):
// q-stats with C0' = C0 % 64 == 0 and Cout' = Cout % 128 == 0; q-conv with
// C0 % 16 == 0 and Cout % 16 == 0, zero-extended to C0' (C0 rounded up to
// 64: A's last chunk reads past C0 into TMA's zero fill) and Cout' (Cout
// rounded up to bn; the epilogue masks the channels past Cout). stride 2
// (q-conv, bn 64): x0 is (B, in_h, in_w, C0), read with zero halos (zero = 1) or
// pre-padded (zero = 0), (H, W) = ((in_h + 2 zero - 3) / 2 + 1, ...).
int run_gemm(const void* x0, const void* k0, int C0, const void* x1, const void* k1, int C1,
             FwdArgs a, int B, int H, int W, int Cout, int zero, int bn, int epi, int grid,
             cudaStream_t stream, int stride = 1, int in_h = 0, int in_w = 0) {
  const bool s8 = is_s8(epi), qconv = epi == EPI_QCONV;
  const int kc = s8 ? KC_S8 : KC, esize = s8 ? 1 : 2;
  const int c0p = qconv ? (C0 + kc - 1) / kc * kc : C0;
  const int coutp = qconv ? (Cout + bn - 1) / bn * bn : Cout;
  if (C0 <= 0 || C0 % (qconv ? 16 : 64) || C1 % 64 || (x1 == nullptr) != (C1 == 0) ||
      Cout <= 0 || Cout % 16 || coutp % bn || B < 1 || H < 1 || W < 1 || grid < 1 ||
      (s8 && x1 != nullptr) || (epi == EPI_QSTATS && bn != 128) ||
      (stride != 1 && (stride != 2 || !qconv || bn != 64)) ||
      (stride == 2 && (in_h < 2 || in_w < 2 || in_h + 2 * zero < 3 || in_w + 2 * zero < 3 ||
                       H != (in_h + 2 * zero - 3) / 2 + 1 || W != (in_w + 2 * zero - 3) / 2 + 1)))
    return (int)cudaErrorInvalidValue;
  const int pad = zero ? 0 : 2;
  CUtensorMap ta0, ta1, tb0, tb1;
  int err = stride == 2
                ? make_nhwc_map_s2(&ta0, x0, B, in_h, in_w, C0, TH + 1, TW, kc, esize)
                : make_nhwc_map(&ta0, x0, B, H + pad, W + pad, C0, TH + 2, TW, kc, esize);
  if (err == 0 && stride == 2) err = make_nhwc_map_s2(&ta1, x0, B, in_h, in_w, C0, TH, TW, kc, esize);
  if (err == 0)
    err = s8 ? make_q_weight_map(&tb0, k0, c0p, coutp, bn) : make_weight_map(&tb0, k0, C0, Cout);
  if (err == 0 && x1 != nullptr) err = make_nhwc_map(&ta1, x1, B, H + pad, W + pad, C1, TH + 2, TW, KC);
  if (err == 0 && x1 != nullptr) err = make_weight_map(&tb1, k1, C1, Cout);
  if (err != 0) return err;
  if (x1 == nullptr) {
    if (stride == 1) ta1 = ta0;
    tb1 = tb0;
  }
  // stride 2, bf16 out: tb1 is the output's map for the staged TMA stores.
  if (stride == 2 && a.out != nullptr) err = make_nhwc_map(&tb1, a.out, B, H, W, Cout, TH, TW, 64);
  if (err != 0) return err;
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
  if (stride == 2) return launch_gemm<64, EPI_QCONV, true>(ta0, ta1, tb0, tb1, a, grid, stream);
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
      case EPI_STATS: return launch_gemm<64, EPI_STATS>(ta0, ta1, tb0, tb1, a, grid, stream);
      case EPI_STORE: return launch_gemm<64, EPI_STORE>(ta0, ta1, tb0, tb1, a, grid, stream);
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

// The operand pass of ircolor_conv_fwd_pass.
int fwd_pass(const void* x, const void* mean, const void* inv, const void* top, const void* bot,
             void* out, int B, int H, int W, int C, int pad, cudaStream_t stream) {
  if (C % 8 || (pad != 0 && pad != 1) || (top == nullptr) != (bot == nullptr) ||
      (top != nullptr && pad != 1))
    return (int)cudaErrorInvalidValue;
  PassArgs a = {};
  a.z = static_cast<const __nv_bfloat16*>(x);
  a.zm = static_cast<const float*>(mean);
  a.zi = static_cast<const float*>(inv);
  a.zp = static_cast<__nv_bfloat16*>(out);
  a.top = static_cast<const __nv_bfloat16*>(top);
  a.bot = static_cast<const __nv_bfloat16*>(bot);
  a.ndy = 0;
  a.nzp = (long long)B * (H + 2 * pad) * (W + 2 * pad) * (C / 8);
  a.H = H;
  a.W = W;
  a.Cz = C;
  a.zpad = pad;
  return launch_operand_pass(a, stream);
}

// sums[b, j] = the sum over tiles t = 0, 1, ... of partial[b, t, j] (j <
// n = 2 Cout: the per-tile Σy, Σy² of the stats policy), added one tile at
// a time in that order: a repeat, and the plain version's loop, give the
// same bits.
__global__ void __launch_bounds__(256)
    tile_sum_kernel(const float* __restrict__ partial, float* __restrict__ sums, int ntiles, int n) {
  const int b = blockIdx.y, j = blockIdx.x * 256 + threadIdx.x;
  if (j >= n) return;
  const float* p = partial + (size_t)b * ntiles * n + j;
  float acc = p[0];
#pragma unroll 8
  for (int t = 1; t < ntiles; ++t) acc = __fadd_rn(acc, __ldg(p + (size_t)t * n));
  sums[(size_t)b * n + j] = acc;
}

// The bf16 GEMM with the stats (partial non-null) or store policy.
int fwd_gemm(const void* x0, const void* k0, int C0, const void* x1, const void* k1, int C1,
             void* out, void* partial, int B, int H, int W, int Cout, int zero, int bn, int grid,
             cudaStream_t stream) {
  if (bn != 128 && bn != 64) return (int)cudaErrorInvalidValue;
  FwdArgs a = {};
  a.out = static_cast<__nv_bfloat16*>(out);
  a.partial = static_cast<float*>(partial);
  return run_gemm(x0, k0, C0, x1, k1, C1, a, B, H, W, Cout, zero, bn,
                  partial != nullptr ? EPI_STATS : EPI_STORE, grid, stream);
}

// ------------------------------------ the int8 block conv, quantized on load ----
//
// The int8 block conv (the q-stats policy, N = 128) with no operand pass:
// the kernel reads the bf16 input and writes A's s8 operand to shared memory
// itself. A block's chunk k (64 input channels) needs the (TH + 2) x (TW +
// 2) input pixels around its tile: rows r0 - 1 .. r0 + TH, columns c0 - 1
// .. c0 + TW.
// * Staging: one TMA box of them, bf16, 128-byte swizzled (43.5 KB: L2
//   serves A once a chunk, as bf16), and at a shard's first and last tile
//   rows the halo row -1 / H from top / bot through 1-row maps of their own
//   into two 4.25 KB buffers. Producer thread 0 asks for the next chunk's
//   box as soon as this one is quantized; it lands while the producers copy
//   this chunk's three stages, which wait on the consumers.
// * Quantize, once an element: the 8 producer warps take the chunk in
//   16-channel units (unit u: pixel u / 4, channels 16 (u % 4) of the chunk;
//   a thread keeps one channel group, so its 16 channels' parameters stay in
//   registers), in the pass's single IEEE steps (tma.cuh) with the rounding
//   on the FP32 pipe (rint_clamp), into an s8 tile of the (TH + 2) x (TW +
//   2) pixels. Rows -1 and H come from the halo buffers or, with top / bot
//   null, from rows 1 and H - 2 (ReflectionPad); columns -1 and W from
//   columns 1 and W - 2; pixels past row H or column W, which feed only
//   masked outputs, are zeros.
// * Copy, a stage (chunk, dx) at a time: the tile's columns dx .. dx + TW -
//   1 into the stage's A buffer, 64-byte swizzled as TMA writes it: the
//   two-launch GEMM's A buffer, so the consumers' descriptors and wgmmas are
//   its own. Producer thread 0 asks for the stage's B box by TMA (as the
//   two-launch GEMM's producer does) once the slot is free; the stage's
//   barrier completes on its bytes and one arrival a producer warp, after
//   each thread's fence.proxy.async.
// Three stages of 44 KB (the staging, the tile and the sums take the rest of
// shared memory): the copy of stage s waits for stage s - 3 to be consumed,
// and the next chunk's quantize runs while the consumers run this chunk's
// three stages. 512 threads: setmaxnreg gives the two consumer warpgroups
// 168 registers a thread (the q-stats epilogue's) and the two producer
// warpgroups 88. The epilogue is the q-stats policy's, in its order, so out
// and the per-tile sums are the two-launch path's bit for bit.
// What bounds it: shared memory's bandwidth. A stage of the two-launch GEMM
// moves ~188 KB through it (its wgmmas' reads 144, B's box 24, A's 20) in
// ~1,900 cycles, ~100 bytes a cycle; the staging, the tile and the copies
// add ~75 KB a stage, which the pass's HBM round trip no longer costs. The
// forms measured on the way (PERF.md §6): the producers reading L2
// themselves (A's 20 KB a stage alone) spilled or waited out their loads'
// latency at the registers a producer thread gets; the consumers copying
// their own A did not hide under the wgmmas. Built with IRCOLOR_QL_PROFILE
// (the probe tools/q_halo_probe.py --fused), one thread of each role adds
// the clock64 cycles of each of its phases to ql_profile.
constexpr int QL_THREADS = 512;
constexpr int QL_CONVERT = 256;                     // the producer threads: warps 8-15
constexpr int QL_BOXW = TW + 2, QL_BOXH = TH + 2;   // a chunk's input pixels
constexpr int QL_UNITS = QL_BOXW * QL_BOXH * (KC_S8 / 16);  // quantize units a chunk: 1360
constexpr int QL_COPY = TW * QL_BOXH * (KC_S8 / 16);        // copy units a stage: 1280
constexpr int QL_STG = 44 * 1024;                   // the staging box: 10 x 34 pixels x 128 B
constexpr int QL_HALO = 5 * 1024;                   // a halo row: 34 x 128 B
constexpr int QL_TILE = 22 * 1024;                  // the s8 tile: 340 x 64 B
constexpr int QL_STAGE = A_BYTES + 2 * B_HALF;      // A 20 KB + B 24 KB
constexpr int QL_STAGES = 3;
constexpr int QL_RED = CONSUMERS * 4 * 128 * 2 * 4; // the sums' warp partials
constexpr int QL_SMEM = QL_STG + 2 * QL_HALO + QL_TILE + QL_STAGES * QL_STAGE + QL_RED + 128 * 4 +
                        (1 + 2 * QL_STAGES) * 8 + 1024;
static_assert(QL_BOXH * QL_BOXW * 128 <= QL_STG && QL_BOXW * 128 <= QL_HALO &&
                  QL_BOXH * QL_BOXW * 64 <= QL_TILE,
              "the staging, halo and tile buffers hold a chunk");
static_assert(QL_CONVERT == 2 * 128 && QL_COPY % QL_CONVERT == 0,
              "two producer warpgroups, each thread in one channel group, 5 copy units a stage");
static_assert(QL_STG % 1024 == 0 && QL_HALO % 1024 == 0 && QL_TILE % 1024 == 0 &&
                  QL_STAGE % 1024 == 0,
              "buffers on 1 KB swizzle atoms");
static_assert(QL_SMEM <= 232448, "the quantize-on-load kernel fits a block's shared memory");

#ifdef IRCOLOR_QL_PROFILE
// Cycles by phase, summed over the blocks: producer thread 0 (0 staging
// wait, 1 quantize, 2 tile barrier and the next load, 3 stage waits, 4
// copies, 5 fences and arrivals, 6 end barrier), consumer 0 (7 stage waits,
// 8 wgmma issue and wait, 9 epilogue); 10 unused; 11 chunks.
__device__ unsigned long long ql_profile[12];
#define QL_MARK(on, i)                                          \
  do {                                                          \
    if (on) {                                                   \
      const long long now_ = clock64();                         \
      atomicAdd(&ql_profile[i], (unsigned long long)(now_ - ql_t_)); \
      ql_t_ = now_;                                             \
    }                                                           \
  } while (0)
#define QL_CLOCK long long ql_t_ = clock64()
#else
#define QL_MARK(on, i) \
  do {                 \
  } while (0)
#define QL_CLOCK
#endif

struct QLoadArgs {
  int H, W, C, Cout;
  int nchunk, ntc, ntiles, ncob, ntasks;
  int halo;                  // 1: rows -1 and H from the halo maps; 0: reflected
  const float* qscale;       // (B,) conv1's 127 / amax, or null
  const float* zm;           // (B, C) conv2's IN mean and inv_std (with qscale null)
  const float* zi;
  float qfixed;              // conv2's 127 / 6
  const float* sc;           // (B, Cout) the dequant scale
  __nv_bfloat16* out;        // (B, H, W, Cout)
  float* partial;            // (B, ntiles, 2, Cout)
};

// The int8 bits of max(lo, min(127, __float2int_rn(v))) in the low byte (on
// the FP32 pipe; a warp's cvt.rni takes 8 cycles of a quarter SM): v clamped
// first (integer bounds commute with rounding to an integer), then rounded to
// nearest even by adding 1.5 * 2^23, whose ulp is 1, so the integer sits in
// the sum's low mantissa bits, two's complement in its low byte. NAN_ZERO:
// NaN gives 0, as cvt.rni does (conv2's relu already maps NaN to 0).
template <bool NAN_ZERO>
__device__ __forceinline__ uint32_t rint_clamp(float v, float lo) {
  const uint32_t r = __float_as_uint(__fadd_rn(fminf(fmaxf(v, lo), 127.f), 12582912.f));
  return NAN_ZERO && v != v ? 0u : r;
}

// Four low bytes into one word, the first lowest.
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// 16 bf16 (two 16-byte words) quantized to 16 s8 as the pass quantizes them:
// conv1 clamp(rint(x * qs), -127, 127); conv2 (NORM) min(rint(relu((x - zm)
// * zi) * qfixed), 127).
template <bool NORM>
__device__ __forceinline__ uint4 quantize16(uint4 v0, uint4 v1, float qs, const float (&zm)[16],
                                            const float (&zi)[16], float qfixed) {
  const uint32_t zw[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  uint32_t q[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float x = k % 2 ? bf16_hi(zw[k / 2]) : bf16_lo(zw[k / 2]);
    if constexpr (NORM) {
      const float z = fmaxf(__fmul_rn(__fsub_rn(x, zm[k]), zi[k]), 0.f);
      q[k] = rint_clamp<false>(__fmul_rn(z, qfixed), 0.f);  // z >= 0: min(.., 127) alone
    } else {
      q[k] = rint_clamp<true>(__fmul_rn(x, qs), -127.f);
    }
  }
  return make_uint4(low_bytes(q[0], q[1], q[2], q[3]), low_bytes(q[4], q[5], q[6], q[7]),
                    low_bytes(q[8], q[9], q[10], q[11]), low_bytes(q[12], q[13], q[14], q[15]));
}

__device__ __forceinline__ uint4 lds16(uint32_t at) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(at));
  return v;
}
__device__ __forceinline__ void sts16(uint32_t at, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// 16-byte chunk c of 64-byte row p (64-byte swizzle) or 128-byte row p
// (128-byte swizzle) of a 1 KB-aligned buffer, as TMA lays them out.
__device__ __forceinline__ uint32_t swz64(uint32_t buf, int p, int c) {
  return buf + p * 64 + ((c ^ ((p >> 1) & 3)) << 4);
}
__device__ __forceinline__ uint32_t swz128(uint32_t buf, int p, int c) {
  return buf + p * 128 + ((c ^ (p & 7)) << 4);
}

// A task's image and tile origin.
struct QTask {
  int b, mt, r0, c0, co0;
  __device__ __forceinline__ QTask(const QLoadArgs& a, int task) {
    mt = task / a.ncob;
    co0 = (task % a.ncob) * 128;
    b = mt / a.ntiles;
    const int tile = mt % a.ntiles;
    r0 = (tile / a.ntc) * TH;
    c0 = (tile % a.ntc) * TW;
  }
};

// The staging loads of (task, chunk k): the box of x's rows into stg and,
// with halo maps, the rows -1 / H at a shard's first / last tile row into
// the two buffers after it; completion (all their bytes) on bar. maps: x's
// rows, top, bot.
__device__ __forceinline__ void q_load_chunk(const QLoadArgs& a, const CUtensorMap* const (&maps)[3],
                                             uint32_t stg, uint32_t bar, int task, int k) {
  const QTask q(a, task);
  const bool top = a.halo && q.r0 == 0, bot = a.halo && q.r0 + TH >= a.H;
  mbar_expect_tx(bar, QL_BOXH * QL_BOXW * 128 + (top + bot) * QL_BOXW * 128);
  tma_load(stg, maps[0], bar, k * KC_S8, q.c0 - 1, q.r0 - 1, q.b);
  if (top) tma_load(stg + QL_STG, maps[1], bar, k * KC_S8, q.c0 - 1, 0, q.b);
  if (bot) tma_load(stg + QL_STG + QL_HALO, maps[2], bar, k * KC_S8, q.c0 - 1, 0, q.b);
}

// The producer warps' loop (conv_q_fused_kernel's shared-memory layout from
// base): per chunk, wait for its staged box, quantize it into the s8 tile,
// ask for the next chunk's box (thread 0), then per stage (dx) wait for the
// slot, ask for its weight box (thread 0) and copy the tile's columns dx ..
// dx + TW - 1 into its A buffer.
template <bool NORM>
__device__ __forceinline__ void q_produce(const QLoadArgs& a, const CUtensorMap* const (&maps)[3],
                                          const CUtensorMap* tb, int t, uint32_t base) {
  const uint32_t stg = base, htop = stg + QL_STG, hbot = htop + QL_HALO;
  const uint32_t tile = hbot + QL_HALO, ring = tile + QL_TILE;
  const uint32_t stg_full = ring + QL_STAGES * QL_STAGE + QL_RED + 128 * 4;
  const uint32_t full0 = stg_full + 8, empty0 = full0 + 8 * QL_STAGES;
  const int cq = t % 4, lane = t % 32;
  [[maybe_unused]] const bool prof = t == 0;
  QL_CLOCK;
  int g = 0, gc = 0;
  for (int task = blockIdx.x; task < a.ntasks; task += gridDim.x) {
    const QTask q(a, task);
    const float qs = NORM ? 0.f : __ldg(a.qscale + q.b);
    for (int k = 0; k < a.nchunk; ++k, ++gc) {
      float zm[16], zi[16];
      if constexpr (NORM) {
        const size_t ch = (size_t)q.b * a.C + k * KC_S8 + 16 * cq;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float m8[8], i8[8];
          load8(a.zm + ch + 8 * e, m8);
          load8(a.zi + ch + 8 * e, i8);
#pragma unroll
          for (int f = 0; f < 8; ++f) {
            zm[8 * e + f] = m8[f];
            zi[8 * e + f] = i8[f];
          }
        }
      }
      mbar_wait(stg_full, gc & 1);
      QL_MARK(prof, 0);
      // Quantize the staged pixels into the s8 tile.
#pragma unroll 2
      for (int u = t; u < QL_UNITS; u += QL_CONVERT) {
        const int p = u / 4, i = p / QL_BOXW, j = p - i * QL_BOXW;
        const int gr = q.r0 - 1 + i, gcl = q.c0 - 1 + j;
        uint4 out = make_uint4(0u, 0u, 0u, 0u);
        if (gr <= a.H && gcl <= a.W) {
          // The source: box column jj (columns -1, W reflected), box row i
          // or the halo buffer's one row (rows -1, H; reflected without).
          const int jj = gcl < 0 ? 2 : (gcl == a.W ? a.W - q.c0 - 1 : j);
          const bool edge = gr < 0 || gr == a.H;
          const uint32_t buf = a.halo && edge ? (gr < 0 ? htop : hbot) : stg;
          const int row = !edge ? i : a.halo ? 0 : gr < 0 ? 2 : a.H - q.r0 - 1;
          const int sp = row * QL_BOXW + jj;
          out = quantize16<NORM>(lds16(swz128(buf, sp, 2 * cq)),
                                 lds16(swz128(buf, sp, 2 * cq + 1)), qs, zm, zi, a.qfixed);
        }
        sts16(swz64(tile, p, cq), out);
      }
      QL_MARK(prof, 1);
      asm volatile("bar.sync 2, %0;\n" ::"n"(QL_CONVERT) : "memory");  // the tile is whole
      if (t == 0) {  // the staging is free: the next chunk's box
        if (k + 1 < a.nchunk) {
          q_load_chunk(a, maps, stg, stg_full, task, k + 1);
        } else if (task + (int)gridDim.x < a.ntasks) {
          q_load_chunk(a, maps, stg, stg_full, task + gridDim.x, 0);
        }
      }
      QL_MARK(prof, 2);
      // The chunk's three stages: the tile's columns dx .. dx + TW - 1.
      for (int dx = 0; dx < 3; ++dx, ++g) {
        const int s = g % QL_STAGES;
        const uint32_t st = ring + s * QL_STAGE, full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((g / QL_STAGES) & 1) ^ 1);
        if (t == 0) {  // the stage's weight box
          mbar_expect_tx(full, 2 * B_HALF);
          tma_load(st + A_BYTES, tb, full, k * KC_S8, q.co0, dx, 0);
        }
        QL_MARK(prof, 3);
        uint4 v[QL_COPY / QL_CONVERT];
#pragma unroll
        for (int m = 0; m < QL_COPY / QL_CONVERT; ++m) {
          const int prow = (t + QL_CONVERT * m) / 4;
          v[m] = lds16(swz64(tile, prow + (prow / TW) * 2 + dx, cq));
        }
#pragma unroll
        for (int m = 0; m < QL_COPY / QL_CONVERT; ++m)
          sts16(swz64(st, (t + QL_CONVERT * m) / 4, cq), v[m]);
        QL_MARK(prof, 4);
        fence_proxy_async();  // the stores, visible to the consumers' wgmmas
        __syncwarp();
        if (lane == 0) mbar_arrive(full);
        QL_MARK(prof, 5);
      }
      asm volatile("bar.sync 2, %0;\n" ::"n"(QL_CONVERT) : "memory");  // the tile is read
      QL_MARK(prof, 6);
#ifdef IRCOLOR_QL_PROFILE
      if (prof) atomicAdd(&ql_profile[11], 1ull);
#endif
    }
  }
}

__global__ void __launch_bounds__(QL_THREADS, 1)
    conv_q_fused_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap ttop,
                        const __grid_constant__ CUtensorMap tbot,
                        const __grid_constant__ CUtensorMap tb, const QLoadArgs a) {
  constexpr int BN = 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = base + QL_STG + 2 * QL_HALO + QL_TILE;  // q_produce's layout
  const uint32_t red = ring + QL_STAGES * QL_STAGE, scp = red + QL_RED;
  const uint32_t stg_full = scp + BN * 4, full0 = stg_full + 8, empty0 = full0 + 8 * QL_STAGES;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(stg_full, 1);
    for (int s = 0; s < QL_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1 + QL_CONVERT / 32);  // B's TMA (expect_tx), a producer warp each
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg >= CONSUMERS) {
    // The producers. Thread t's quantize units are t + 256 m, its copy units
    // likewise: all in channel group t % 4.
    setmaxnreg_dec<88>();
    const int t = threadIdx.x - CONSUMERS * 128;
    const CUtensorMap* const maps[3] = {&tx, &ttop, &tbot};
    if (t == 0 && blockIdx.x < a.ntasks) q_load_chunk(a, maps, base, stg_full, blockIdx.x, 0);
    if (a.zm != nullptr) {
      q_produce<true>(a, maps, &tb, t, base);
    } else {
      q_produce<false>(a, maps, &tb, t, base);
    }
    return;
  }

  // Consumer warpgroup wg: output rows r0 + 4 wg + [0, 4) of each task, as
  // two m64 sub-tiles of 2 rows; 128 output channels.
  setmaxnreg_inc<168>();
  const int warp = (threadIdx.x / 32) % 4;
  [[maybe_unused]] const bool prof = threadIdx.x == 0;
  float* redp = reinterpret_cast<float*>(smem_raw + (red - smem_u32(smem_raw)));
  float* scv = reinterpret_cast<float*>(smem_raw + (scp - smem_u32(smem_raw)));
  QL_CLOCK;
  int g = 0;
  for (int task = blockIdx.x; task < a.ntasks; task += gridDim.x) {
    const QTask q(a, task);
    if (threadIdx.x < BN) scv[threadIdx.x] = a.sc[(size_t)q.b * a.Cout + q.co0 + threadIdx.x];
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
    int acc[2][BN / 2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[t][i] = 0;
    const int nst = 3 * a.nchunk;
    QL_MARK(prof, 9);
    for (int j = 0; j < nst; ++j, ++g) {
      const int s = g % QL_STAGES;
      const uint32_t st = ring + s * QL_STAGE;
      mbar_wait(full0 + 8 * s, (g / QL_STAGES) & 1);
      QL_MARK(prof, 7);
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {  // 32 bytes of each 64-byte row: k32 s8
          const uint64_t db = smem_desc_k64(st + A_BYTES + dy * BN * KC_S8 + ks * 32);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int row = 4 * wg + 2 * t + dy;  // the tap's first buffer row
            wgmma_s8_n128(acc[t], smem_desc_k64(st + row * TW * A_ROW + ks * 32), db);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the stage before this one is done with its buffers
      if (j > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % QL_STAGES));
      QL_MARK(prof, 8);
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % QL_STAGES));  // the task's last stage
    QL_MARK(prof, 8);
    // The q-stats epilogue (conv_fwd_gemm_kernel's, in its order).
    const int rw = q.r0 + 4 * wg + warp / 2, cw = q.c0 + 16 * (warp % 2) + lane / 4;
    const int cl = 2 * (lane % 4);
    const size_t obase = (((size_t)q.b * a.H + rw) * a.W + cw) * a.Cout + q.co0 + cl;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const float2 mm = *reinterpret_cast<const float2*>(scv + 8 * i + cl);
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rw + 2 * t, c = cw + 8 * h;
          if (r >= a.H || c >= a.W) continue;
          const size_t o = obase + ((size_t)2 * t * a.W + 8 * h) * a.Cout + 8 * i;
          const float y0 = __fmul_rn(__int2float_rn(acc[t][4 * i + 2 * h]), mm.x);
          const float y1 = __fmul_rn(__int2float_rn(acc[t][4 * i + 2 * h + 1]), mm.y);
          s1[0] += y0;
          s1[1] += y1;
          s2[0] += y0 * y0;
          s2[1] += y1 * y1;
          *reinterpret_cast<uint32_t*>(a.out + o) = pack_bf16x2(y0, y1);
        }
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
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");  // consumers only
    if (threadIdx.x < BN) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int w = 0; w < CONSUMERS * 4; ++w) {  // warps in a fixed order
        t1 += redp[(w * BN + threadIdx.x) * 2];
        t2 += redp[(w * BN + threadIdx.x) * 2 + 1];
      }
      float* dst = a.partial + ((size_t)q.mt * 2) * a.Cout + q.co0 + threadIdx.x;
      dst[0] = t1;
      dst[a.Cout] = t2;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");  // red, scv free again
  }
}

// The quantize-on-load launch: the tensor maps (x's rows, the halo rows,
// the weights), the tiling, the shared-memory attribute once a card (as
// launch_gemm), the kernel. x / top / bot: image strides x_img / t_img.
int launch_q_fused(QLoadArgs a, const void* x, const void* top, const void* bot, long long x_img,
                   long long t_img, const void* kt, int B, int grid, cudaStream_t stream) {
  CUtensorMap tx, ttop, tbot, tb;
  const cuuint64_t row = (cuuint64_t)a.W * a.C * 2;
  const cuuint64_t dx[4] = {(cuuint64_t)a.C, (cuuint64_t)a.W, (cuuint64_t)a.H, (cuuint64_t)B};
  const cuuint64_t sx[3] = {(cuuint64_t)a.C * 2, row, (cuuint64_t)x_img * 2};
  const cuuint32_t bx[4] = {KC_S8, QL_BOXW, QL_BOXH, 1};
  int err = make_map_4d(&tx, x, dx, sx, bx);
  if (err == 0 && top != nullptr) {
    const cuuint64_t dt[4] = {(cuuint64_t)a.C, (cuuint64_t)a.W, 1, (cuuint64_t)B};
    const cuuint64_t st[3] = {(cuuint64_t)a.C * 2, row, (cuuint64_t)t_img * 2};
    const cuuint32_t bt[4] = {KC_S8, QL_BOXW, 1, 1};
    err = make_map_4d(&ttop, top, dt, st, bt);
    if (err == 0) err = make_map_4d(&tbot, bot, dt, st, bt);
  } else {
    ttop = tbot = tx;
  }
  if (err == 0) err = make_q_weight_map(&tb, kt, a.C, a.Cout, 128);
  if (err != 0) return err;
  a.halo = top != nullptr;
  a.nchunk = a.C / KC_S8;
  a.ntc = (a.W + TW - 1) / TW;
  a.ntiles = ((a.H + TH - 1) / TH) * a.ntc;
  a.ncob = a.Cout / 128;
  const long long tasks = (long long)B * a.ntiles * a.ncob;
  if (tasks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  a.ntasks = (int)tasks;
  static std::atomic<unsigned long long> set_on{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if ((set_on.load(std::memory_order_relaxed) & bit) == 0 || bit == 0) {
    e = cudaFuncSetAttribute(conv_q_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             QL_SMEM);
    if (e != cudaSuccess) return (int)e;
    set_on.fetch_or(bit, std::memory_order_relaxed);
  }
  conv_q_fused_kernel<<<grid, QL_THREADS, QL_SMEM, stream>>>(tx, ttop, tbot, tb, a);
  return (int)cudaGetLastError();
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
// bf16(relu((x - mean)*inv)) where mean is non-null. The spatial halo
// form (pad = 1): with top and bot non-null, (B, 1, W, C) each, rows -1
// and H are theirs. Columns stay reflected.
int ircolor_conv_fwd_pass(const void* x, const void* mean, const void* inv, const void* top,
                          const void* bot, void* out, int B, int H, int W, int C, int pad,
                          void* stream) {
  return ircolor::fwd_pass(x, mean, inv, top, bot, out, B, H, W, C, pad,
                           static_cast<cudaStream_t>(stream));
}

// out (B, H, W, Cout) bf16 and, with partial non-null, partial (B, ntiles,
// 2, Cout) f32 (ntiles = ceil(H/TH) * ceil(W/TW)) of the conv of leg 0 (x0,
// k0 (3, 3, C0, Cout)) and, with x1 non-null, leg 1 (x1, k1, C1). zero = 1:
// the legs are (B, H, W, C) and read with zero halos; zero = 0: they are
// padded, (B, H+2, W+2, C). C0, C1 % 64 == 0, Cout % bn == 0, bn 128 or 64
// output channels a block. grid: persistent blocks, each running every
// grid-th output block.
int ircolor_conv_fwd_gemm(const void* x0, const void* k0, int C0, const void* x1, const void* k1,
                          int C1, void* out, void* partial, int B, int H, int W, int Cout,
                          int zero, int bn, int grid, void* stream) {
  return ircolor::fwd_gemm(x0, k0, C0, x1, k1, C1, out, partial, B, H, W, Cout, zero, bn, grid,
                           static_cast<cudaStream_t>(stream));
}

// The bf16 conv in one call, the launches of the two entries above in
// order: with pass_pad 1 or 0, ircolor_conv_fwd_pass on each leg (x_i into
// zp_i, (B, H+2, W+2, C_i); pad 1: x_i is (B, H, W, C_i), its rows -1 and H
// from top / bot where non-null; 0: x_i is padded already; mean / inv
// normalize where non-null), then ircolor_conv_fwd_gemm on the zp_i with
// zero = 0; with pass_pad -1, the GEMM on the legs themselves. With sums
// non-null (and partial), then sums (B, 2, Cout) f32 = partial summed over
// its tiles in order.
int ircolor_conv_fwd(const void* x0, const void* k0, int C0, const void* x1, const void* k1,
                     int C1, const void* mean, const void* inv, const void* top, const void* bot,
                     void* zp0, void* zp1, int pass_pad, void* out, void* partial, void* sums,
                     int B, int H, int W, int Cout, int zero, int bn, int grid, void* stream) {
  using namespace ircolor;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pass_pad < -1 || pass_pad > 1 || (sums != nullptr && (partial == nullptr || B > 65535)) ||
      (pass_pad >= 0 && (zero || zp0 == nullptr || (x1 != nullptr) != (zp1 != nullptr))))
    return (int)cudaErrorInvalidValue;
  if (pass_pad >= 0) {
    const int ph = pass_pad ? H : H + 2, pw = pass_pad ? W : W + 2;
    int err = fwd_pass(x0, mean, inv, top, bot, zp0, B, ph, pw, C0, pass_pad, st);
    if (err == 0 && x1 != nullptr)
      err = fwd_pass(x1, mean, inv, top, bot, zp1, B, ph, pw, C1, pass_pad, st);
    if (err != 0) return err;
    x0 = zp0;
    x1 = zp1;
  }
  const int err = fwd_gemm(x0, k0, C0, x1, k1, C1, out, partial, B, H, W, Cout, zero, bn, grid, st);
  if (err != 0 || sums == nullptr) return err;
  const int ntiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW), n = 2 * Cout;
  tile_sum_kernel<<<dim3((n + 255) / 256, B), 256, 0, st>>>(static_cast<const float*>(partial),
                                                           static_cast<float*>(sums), ntiles, n);
  return (int)cudaGetLastError();
}

// The int8 conv's operand pass: out (B, H+2, W+2, C) int8 = x (B, H, W,
// C) bf16 reflect-padded by one pixel and quantized: clamp(rint(x *
// qscale[b]), -127, 127) where mean is null, else min(rint(relu((x -
// mean)*inv) * qfixed), 127). C % 16 == 0. The halo form as in
// ircolor_conv_fwd_pass (top / bot rows), the halo rows quantized like
// the rest.
int ircolor_conv_q_pass(const void* x, const void* qscale, const void* mean, const void* inv,
                        const void* top, const void* bot, float qfixed, void* out, int B, int H,
                        int W, int C, void* stream) {
  using namespace ircolor;
  if (C % 16 || (mean == nullptr) == (qscale == nullptr) || (mean == nullptr) != (inv == nullptr) ||
      (top == nullptr) != (bot == nullptr))
    return (int)cudaErrorInvalidValue;
  PassArgs a = {};
  a.z = static_cast<const __nv_bfloat16*>(x);
  a.qscale = static_cast<const float*>(qscale);
  a.zm = static_cast<const float*>(mean);
  a.zi = static_cast<const float*>(inv);
  a.qfixed = qfixed;
  a.zp = out;
  a.top = static_cast<const __nv_bfloat16*>(top);
  a.bot = static_cast<const __nv_bfloat16*>(bot);
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

// The int8 block conv in one call, no operand pass: out (B, H, W, Cout)
// bf16 and partial (B, ntiles, 2, Cout) f32 of y = f32(sum of the quantized,
// padded input against kt (3, 3, Cout, C) int8, K-major) * sc[b, co], the
// input quantized as ircolor_conv_q_pass quantizes it (conv1: qscale
// non-null; conv2: mean, inv and qfixed) while the GEMM loads it, its rows
// -1 and H from top / bot where non-null, else reflected, its columns
// reflected; then sums (B, 2, Cout) = partial summed over its tiles in
// order. x: the (B, H, W, C) bf16 rows, image i at x + i * x_img elements
// (H W C, or (H + 2) W C for the interior of a slab); top / bot: one row an
// image, image stride t_img. C % 64 == 0, Cout % 128 == 0, H, W >= 2; x,
// top, bot, mean and inv 16-byte aligned.
int ircolor_conv_q_fwd(const void* x, const void* top, const void* bot, long long x_img,
                       long long t_img, const void* kt, const void* sc, const void* qscale,
                       const void* mean, const void* inv, float qfixed, void* out, void* partial,
                       void* sums, int B, int H, int W, int C, int Cout, int grid, void* stream) {
  using namespace ircolor;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  const long long plane = (long long)H * W * C;
  if (x == nullptr || kt == nullptr || sc == nullptr || out == nullptr || partial == nullptr ||
      sums == nullptr || C <= 0 || C % KC_S8 || Cout <= 0 || Cout % 128 || H < 2 || W < 2 ||
      B < 1 || B > 65535 || grid < 1 || (top == nullptr) != (bot == nullptr) ||
      (qscale == nullptr) == (mean == nullptr) || (mean == nullptr) != (inv == nullptr) ||
      x_img < plane || (top != nullptr && t_img < (long long)W * C) || misaligned(x) ||
      misaligned(top) || misaligned(bot) || misaligned(mean) || misaligned(inv))
    return (int)cudaErrorInvalidValue;
  QLoadArgs a = {};
  a.qscale = static_cast<const float*>(qscale);
  a.zm = static_cast<const float*>(mean);
  a.zi = static_cast<const float*>(inv);
  a.qfixed = qfixed;
  a.sc = static_cast<const float*>(sc);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.partial = static_cast<float*>(partial);
  a.H = H;
  a.W = W;
  a.C = C;
  a.Cout = Cout;
  const int err = launch_q_fused(a, x, top, bot, x_img, t_img, kt, B, grid, st);
  if (err != 0) return err;
  const int ntiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW), n = 2 * Cout;
  tile_sum_kernel<<<dim3((n + 255) / 256, B), 256, 0, st>>>(static_cast<const float*>(partial),
                                                           static_cast<float*>(sums), ntiles, n);
  return (int)cudaGetLastError();
}

#ifdef IRCOLOR_QL_PROFILE
// The quantize-on-load kernel's phase cycles (ql_profile, 12 u64) into dst,
// then zeroed.
int ircolor_ql_profile(void* dst) {
  using namespace ircolor;
  cudaError_t e = cudaMemcpyFromSymbol(dst, ql_profile, sizeof(ql_profile));
  if (e == cudaSuccess) {
    const unsigned long long zero[12] = {};
    e = cudaMemcpyToSymbol(ql_profile, zero, sizeof(zero));
  }
  return (int)e;
}
#endif

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

// The int8 conv's GEMM: out (B, H, W, Cout), bf16 or (out_f32) f32, =
// ((f32(sum of xq against kq) * sc[b, co]) + addend) + bias, the addend (B,
// H, W, Cout) and bias (Cout) f32 where non-null, sc (B, Cout) f32. xq
// (B, in_h, in_w, C) int8: read with zero halos (zero = 1) or padded (zero
// = 0), at stride 1 (in_h, in_w = H, W, or H+2, W+2 padded) or 2 (the
// input itself through strided boxes, no pass). kq (3, 3, Cout', C') int8,
// zero-extended: C' is C rounded up to 64, Cout' Cout rounded up to bn (128
// or 64). C % 16 == 0, Cout % 16 == 0.
int ircolor_conv_qconv_gemm(const void* xq, const void* kq, const void* sc, const void* addend,
                            const void* bias, void* out, int out_f32, int C, int B, int H, int W,
                            int Cout, int zero, int stride, int in_h, int in_w, int bn, int grid,
                            void* stream) {
  using namespace ircolor;
  if (sc == nullptr || (bn != 128 && bn != 64) ||
      (stride == 1 && (in_h != H + 2 * !zero || in_w != W + 2 * !zero)))
    return (int)cudaErrorInvalidValue;
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
                  static_cast<cudaStream_t>(stream), stride, in_h, in_w);
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
