// Weight gradient of the resnet blocks' and the enc/dec segments' 3x3 convs,
// for Hopper (sm_90a): one transform pass, then a TMA + wgmma GEMM.
//
// Replaces ircolor_tpu/ops/pallas_resblock.py: conv3x3_wgrad_fused
// (_kernel_wgrad at :956, pallas_call at :1025), in all four of its forms:
// reflect halos with Z = z (block conv1) or Z = bf16(relu((z - zm)*zi))
// (block conv2), and zero halos with or without p masked by comp > m (the
// enc/dec segments).
//
//   dk[ty, tx, ci, co] = sum_{b,r,c} Zpad[b, r+ty, c+tx, ci] * dy[b, r, c, co]
//   dy = bf16(inv*((p - gm) - n*gy)), n = (comp - m)*inv   (IN backward)
//
// What bounds it on the H100: the tensor cores. At the flagship training
// bottleneck (8x128x160x256, k 3x3x256x256) the contraction is 0.193 TFLOP
// against 0.25 GB of bf16 operands (~770 flop/byte, above the card's ridge
// point); at the b8 segments (8x256x320) 0.19-0.39 TFLOP a launch.
//
// Design:
// * Transform pass (tma.cuh's operand pass; memory-bound): dy from (p, comp) through
//   InBwd8::apply (bit-identical to the dgrad's dy), and for the reflect
//   forms a reflect-padded Zp (B, H+2, W+2, Cz) of z or its normalize +
//   ReLU. Each input element is read once, each output written once. The
//   zero forms need no Z pass: their halo is the TMA's out-of-bounds zero.
// * GEMM: per tap, M = input channels, N = output channels, K = pixels.
//   TMA copies boxes of (64 channels, TC columns, TR rows, 1 image) of the
//   NHWC planes as they are, 128-byte swizzled: a pixel is one 128-byte
//   row, so both operands are MN-major in shared memory (channels
//   contiguous, K = pixel rows) and wgmma reads them with both transpose
//   bits set. The tap shift and the halo are box coordinates; a partial
//   edge chunk reads zero dy.
// * A block: two consumer warpgroups and one producer warp, six boxes a
//   chunk. Each warpgroup runs m64n256k16 wgmmas on its own A box and the
//   shared four-atom B: with Co % 256 == 0 A is two Z M-blocks ((tap, 64
//   input channels)) and B 256 dy channels; with 128 output channels a
//   block the roles swap (A: 2 x 64 dy channels, B: four Z M-blocks), so
//   every launch runs the wide tile and one ring of 48 KB stages. The
//   producer keeps STAGES chunks in flight with mbarrier completion; a
//   consumer keeps one chunk's wgmma group in flight and frees the chunk
//   before it.
// * K (pixel chunks) is split over a number of f32 workspace slots fixed
//   by the shapes alone (_wgrad_plan in kernels/resblock.py: about one
//   132-block wave), never by the card; the wrapper sums the slots in a
//   fixed order, so a repeat is bit-exact. The grid runs the blocks of one
//   slot next to each other: blocks in flight together read the same
//   chunks, from L2 after the first.
#include "tma.cuh"  // the operand pass, TMA, mbarrier and wgmma helpers

namespace ircolor {
namespace {

constexpr int TR = 2;                  // pixel rows per K chunk
constexpr int TC = 32;                 // pixel columns per K chunk
constexpr int PX = TR * TC;            // pixels per chunk: 4 k16 steps
constexpr int BOX = PX * 128;          // one 64-channel box: 8 KB
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;           // warpgroups
constexpr int NTHREADS = CONSUMERS * 128 + 32;  // + the producer warp

// m64nNk16, bf16 x bf16 -> f32, D += A*B, A and B both MN-major (the two
// transpose immediates set).
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// ------------------------------------------------------------- GEMM ----

// A block computes two m64n256 tiles, one a consumer warpgroup, from six
// boxes a chunk: box w (w = 0, 1) is warpgroup w's A, boxes 2..5 are the
// four 64-wide atoms of the shared B. An M-block is (tap, 64 input
// channels): mb = tap * ncib + ci/64.
// * Co % 256 == 0: A = two Z M-blocks (2 * mt + w), B = dy channels co0 ..
//   co0 + 255; the tiles are dk[tap][ci][co].
// * else (SWAP, 128 output channels a block): A = dy channels co0 + 64 w ..,
//   B = four Z M-blocks (4 * mt + n); the tiles are dk transposed.
// A Z box past the last M-block is not loaded: its rows or columns are
// never written.
struct GemmArgs {
  float* ws;        // (slots, 9, Cz, Co) f32 partials
  int Cz, Co;
  int ntr, ntc;     // chunk grid of one image
  int nchunks, cps; // chunks in all, chunks per slot
  int nmb, ncib;    // M-blocks (9 taps x Cz/64), input-channel blocks
  int ncob;         // output-channel blocks (256, or 128 with SWAP)
  int zshift;       // 0: Z boxes read the padded Zp; 1: z itself (zero halos)
};

constexpr int NBOX = CONSUMERS + 4;
constexpr int STAGE = NBOX * BOX;  // 48 KB
constexpr int GEMM_SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;  // + barriers, alignment

// Grid (tiles, slots), tile = mt * ncob + cob; x runs fastest, so the
// blocks of one slot run together.
template <bool SWAP>
__global__ void __launch_bounds__(NTHREADS, 1)
    wgrad_gemm_kernel(const __grid_constant__ CUtensorMap tz,
                      const __grid_constant__ CUtensorMap tdy, const GemmArgs a) {
  constexpr int CW = SWAP ? 128 : 256;  // output channels a block
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms: 1 KB
  const uint32_t full0 = base + STAGES * STAGE, empty0 = full0 + STAGES * 8;
  const int mt = blockIdx.x / a.ncob, co0 = (blockIdx.x % a.ncob) * CW;
  const int slot = blockIdx.y;
  const int k0 = slot * a.cps, nk = min(a.cps, a.nchunks - k0);
  const int per_img = a.ntr * a.ntc;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // Producer warp: one thread issues every copy. Box i: (map, channel,
    // column and row shift, loaded).
    if (threadIdx.x % 32 != 0) return;
    int ch[NBOX], dx[NBOX], dyr[NBOX];
    bool isz[NBOX], live[NBOX];
    int bytes = 0;
#pragma unroll
    for (int i = 0; i < NBOX; ++i) {
      isz[i] = SWAP ? i >= CONSUMERS : i < CONSUMERS;
      const int mb = SWAP ? 4 * mt + i - CONSUMERS : CONSUMERS * mt + i;
      live[i] = !isz[i] || mb < a.nmb;
      const int tap = mb / a.ncib;
      ch[i] = isz[i] ? (mb % a.ncib) * 64 : co0 + 64 * (SWAP ? i : i - CONSUMERS);
      dx[i] = isz[i] ? tap % 3 - a.zshift : 0;
      dyr[i] = isz[i] ? tap / 3 - a.zshift : 0;
      bytes += live[i] ? BOX : 0;
    }
    for (int j = 0; j < nk; ++j) {
      const int s = j % STAGES;
      const uint32_t full = full0 + 8 * s, dst = base + s * STAGE;
      mbar_wait(empty0 + 8 * s, ((j / STAGES) & 1) ^ 1);
      const int k = k0 + j, img = k / per_img, rem = k - img * per_img;
      const int r0 = (rem / a.ntc) * TR, c0 = (rem % a.ntc) * TC;
      mbar_expect_tx(full, bytes);
#pragma unroll
      for (int i = 0; i < NBOX; ++i) {
        if (live[i]) {
          tma_load(dst + i * BOX, isz[i] ? &tz : &tdy, full, ch[i], c0 + dx[i], r0 + dyr[i], img);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: D (64 x 256) += A_wg^T-by-pixels x B.
  const int mbw = CONSUMERS * mt + wg;  // its Z M-block (not SWAP)
  const bool live = SWAP || mbw < a.nmb;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int j = 0; j < nk; ++j) {
    const int s = j % STAGES;
    const uint32_t st = base + s * STAGE;
    mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
    if (live) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < PX / 16; ++ks) {  // 16 pixel rows = 2 KB a step
        const uint64_t da = smem_desc(st + wg * BOX + ks * 2048, BOX);
        const uint64_t db = smem_desc(st + CONSUMERS * BOX + ks * 2048, BOX);
        wgmma_n256(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the chunk before this one is done with its stage
    }
    if (j > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((j - 1) % STAGES));
  }
  wgmma_wait<0>();
  if (!live) return;

  // Epilogue into this slot. Accumulator i of a thread: tile row 16*warp +
  // lane/4 (+8 for the odd pair), tile column 8*(i/4) + 2*(lane%4) (+1).
  const int row = 16 * warp + lane / 4;
  if constexpr (!SWAP) {
    const int tap = mbw / a.ncib, ci0 = (mbw % a.ncib) * 64;
    float* dst = a.ws + ((size_t)(slot * 9 + tap) * a.Cz + ci0 + row) * a.Co + co0 + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(dst + (size_t)8 * a.Co + 8 * i) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  } else {
    // Rows are output channels, columns (atom n, input channel).
    float* dst = a.ws + (size_t)slot * 9 * a.Cz * a.Co + co0 + 64 * wg + row;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int mb = 4 * mt + n;
      if (mb >= a.nmb) continue;
      float* d = dst + ((size_t)(mb / a.ncib) * a.Cz + (mb % a.ncib) * 64 + 2 * (lane % 4)) * a.Co;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = 8 * n + q;
        d[(size_t)(8 * q) * a.Co] = acc[4 * i];
        d[(size_t)(8 * q + 1) * a.Co] = acc[4 * i + 1];
        d[(size_t)(8 * q) * a.Co + 8] = acc[4 * i + 2];
        d[(size_t)(8 * q + 1) * a.Co + 8] = acc[4 * i + 3];
      }
    }
  }
}

template <bool SWAP>
int launch_gemm(const CUtensorMap& tz, const CUtensorMap& tdy, const GemmArgs& a, int mtiles,
                int slots, cudaStream_t stream) {
  auto kernel = wgrad_gemm_kernel<SWAP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(mtiles * a.ncob, slots);
  kernel<<<grid, NTHREADS, GEMM_SMEM, stream>>>(tz, tdy, a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ircolor

extern "C" {

// The GEMM's chunk shape: the Python plan must use the same.
int ircolor_wgrad_chunk_rows() { return ircolor::TR; }
int ircolor_wgrad_chunk_cols() { return ircolor::TC; }

// dy (and, with z non-null, the reflect-padded Zp; zm/zi non-null: of
// relu((z - zm)*zi)). mask_p: p masked by comp > m.
int ircolor_wgrad_transform(const void* z, const void* p, const void* comp, const void* m,
                            const void* inv, const void* gm, const void* gy, const void* zm,
                            const void* zi, void* dy, void* zp, int B, int H, int W, int Cz,
                            int Co, int mask_p, void* stream) {
  using namespace ircolor;
  PassArgs a = {};
  a.z = static_cast<const __nv_bfloat16*>(z);
  a.p = static_cast<const __nv_bfloat16*>(p);
  a.comp = static_cast<const __nv_bfloat16*>(comp);
  a.m = static_cast<const float*>(m);
  a.inv = static_cast<const float*>(inv);
  a.gm = static_cast<const float*>(gm);
  a.gy = static_cast<const float*>(gy);
  a.zm = static_cast<const float*>(zm);
  a.zi = static_cast<const float*>(zi);
  a.dy = static_cast<__nv_bfloat16*>(dy);
  a.zp = static_cast<__nv_bfloat16*>(zp);
  a.ndy = (long long)B * H * W * (Co / 8);
  a.nzp = z != nullptr ? (long long)B * (H + 2) * (W + 2) * (Cz / 8) : 0;
  a.H = H;
  a.W = W;
  a.Cz = Cz;
  a.Co = Co;
  a.mask_p = mask_p;
  a.zpad = 1;
  return launch_operand_pass(a, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of a GEMM block (the ring, barriers, alignment).
int ircolor_wgrad_gemm_smem() { return ircolor::GEMM_SMEM; }

// ws (slots, 9, Cz, Co) f32 partials of the contraction of zsrc with dy
// (B, H, W, Co): zsrc is the padded Zp (B, H+2, W+2, Cz) when reflect,
// else z (B, H, W, Cz) itself. Slot s covers chunks [s*cps, (s+1)*cps) of
// the B x ceil(H/TR) x ceil(W/TC) chunk grid. Co % 256 == 0: blocks of two
// M-blocks x 256 output channels, else (Co % 128 == 0) four x 128.
int ircolor_wgrad_gemm(const void* zsrc, const void* dy, void* ws, int B, int H, int W, int Cz,
                       int Co, int reflect, int slots, int cps, void* stream) {
  using namespace ircolor;
  if (Cz % 64 || Co % 128) return (int)cudaErrorInvalidValue;
  CUtensorMap tz, tdy;
  const int pad = reflect ? 2 : 0;
  int err = make_nhwc_map(&tz, zsrc, B, H + pad, W + pad, Cz, TR, TC);
  if (err == 0) err = make_nhwc_map(&tdy, dy, B, H, W, Co, TR, TC);
  if (err != 0) return err;
  const bool swap = Co % 256 != 0;
  GemmArgs a;
  a.ws = static_cast<float*>(ws);
  a.Cz = Cz;
  a.Co = Co;
  a.ntr = (H + TR - 1) / TR;
  a.ntc = (W + TC - 1) / TC;
  a.nchunks = B * a.ntr * a.ntc;
  a.cps = cps;
  a.ncib = Cz / 64;
  a.nmb = 9 * a.ncib;
  a.ncob = Co / (swap ? 128 : 256);
  a.zshift = reflect ? 0 : 1;
  if (cps < 1 || (long long)slots * cps < a.nchunks || (long long)(slots - 1) * cps >= a.nchunks)
    return (int)cudaErrorInvalidValue;
  const int per = swap ? 4 : CONSUMERS;  // M-blocks a block
  const int mtiles = (a.nmb + per - 1) / per;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return swap ? launch_gemm<true>(tz, tdy, a, mtiles, slots, s)
              : launch_gemm<false>(tz, tdy, a, mtiles, slots, s);
}

}  // extern "C"
