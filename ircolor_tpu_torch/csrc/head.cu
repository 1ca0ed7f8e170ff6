// Fused 7x7 output head of the generator for Hopper (sm_90a): up2's
// instance-norm normalize + ReLU, ReflectionPad(3) and the 7x7 conv to 3
// channels, on the tensor cores. One kernel template, two forms: bf16 (row
// 4) and s8 (row 4q). The caller adds the bias and the tanh.
//
// Replaces ircolor_tpu/ops/pallas_head.py:conv7x7_head_pallas (:286;
// _kernel_head :131, pallas_call :366): quant=False is the bf16 form,
// quant=True (outc_head_q, :445) the s8 form.
//
//   bf16: z   = bf16(relu((x - mean) * inv))          (rounded as the JAX kernel does)
//         out = bf16(sum_{dy,dx,c} z[r+dy-3, c'+dx-3, c] * k[dy, dx, c, co])
//   s8:   q   = min(rint(relu((x - mean) * inv) * 127/6), 127)   (single IEEE steps)
//         out = bf16(f32(sum_{dy,dx,c} q * kq[dy, dx, c, co]) * sc[co]),  sc = 6/127 * sw[co]
//
// What bounds it on the H100: bytes. At the flagship (32x512x640, 64 -> 3)
// the bf16 input is 1.34 GB, read once, and the output 63 MB: 0.419 ms at
// 3.35 TB/s. The conv is 197 GFLOP, but Cout = 3 fills no MMA tile: padded
// alone to N = 8 it would be 524 GFLOP, 0.53 ms at the bf16 dense peak.
//
// Design: the 7 horizontal taps go into the MMA's N. For each staged input
// row and each vertical tap dy, one GEMM: A = the row's window, M = its
// 122 + 6 reflect-extended pixels (8 m16 tiles), K = the channels; B_dy =
// k[dy] as K = C by N = (dx, co), 21 columns zero-padded to 24 (3 n8
// tiles). Useful work is 21/24 of the MMAs', ~283 GFLOP at the flagship
// with the halo columns and the sixth, partial strip. Output row r
// accumulates A(r+dy-3) . B_dy over dy in registers; its epilogue
// shift-sums out[c', co] = sum_dx P[c'+dx, 3 dx + co] through shared
// memory (the 7 source pixels cross fragments). In the s8 form the
// shift-sum stays in int32 before the cvt, so the result equals the plain
// version's exact integer conv bit for bit; the bf16 form sums in f32 in a
// fixed order (dy, then dx), so a repeat is bit-exact.
//
// A block owns a 122-column strip of `th` output rows of one image and
// walks down its th + 6 input rows, each in chunks of <= 64 channels (a
// "unit"). A staging warpgroup keeps 4 units of cp.async in flight
// (16-byte loads, the reflect halo in the index map; each thread prepares
// exactly the chunks it loaded: normalize + ReLU + round to bf16, or
// quantize) and fills a ring of 4 prepared units, handed over by named
// barriers (full / empty), so loads and the normalize overlap the MMAs. A
// prepared unit is [K step][pixel][32 bytes], the 16-byte halves of pixels
// 4-7 of each 8 swapped, so ldmatrix's 8 rows hit 8 bank groups. 3 MMA
// warpgroups: warp (m, n) owns m16 tiles 2m, 2m+1 and n8 tile n, keeps its
// B fragments for all 7 dy in registers (read once a block when C <= 64)
// and 7 rolling output rows of accumulators; each A fragment it loads
// feeds 7 MMAs. The 128-pixel window is 8 m16 tiles exactly, so the 12
// MMA warps split into 3 a scheduler (a 134-pixel window for 128 columns
// pads to 9 tiles and 9 warps, 3 on one scheduler and 2 on the others);
// setmaxnreg moves registers from the staging warpgroup to the MMA warps.
// mma.sync, not wgmma: wgmma's M = 64 would need its 7 rows of 64 x 24
// accumulators per warpgroup and pad the window to whole m64 tiles;
// mma.sync's m16 keeps A register-resident across the 7 taps. On the card
// mma.sync runs at about half the dense peak, and the MMA warps and the
// staging warps each take about as long as the other, so neither the
// bytes nor the MMAs alone bound the kernel (PERF.md, the head). B is
// read straight from the (7, 7, C, 3) weights through a cached index table
// (kernels/head.py:_head_index): no per-call repack. Channels past C (C =
// 8, 24, ...) are zero in the prepared tile (never written) and in B
// (index -1).
#include <type_traits>

#include "common.cuh"

namespace ircolor {
namespace {

constexpr int KS = 7;
constexpr int HALO = 3;
constexpr int COUT = 3;
constexpr int TW = 122;                  // output columns a block
constexpr int WIN = TW + 2 * HALO;       // staged window columns
constexpr int MTILES = 8;                // m16 tiles over the window
constexpr int NPIX = 16 * MTILES;        // 128 rows of A: the window
constexpr int MPW = 2;                   // m16 tiles an MMA warp
constexpr int NTILES = 3;                // n8 tiles: (dx, co), 21 of 24 columns
constexpr int NCOL = 8 * NTILES;
constexpr int NMMA = 32 * (MTILES / MPW) * NTILES;  // 384 MMA threads (3 warpgroups)
constexpr int NPROD = 128;               // 1 staging warpgroup
constexpr int NTHREADS = NMMA + NPROD;   // 512: 3 MMA warps and 1 staging warp a scheduler
// setmaxnreg, 3 MMA warpgroups + 1 staging = 4 x 128 registers a thread:
// the bf16 form at 64 channels holds 56 B registers (s8: 28), so its MMA
// warps take 152 and its staging warps, which share their raw and prepared
// offsets, 56; the several-unit forms 144 and 80; the others fit in 128.
// Each value is the one at which ptxas spilled nothing on the card.
template <bool S8, int KST, bool MULTI>
struct Regs {
  static constexpr int MMA = MULTI ? 144 : !S8 && KST == 4 ? 152 : 128;
  static constexpr int PROD = 512 - 3 * MMA;
};
constexpr int NRAW = 4;                  // a staging thread's cp.async ring (units)
constexpr int NA = 4;                    // ring of prepared A units
constexpr int QS = 132;                  // staging stride in words (4 mod 16)
constexpr int ROWB = 32;                 // bytes of one pixel's K step
constexpr float QFIXED = 127.0f / 6.0f;
// Named barriers: FULL(s) = 1 + s (A slot s prepared), EMPTY(s) = 1 + NA +
// s (A slot s read), and one among the MMA warps.
constexpr int BAR_FULL = 1, BAR_EMPTY = 1 + NA, BAR_MMA = 1 + 2 * NA;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// m16n8k32 s8 mma.sync, s32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One element on the fixed 127/6 grid, min(rint(relu((v - m) * iv) * 127/6),
// 127), each step one IEEE operation as in the plain version: the sum with
// 1.5 * 2^23 rounds a value in [0, 127] to the nearest integer (ties to
// even) in its low byte.
__device__ __forceinline__ uint32_t quant_bits(float v, float m, float iv) {
  const float z = fmaxf(__fmul_rn(__fsub_rn(v, m), iv), 0.f);
  return __float_as_uint(__fadd_rn(fminf(__fmul_rn(z, QFIXED), 127.f), 12582912.f));
}

// Read-only loads of the B index table and the weights; ORDERED: volatile.
template <bool ORDERED>
__device__ __forceinline__ int4 ld_index(const int4* p) {
  if constexpr (ORDERED) {
    const volatile int* v = reinterpret_cast<const volatile int*>(p);
    return make_int4(v[0], v[1], v[2], v[3]);
  }
  return __ldg(p);
}

template <bool ORDERED, class T>
__device__ __forceinline__ T ld_weight(const T* p) {
  if constexpr (ORDERED) return *reinterpret_cast<const volatile T*>(p);
  return __ldg(p);
}

// A staged tile is [K step][pixel][32 bytes]: ldmatrix reads 8 pixels'
// 16-byte halves of one K step, and the halves of pixels 4-7 of each 8
// swap, so those 8 rows hit 8 bank groups. A K step is padded so that the
// 8 threads of a quarter warp, which stage the K steps of one or two
// pixels, hit different bank groups too.
template <int NKS>
struct Tile {
  static constexpr int STEP = NPIX * ROWB + (NKS >= 3 ? 32 : 128 / NKS);
  static constexpr int BYTES = NKS * STEP;
  // Byte offset of pixel p's 16-byte half h of K step s.
  static __device__ __forceinline__ int off(int s, int p, int h) {
    return s * STEP + p * ROWB + ((h ^ ((p >> 2) & 1)) << 4);
  }
};

template <bool S8, int KST>
struct HeadShape {
  static constexpr int RKS = S8 ? 2 * KST : KST;  // bf16 K steps a staged unit
  static constexpr int QPP = 2 * RKS;             // 16-byte chunks a pixel
  static constexpr int KC = 8 * QPP;              // channels a unit
  using Raw = Tile<RKS>;                          // a raw bf16 unit
  using A = Tile<KST>;                            // a prepared unit: bf16 z or s8 q
  static constexpr int E = S8 ? 8 : 4;            // B elements a lane, (dy, K step)
  static int smem_bytes(int nchunk) {
    return NRAW * Raw::BYTES + NA * A::BYTES + 2 * NCOL * QS * 4 + 2 * nchunk * KC * 4;
  }
};

// One block's state; its members run inlined in head_kernel. MULTI: C
// takes more than one unit, and the MMA warps reload B for each.
template <bool S8, int KST, bool MULTI>
struct HeadBlock {
  using Sh = HeadShape<S8, KST>;
  using Acc = typename std::conditional<S8, int, float>::type;
  using Raw = typename Sh::Raw;
  using A = typename Sh::A;
  static constexpr int QPP = Sh::QPP, KC = Sh::KC, E = Sh::E;
  static_assert(NPROD % QPP == 0, "a staging thread keeps one chunk slot of every pixel");

  const __nv_bfloat16* xb;
  const void* w;
  const int* bidx;
  __nv_bfloat16* out;
  uint8_t* raw;    // NRAW raw units
  uint8_t* atile;  // NA prepared units
  Acc* stage;      // two (24, QS) output rows of P
  const float* smean;
  const float* sinv;
  float sc_co;  // s8: the dequant scale of this thread's output channel
  int tid, lane, nt, m0, b, r0, c0, rows, n_in, units, cols, q, H, W, C, nchunk;

  // Units an input row: 1 unless MULTI.
  __device__ __forceinline__ int nch() const { return MULTI ? nchunk : 1; }

  // --- staging warps (tid >= NMMA) -------------------------------------
  // Staging thread pt = tid - NMMA owns chunk q = pt % QPP (8 channels) of
  // pixels (pt + k NPROD) / QPP: FULLK of them in every thread, one more
  // in some.
  static constexpr int FULLK = WIN * QPP / NPROD;
  static constexpr int CPT = (WIN * QPP + NPROD - 1) / NPROD;

  struct Chunks {
    int src[CPT];   // element offset of the pixel in its input row (reflected)
    int roff[CPT];  // byte offset in a raw unit
    int aoff_[S8 ? CPT : 1];  // s8: byte offset in a prepared unit (bf16: roff)
    bool tail;      // chunk CPT - 1 is this thread's
    __device__ __forceinline__ int aoff(int k) const {
      if constexpr (S8) return aoff_[k];
      return roff[k];
    }
  };

  // cp.async of this thread's chunks of unit u (input row u / nchunk,
  // channel chunk u % nchunk) into raw slot u % NRAW; one group a call.
  __device__ __forceinline__ void issue(const Chunks& ch, int u) const {
    if (u < units) {
      const int ii = u / nch(), cq = (u - ii * nch()) * KC + q * 8;
      if (cq < C) {
        const __nv_bfloat16* rp =
            xb + (size_t)reflect_index(r0 - HALO + ii, H) * W * C + cq;
        const uint32_t slot = smem_u32(raw + (u % NRAW) * Raw::BYTES);
#pragma unroll
        for (int k = 0; k < CPT; ++k)
          if (k < FULLK || ch.tail) cp_async16(slot + ch.roff[k], rp + ch.src[k]);
      }
    }
    cp_async_commit();
  }

  // This thread's chunks of unit u, raw slot -> A slot u % NA: normalize +
  // ReLU + round to bf16 (s8: quantize on the 127/6 grid).
  __device__ __forceinline__ void prepare(const Chunks& ch, int u, const float (&m)[8],
                                          const float (&iv)[8]) const {
    const uint8_t* rs = raw + (u % NRAW) * Raw::BYTES;
    uint8_t* as = atile + (u % NA) * A::BYTES;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      if (k >= FULLK && !ch.tail) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(rs + ch.roff[k]);
      const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
      if constexpr (S8) {
        uint32_t o[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * h;
          const uint32_t lo = __byte_perm(quant_bits(bf16_lo(wv[2 * h]), m[e], iv[e]),
                                          quant_bits(bf16_hi(wv[2 * h]), m[e + 1], iv[e + 1]),
                                          0x0040);
          const uint32_t hi =
              __byte_perm(quant_bits(bf16_lo(wv[2 * h + 1]), m[e + 2], iv[e + 2]),
                          quant_bits(bf16_hi(wv[2 * h + 1]), m[e + 3], iv[e + 3]), 0x0040);
          o[h] = __byte_perm(lo, hi, 0x5410);
        }
        *reinterpret_cast<uint2*>(as + ch.aoff(k)) = make_uint2(o[0], o[1]);
      } else {
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lo = fmaxf(__fmul_rn(__fsub_rn(bf16_lo(wv[e]), m[2 * e]), iv[2 * e]), 0.f);
          const float hi =
              fmaxf(__fmul_rn(__fsub_rn(bf16_hi(wv[e]), m[2 * e + 1]), iv[2 * e + 1]), 0.f);
          o[e] = pack_bf16x2(lo, hi);
        }
        *reinterpret_cast<uint4*>(as + ch.aoff(k)) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  }

  // The mean and inv_std of this thread's 8 channels of unit u.
  __device__ __forceinline__ void stats(int u, float (&m)[8], float (&iv)[8]) const {
    const int ii = u / nch(), cq = (u - ii * nch()) * KC + q * 8;
    const float4* pm = reinterpret_cast<const float4*>(smean + cq);
    const float4* pi = reinterpret_cast<const float4*>(sinv + cq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 mv = pm[h], vv = pi[h];
      m[4 * h] = mv.x; m[4 * h + 1] = mv.y; m[4 * h + 2] = mv.z; m[4 * h + 3] = mv.w;
      iv[4 * h] = vv.x; iv[4 * h + 1] = vv.y; iv[4 * h + 2] = vv.z; iv[4 * h + 3] = vv.w;
    }
  }

  // Keeps NRAW units of cp.async in flight; prepares each unit once the
  // MMA warps have released its A slot, then marks the slot full. A
  // thread's chunks past C are skipped (the A tile stays zero there).
  __device__ __forceinline__ void stage_units() const {
    const int pt = tid - NMMA;
    Chunks ch;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int p = min((pt + k * NPROD) / QPP, WIN - 1);
      ch.src[k] = reflect_index(c0 - HALO + p, W) * C;
      ch.roff[k] = Raw::off(q >> 1, p, q & 1);
      if constexpr (S8) ch.aoff_[k] = A::off(q >> 2, p, (q >> 1) & 1) + (q & 1) * 8;
    }
    ch.tail = (pt + (CPT - 1) * NPROD) / QPP < WIN;
    float m[8], iv[8];
    stats(0, m, iv);
#pragma unroll
    for (int d = 0; d < NRAW; ++d) issue(ch, d);
    for (int u = 0; u < units; ++u) {
      cp_async_wait<NRAW - 1>();  // this thread's chunks of unit u landed
      if (u >= NA) bar_sync(BAR_EMPTY + u % NA, NTHREADS);
      if constexpr (MULTI) stats(u, m, iv);
      if ((u % nch()) * KC + q * 8 < C) prepare(ch, u, m, iv);
      bar_arrive(BAR_FULL + u % NA, NTHREADS);
      issue(ch, u + NRAW);  // into the raw slot just read, by this thread only
    }
    cp_async_wait<0>();
  }

  // --- MMA warps (tid < NMMA) ------------------------------------------

  // The B fragment of n8 tile nt for (dy, K step ks) of channel chunk ck,
  // gathered from the (7, 7, C, 3) weights through the index table (-1:
  // zero). ORDERED: volatile reads, which the compiler keeps in program
  // order among the MMAs; the several-unit path, which gathers B for every
  // unit, would otherwise hoist all 7 taps' loads at once and spill.
  template <bool ORDERED = false>
  __device__ __forceinline__ void load_frag(int ck, int dy, int ks, uint32_t& b0,
                                            uint32_t& b1) const {
    const int4* e = reinterpret_cast<const int4*>(bidx) +
                    ((((size_t)ck * KS + dy) * KST + ks) * NTILES * 32 + nt * 32 + lane) * (E / 4);
    uint32_t r[2];
    if constexpr (S8) {
      const int8_t* wk = static_cast<const int8_t*>(w);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int4 id = ld_index<ORDERED>(e + h);
        const int v[4] = {id.x, id.y, id.z, id.w};
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          word |= (uint32_t)(uint8_t)(v[j] >= 0 ? ld_weight<ORDERED>(wk + v[j]) : 0) << (8 * j);
        r[h] = word;
      }
    } else {
      const unsigned short* wk = static_cast<const unsigned short*>(w);
      const int4 id = ld_index<ORDERED>(e);
      const int v[4] = {id.x, id.y, id.z, id.w};
      uint32_t h16[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) h16[j] = v[j] >= 0 ? (uint32_t)ld_weight<ORDERED>(wk + v[j]) : 0u;
      r[0] = h16[0] | (h16[1] << 16);
      r[1] = h16[2] | (h16[3] << 16);
    }
    b0 = r[0];
    b1 = r[1];
  }

  __device__ __forceinline__ void mma_acc(Acc (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) const {
    if constexpr (S8) {
      mma_s8(d, a, b0, b1);
    } else {
      mma(d, a, b0, b1);
    }
  }

  // out[r, c', co] = sum_dx P[c' + dx, 3 dx + co], dx in order: output
  // tid = 3 c' + co of the row (cols * 3 <= 366 < 384 MMA threads).
  __device__ __forceinline__ void shift_sum(int r) const {
    if (tid >= cols * COUT) return;
    const int c = tid / COUT, co = tid - c * COUT;
    const Acc* st = stage + (r & 1) * NCOL * QS + co * QS + c;
    Acc s = st[0];
#pragma unroll
    for (int dx = 1; dx < KS; ++dx) s += st[COUT * dx * QS + dx];
    __nv_bfloat16* o = out + (((size_t)b * H + r0 + r) * W + c0) * COUT + tid;
    if constexpr (S8) {
      *o = __float2bfloat16_rn(__fmul_rn(__int2float_rn(s), sc_co));
    } else {
      *o = __float2bfloat16_rn(s);
    }
  }

  // Input row ii = i0 + U7, all its channel chunks. U7 is static, so the
  // accumulators of output row ii - dy, acc[(U7 - dy) % 7], are indexed
  // statically. Every tap runs, also for the rows ii - dy outside the
  // band: the accumulators of row ii are zeroed before its first tap and
  // those past the band are never stored. False past the last input row.
  template <int U7>
  __device__ __forceinline__ bool row(int i0, Acc (&acc)[KS][MPW][4],
                                      uint32_t (&bf)[MULTI ? 1 : KS][KST][2], int& pending) const {
    const int ii = i0 + U7;
    if (ii >= n_in) return false;
#pragma unroll
    for (int j = 0; j < MPW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[U7][j][e] = 0;
    for (int ck = 0; ck < nch(); ++ck) {
      const int u = ii * nch() + ck;
      bar_sync(BAR_FULL + u % NA, NTHREADS);  // also orders the staging rows
      const uint32_t abase = smem_u32(atile + (u % NA) * A::BYTES);
      // Each A fragment feeds the 7 taps back to back: 7 independent
      // accumulators; each accumulator sums its K steps in order.
      if constexpr (MULTI) {
        // B of this unit's chunk, one fragment at a time, for both m16
        // tiles: nothing held across units.
#pragma unroll
        for (int ks = 0; ks < KST; ++ks) {
          uint32_t a[MPW][4];
#pragma unroll
          for (int j = 0; j < MPW; ++j)
            ldsm_x4(a[j], abase + A::off(ks, 16 * (m0 + j) + (lane & 15), lane >> 4));
#pragma unroll
          for (int dy = 0; dy < KS; ++dy) {
            uint32_t b0, b1;
            load_frag<true>(ck, dy, ks, b0, b1);
#pragma unroll
            for (int j = 0; j < MPW; ++j) mma_acc(acc[(U7 - dy + KS) % KS][j], a[j], b0, b1);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < MPW; ++j) {
          const int p = 16 * (m0 + j) + (lane & 15);
#pragma unroll
          for (int ks = 0; ks < KST; ++ks) {
            uint32_t a[4];
            ldsm_x4(a, abase + A::off(ks, p, lane >> 4));
#pragma unroll
            for (int dy = 0; dy < KS; ++dy)
              mma_acc(acc[(U7 - dy + KS) % KS][j], a, bf[dy][ks][0], bf[dy][ks][1]);
          }
        }
      }
      if (u + NA < units) bar_arrive(BAR_EMPTY + u % NA, NTHREADS);
      // The previous output row, staged before this unit's full barrier,
      // while this unit's MMAs run.
      if (pending >= 0) {
        shift_sum(pending);
        pending = -1;
      }
      if (ck == nch() - 1 && ii >= KS - 1) {
        // Output row ii - 6 has all its taps: to the staging buffer.
        constexpr int sl = (U7 + 1) % KS;
        const int r = ii - (KS - 1);
        Acc* st = stage + (r & 1) * NCOL * QS;
        const int n = 8 * nt + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < MPW; ++j) {
          const int pix = 16 * (m0 + j) + (lane >> 2);
          st[n * QS + pix] = acc[sl][j][0];
          st[(n + 1) * QS + pix] = acc[sl][j][1];
          st[n * QS + pix + 8] = acc[sl][j][2];
          st[(n + 1) * QS + pix + 8] = acc[sl][j][3];
        }
        pending = r;
      }
    }
    return true;
  }

  __device__ __forceinline__ void mma_units() const {
    Acc acc[KS][MPW][4];
    uint32_t bf[MULTI ? 1 : KS][KST][2];  // B of the one unit of a row, held
    if constexpr (!MULTI) {
#pragma unroll
      for (int dy = 0; dy < KS; ++dy)
#pragma unroll
        for (int ks = 0; ks < KST; ++ks) load_frag(0, dy, ks, bf[dy][ks][0], bf[dy][ks][1]);
    }
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int j = 0; j < MPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][j][e] = 0;
    int pending = -1;  // an output row in the staging buffer, not yet stored
    for (int i0 = 0; i0 < n_in; i0 += KS) {
      if (!(row<0>(i0, acc, bf, pending) && row<1>(i0, acc, bf, pending) &&
            row<2>(i0, acc, bf, pending) && row<3>(i0, acc, bf, pending) &&
            row<4>(i0, acc, bf, pending) && row<5>(i0, acc, bf, pending) &&
            row<6>(i0, acc, bf, pending)))
        break;
    }
    bar_sync(BAR_MMA, NMMA);
    if (pending >= 0) shift_sum(pending);
  }
};

// 12 MMA warps and 4 staging warps; see the note at the top.
template <bool S8, int KST, bool MULTI>
__global__ void __launch_bounds__(NTHREADS, 1)
    head_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ inv, const void* __restrict__ w,
                const int* __restrict__ bidx, const float* __restrict__ sc,
                __nv_bfloat16* __restrict__ out, int H, int W, int C, int th,
                int nchunk) {
  using Blk = HeadBlock<S8, KST, MULTI>;
  using Acc = typename Blk::Acc;
  extern __shared__ __align__(128) uint8_t smem[];

  Blk k;
  k.raw = smem;
  k.atile = smem + NRAW * Blk::Raw::BYTES;
  k.stage = reinterpret_cast<Acc*>(k.atile + NA * Blk::A::BYTES);
  float* smean = reinterpret_cast<float*>(k.stage + 2 * NCOL * QS);
  float* sinv = smean + nchunk * Blk::KC;
  k.smean = smean;
  k.sinv = sinv;
  k.w = w;
  k.bidx = bidx;
  k.out = out;
  k.tid = threadIdx.x;
  k.lane = k.tid & 31;
  k.nt = (k.tid >> 5) % NTILES;
  k.m0 = ((k.tid >> 5) / NTILES) * MPW;
  k.b = blockIdx.z;
  k.r0 = blockIdx.y * th;
  k.c0 = blockIdx.x * TW;
  k.H = H;
  k.W = W;
  k.C = C;
  k.nchunk = nchunk;
  k.rows = min(th, H - k.r0);
  k.n_in = k.rows + 2 * HALO;
  k.units = k.n_in * nchunk;
  k.cols = min(TW, W - k.c0);
  k.q = (k.tid - NMMA) % Blk::QPP;
  k.xb = x + (size_t)k.b * H * W * C;
  k.sc_co = S8 && k.tid < NMMA ? __ldg(sc + k.tid % COUT) : 0.f;  // this thread's co

  // Channels past C and pixels past the window are never written: zero.
  uint4* z = reinterpret_cast<uint4*>(k.atile);
  for (int i = k.tid; i < NA * Blk::A::BYTES / 16; i += NTHREADS) z[i] = make_uint4(0, 0, 0, 0);
  for (int i = k.tid; i < nchunk * Blk::KC; i += NTHREADS) {
    smean[i] = i < C ? __ldg(mean + (size_t)k.b * C + i) : 0.f;
    sinv[i] = i < C ? __ldg(inv + (size_t)k.b * C + i) : 0.f;
  }
  __syncthreads();
  using R = Regs<S8, KST, MULTI>;
  if (k.tid >= NMMA) {
    if constexpr (R::MMA != 128)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R::PROD));
    k.stage_units();
  } else {
    if constexpr (R::MMA != 128)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R::MMA));
    k.mma_units();
  }
}

template <bool S8, int KST, bool MULTI>
int launch_head(const void* x, const void* mean, const void* inv, const void* w,
                const void* bidx, const void* sc, void* out, int B, int H, int W, int C,
                int th, int nchunk, int smem, cudaStream_t stream) {
  if (th <= 0 || (nchunk > 1) != MULTI || smem < HeadShape<S8, KST>::smem_bytes(nchunk))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      head_kernel<S8, KST, MULTI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + th - 1) / th, B);
  head_kernel<S8, KST, MULTI><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(inv), w, static_cast<const int*>(bidx),
      static_cast<const float*>(sc), static_cast<__nv_bfloat16*>(out), H, W, C, th, nchunk);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ircolor

extern "C" {

// x (B, H, W, C) bf16, C % 8 == 0, 16-byte aligned; mean, inv (B, C) f32;
// w the (7, 7, C, 3) weights, bf16 (s8 = 0) or int8 (s8 = 1) with sc the
// (3,) dequant scale; bidx the B index table of kernels/head.py:_head_index
// for (C, kst, nchunk); th, kst, nchunk and smem from kernels/head.py:
// _head_plan. Returns cudaErrorInvalidValue for a plan the kernel does not
// have or a smem below its layout.
int ircolor_conv7x7_head(const void* x, const void* mean, const void* inv, const void* w,
                         const void* bidx, const void* sc, void* out, int B, int H, int W,
                         int C, int s8, int kst, int th, int nchunk, int smem,
                         void* stream) {
  using namespace ircolor;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define IRCOLOR_HEAD(S, K, M) \
  launch_head<S, K, M>(x, mean, inv, w, bidx, sc, out, B, H, W, C, th, nchunk, smem, st)
  // Units of 1, 2 or 4 K steps; past 64 channels, several 64-channel units.
  switch ((s8 ? 16 : 0) + (nchunk > 1 ? 8 : 0) + kst) {
    case 1: return IRCOLOR_HEAD(false, 1, false);
    case 2: return IRCOLOR_HEAD(false, 2, false);
    case 4: return IRCOLOR_HEAD(false, 4, false);
    case 8 + 4: return IRCOLOR_HEAD(false, 4, true);
    case 16 + 1: return IRCOLOR_HEAD(true, 1, false);
    case 16 + 2: return IRCOLOR_HEAD(true, 2, false);
    case 16 + 8 + 2: return IRCOLOR_HEAD(true, 2, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef IRCOLOR_HEAD
}

}  // extern "C"
