// Pieces shared by the port's TMA + wgmma kernels (csrc/conv_fwd.cu, the
// 3x3 conv in bf16 and int8 and its dgrad, and csrc/wgrad.cu, its weight
// gradient): the operand pass that feeds the GEMMs, the mbarrier ring with its watchdog, 4-D TMA
// loads, the shared-memory matrix descriptors of swizzled tiles, the wgmma
// fences, and the tensor-map encoder taken from the driver at run time (no
// libcuda link).
#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's types

#include "common.cuh"

namespace ircolor {
namespace {

constexpr int PASS_THREADS = 256;
constexpr long long PASS_MAX_BLOCKS = 2048;       // grid-stride beyond this
constexpr long long WATCHDOG_CYCLES = 1ll << 35;  // ~18 s at 1.98 GHz

// ---------------------------------------------------- operand pass ----

// Memory-bound, one 16-byte output unit a step, two parts:
// * dy (ndy units of 8 channels: the wgrad and the dgrad): the IN backward
//   of (p, comp) through InBwd8::apply, bit-identical to the plain
//   version's;
// * Z (nzp units): Z = z, or bf16(relu((z - zm)*zi)) in the plain
//   version's single IEEE steps, written as (B, H+2*zpad, W+2*zpad, Cz):
//   reflect-padded by one pixel (zpad = 1) or as it is (zpad = 0: z is
//   already padded and only normalized). 8 channels a unit.
// The int8 form (Q8, the int8 block conv; no dy part) writes Z as int8,
// 16 channels a unit from two 16-byte bf16 loads, quantized in the plain
// version's single IEEE steps with rint (ties to even, as torch.round):
//   q = clamp(rint(z * qscale[b]), -127, 127)                (zm null)
//   q = min(rint(relu((z - zm)*zi) * qfixed), 127)
// The normalized value stays f32 up to the quantize: it is not rounded to
// bf16 first. With zq (the int8 conv's reflect sites) the input is int8
// already and Z is zq reflect-padded, 16 bytes copied a unit.
// The spatial halo form of the block convs (zpad = 1; the JAX kernels'
// halo "separate"): rows -1 and H of Zp come from the 1-row tensors top /
// bot (the neighbour shards' edge rows). The halo rows take the same
// normalize or quantize as interior rows, and columns, corners included,
// stay reflected within their row. (The int8 block conv runs no pass on
// the card: conv_fwd.cu's conv_q_fused_kernel quantizes on its A load; this
// int8 pass is the two-launch path it is held to.)
struct PassArgs {
  const __nv_bfloat16* z;     // (B, H, W, Cz), or null (no Z part)
  const int8_t* zq;           // Q8: (B, H, W, Cz) int8 copied as it is, or null
  const __nv_bfloat16* p;     // (B, H, W, Co), or null (no dy part)
  const __nv_bfloat16* comp;  // (B, H, W, Co)
  const float* m;             // (B, Co) IN mean, inv, E[p], E[p*n]
  const float* inv;
  const float* gm;
  const float* gy;
  const float* zm;            // (B, Cz) or null: Z = relu((z - zm)*zi)
  const float* zi;
  const float* qscale;        // Q8: (B,) conv1's per-sample scale, with zm null
  float qfixed;               // Q8: conv2's fixed grid, with zm
  __nv_bfloat16* dy;          // (B, H, W, Co)
  void* zp;                   // (B, H+2*zpad, W+2*zpad, Cz), bf16 or (Q8) int8
  const __nv_bfloat16* top;   // (B, 1, W, Cz) row -1 of Z, with bot; or null
  const __nv_bfloat16* bot;   // (B, 1, W, Cz) row H of Z
  long long ndy, nzp;         // 16-byte units of each output
  int H, W, Cz, Co, mask_p, zpad;
};

__device__ __forceinline__ uint32_t pack_s8x4(int q0, int q1, int q2, int q3) {
  return (uint32_t)(q0 & 0xff) | ((uint32_t)(q1 & 0xff) << 8) | ((uint32_t)(q2 & 0xff) << 16) |
         ((uint32_t)(q3 & 0xff) << 24);
}

template <bool Q8>
__global__ void __launch_bounds__(PASS_THREADS) operand_pass_kernel(const PassArgs a) {
  constexpr int CU = Q8 ? 16 : 8;  // channels of one output unit
  const long long stride = (long long)gridDim.x * PASS_THREADS;
  for (long long u = (long long)blockIdx.x * PASS_THREADS + threadIdx.x; u < a.ndy + a.nzp;
       u += stride) {
    if (!Q8 && u < a.ndy) {
      const int cu = a.Co / 8;
      const long long pix = u / cu;
      const int c8 = (int)(u - pix * cu) * 8;
      const size_t prm = (size_t)(pix / ((long long)a.H * a.W)) * a.Co + c8;
      InBwd8 in;
      in.load(a.m + prm, a.inv + prm, a.gm + prm, a.gy + prm);
      *reinterpret_cast<uint4*>(a.dy + u * 8) =
          in.apply(ldg16(a.p + u * 8), ldg16(a.comp + u * 8), a.mask_p != 0);
    } else {
      const long long v = u - a.ndy;
      const int cu = a.Cz / CU, wo = a.W + 2 * a.zpad;
      const long long pix = v / cu;
      const int c8 = (int)(v - pix * cu) * CU;
      const long long plane = (long long)(a.H + 2 * a.zpad) * wo;
      const long long b = pix / plane;
      const int rem = (int)(pix - b * plane);
      // zpad = 0: the identity map (every index lies in range).
      const int hp = rem / wo - a.zpad;  // -1 .. H with zpad = 1
      const int h = reflect_index(hp, a.H);
      const int w = reflect_index(rem % wo - a.zpad, a.W);
      const size_t off = (((size_t)b * a.H + h) * a.W + w) * a.Cz + c8;
      if (Q8 && a.zq != nullptr) {
        *reinterpret_cast<uint4*>(static_cast<int8_t*>(a.zp) + v * 16) = ldg16(a.zq + off);
        continue;
      }
      const size_t row_off = ((size_t)b * a.W + w) * a.Cz + c8;  // in a (B, 1, W, Cz) row
      const __nv_bfloat16* src = (hp < 0 && a.top != nullptr)    ? a.top + row_off
                                 : (hp >= a.H && a.bot != nullptr) ? a.bot + row_off
                                                                   : a.z + off;
      uint4 zv = ldg16(src);
      if constexpr (Q8) {
        const uint4 zv1 = ldg16(src + 8);
        const uint32_t zw[8] = {zv.x, zv.y, zv.z, zv.w, zv1.x, zv1.y, zv1.z, zv1.w};
        float zm[2][8], zi[2][8];
        const float qs = a.zm == nullptr ? a.qscale[b] : 0.f;
        if (a.zm != nullptr) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            load8(a.zm + b * a.Cz + c8 + 8 * j, zm[j]);
            load8(a.zi + b * a.Cz + c8 + 8 * j, zi[j]);
          }
        }
        int q[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const float x = k % 2 ? bf16_hi(zw[k / 2]) : bf16_lo(zw[k / 2]);
          if (a.zm != nullptr) {
            const float z = fmaxf(__fmul_rn(__fsub_rn(x, zm[k / 8][k % 8]), zi[k / 8][k % 8]), 0.f);
            q[k] = min(__float2int_rn(__fmul_rn(z, a.qfixed)), 127);
          } else {
            q[k] = max(-127, min(127, __float2int_rn(__fmul_rn(x, qs))));
          }
        }
        *reinterpret_cast<uint4*>(static_cast<int8_t*>(a.zp) + v * 16) =
            make_uint4(pack_s8x4(q[0], q[1], q[2], q[3]), pack_s8x4(q[4], q[5], q[6], q[7]),
                       pack_s8x4(q[8], q[9], q[10], q[11]), pack_s8x4(q[12], q[13], q[14], q[15]));
        continue;
      }
      if (a.zm != nullptr) {
        float zm[8], zi[8];
        load8(a.zm + b * a.Cz + c8, zm);
        load8(a.zi + b * a.Cz + c8, zi);
        uint32_t zw[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 2 * e;  // the plain version's single IEEE steps
          const float v0 = fmaxf(__fmul_rn(__fsub_rn(bf16_lo(zw[e]), zm[k]), zi[k]), 0.f);
          const float v1 =
              fmaxf(__fmul_rn(__fsub_rn(bf16_hi(zw[e]), zm[k + 1]), zi[k + 1]), 0.f);
          zw[e] = pack_bf16x2(v0, v1);
        }
        zv = make_uint4(zw[0], zw[1], zw[2], zw[3]);
      }
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.zp) + v * 8) = zv;
    }
  }
}

// q8: the int8 form (nzp units of 16 channels, no dy part).
int launch_operand_pass(const PassArgs& a, cudaStream_t stream, bool q8 = false) {
  const long long units = a.ndy + a.nzp;
  const long long need = (units + PASS_THREADS - 1) / PASS_THREADS;
  const int blocks = (int)(need < PASS_MAX_BLOCKS ? need : PASS_MAX_BLOCKS);
  if (blocks == 0) return 0;
  if (q8) {
    operand_pass_kernel<true><<<blocks, PASS_THREADS, 0, stream>>>(a);
  } else {
    operand_pass_kernel<false><<<blocks, PASS_THREADS, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------- TMA, mbarrier, wgmma ----

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of this parity has completed. A wait
// that never completes is a fault of the pipeline: trap (the launch fails)
// rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = -1;
  for (uint32_t spins = 1; !done; ++spins) {
    if ((spins & 0xfff) == 0) {
      const long long now = clock64();
      if (t0 < 0) {
        t0 = now;
      } else if (now - t0 > WATCHDOG_CYCLES) {
        __trap();
      }
    }
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Barrier set-up by one thread, before any thread uses the barriers.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One box of a 4-D tensor map into shared memory; completion counts on the
// barrier. Out-of-bounds elements (negative coordinates included) are
// filled with zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// One box of shared memory into a 4-D tensor map (elements outside the
// tensor are not written); one bulk async-group a commit. Before it, the
// threads that wrote the box run fence_proxy_async and meet at a barrier.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The issuing thread's bulk stores have read their shared memory (READ) or
// completed.
template <bool READ>
__device__ __forceinline__ void bulk_wait_all() {
  if constexpr (READ) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}
// Shared-memory writes of this thread, visible to the async proxy (TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile (one
// 128-byte row per K or M/N index, 8-row atoms of 1 KB): sbo = 1024, the
// step between 8-row groups. MN-major operands: lbo = the step between
// 64-element atoms along M or N. K-major operands (a k16 step never
// leaves the 128-byte row): lbo is not read.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// The same for a K-major operand in 64-byte-swizzled rows (32 bf16 or 64
// int8 of K a row, 8-row atoms of 512 bytes): sbo = 512; a k16 bf16 or
// k32 s8 step is 32 bytes along the row.
__device__ __forceinline__ uint64_t smem_desc_k64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------ tensor maps ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D tensor map of bf16 (esize 2) or int8 (esize 1) elements: dims
// innermost first, strides of dims 1..3 in bytes, the box in elements. Its
// first dim is one swizzled row: 128 bytes (128-byte swizzle) or 64 (64-byte
// swizzle). elem: the traversal strides of dims 1..3 (null: all 1); a box
// dim of n * stride traverses that many elements and lands n of them,
// densely, in shared memory. Returns 0 or a nonzero code.
int make_map_4d(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[4],
                const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4], int esize = 2,
                const cuuint32_t* elem3 = nullptr) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint32_t row = box[0] * esize;
  if ((esize != 1 && esize != 2) || (row != 128 && row != 64)) return (int)cudaErrorInvalidValue;
  cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int i = 0; elem3 != nullptr && i < 3; ++i) {
    if (elem3[i] < 1 || elem3[i] > 8 || box[i + 1] % elem3[i]) return (int)cudaErrorInvalidValue;
    elem[i + 1] = elem3[i];
  }
  const CUresult r =
      enc(map, esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
          const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
          row == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

// An NHWC plane (B, H, W, C) of esize-byte elements with boxes of (bc
// channels, bw columns, bh rows, 1 image).
int make_nhwc_map(CUtensorMap* map, const void* ptr, int B, int H, int W, int C, int bh, int bw,
                  int bc = 64, int esize = 2) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * esize, (cuuint64_t)W * C * esize,
                                 (cuuint64_t)H * W * C * esize};
  const cuuint32_t box[4] = {(cuuint32_t)bc, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  return make_map_4d(map, ptr, dims, strides, box, esize);
}

// The same plane read at stride 2 in W and H: a box lands bw columns and
// bh rows, every other one of the 2 bw columns and 2 bh rows it traverses
// from its coordinates (TMA's elementStrides; out-of-bounds ones filled
// with zeros, as in a dense box).
int make_nhwc_map_s2(CUtensorMap* map, const void* ptr, int B, int H, int W, int C, int bh, int bw,
                     int bc, int esize) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * esize, (cuuint64_t)W * C * esize,
                                 (cuuint64_t)H * W * C * esize};
  const cuuint32_t box[4] = {(cuuint32_t)bc, 2 * (cuuint32_t)bw, 2 * (cuuint32_t)bh, 1};
  const cuuint32_t elem3[3] = {2, 2, 1};
  return make_map_4d(map, ptr, dims, strides, box, esize, elem3);
}

}  // namespace
}  // namespace ircolor
