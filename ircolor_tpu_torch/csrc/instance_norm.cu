// Fused instance norm of NHWC planes for Hopper (sm_90a): y = IN(x), with
// an optional ReLU, or y = IN(x) + r.
//
// Replaces (ircolor_tpu/ops/pallas_kernels.py, TPU kernel 11):
//   _run_in     (_in_kernel,     pallas_call at :122) -> MODE_PLAIN / MODE_RELU
//   _run_in_res (_in_res_kernel, pallas_call at :138) -> MODE_RESIDUAL
// and its shard form (row 11h: the plane held as H-shards, possibly on
// several cards; the JAX package's GSPMD runs kernel 11 on the gathered
// plane) in two launches a shard and no gather:
//   PHASE_STATS: passes 1 and 2 over the shard's rows only: its mean and
//     centred sum of squares M2 per (image, channel), written in f32;
//   (the host merges the shards' (n, mean, M2) by Chan's rule, in shard
//    order: M2 = sum M2_i + sum n_i (mean_i - mean)^2, then the inverse std)
//   PHASE_APPLY: pass 3 with the merged mean and inverse std read from
//     memory, the same steps and one rounding.
//
// Per image b and channel c, over the H*W plane, all in f32:
//   mean = sum(x) / N
//   var  = sum((x - mean)^2) / N           (two passes, centered)
//   y    = (x - mean) * (1 / sqrt(var + 1e-5))
//   MODE_RELU: y = max(y, 0); MODE_RESIDUAL: y = y + r
//   out  = y rounded once to x's type (bf16 or f32)
// Every step is its own IEEE rounding (__fsub_rn, __fmul_rn, ...: no FMA
// contraction), in the plain version's order.
//
// What bounds it on the H100: device memory. Each element is read once and
// written once (the residual form also reads r once), with a few flops per
// element: at 16x64x64x256 bf16, 67 MB (101 MB with r) against 3.35 TB/s.
//
// Design: one block per (image, 32-byte channel slice): 16 bf16 or 8 f32
// channels, so a bf16 16x64x64x256 tensor is 256 blocks. Where the slice's
// plane fits in shared memory (N * 32 bytes, up to ~7,000 pixels) the first
// pass stores it there and the second and third passes read it back, so
// device memory sees x once; a larger plane is read again from device
// memory (mostly L2) by the later passes. A thread owns one 16-byte unit of
// the slice (8 bf16 or 4 f32 channels; one element when C does not allow
// aligned 16-byte units) at a fixed stride of pixels, and sums its pixels
// in a fixed order; the block reduces those partial sums with a fixed
// butterfly and then warp by warp, so a repeat is bit-exact. No atomics.
#include "common.cuh"

namespace ircolor {
namespace {

constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr int SLICE_BYTES = 32;  // channel bytes of one pixel per block
constexpr float EPS = 1e-5f;
constexpr int MAX_SMEM = 232448;  // 227 KB of dynamic shared memory

enum { MODE_PLAIN = 0, MODE_RELU = 1, MODE_RESIDUAL = 2 };
// PHASE_FULL: kernel 11; PHASE_STATS / PHASE_APPLY: its shard form's halves.
enum { PHASE_FULL = 0, PHASE_STATS = 1, PHASE_APPLY = 2 };
// What ``reduce`` leaves for each channel: the sum over N, the inverse std
// of the sum as a variance, or the sum itself.
enum { RED_MEAN = 0, RED_INV = 1, RED_SUM = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// A unit: VEC consecutive channels of one pixel, loaded and stored at once.
template <typename T, int VEC>
struct Unit {  // VEC == 1: one element
  using V = T;
  __device__ static V load(const T* p) { return *p; }
  __device__ static void unpack(const V& v, float (&f)[1]) { f[0] = to_f32(v); }
  __device__ static void store(T* p, const float (&f)[1]) { from_f32(f[0], p); }
};

template <>
struct Unit<__nv_bfloat16, 8> {
  using V = uint4;
  __device__ static V load(const __nv_bfloat16* p) { return ldg16(p); }
  __device__ static void unpack(const V& v, float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[2 * e] = bf16_lo(w[e]);
      f[2 * e + 1] = bf16_hi(w[e]);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&f)[8]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                                              pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  }
};

template <>
struct Unit<float, 4> {
  using V = float4;
  __device__ static V load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static void unpack(const V& v, float (&f)[4]) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

struct InArgs {
  const void* x;  // (B, H, W, C)
  const void* r;  // (B, H, W, C) residual, MODE_RESIDUAL only
  void* out;      // (B, H, W, C)
  float* mean;    // (B, C): PHASE_STATS writes it, PHASE_APPLY reads it
  float* aux;     // (B, C): PHASE_STATS writes M2, PHASE_APPLY reads the inverse std
  int N, C;       // N = H * W
};

template <typename T>
__host__ __device__ constexpr int slice_channels() { return SLICE_BYTES / (int)sizeof(T); }

// Shared memory ahead of the staged plane: per-warp partial sums, then the
// slice's mean and inverse std.
template <typename T>
__host__ __device__ constexpr int head_bytes() { return (NWARPS + 2) * slice_channels<T>() * 4; }

template <typename T, int VEC, int MODE, bool STAGED, int PHASE>
__global__ void __launch_bounds__(NTHREADS) instance_norm_kernel(const InArgs a) {
  using U = Unit<T, VEC>;
  using V = typename U::V;
  constexpr int CS = slice_channels<T>();
  constexpr int UPP = CS / VEC;           // units per pixel
  constexpr int PSTEP = NTHREADS / UPP;   // pixels per sweep of the block
  static_assert(32 % UPP == 0, "a warp must hold whole pixels");
  extern __shared__ __align__(16) uint8_t smem[];
  float* red = reinterpret_cast<float*>(smem);  // NWARPS x CS
  float* stat = red + NWARPS * CS;               // mean[CS], inv[CS]
  V* stage = reinterpret_cast<V*>(smem + head_bytes<T>());

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u = tid % UPP, p0 = tid / UPP;
  const int c = blockIdx.x * CS + u * VEC;
  const bool live = c < a.C;  // the last slice may hold fewer channels
  const size_t base = (size_t)blockIdx.y * a.N * a.C + c;
  const T* x = static_cast<const T*>(a.x) + base;
  const float n = (float)a.N;

  // Sum of v over every thread holding unit u, in a fixed order.
  auto reduce = [&](float (&v)[VEC], float* dst, int kind) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
#pragma unroll
      for (int off = UPP; off < 32; off <<= 1)
        v[e] = __fadd_rn(v[e], __shfl_xor_sync(0xffffffffu, v[e], off));
    if (lane < UPP) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[warp * CS + lane * VEC + e] = v[e];
    }
    __syncthreads();
    if (tid < CS) {
      float s = 0.f;
      for (int w = 0; w < NWARPS; ++w) s = __fadd_rn(s, red[w * CS + tid]);
      if (kind != RED_SUM) s = __fdiv_rn(s, n);
      dst[tid] = kind == RED_INV ? __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(s, EPS))) : s;
    }
    __syncthreads();
  };

  auto fetch = [&](int p, float (&f)[VEC]) {
    const V v = STAGED ? stage[(size_t)p * UPP + u] : U::load(x + (size_t)p * a.C);
    U::unpack(v, f);
  };

  float m[VEC], iv[VEC];
  if constexpr (PHASE == PHASE_APPLY) {
    if (!live) return;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      m[e] = a.mean[(size_t)blockIdx.y * a.C + c + e];
      iv[e] = a.aux[(size_t)blockIdx.y * a.C + c + e];
    }
  } else {
    // Pass 1: the mean (and the plane into shared memory).
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    if (live) {
#pragma unroll 8
      for (int p = p0; p < a.N; p += PSTEP) {
        const V v = U::load(x + (size_t)p * a.C);
        if (STAGED) stage[(size_t)p * UPP + u] = v;
        float f[VEC];
        U::unpack(v, f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], f[e]);
      }
    }
    reduce(acc, stat, RED_MEAN);
#pragma unroll
    for (int e = 0; e < VEC; ++e) m[e] = live ? stat[u * VEC + e] : 0.f;

    // Pass 2: the centered sum of squares -> inverse std (PHASE_STATS: M2).
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    if (live) {
#pragma unroll 8
      for (int p = p0; p < a.N; p += PSTEP) {
        float f[VEC];
        fetch(p, f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float d = __fsub_rn(f[e], m[e]);
          acc[e] = __fadd_rn(acc[e], __fmul_rn(d, d));
        }
      }
    }
    reduce(acc, stat + CS, PHASE == PHASE_STATS ? RED_SUM : RED_INV);
    if constexpr (PHASE == PHASE_STATS) {
      const int ch = blockIdx.x * CS + tid;
      if (tid < CS && ch < a.C) {
        a.mean[(size_t)blockIdx.y * a.C + ch] = stat[tid];
        a.aux[(size_t)blockIdx.y * a.C + ch] = stat[CS + tid];
      }
      return;
    }
    if (!live) return;
#pragma unroll
    for (int e = 0; e < VEC; ++e) iv[e] = stat[CS + u * VEC + e];
  }

  // Pass 3: normalize (+ ReLU | + r), one rounding to T.
  if constexpr (PHASE != PHASE_STATS) {
    T* out = static_cast<T*>(a.out) + base;
    const T* r = static_cast<const T*>(a.r) + base;
#pragma unroll 4
    for (int p = p0; p < a.N; p += PSTEP) {
      float f[VEC];
      fetch(p, f);
      float rf[VEC];
      if constexpr (MODE == MODE_RESIDUAL) U::unpack(U::load(r + (size_t)p * a.C), rf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float y = __fmul_rn(__fsub_rn(f[e], m[e]), iv[e]);
        if constexpr (MODE == MODE_RELU) y = fmaxf(y, 0.f);
        if constexpr (MODE == MODE_RESIDUAL) y = __fadd_rn(y, rf[e]);
        f[e] = y;
      }
      U::store(out + (size_t)p * a.C, f);
    }
  }
}

template <typename T, int VEC, int MODE, int PHASE>
int launch(const InArgs& a, int B, cudaStream_t stream) {
  constexpr int CS = slice_channels<T>();
  const dim3 grid((a.C + CS - 1) / CS, B);
  const size_t staged = head_bytes<T>() + (size_t)a.N * SLICE_BYTES;
  cudaError_t err;
  // The apply phase reads each element once: nothing to stage.
  if (PHASE != PHASE_APPLY && staged <= (size_t)MAX_SMEM) {
    auto kernel = instance_norm_kernel<T, VEC, MODE, true, PHASE>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)staged);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, NTHREADS, staged, stream>>>(a);
  } else {
    instance_norm_kernel<T, VEC, MODE, false, PHASE>
        <<<grid, NTHREADS, head_bytes<T>(), stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int PHASE>
int launch_mode(const InArgs& a, int B, int mode, cudaStream_t s) {
  if (PHASE == PHASE_STATS) return launch<T, VEC, MODE_PLAIN, PHASE>(a, B, s);
  if (mode == MODE_RELU) return launch<T, VEC, MODE_RELU, PHASE>(a, B, s);
  if (mode == MODE_RESIDUAL) return launch<T, VEC, MODE_RESIDUAL, PHASE>(a, B, s);
  return launch<T, VEC, MODE_PLAIN, PHASE>(a, B, s);
}

template <int PHASE>
int launch_dtype(int f32, int vec, const InArgs& a, int B, int mode, cudaStream_t s) {
  if (f32) {
    return vec ? launch_mode<float, 4, PHASE>(a, B, mode, s)
               : launch_mode<float, 1, PHASE>(a, B, mode, s);
  }
  return vec ? launch_mode<__nv_bfloat16, 8, PHASE>(a, B, mode, s)
             : launch_mode<__nv_bfloat16, 1, PHASE>(a, B, mode, s);
}

}  // namespace
}  // namespace ircolor

extern "C" {

// f32: 0 for bf16 tensors, 1 for float32; mode: 0 IN, 1 IN + ReLU, 2 IN + r
// (r null otherwise); vec: 1 when C and every pointer allow 16-byte units.
int ircolor_instance_norm(int f32, int mode, int vec, const void* x, const void* r, void* out,
                          int B, int H, int W, int C, void* stream) {
  using namespace ircolor;
  const InArgs a{x, r, out, nullptr, nullptr, H * W, C};
  return launch_dtype<PHASE_FULL>(f32, vec, a, B, mode, static_cast<cudaStream_t>(stream));
}

// Row 11h, a shard's statistics: mean and M2 (B, C) f32 over its H x W
// plane (H >= 1).
int ircolor_instance_norm_stats(int f32, int vec, const void* x, float* mean, float* m2, int B,
                                int H, int W, int C, void* stream) {
  using namespace ircolor;
  const InArgs a{x, nullptr, nullptr, mean, m2, H * W, C};
  return launch_dtype<PHASE_STATS>(f32, vec, a, B, MODE_PLAIN, static_cast<cudaStream_t>(stream));
}

// Row 11h, a shard's output: (x - mean) * inv (+ ReLU | + r) with the
// merged (B, C) f32 mean and inverse std.
int ircolor_instance_norm_apply(int f32, int mode, int vec, const void* x, const void* r,
                                const float* mean, const float* inv, void* out, int B, int H,
                                int W, int C, void* stream) {
  using namespace ircolor;
  const InArgs a{x, r, out, const_cast<float*>(mean), const_cast<float*>(inv), H * W, C};
  return launch_dtype<PHASE_APPLY>(f32, vec, a, B, mode, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
