// Fused instance norm of NHWC planes for Hopper (sm_90a): y = IN(x), with
// an optional ReLU, or y = IN(x) + r.
//
// Replaces (ircolor_tpu/ops/pallas_kernels.py, TPU kernel 11):
//   _run_in     (_in_kernel,     pallas_call at :122) -> MODE_PLAIN / MODE_RELU
//   _run_in_res (_in_res_kernel, pallas_call at :138) -> MODE_RESIDUAL
// and its shard form (row 11h: the plane held as H-shards; the JAX
// package's GSPMD runs kernel 11 on the gathered plane), with no gather.
// Each shard's statistics are kernel 11's passes 1 and 2 over its own rows
// (its mean and its M2, centred on that mean); ``merge_parts`` adds the
// shards' (n, mean, M2) by Chan's rule in shard order; pass 3 normalizes
// each shard with the plane's mean and inverse std. Two forms, the same
// passes and the same merge, so the same bits:
//   in_cluster_kernel: every shard on one card, S <= 8. One launch; a
//     cluster of S CTAs covers an (image, channel slice), CTA rank i owns
//     shard i (a table passed by value; shards may be unequal or empty).
//     Each CTA stages its shard's slice plane, writes its (mean, M2) to its
//     own shared memory, and after a cluster barrier reads every rank's
//     through distributed shared memory and merges them; a second barrier
//     keeps each CTA's statistics alive until every peer has read them.
//     Rank 0 also writes the plane's (mean, inv) for the backward.
//   PHASE_STATS + in_apply_kernel: shards on several cards, or S > 8. A
//     stats launch a shard writes its (mean, M2); the wrapper copies the S
//     partials to each shard's card; each shard's apply launch merges them
//     itself and normalizes.
// The tile form (the plane held as a grid of Sh x Sw tiles, test mode's
// 2-D H x W mesh) is the same two forms: a tile is a shard of rows x cols
// pixels, contiguous as (B, rows, cols, C), and every cluster rank (every
// per-shard launch) carries its tile's rows, columns and pointers, so one
// cluster takes the Sh * Sw <= 8 tiles of one plane (2 x 2, 4 x 2). The
// wrapper passes the tiles row by row, the one order of the merge; a 1-D
// mesh is the Sw = 1 case, every shard the plane's width.
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
// channels, so a bf16 16x64x64x256 tensor is 256 blocks. The shard forms
// take a 64-byte slice where C holds one and the tallest shard's 64-byte
// slice plane fits in shared memory (the wrapper's plan; else 32 bytes):
// at S = 2 on that plane 2 x 8 x 16 blocks of 128 KB, one a SM in two
// full waves as kernel 11's, 0.036 ms a launch against 0.048 with 32-byte
// slices' 512 blocks, three a SM in 1.3 waves (tools/in_halo_probe.py,
// H100). Where the slice's plane (a shard's, in the shard forms) fits in
// shared memory (N * slice bytes, up to ~7,000 pixels at 32) the first
// pass stores it there and the second and third passes read it back, so
// device memory sees x once; a larger plane is read again from device
// memory (mostly L2) by the later passes. The loads are 16-byte vector
// loads by every thread, not TMA boxes: the same code serves the per-shard
// stats launch and the cluster CTA, which must sum in the same order, and
// 512 threads with 8 loads each in flight already keep 64 KB a block
// moving. A thread owns one 16-byte unit of the slice (8 bf16 or 4 f32
// channels; one element when C does not allow aligned 16-byte units) at a
// fixed stride of pixels, and sums its pixels in a fixed order; the block
// reduces those partial sums with a fixed butterfly and then warp by warp,
// so a repeat is bit-exact. No atomics.
#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace ircolor {
namespace {

constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr int SLICE_BYTES = 32;  // kernel 11's channel bytes of one pixel per block
constexpr float EPS = 1e-5f;
constexpr int MAX_SMEM = 232448;  // 227 KB of dynamic shared memory
constexpr int MAX_CLUSTER = 8;    // the portable cluster size: the cluster form's S
constexpr int MAX_SHARDS = 256;   // the per-shard form's count table
constexpr int NO_CLUSTER = -1;    // returned where no cluster of the launch fits the card

enum { MODE_PLAIN = 0, MODE_RELU = 1, MODE_RESIDUAL = 2 };
// PHASE_FULL: kernel 11; PHASE_STATS: a shard's passes 1-2 (the per-shard form).
enum { PHASE_FULL = 0, PHASE_STATS = 1 };
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

template <typename T, int SB>
__host__ __device__ constexpr int slice_channels() { return SB / (int)sizeof(T); }

// Shared memory ahead of the staged plane: per-warp partial sums, then the
// slice's mean and inverse std (or M2); the shard forms then hold the
// plane's merged mean and inverse std.
template <typename T, int SB>
__host__ __device__ constexpr int head_bytes() {
  return (NWARPS + 2) * slice_channels<T, SB>() * 4;
}
template <typename T, int SB>
__host__ __device__ constexpr int shard_head_bytes() {
  return (NWARPS + 4) * slice_channels<T, SB>() * 4;
}

// One block's SB-byte channel slice of one image: the unit a thread owns
// and the three passes over an N-pixel plane.
template <typename T, int VEC, int SB>
struct Slice {
  using U = Unit<T, VEC>;
  using V = typename U::V;
  static constexpr int CS = slice_channels<T, SB>();
  static constexpr int UPP = CS / VEC;          // units per pixel
  static constexpr int PSTEP = NTHREADS / UPP;  // pixels per sweep of the block
  static_assert(32 % UPP == 0, "a warp must hold whole pixels");

  float* red;  // NWARPS x CS partial sums
  V* stage;    // the staged plane
  int tid, lane, warp, u, p0, c, C;
  bool live;   // the last slice may hold fewer channels

  __device__ Slice(uint8_t* smem, int head, int slice, int C_)
      : red(reinterpret_cast<float*>(smem)), stage(reinterpret_cast<V*>(smem + head)),
        tid(threadIdx.x), lane(threadIdx.x & 31), warp(threadIdx.x >> 5),
        u(threadIdx.x % UPP), p0(threadIdx.x / UPP),
        c(slice * CS + (int)(threadIdx.x % UPP) * VEC), C(C_), live(c < C_) {}

  // This thread's unit in pixel 0 of image b of an N-pixel plane.
  __device__ size_t base(int b, int N) const { return (size_t)b * N * C + c; }

  // Sum of v over every thread holding unit u, in a fixed order.
  __device__ void reduce(float (&v)[VEC], float* dst, int kind, float n) {
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
  }

  template <bool STAGED>
  __device__ void fetch(const T* x, int p, float (&f)[VEC]) const {
    const V v = STAGED ? stage[(size_t)p * UPP + u] : U::load(x + (size_t)p * C);
    U::unpack(v, f);
  }

  // Passes 1 and 2 over an N-pixel plane (N >= 1; x at this thread's unit):
  // stat[0, CS) the mean, stat[CS, 2 CS) the centred M2 (RED_SUM) or the
  // inverse std (RED_INV). STAGED leaves the plane in shared memory.
  template <bool STAGED>
  __device__ void stats(const T* x, int N, float* stat, int kind) {
    const float n = (float)N;
    // Pass 1: the mean (and the plane into shared memory).
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    if (live) {
#pragma unroll 8
      for (int p = p0; p < N; p += PSTEP) {
        const V v = U::load(x + (size_t)p * C);
        if (STAGED) stage[(size_t)p * UPP + u] = v;
        float f[VEC];
        U::unpack(v, f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], f[e]);
      }
    }
    reduce(acc, stat, RED_MEAN, n);
    float m[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) m[e] = live ? stat[u * VEC + e] : 0.f;

    // Pass 2: the centered sum of squares.
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    if (live) {
#pragma unroll 8
      for (int p = p0; p < N; p += PSTEP) {
        float f[VEC];
        fetch<STAGED>(x, p, f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float d = __fsub_rn(f[e], m[e]);
          acc[e] = __fadd_rn(acc[e], __fmul_rn(d, d));
        }
      }
    }
    reduce(acc, stat + CS, kind, n);
  }

  // Pass 3: (x - mean) * inv (+ ReLU | + r), one rounding to T; mean and
  // inv hold the slice's CS channels.
  template <bool STAGED, int MODE>
  __device__ void apply(const T* x, const T* r, T* out, int N, const float* mean,
                        const float* inv) const {
    if (!live) return;
    float m[VEC], iv[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      m[e] = mean[u * VEC + e];
      iv[e] = inv[u * VEC + e];
    }
#pragma unroll 4
    for (int p = p0; p < N; p += PSTEP) {
      float f[VEC];
      fetch<STAGED>(x, p, f);
      float rf[VEC];
      if constexpr (MODE == MODE_RESIDUAL) U::unpack(U::load(r + (size_t)p * C), rf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float y = __fmul_rn(__fsub_rn(f[e], m[e]), iv[e]);
        if constexpr (MODE == MODE_RELU) y = fmaxf(y, 0.f);
        if constexpr (MODE == MODE_RESIDUAL) y = __fadd_rn(y, rf[e]);
        f[e] = y;
      }
      U::store(out + (size_t)p * C, f);
    }
  }
};

struct InArgs {
  const void* x;  // (B, H, W, C)
  const void* r;  // (B, H, W, C) residual, MODE_RESIDUAL only
  void* out;      // (B, H, W, C)
  float* mean;    // (B, C): PHASE_STATS writes it
  float* m2;      // (B, C): PHASE_STATS writes M2
  int N, C;       // N = H * W
};

template <typename T, int VEC, int MODE, bool STAGED, int PHASE, int SB>
__global__ void __launch_bounds__(NTHREADS) instance_norm_kernel(const InArgs a) {
  using Sl = Slice<T, VEC, SB>;
  constexpr int CS = Sl::CS;
  extern __shared__ __align__(16) uint8_t smem[];
  Sl s(smem, head_bytes<T, SB>(), blockIdx.x, a.C);
  float* stat = s.red + NWARPS * CS;  // mean[CS], inv (PHASE_STATS: M2)[CS]
  const int b = blockIdx.y;
  const size_t base = s.base(b, a.N);
  const T* x = static_cast<const T*>(a.x) + base;
  s.template stats<STAGED>(x, a.N, stat, PHASE == PHASE_STATS ? RED_SUM : RED_INV);
  if constexpr (PHASE == PHASE_STATS) {
    const int ch = blockIdx.x * CS + s.tid;
    if (s.tid < CS && ch < a.C) {
      a.mean[(size_t)b * a.C + ch] = stat[s.tid];
      a.m2[(size_t)b * a.C + ch] = stat[CS + s.tid];
    }
  } else {
    s.template apply<STAGED, MODE>(x, static_cast<const T*>(a.r) + base,
                                   static_cast<T*>(a.out) + base, a.N, stat, stat + CS);
  }
}

// --- row 11h: the merge both shard forms share -----------------------------

// One shard's statistics of one channel: its pixel count, mean and M2.
struct Part {
  float n, mean, m2;
};

// Chan's merge of S shards' parts, in shard order, one IEEE step at a time:
// mean = (sum n_i mean_i) / n, M2 = sum (M2_i + n_i (mean_i - mean)^2),
// inv = 1 / sqrt(M2 / n + eps) as kernel 11 takes it. An empty shard
// (n_i = 0) adds nothing. ``get(j)`` gives shard j's part.
template <typename Get>
__device__ __forceinline__ void merge_parts(int S, Get get, float* mean, float* inv) {
  float n = 0.f, s = 0.f;
  for (int j = 0; j < S; ++j) {
    const Part p = get(j);
    if (p.n > 0.f) {
      n = __fadd_rn(n, p.n);
      s = __fadd_rn(s, __fmul_rn(p.mean, p.n));
    }
  }
  const float m = __fdiv_rn(s, n);
  float q = 0.f;
  for (int j = 0; j < S; ++j) {
    const Part p = get(j);
    if (p.n > 0.f) {
      const float d = __fsub_rn(p.mean, m);
      q = __fadd_rn(q, __fadd_rn(p.m2, __fmul_rn(__fmul_rn(d, d), p.n)));
    }
  }
  *mean = m;
  *inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(q, n), EPS)));
}

// --- row 11h, the cluster form: every shard on this card, S <= 8 -----------

struct Shard {
  const void* x;  // (B, rows, cols, C)
  const void* r;  // (B, rows, cols, C), MODE_RESIDUAL only
  void* out;      // (B, rows, cols, C)
  int rows;       // 0 for an empty shard
  int cols;       // the plane's width, or the tile's columns
};

struct ClusterArgs {
  Shard shard[MAX_CLUSTER];
  float* mean;    // (B, C): the plane's mean, written by rank 0
  float* inv;     // (B, C): the plane's inverse std, written by rank 0
  int S, C;
  int stage_cap;  // bytes of its shard's slice plane a CTA may stage
};

template <typename T, int VEC, int MODE, int SB>
__global__ void __launch_bounds__(NTHREADS)
    in_cluster_kernel(const __grid_constant__ ClusterArgs a) {
  using Sl = Slice<T, VEC, SB>;
  constexpr int CS = Sl::CS;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.z;
  Sl s(smem, shard_head_bytes<T, SB>(), blockIdx.y, a.C);
  float* stat = s.red + NWARPS * CS;  // this shard's mean[CS], M2[CS]: the peers read them
  float* fin = stat + 2 * CS;         // the plane's mean[CS], inverse std[CS]
  const Shard& sh = a.shard[rank];
  const int N = sh.rows * sh.cols;
  // A shard slice over the launch's stage reads x again (uniform per CTA).
  const bool staged = (size_t)N * SB <= (size_t)a.stage_cap;
  const size_t base = s.base(b, N);
  const T* x = static_cast<const T*>(sh.x) + base;
  if (N > 0) {
    if (staged) {
      s.template stats<true>(x, N, stat, RED_SUM);
    } else {
      s.template stats<false>(x, N, stat, RED_SUM);
    }
  }
  cluster.sync();  // every rank's (mean, M2) is in its shared memory
  if (s.tid < CS) {
    merge_parts(
        a.S,
        [&](int j) {
          const int nj = a.shard[j].rows * a.shard[j].cols;
          if (nj == 0) return Part{0.f, 0.f, 0.f};
          const float* peer = cluster.map_shared_rank(stat, j);
          return Part{(float)nj, peer[s.tid], peer[CS + s.tid]};
        },
        fin + s.tid, fin + CS + s.tid);
    const int ch = blockIdx.y * CS + s.tid;
    if (rank == 0 && ch < a.C) {
      a.mean[(size_t)b * a.C + ch] = fin[s.tid];
      a.inv[(size_t)b * a.C + ch] = fin[CS + s.tid];
    }
  }
  cluster.sync();  // no CTA exits while a peer still reads its statistics
  if (N > 0) {
    T* out = static_cast<T*>(sh.out) + base;
    const T* r = static_cast<const T*>(sh.r) + base;
    if (staged) {
      s.template apply<true, MODE>(x, r, out, N, fin, fin + CS);
    } else {
      s.template apply<false, MODE>(x, r, out, N, fin, fin + CS);
    }
  }
}

// --- row 11h, the per-shard form's apply: the merge, then pass 3 -----------

struct ApplyArgs {
  const void* x;       // this shard, (B, H, W, C)
  const void* r;       // (B, H, W, C), MODE_RESIDUAL only
  void* out;           // (B, H, W, C)
  const float* parts;  // (S, 2, B, C) on this card: every shard's mean, then M2
  float* mean;         // (B, C): the plane's mean, or null
  float* inv;          // (B, C): the plane's inverse std, or null
  int N, B, C, S;      // N = H * W
  int n[MAX_SHARDS];   // every shard's pixel count
};

template <typename T, int VEC, int MODE, int SB>
__global__ void __launch_bounds__(NTHREADS) in_apply_kernel(const __grid_constant__ ApplyArgs a) {
  using Sl = Slice<T, VEC, SB>;
  constexpr int CS = Sl::CS;
  extern __shared__ __align__(16) uint8_t smem[];
  Sl s(smem, shard_head_bytes<T, SB>(), blockIdx.x, a.C);
  float* fin = s.red + (NWARPS + 2) * CS;  // the plane's mean[CS], inverse std[CS]
  const int b = blockIdx.y;
  const int ch = blockIdx.x * CS + s.tid;
  if (s.tid < CS && ch < a.C) {
    const size_t plane = (size_t)a.B * a.C, at = (size_t)b * a.C + ch;
    merge_parts(
        a.S,
        [&](int j) {
          return Part{(float)a.n[j], a.parts[2 * j * plane + at],
                      a.parts[(2 * j + 1) * plane + at]};
        },
        fin + s.tid, fin + CS + s.tid);
    if (a.mean != nullptr) {
      a.mean[at] = fin[s.tid];
      a.inv[at] = fin[CS + s.tid];
    }
  }
  __syncthreads();
  const size_t base = s.base(b, a.N);
  s.template apply<false, MODE>(static_cast<const T*>(a.x) + base,
                                static_cast<const T*>(a.r) + base, static_cast<T*>(a.out) + base,
                                a.N, fin, fin + CS);
}

// --- launches -------------------------------------------------------------

template <typename T, int VEC, int MODE, int PHASE, int SB>
int launch(const InArgs& a, int B, cudaStream_t stream) {
  constexpr int CS = slice_channels<T, SB>();
  const dim3 grid((a.C + CS - 1) / CS, B);
  const size_t staged = head_bytes<T, SB>() + (size_t)a.N * SB;
  cudaError_t err;
  if (staged <= (size_t)MAX_SMEM) {
    auto kernel = instance_norm_kernel<T, VEC, MODE, true, PHASE, SB>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)staged);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, NTHREADS, staged, stream>>>(a);
  } else {
    instance_norm_kernel<T, VEC, MODE, false, PHASE, SB>
        <<<grid, NTHREADS, head_bytes<T, SB>(), stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// What does not change between calls, once per kernel, card, dynamic
// shared memory and cluster size: the kernel's shared-memory allowance and,
// for a cluster launch, cudaOccupancyMaxActiveClusters >= 1 (else
// NO_CLUSTER: a cluster of S such CTAs cannot be resident on the card).
std::mutex setup_mu;
std::map<std::tuple<const void*, int, size_t, int>, int> setup_done;

int setup(const void* kernel, const cudaLaunchConfig_t& cfg, int cluster) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const auto key = std::make_tuple(kernel, dev, cfg.dynamicSmemBytes, cluster);
  std::lock_guard<std::mutex> lock(setup_mu);
  const auto it = setup_done.find(key);
  if (it != setup_done.end()) return it->second;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  int res = (int)err;
  if (err == cudaSuccess && cluster > 0) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    res = err != cudaSuccess ? (int)err : (clusters < 1 ? NO_CLUSTER : 0);
  }
  setup_done[key] = res;
  return res;
}

template <typename T, int VEC, int MODE>
struct LaunchFull {
  static int run(const InArgs& a, int B, cudaStream_t s) {
    return launch<T, VEC, MODE, PHASE_FULL, SLICE_BYTES>(a, B, s);
  }
};

// The shard forms' launches at a slice of SB bytes (both forms take the
// same one, so that their sums run in the same order).
template <int SB>
struct Shards {
  template <typename T, int VEC, int MODE>
  struct Stats {  // one kernel whatever the mode
    static int run(const InArgs& a, int B, cudaStream_t s) {
      return launch<T, VEC, MODE_PLAIN, PHASE_STATS, SB>(a, B, s);
    }
  };
  template <typename T, int VEC, int MODE>
  struct Cluster;
  template <typename T, int VEC, int MODE>
  struct Apply;
};

template <int SB>
template <typename T, int VEC, int MODE>
struct Shards<SB>::Cluster {
  static int run(const ClusterArgs& a, int B, cudaStream_t s) {
    constexpr int CS = slice_channels<T, SB>();
    auto kernel = in_cluster_kernel<T, VEC, MODE, SB>;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.S, (a.C + CS - 1) / CS, B);
    cfg.blockDim = dim3(NTHREADS);
    cfg.dynamicSmemBytes = shard_head_bytes<T, SB>() + (size_t)a.stage_cap;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const int err = setup(reinterpret_cast<const void*>(kernel), cfg, a.S);
    if (err != 0) return err;
    const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, a);
    if (launched != cudaSuccess) return (int)launched;
    return (int)cudaGetLastError();
  }
};

template <int SB>
template <typename T, int VEC, int MODE>
struct Shards<SB>::Apply {
  static int run(const ApplyArgs& a, int B, cudaStream_t s) {
    constexpr int CS = slice_channels<T, SB>();
    const dim3 grid((a.C + CS - 1) / CS, B);
    in_apply_kernel<T, VEC, MODE, SB><<<grid, NTHREADS, shard_head_bytes<T, SB>(), s>>>(a);
    return (int)cudaGetLastError();
  }
};

template <template <typename, int, int> class L, typename T, int VEC, typename A>
int by_mode(int mode, const A& a, int B, cudaStream_t s) {
  if (mode == MODE_RELU) return L<T, VEC, MODE_RELU>::run(a, B, s);
  if (mode == MODE_RESIDUAL) return L<T, VEC, MODE_RESIDUAL>::run(a, B, s);
  return L<T, VEC, MODE_PLAIN>::run(a, B, s);
}

// L<T, VEC, MODE>::run for the dtype, unit and mode given at run time.
template <template <typename, int, int> class L, typename A>
int dispatch(int f32, int vec, int mode, const A& a, int B, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    return vec ? by_mode<L, float, 4>(mode, a, B, s) : by_mode<L, float, 1>(mode, a, B, s);
  }
  return vec ? by_mode<L, __nv_bfloat16, 8>(mode, a, B, s)
             : by_mode<L, __nv_bfloat16, 1>(mode, a, B, s);
}

// The shard forms take a slice of 64 or 32 bytes (the wrapper's plan).
#define SHARD_DISPATCH(KIND, sb, ...)                                  \
  ((sb) == 64 ? dispatch<Shards<64>::KIND>(__VA_ARGS__)                \
   : (sb) == 32 ? dispatch<Shards<32>::KIND>(__VA_ARGS__)              \
                : (int)cudaErrorInvalidValue)

}  // namespace
}  // namespace ircolor

extern "C" {

// f32: 0 for bf16 tensors, 1 for float32; mode: 0 IN, 1 IN + ReLU, 2 IN + r
// (r null otherwise); vec: 1 when C and every pointer allow 16-byte units.
int ircolor_instance_norm(int f32, int mode, int vec, const void* x, const void* r, void* out,
                          int B, int H, int W, int C, void* stream) {
  using namespace ircolor;
  const InArgs a{x, r, out, nullptr, nullptr, H * W, C};
  return dispatch<LaunchFull>(f32, vec, mode, a, B, stream);
}

// Row 11h's per-shard form, a shard's statistics: mean and M2 (B, C) f32
// over its H x W plane (H >= 1), a block a slice of slice_bytes (32 or 64:
// the plan's, the same in both forms).
int ircolor_instance_norm_stats(int f32, int vec, int slice_bytes, const void* x, float* mean,
                                float* m2, int B, int H, int W, int C, void* stream) {
  using namespace ircolor;
  const InArgs a{x, nullptr, nullptr, mean, m2, H * W, C};
  return SHARD_DISPATCH(Stats, slice_bytes, f32, vec, MODE_PLAIN, a, B, stream);
}

// Row 11h's per-shard form, a shard's output: merges the S shards' (mean,
// M2) in ``parts`` ((S, 2, B, C) f32 on this card; ``counts`` their pixel
// counts), then (x - mean) * inv (+ ReLU | + r). With ``mean`` and ``inv``
// not null it also writes the plane's (B, C) statistics there.
int ircolor_instance_norm_apply(int f32, int mode, int vec, int slice_bytes, const void* x,
                                const void* r, const float* parts, const int* counts, int S,
                                float* mean, float* inv, void* out, int B, int H, int W, int C,
                                void* stream) {
  using namespace ircolor;
  if (S < 1 || S > MAX_SHARDS) return (int)cudaErrorInvalidValue;
  ApplyArgs a{x, r, out, parts, mean, inv, H * W, B, C, S, {}};
  for (int j = 0; j < S; ++j) a.n[j] = counts[j];
  return SHARD_DISPATCH(Apply, slice_bytes, f32, vec, mode, a, B, stream);
}

// Row 11h's cluster form: the S <= 8 shards (or tiles, row by row) of one
// plane on this card, one launch. xs, rs (or null), outs: each shard's
// tensors; rows, cols: each shard's height (0 for an empty one) and width
// (the plane's, or the tile's); mean, inv: the plane's (B, C) f32 out;
// slice_bytes: a block's channel slice (32 or 64); stage_cap: the bytes of
// a shard's slice plane a CTA stages (a larger one reads x again). Returns
// NO_CLUSTER (-1) where no such cluster fits on the card.
int ircolor_instance_norm_cluster(int f32, int mode, int vec, int slice_bytes, int S,
                                  const void* const* xs, const void* const* rs, void* const* outs,
                                  const int* rows, const int* cols, float* mean, float* inv, int B,
                                  int C, int stage_cap, void* stream) {
  using namespace ircolor;
  const int cs4 = slice_bytes / (f32 ? 4 : 2) * 4;  // a slice's f32 statistics, bytes
  if (S < 1 || S > MAX_CLUSTER || stage_cap < 0 ||
      (NWARPS + 4) * cs4 + stage_cap > MAX_SMEM) {
    return (int)cudaErrorInvalidValue;
  }
  ClusterArgs a{};
  for (int j = 0; j < S; ++j) {
    a.shard[j] = Shard{xs[j], rs ? rs[j] : nullptr, outs[j], rows[j], cols[j]};
  }
  a.mean = mean;
  a.inv = inv;
  a.S = S;
  a.C = C;
  a.stage_cap = stage_cap;
  return SHARD_DISPATCH(Cluster, slice_bytes, f32, vec, mode, a, B, stream);
}

}  // extern "C"
