// GroupNorm backward of [N, C, T] for Hopper (sm_90a), through the optional
// FiLM and exact GELU of the forward; plain C interface.
//
// The forward (ops/group_norm.py) is y = act(u), u = (x - mean) * a + b per
// (n, channel) row, with a = rstd * w * s, b = bias * s + cb, s = ca + 1
// (s = 1 and cb = 0 without FiLM), act = exact GELU or the identity. Its
// gradient with respect to x is GroupNorm's:
//   dz = dy * act'(u),  xh = (x - mean) * rstd,  k = w * s,
//   dx = rstd * (dz * k - A_g - xh * B_g),
//   A_g = mean over the group of k * dz,  B_g = mean over the group of k * dz * xh,
// and the parameter gradients are sums of the per-row
//   S1 = sum_t dz,  S2 = sum_t dz * xh
// (ops/group_norm.py::group_norm_param_grads).
//
// No Pallas kernel computes this: it replaces the VJP the JAX package takes
// of GroupNorm, vq_voice_swap_tpu/ops/fused_norm.py::_fgn_bwd (the VJP of
// reference_group_norm) and flax's autodiff of models/layers.py::GroupNorm.
//
// What bounds it on the card: bytes. x and dy are read and dx written, a few
// tens of flops per element (erf and exp for GELU'). The bound is those three
// tensors over the memory rate.
//
// Design (simple first): the group (mean, var) come from the statistics
// kernel (csrc/group_norm_stats.cu, (mean, var) mode) launched by the
// wrapper, since rstd cannot be recovered from the folded a when w * s = 0.
// Then two launches:
// - reduce: one or more blocks per (n, channel) row. A block folds 16
//   elements of x and dy per thread per pass (16-byte loads), sums dz and
//   dz * (x - mean) in float32, and merges across the block in a fixed tree.
//   A row split over several blocks publishes one partial per block; the
//   last block to finish (a per-row ticket, __threadfence + atomicAdd, reset
//   by that block) adds them in slice order. So two calls give the same
//   bits, and no float atomics are used. It writes S1 and S2 per row.
// - dx: one block per 4096 elements of a row. Its first warp forms A_g and
//   B_g from the S1, S2 of the row's group in a fixed order (every block of
//   the group gets the same bits), then each thread reads 16 elements of x
//   and dy, recomputes u (a and b exactly as the statistics kernel folds
//   them) and writes dx in x's dtype.
// So x is read three times (statistics, reduce, dx) and dy twice: six passes
// against the bound's three.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BATCH = 16;              // elements of each tensor a thread holds at once
constexpr int TILE = THREADS * BATCH;  // row elements one block pass covers
constexpr int MAX_SLICES = 64;         // reduce blocks of one row

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// V values starting at element i * V of p, as float; and the store back.
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, long long i, float* out) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
    out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, long long i, const float* v) {
    reinterpret_cast<float4*>(p)[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, long long i, float* out) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[2 * j] = bf16_lo(w[j]);
      out[2 * j + 1] = bf16_hi(w[j]);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, long long i, const float* v) {
    reinterpret_cast<uint4*>(p)[i] = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, long long i, float* out) {
    out[0] = __ldg(p + i);
  }
  static __device__ __forceinline__ void store(float* p, long long i, const float* v) {
    p[i] = v[0];
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, long long i, float* out) {
    out[0] = __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, long long i, const float* v) {
    p[i] = __float2bfloat16_rn(v[0]);
  }
};

__device__ __forceinline__ float load_film(const void* p, int bf16, long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// d/du of the exact (erf) GELU: Phi(u) + u * phi(u).
__device__ __forceinline__ float gelu_grad(float u) {
  const float cdf = 0.5f * (1.0f + erff(u * 0.7071067811865476f));
  const float pdf = 0.3989422804014327f * expf(-0.5f * u * u);
  return fmaf(u, pdf, cdf);
}

struct Args {
  int c, groups, cpg;    // C, G, C/G
  long long t;           // T
  const float* mean;     // [N * G] group statistics
  const float* var;
  float eps;
  const float* weight;   // [C] float32
  const float* bias;
  const void* film_a;    // [N, C] with row stride film_ld, or null
  const void* film_b;
  int film_bf16;
  long long film_ld;
  int use_gelu;
  int slices;            // reduce blocks per row
  long long chunk;       // row elements per reduce block, a multiple of 8
  float* part;           // [rows, slices, 2] block partials (slices > 1)
  int* tickets;          // [rows] zeroed counters (slices > 1)
  float* s1;             // [N * C]
  float* s2;
};

// The film scale s = ca + 1 of channel ch of sample n (1 without FiLM).
__device__ __forceinline__ float film_scale(const Args& args, int n, int ch) {
  if (args.film_a == nullptr) return 1.0f;
  return __fadd_rn(load_film(args.film_a, args.film_bf16, n * args.film_ld + ch), 1.0f);
}

struct Row {
  float mean, rstd, a, b, k;
};

// A row's coefficients; a and b operation for operation as the statistics
// kernel folds them, so u is the forward's.
__device__ __forceinline__ Row row_coefficients(const Args& args, int row) {
  const int n = row / args.c;
  const int ch = row - n * args.c;
  const int span = n * args.groups + ch / args.cpg;
  Row r;
  r.mean = args.mean[span];
  r.rstd = rsqrtf(args.var[span] + args.eps);
  const float w = args.weight[ch];
  const float s = film_scale(args, n, ch);
  r.a = __fmul_rn(r.rstd, w);
  r.b = args.bias[ch];
  if (args.film_a != nullptr) {
    r.a = __fmul_rn(r.a, s);
    r.b = __fadd_rn(__fmul_rn(r.b, s),
                    load_film(args.film_b, args.film_bf16, n * args.film_ld + ch));
  }
  r.k = __fmul_rn(w, s);
  return r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS, 4)
group_norm_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy, Args args) {
  constexpr int LOADS = BATCH / V;
  __shared__ float warp_part[2][WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x / args.slices;
  const int slice = blockIdx.x - row * args.slices;
  const Row rc = row_coefficients(args, row);
  const long long start = slice * args.chunk;
  const long long end = min(args.t, start + args.chunk);
  const long long nvec = start < end ? (end - start) / V : 0;
  const T* px = x + row * args.t + start;
  const T* pg = dy + row * args.t + start;

  float s1 = 0.0f, s2 = 0.0f;
  for (long long v0 = 0; v0 < nvec; v0 += (long long)THREADS * LOADS) {
    float xv[BATCH], gv[BATCH];
    int valid = 0;
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const long long v = v0 + j * THREADS + tid;
      if (v < nvec) {
        Vec<T, V>::load(px, v, xv + j * V);
        Vec<T, V>::load(pg, v, gv + j * V);
        ++valid;
      }
    }
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      if (j < valid) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = xv[j * V + e] - rc.mean;
          float dz = gv[j * V + e];
          if (args.use_gelu) dz *= gelu_grad(fmaf(d, rc.a, rc.b));
          s1 += dz;
          s2 = fmaf(dz, d, s2);
        }
      }
    }
  }

  // Block merge in a fixed tree: shuffles in each warp, then warp 0 in order.
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    warp_part[0][warp] = s1;
    warp_part[1][warp] = s2;
  }
  __syncthreads();
  if (tid != 0) return;
  s1 = 0.0f;
  s2 = 0.0f;
  for (int w = 0; w < WARPS; ++w) {
    s1 += warp_part[0][w];
    s2 += warp_part[1][w];
  }

  if (args.slices > 1) {
    // Publish this slice's partial; the last block of the row adds them.
    float* out = args.part + (row * (long long)args.slices + slice) * 2;
    out[0] = s1;
    out[1] = s2;
    __threadfence();
    if (atomicAdd(args.tickets + row, 1) != args.slices - 1) return;
    args.tickets[row] = 0;
    __threadfence();
    const float* part = args.part + row * (long long)args.slices * 2;
    s1 = 0.0f;
    s2 = 0.0f;
    for (int s = 0; s < args.slices; ++s) {
      s1 += __ldcg(part + 2 * s);
      s2 += __ldcg(part + 2 * s + 1);
    }
  }
  args.s1[row] = s1;
  args.s2[row] = s2 * rc.rstd;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
group_norm_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                         Args args, int tiles) {
  constexpr int LOADS = BATCH / V;
  __shared__ float s_ab[2];

  const int tid = threadIdx.x, lane = tid & 31;
  const int row = blockIdx.x / tiles;
  const int tile = blockIdx.x - row * tiles;
  const Row rc = row_coefficients(args, row);

  if (tid < 32) {
    // A_g and B_g: lane j takes channels j, j + 32, ... of the group, then a
    // fixed shuffle tree, so every block of the group gets the same bits.
    const int n = row / args.c;
    const int g = (row - n * args.c) / args.cpg;
    float ka = 0.0f, kb = 0.0f;
    for (int j = lane; j < args.cpg; j += 32) {
      const int ch = g * args.cpg + j;
      const float k = __fmul_rn(args.weight[ch], film_scale(args, n, ch));
      ka = fmaf(k, args.s1[n * args.c + ch], ka);
      kb = fmaf(k, args.s2[n * args.c + ch], kb);
    }
    ka = warp_sum(ka);
    kb = warp_sum(kb);
    if (lane == 0) {
      const float count = static_cast<float>(args.cpg * args.t);
      s_ab[0] = ka / count;
      s_ab[1] = kb / count;
    }
  }
  __syncthreads();
  const float ga = s_ab[0], gb = s_ab[1];

  const long long start = (long long)tile * TILE;
  const long long nvec = (min(args.t, start + TILE) - start) / V;
  const T* px = x + row * args.t + start;
  const T* pg = dy + row * args.t + start;
  T* po = dx + row * args.t + start;
  float xv[BATCH], gv[BATCH];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const long long v = j * THREADS + tid;
    if (v < nvec) {
      Vec<T, V>::load(px, v, xv + j * V);
      Vec<T, V>::load(pg, v, gv + j * V);
    }
  }
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const long long v = j * THREADS + tid;
    if (v < nvec) {
      float out[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = xv[j * V + e] - rc.mean;
        float dz = gv[j * V + e];
        if (args.use_gelu) dz *= gelu_grad(fmaf(d, rc.a, rc.b));
        out[e] = rc.rstd * (fmaf(dz, rc.k, -ga) - d * rc.rstd * gb);
      }
      Vec<T, V>::store(po, v, out);
    }
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* dy, void* dx, int rows, const Args& args,
                   cudaStream_t stream) {
  group_norm_bwd_reduce_kernel<T, V><<<rows * args.slices, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = static_cast<int>((args.t + TILE - 1) / TILE);
  group_norm_bwd_dx_kernel<T, V><<<rows * tiles, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), args, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int group_norm_bwd_tile() { return TILE; }
extern "C" int group_norm_bwd_max_slices() { return MAX_SLICES; }

// x, dy, dx [N, C, T] contiguous, float32 (dtype 0) or bfloat16 (dtype 1);
// `vec` selects 16-byte accesses (T a multiple of 4 float32 or 8 bfloat16
// values, x, dy and dx 16-byte aligned). mean and var: the group statistics
// [N * groups] of x. weight, bias: [C] float32; FiLM (film_a, film_b) [N, C]
// in film_dtype with row stride film_ld, or null. Each row of T is split
// into `slices` slices of `chunk` elements for the reduce; `part` holds
// rows * slices * 2 floats and `tickets` rows zeroed ints when slices > 1.
// Writes dx and the per-row S1, S2 [N * C]. Launches both kernels on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int group_norm_bwd(int dtype, const void* x, const void* dy, void* dx, int n, int c,
                              long long t, int groups, int slices, long long chunk, int vec,
                              float* part, int* tickets, const float* mean, const float* var,
                              float eps, const float* weight, const float* bias,
                              const void* film_a, const void* film_b, int film_dtype,
                              long long film_ld, int use_gelu, float* s1, float* s2,
                              void* stream) {
  if (slices < 1 || slices > MAX_SLICES || groups < 1 || c % groups ||
      (slices > 1 && (part == nullptr || tickets == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = n * c;
  if (rows == 0 || t == 0) return static_cast<int>(cudaGetLastError());
  Args args{c, groups, c / groups, t, mean, var, eps, weight, bias, film_a, film_b,
            film_dtype, film_ld, use_gelu, slices, chunk, part, tickets, s1, s2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = vec ? launch<float, 4>(x, dy, dx, rows, args, s)
              : launch<float, 1>(x, dy, dx, rows, args, s);
  } else {
    err = vec ? launch<__nv_bfloat16, 8>(x, dy, dx, rows, args, s)
              : launch<__nv_bfloat16, 1>(x, dy, dx, rows, args, s);
  }
  return static_cast<int>(err);
}
