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
// What bounds it on the card: bytes. x and dy must be read once and dx
// written once; a few tens of flops per element (erf and exp for GELU').
// The bound is those three tensors over the memory rate.
//
// The group (mean, var) come from the forward: its statistics launch writes
// them beside the folded coefficients (csrc/group_norm_stats.cu), since rstd
// cannot be recovered from the folded a when w * s = 0. From them the
// kernel recomputes a and b operation for operation as that launch folds
// them, so GELU' is taken at the forward's u.
//
// Two routes, chosen by shape in one place (ops/group_norm.py::bwd_route):
//
// - Cluster route, one launch (group_norm_bwd_cluster_kernel). A group is
//   one contiguous span of C/G * T elements of [N, C, T]. A thread-block
//   cluster of K <= 16 blocks takes one span at a time (above 8, the
//   non-portable cluster sizes that Hopper allows on request); block r
//   holds elements [r * chunk, (r + 1) * chunk) of it in shared memory.
//   Thread 0 copies x and dy in with bulk asynchronous copies
//   (cp.async.bulk, one mbarrier per stage of PIECE elements, so the
//   threads start on the first stage while the rest arrive). Unaligned
//   shapes (T not a multiple of 16 bytes) load element by element
//   instead. Each block forms dz = dy * act'(u)
//   once and keeps it on chip (over dy in float32; in a float32 region
//   beside x and dy for bfloat16, so dz is not rounded), and reduces per
//   channel S1 and sum dz * (x - mean) in a fixed tree. After a cluster
//   barrier, warp 0 of every block reads every rank's partials through
//   distributed shared memory in rank order and forms the group's S1, S2,
//   A_g and B_g in a fixed lane order and shuffle tree: every block
//   computes the same operations on the same values, so all get the same
//   bits, and rank 0 writes S1, S2. Then each block writes dx from shared
//   memory. Traffic: x and dy read once, dx written once, the bound's
//   three passes; no global partials, no tickets, no atomics.
// - Two-kernel route, for spans larger than a cluster holds: 16 blocks of
//   28672 elements, 458752 elements a span. At 16 kHz that is 14.3 s of
//   audio at the first level of a unet32 (whose up path concatenates its
//   skips there: 64 channels, two a group), 7.2 s at a unet64's (128
//   channels, four a group) and 28.7 s at a classifier's (one). A reduce
//   launch (one or more blocks per (n, channel) row; a row split over
//   several blocks publishes one partial per block and the last block to
//   finish, a per-row ticket reset by that block, adds them in slice
//   order), then a dx launch that forms A_g, B_g per block in the same
//   fixed order. x and dy are read twice: five passes.
//
// The two-kernel route's launches are two C entry points,
// group_norm_bwd_reduce and group_norm_bwd_dx. Under sequence parallelism
// (parallel/sequence.py) a group's span is cut over the ranks along T and
// no launch sees the whole group: between the two, the caller sums the
// per-row S1, S2 over the ranks (one all-reduce of [2, N, C] floats), and
// the dx launch takes the group's element count over all ranks, cpg *
// T_total, as the divisor of A_g and B_g. One device passes its own span,
// cpg * T, as before. The count reaches the kernels as a float: exact below
// 2^24 elements, within 2^-24 relative above.
//
// Both routes give the same bits on every call whatever order the blocks
// run in: every sum has a fixed order, and no float atomics are used.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BATCH = 16;              // elements of each tensor a thread holds at once
constexpr int TILE = THREADS * BATCH;  // row elements one two-kernel block pass covers
constexpr int MAX_SLICES = 64;         // reduce blocks of one row

constexpr int CLUSTER_MAX = 16;        // blocks of one cluster (8 is the portable limit)
constexpr int PIECE = 4096;            // span elements of one bulk-copy stage
constexpr int MAX_PIECES = 7;
constexpr int BLOCK_ELEMS = PIECE * MAX_PIECES;  // span elements one cluster block holds
constexpr int MAX_SMEM = 232448;       // dynamic shared memory a block may use (227 KB)
constexpr int BARS = 128;              // bytes of the header that hold the mbarriers
constexpr int HEADER = BARS + 4 * (2 * WARPS + 4);  // mbarriers, block sums, A_g and B_g
static_assert(MAX_PIECES * 8 <= BARS, "one mbarrier a stage fits the header");

// Shared memory of one cluster block: the header, the block's per-channel
// partials [2, cpg], then x, dy and (bfloat16 only) dz of chunk elements:
// 8 bytes an element for either dtype.
__host__ __device__ constexpr long long cluster_smem(int cpg, long long chunk) {
  return ((HEADER + 8LL * cpg + 15) / 16) * 16 + 8 * chunk;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// V values starting at element i * V of p, as float; and the store back.
// `load` reads global memory through the read-only path, `load_shared`
// shared memory.
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, long long i, float* out) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
    out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
  }
  static __device__ __forceinline__ void load_shared(const float* p, int i, float* out) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, long long i, const float* v) {
    reinterpret_cast<float4*>(p)[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void unpack(const uint4 q, float* out) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[2 * j] = bf16_lo(w[j]);
      out[2 * j + 1] = bf16_hi(w[j]);
    }
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, long long i, float* out) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p) + i), out);
  }
  static __device__ __forceinline__ void load_shared(const __nv_bfloat16* p, int i, float* out) {
    unpack(reinterpret_cast<const uint4*>(p)[i], out);
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
  static __device__ __forceinline__ void load_shared(const float* p, int i, float* out) {
    out[0] = p[i];
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
  static __device__ __forceinline__ void load_shared(const __nv_bfloat16* p, int i, float* out) {
    out[0] = __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, long long i, const float* v) {
    p[i] = __float2bfloat16_rn(v[0]);
  }
};

// V float32 values of shared memory at element i * V, and the store back.
template <int V>
__device__ __forceinline__ void load_dz(const float* p, int i, float* out) {
  if constexpr (V == 1) {
    out[0] = p[i];
  } else {
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const float4 q = reinterpret_cast<const float4*>(p)[i * (V / 4) + j];
      out[4 * j] = q.x; out[4 * j + 1] = q.y; out[4 * j + 2] = q.z; out[4 * j + 3] = q.w;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_dz(float* p, int i, const float* v) {
  if constexpr (V == 1) {
    p[i] = v[0];
  } else {
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      reinterpret_cast<float4*>(p)[i * (V / 4) + j] =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
  }
}

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
  const float* mean;     // [N * G] group statistics of the forward
  const float* var;
  float eps;
  const float* weight;   // [C] float32
  const float* bias;
  const void* film_a;    // [N, C] with row stride film_ld, or null
  const void* film_b;
  int film_bf16;
  long long film_ld;
  int use_gelu;
  int slices;            // two-kernel: reduce blocks per row; cluster: blocks per span
  long long chunk;       // elements per reduce block (of a row) or cluster block (of a span)
  float* part;           // two-kernel: [rows, slices, 2] block partials (slices > 1)
  int* tickets;          // two-kernel: [rows] zeroed counters (slices > 1)
  float* s1;             // [N * C]
  float* s2;
  long long count;       // elements of a group over all its shards: A_g and B_g's divisor
};

// The film scale s = ca + 1 of channel ch of sample n (1 without FiLM).
__device__ __forceinline__ float film_scale(const Args& args, int n, int ch) {
  if (args.film_a == nullptr) return 1.0f;
  return __fadd_rn(load_film(args.film_a, args.film_bf16, n * args.film_ld + ch), 1.0f);
}

struct Row {
  float mean, rstd, a, b, k;
};

// Channel ch of sample n's coefficients; a and b operation for operation
// as the statistics kernel folds them, so u is the forward's.
__device__ __forceinline__ Row row_coefficients(const Args& args, int n, int ch) {
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

__device__ __forceinline__ Row row_coefficients(const Args& args, int row) {
  const int n = row / args.c;
  return row_coefficients(args, n, row - n * args.c);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------ cluster route

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the first phase of an mbarrier (each is used once).
__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar) : "memory");
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Thread 0: the bulk copies of `count` elements of x and dy from `base` into
// xs and gs, a stage of PIECE elements on each of `bars`.
template <typename T>
__device__ __forceinline__ void start_loads(const T* x, const T* dy, long long base, int count,
                                            T* xs, T* gs, uint64_t* bars) {
  for (int p = 0; p * PIECE < count; ++p) {
    const uint32_t bytes = static_cast<uint32_t>(min(PIECE, count - p * PIECE) * sizeof(T));
    const uint32_t bar = shared_addr(bars + p);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(2 * bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(shared_addr(xs + p * PIECE)), "l"(x + base + p * PIECE), "r"(bytes), "r"(bar)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(shared_addr(gs + p * PIECE)), "l"(dy + base + p * PIECE), "r"(bytes), "r"(bar)
        : "memory");
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS, 3)
group_norm_bwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                              T* __restrict__ dx, Args args) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [MAX_PIECES]
  float* red = reinterpret_cast<float*>(smem + BARS);  // [2, WARPS] block sums
  float* ab = red + 2 * WARPS;                         // A_g, B_g
  float* part = ab + 4;                                // [2, cpg] this block's partials
  const int cpg = args.cpg;
  const long long t = args.t;
  T* xs = reinterpret_cast<T*>(smem + cluster_smem(cpg, 0));
  T* gs = xs + args.chunk;
  // dz: over dy in float32; its own float32 region for bfloat16.
  float* zs = sizeof(T) == 4 ? reinterpret_cast<float*>(gs)
                             : reinterpret_cast<float*>(gs + args.chunk);

  cg::cluster_group cluster = cg::this_cluster();
  const int K = args.slices;
  const int rank = static_cast<int>(cluster.block_rank());
  const int span = blockIdx.x / K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long span_len = cpg * t;
  const long long start = rank * args.chunk;
  const long long end = min(span_len, start + args.chunk);
  const int count = start < end ? static_cast<int>(end - start) : 0;
  const long long base = span * span_len + start;
  const int npieces = V > 1 ? (count + PIECE - 1) / PIECE : 0;

  if (tid == 0 && npieces > 0) {
    for (int p = 0; p < npieces; ++p) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(shared_addr(bars + p)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = tid; j < 2 * cpg; j += THREADS) part[j] = 0.0f;
  __syncthreads();
  if constexpr (V > 1) {
    if (tid == 0 && npieces > 0) start_loads(x, dy, base, count, xs, gs, bars);
  } else {
    for (int e = tid; e < count; e += THREADS) {
      xs[e] = x[base + e];
      gs[e] = dy[base + e];
    }
    __syncthreads();
  }

  // The channels of the group that this block's elements fall in.
  const int c_first = count ? static_cast<int>(start / t) : 0;
  const int c_last = count ? static_cast<int>((end - 1) / t) : -1;
  const int n = span / args.groups;
  const int ch0 = (span - n * args.groups) * cpg;

  // Phase 1: dz once, and per channel S1 and sum dz * (x - mean).
  int ready = 0;
  for (int c = c_first; c <= c_last; ++c) {
    const Row rc = row_coefficients(args, n, ch0 + c);
    const int lo = static_cast<int>(max(start, c * t) - start);
    const int hi = static_cast<int>(min(end, (c + 1) * t) - start);
    float s1 = 0.0f, s2 = 0.0f;
    for (int e = lo + tid * V; e < hi; e += THREADS * V) {
      if constexpr (V > 1) {
        for (const int p = e / PIECE; ready <= p; ++ready) {
          mbar_wait(shared_addr(bars + ready));
        }
      }
      float xv[V], zv[V];
      Vec<T, V>::load_shared(xs, e / V, xv);
      Vec<T, V>::load_shared(gs, e / V, zv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = xv[k] - rc.mean;
        if (args.use_gelu) zv[k] *= gelu_grad(fmaf(d, rc.a, rc.b));
        s1 += zv[k];
        s2 = fmaf(zv[k], d, s2);
      }
      if (args.use_gelu) store_dz<V>(zs, e / V, zv);
    }
    // Block merge in a fixed tree: shuffles in each warp, then thread 0 in order.
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red[warp] = s1;
      red[WARPS + warp] = s2;
    }
    __syncthreads();
    if (tid == 0) {
      s1 = 0.0f;
      s2 = 0.0f;
      for (int w = 0; w < WARPS; ++w) {
        s1 += red[w];
        s2 += red[WARPS + w];
      }
      part[c] = s1;
      part[cpg + c] = s2;
    }
    __syncthreads();
  }
  if constexpr (V > 1) {
    // Phase 2 reads elements this thread did not wait for.
    for (; ready < npieces; ++ready) mbar_wait(shared_addr(bars + ready));
  }

  // Every rank's partials, in rank order, through distributed shared memory.
  cluster_arrive();
  cluster_wait();
  const float rstd = rsqrtf(args.var[span] + args.eps);
  if (warp == 0) {
    float ka = 0.0f, kb = 0.0f;
    for (int j = lane; j < cpg; j += 32) {
      float t1 = 0.0f, t2 = 0.0f;
      for (int r = 0; r < K; ++r) {
        const float* remote = cluster.map_shared_rank(part, r);
        t1 += remote[j];
        t2 += remote[cpg + j];
      }
      t2 *= rstd;
      const int ch = ch0 + j;
      const float k = __fmul_rn(args.weight[ch], film_scale(args, n, ch));
      ka = fmaf(k, t1, ka);
      kb = fmaf(k, t2, kb);
      if (rank == 0) {
        args.s1[n * args.c + ch] = t1;
        args.s2[n * args.c + ch] = t2;
      }
    }
    ka = warp_sum(ka);
    kb = warp_sum(kb);
    if (lane == 0) {
      const float total = static_cast<float>(args.count);
      ab[0] = ka / total;
      ab[1] = kb / total;
    }
  }
  __syncthreads();
  cluster_arrive();  // this block has read the others' partials
  const float ga = ab[0], gb = ab[1];

  // Phase 2: dx from shared memory, written once.
  T* po = dx + base;
  for (int c = c_first; c <= c_last; ++c) {
    const Row rc = row_coefficients(args, n, ch0 + c);
    const int lo = static_cast<int>(max(start, c * t) - start);
    const int hi = static_cast<int>(min(end, (c + 1) * t) - start);
    for (int e = lo + tid * V; e < hi; e += THREADS * V) {
      float xv[V], zv[V], out[V];
      Vec<T, V>::load_shared(xs, e / V, xv);
      if (sizeof(T) == 2 && !args.use_gelu) {
        Vec<T, V>::load_shared(gs, e / V, zv);
      } else {
        load_dz<V>(zs, e / V, zv);
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = xv[k] - rc.mean;
        out[k] = rc.rstd * (fmaf(zv[k], rc.k, -ga) - d * rc.rstd * gb);
      }
      Vec<T, V>::store(po, e / V, out);
    }
  }
  cluster_wait();  // no block leaves while another may still read its partials
}

template <typename T, int V>
cudaError_t launch_cluster(const void* x, const void* dy, void* dx, int spans, const Args& args,
                           cudaStream_t stream) {
  auto kernel = group_norm_bwd_cluster_kernel<T, V>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(spans * args.slices);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(cluster_smem(args.cpg, args.chunk));
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = args.slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(dy),
                           static_cast<T*>(dx), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// -------------------------------------------------------- two-kernel route

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
      const float count = static_cast<float>(args.count);
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
cudaError_t launch_reduce(const void* x, const void* dy, int rows, const Args& args,
                          cudaStream_t stream) {
  group_norm_bwd_reduce_kernel<T, V><<<rows * args.slices, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), args);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_dx(const void* x, const void* dy, void* dx, int rows, const Args& args,
                      cudaStream_t stream) {
  const int tiles = static_cast<int>((args.t + TILE - 1) / TILE);
  group_norm_bwd_dx_kernel<T, V><<<rows * tiles, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), args, tiles);
  return cudaGetLastError();
}

Args make_args(int c, long long t, int groups, int slices, long long chunk, float* part,
               int* tickets, const float* mean, const float* var, float eps,
               const float* weight, const float* bias, const void* film_a, const void* film_b,
               int film_dtype, long long film_ld, int use_gelu, float* s1, float* s2,
               long long count) {
  return Args{c, groups, c / groups, t, mean, var, eps, weight, bias, film_a, film_b,
              film_dtype, film_ld, use_gelu, slices, chunk, part, tickets, s1, s2, count};
}

}  // namespace

extern "C" int group_norm_bwd_tile() { return TILE; }
extern "C" int group_norm_bwd_max_slices() { return MAX_SLICES; }
extern "C" int group_norm_bwd_cluster_max() { return CLUSTER_MAX; }
extern "C" int group_norm_bwd_block_elems() { return BLOCK_ELEMS; }
extern "C" int group_norm_bwd_max_smem() { return MAX_SMEM; }
extern "C" long long group_norm_bwd_cluster_smem(int cpg, long long chunk) {
  return cluster_smem(cpg, chunk);
}

// Common to both routes: x, dy, dx [N, C, T] contiguous, float32 (dtype 0)
// or bfloat16 (dtype 1); `vec` selects 16-byte accesses (T a multiple of 4
// float32 or 8 bfloat16 values, x, dy and dx 16-byte aligned). mean and
// var: the group statistics [N * groups] of x as the forward computed
// them. weight, bias: [C] float32; FiLM (film_a, film_b) [N, C] in
// film_dtype with row stride film_ld, or null. Writes dx and the per-row
// S1, S2 [N * C]. Launch on `stream` and return cudaGetLastError() (0 on
// success).

// The cluster route: one cluster of `cluster` blocks per (n, group) span of
// C/G * T elements, `chunk` elements a block (a multiple of 8, at most
// group_norm_bwd_block_elems(), cluster * chunk covering the span), in at
// most group_norm_bwd_max_smem() bytes.
extern "C" int group_norm_bwd_cluster(int dtype, const void* x, const void* dy, void* dx, int n,
                                      int c, long long t, int groups, int cluster,
                                      long long chunk, int vec, const float* mean,
                                      const float* var, float eps, const float* weight,
                                      const float* bias, const void* film_a, const void* film_b,
                                      int film_dtype, long long film_ld, int use_gelu,
                                      float* s1, float* s2, void* stream) {
  if (groups < 1 || c % groups || cluster < 1 || cluster > CLUSTER_MAX || chunk % 8 ||
      chunk < 8 || chunk > BLOCK_ELEMS || cluster * chunk < (c / groups) * t ||
      cluster_smem(c / groups, chunk) > MAX_SMEM || (vec && t % (dtype == 0 ? 4 : 8))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int spans = n * groups;
  if (spans == 0 || t == 0) return static_cast<int>(cudaGetLastError());
  const Args args = make_args(c, t, groups, cluster, chunk, nullptr, nullptr, mean, var, eps,
                              weight, bias, film_a, film_b, film_dtype, film_ld, use_gelu,
                              s1, s2, (long long)(c / groups) * t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = vec ? launch_cluster<float, 4>(x, dy, dx, spans, args, s)
              : launch_cluster<float, 1>(x, dy, dx, spans, args, s);
  } else {
    err = vec ? launch_cluster<__nv_bfloat16, 8>(x, dy, dx, spans, args, s)
              : launch_cluster<__nv_bfloat16, 1>(x, dy, dx, spans, args, s);
  }
  return static_cast<int>(err);
}

// The two-kernel route, for spans beyond a cluster: the reduce launch, then
// the dx launch (one device passes the dx launch its own span as `count`).
// The reduce writes the per-row S1 and S2 of this tensor; each row of T is
// split into `slices` slices of `chunk` elements, and `part` holds rows *
// slices * 2 floats and `tickets` rows zeroed ints when slices > 1.
extern "C" int group_norm_bwd_reduce(int dtype, const void* x, const void* dy, int n, int c,
                                     long long t, int groups, int slices, long long chunk,
                                     int vec, float* part, int* tickets, const float* mean,
                                     const float* var, float eps, const float* weight,
                                     const float* bias, const void* film_a,
                                     const void* film_b, int film_dtype, long long film_ld,
                                     int use_gelu, float* s1, float* s2, void* stream) {
  if (slices < 1 || slices > MAX_SLICES || groups < 1 || c % groups ||
      (slices > 1 && (part == nullptr || tickets == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = n * c;
  if (rows == 0 || t == 0) return static_cast<int>(cudaGetLastError());
  const Args args = make_args(c, t, groups, slices, chunk, part, tickets, mean, var, eps,
                              weight, bias, film_a, film_b, film_dtype, film_ld, use_gelu,
                              s1, s2, (long long)(c / groups) * t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = vec ? launch_reduce<float, 4>(x, dy, rows, args, s)
              : launch_reduce<float, 1>(x, dy, rows, args, s);
  } else {
    err = vec ? launch_reduce<__nv_bfloat16, 8>(x, dy, rows, args, s)
              : launch_reduce<__nv_bfloat16, 1>(x, dy, rows, args, s);
  }
  return static_cast<int>(err);
}

// The dx launch, from the per-row S1 and S2 of the whole group (on one
// device, the reduce's; under sequence parallelism, summed over the ranks),
// `count` the group's elements over all its shards (cpg * T on one device).
extern "C" int group_norm_bwd_dx(int dtype, const void* x, const void* dy, void* dx, int n,
                                 int c, long long t, int groups, int vec, const float* mean,
                                 const float* var, float eps, const float* weight,
                                 const float* bias, const void* film_a, const void* film_b,
                                 int film_dtype, long long film_ld, int use_gelu,
                                 const float* s1, const float* s2, long long count,
                                 void* stream) {
  if (groups < 1 || c % groups || count < (long long)(c / groups) * t) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = n * c;
  if (rows == 0 || t == 0) return static_cast<int>(cudaGetLastError());
  const Args args = make_args(c, t, groups, 1, 0, nullptr, nullptr, mean, var, eps, weight,
                              bias, film_a, film_b, film_dtype, film_ld, use_gelu,
                              const_cast<float*>(s1), const_cast<float*>(s2), count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = vec ? launch_dx<float, 4>(x, dy, dx, rows, args, s)
              : launch_dx<float, 1>(x, dy, dx, rows, args, s);
  } else {
    err = vec ? launch_dx<__nv_bfloat16, 8>(x, dy, dx, rows, args, s)
              : launch_dx<__nv_bfloat16, 1>(x, dy, dx, rows, args, s);
  }
  return static_cast<int>(err);
}
