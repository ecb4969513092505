// GroupNorm statistics of [N, C, T] for Hopper (sm_90a), with the affine and
// FiLM fold in the kernel's own epilogue; plain C interface.
//
// Replaces vq_voice_swap_tpu/ops/fused_norm.py::_stats_kernel together with
// what follows it there, _finish_from_channel_stats up to the folded affine
// (fused_norm.py:166-184): one launch goes from x to the float32 per-channel
// (mean_c, a, b) that the apply kernel takes, with
//   a = rsqrt(var + eps) * weight * s,  b = bias * s + cb,  s = 1 + ca
// (s = 1 without FiLM), exactly ops/group_norm.py::fold_affine. Without a
// weight it writes the group (mean, var) instead.
//
// What bounds it on the card: bytes. Each (n, group) of a contiguous
// [N, C, T] tensor is one contiguous span of C/G*T elements, read once; a
// few flops per element. The bound is x's bytes over the memory rate.
//
// Design:
// - Blocks. Each block takes one contiguous slice of one span; the wrapper
//   sizes the slices so that the grid fills the card (one block per span
//   when there are enough spans).
// - Loads. A thread issues BATCH / V loads of 16 bytes (float4, or 8 bf16)
//   before it uses any, then folds the BATCH = 32 values it holds: a
//   two-pass mean and M2 in registers, Chan-merged into its running (count,
//   mean, M2) with one division per batch, none per element. Unaligned
//   spans take the same path with one element per load.
// - Merge. Warps merge by shuffle, then through shared memory, in a fixed
//   tree. Each block of a multi-slice span writes its partial; the last
//   block to finish (a per-span ticket: __threadfence + atomicAdd, reset by
//   that block, so the counters need no clearing launch) merges the partials
//   in slice order. The result has the same bits from run to run, whatever
//   order the blocks run in. The wrapper gives each stream its own tickets
//   (ops/tickets.py).
// - Epilogue. The last block computes rsqrt(var + eps) and writes each
//   channel of its group. FiLM (ca, cb) is read in its own dtype through a
//   row stride, so the chunks of a [N, 2C] projection need no copy; outputs
//   go through a row stride, so several inputs can fill the column slices of
//   one [N, Cin] result.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BATCH = 32;               // values a thread folds at once
constexpr int TILE = THREADS * BATCH;   // span elements one block pass reads
constexpr int MAX_SLICES = 256;         // block partials of one span

struct Stat {
  float n, mean, m2;
};

// Chan's merge of b into a. n is an exact integer count (spans < 2^24).
__device__ __forceinline__ void chan(Stat& a, const Stat& b) {
  if (b.n == 0.0f) return;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float r = b.n / n;
  a.mean = a.mean + d * r;
  a.m2 = a.m2 + b.m2 + d * d * a.n * r;
  a.n = n;
}

__device__ __forceinline__ Stat shfl_down(const Stat& s, int o) {
  return Stat{__shfl_down_sync(0xffffffffu, s.n, o),
              __shfl_down_sync(0xffffffffu, s.mean, o),
              __shfl_down_sync(0xffffffffu, s.m2, o)};
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// V values starting at element i * V of p, as float.
template <typename T, int V>
__device__ __forceinline__ void load_values(const T* p, long long i, float* out);

template <>
__device__ __forceinline__ void load_values<float, 4>(const float* p, long long i, float* out) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
  out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
}

template <>
__device__ __forceinline__ void load_values<__nv_bfloat16, 8>(const __nv_bfloat16* p, long long i,
                                                              float* out) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[2 * j] = bf16_lo(w[j]);
    out[2 * j + 1] = bf16_hi(w[j]);
  }
}

template <>
__device__ __forceinline__ void load_values<float, 1>(const float* p, long long i, float* out) {
  out[0] = __ldg(p + i);
}

template <>
__device__ __forceinline__ void load_values<__nv_bfloat16, 1>(const __nv_bfloat16* p, long long i,
                                                              float* out) {
  out[0] = __bfloat162float(p[i]);
}

__device__ __forceinline__ float load_film(const void* p, int bf16, long long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

struct Args {
  long long span;      // C/G * T
  int slices;          // blocks per span
  long long chunk;     // span elements per slice, a multiple of 8
  int groups, cpg;     // G and C/G
  float* part;         // [spans, slices, 3] block partials (slices > 1)
  int* tickets;        // [spans] zeroed counters
  const float* weight; // [C] or null: write (mean, var) instead
  const float* bias;
  float eps;
  const void* film_a;  // [N, C] with row stride film_ld, or null
  const void* film_b;
  int film_bf16;
  long long film_ld;
  float* out_mean;     // coefficients: [N, *] with row stride out_ld
  float* out_a;        //   statistics: mean, var [N * G]
  float* out_b;
  long long out_ld;
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS, 4)
group_norm_stats_kernel(const T* __restrict__ x, Args args) {
  constexpr int LOADS = BATCH / V;
  __shared__ Stat warp_stat[WARPS];
  __shared__ Stat slice_stat[MAX_SLICES];
  __shared__ int is_last;
  __shared__ float s_mean, s_rstd;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span_id = blockIdx.x / args.slices;
  const int slice = blockIdx.x - span_id * args.slices;
  const long long start = slice * args.chunk;
  const long long end = min(args.span, start + args.chunk);
  const T* p = x + span_id * args.span + start;
  const long long nvec = start < end ? (end - start) / V : 0;

  Stat acc{0.0f, 0.0f, 0.0f};
  for (long long v0 = 0; v0 < nvec; v0 += (long long)THREADS * LOADS) {
    float vals[BATCH];
    int valid = 0;
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const long long v = v0 + j * THREADS + tid;
      if (v < nvec) {
        load_values<T, V>(p, v, vals + j * V);
        ++valid;
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) vals[j * V + e] = 0.0f;
      }
    }
    if (valid == 0) break;  // later batches of this thread are empty too
    // Two passes over the values in registers, four interleaved sums each.
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BATCH; ++j) s[j & 3] += vals[j];
    const float sum = (s[0] + s[1]) + (s[2] + s[3]);
    const float count = static_cast<float>(valid * V);
    const float mean = valid == LOADS ? sum * (1.0f / BATCH) : sum / count;
    float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = vals[j * V + e] - mean;
        if (j < valid) q[(j * V + e) & 3] = fmaf(d, d, q[(j * V + e) & 3]);
      }
    }
    chan(acc, Stat{count, mean, (q[0] + q[1]) + (q[2] + q[3])});
  }

  // Block merge: a shuffle tree in each warp, then across warps.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Stat other = shfl_down(acc, o);
    if (lane < o) chan(acc, other);
  }
  if (lane == 0) warp_stat[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < WARPS ? warp_stat[lane] : Stat{0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int o = WARPS / 2; o > 0; o >>= 1) {
      const Stat other = shfl_down(acc, o);
      if (lane < o) chan(acc, other);
    }
  }

  if (args.slices > 1) {
    // Publish this slice's partial; the last block of the span merges them.
    if (tid == 0) {
      float* out = args.part + (span_id * (long long)args.slices + slice) * 3;
      out[0] = acc.n;
      out[1] = acc.mean;
      out[2] = acc.m2;
      __threadfence();
      const int prev = atomicAdd(args.tickets + span_id, 1);
      is_last = prev == args.slices - 1;
      if (is_last) args.tickets[span_id] = 0;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const float* part = args.part + span_id * (long long)args.slices * 3;
    for (int s = tid; s < args.slices; s += THREADS) {
      slice_stat[s] = Stat{__ldcg(part + 3 * s), __ldcg(part + 3 * s + 1),
                           __ldcg(part + 3 * s + 2)};
    }
    __syncthreads();
    if (tid == 0) {
      acc = slice_stat[0];
      for (int s = 1; s < args.slices; ++s) chan(acc, slice_stat[s]);
    }
  }

  if (tid == 0) {
    const float mean = acc.mean;
    const float var = acc.m2 / acc.n;
    if (args.weight == nullptr) {
      args.out_mean[span_id] = mean;
      args.out_a[span_id] = var;
    }
    s_mean = mean;
    s_rstd = rsqrtf(var + args.eps);
  }
  if (args.weight == nullptr) return;
  __syncthreads();

  const int n = span_id / args.groups;
  const int g = span_id - n * args.groups;
  const float mean = s_mean, rstd = s_rstd;
  for (int c = tid; c < args.cpg; c += THREADS) {
    const int ch = g * args.cpg + c;
    float a = __fmul_rn(rstd, args.weight[ch]);
    float b = args.bias[ch];
    if (args.film_a != nullptr) {
      const long long f = n * args.film_ld + ch;
      const float s = __fadd_rn(load_film(args.film_a, args.film_bf16, f), 1.0f);
      a = __fmul_rn(a, s);
      b = __fadd_rn(__fmul_rn(b, s), load_film(args.film_b, args.film_bf16, f));
    }
    const long long o = n * args.out_ld + ch;
    args.out_mean[o] = mean;
    args.out_a[o] = a;
    args.out_b[o] = b;
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, int blocks, const Args& args, cudaStream_t stream) {
  group_norm_stats_kernel<T, V><<<blocks, THREADS, 0, stream>>>(static_cast<const T*>(x), args);
  return cudaGetLastError();
}

}  // namespace

extern "C" int group_norm_stats_tile() { return TILE; }
extern "C" int group_norm_stats_max_slices() { return MAX_SLICES; }

// x [N, C, T] contiguous, float32 (dtype 0) or bfloat16 (dtype 1); `vec`
// selects 16-byte loads (x 16-byte aligned, span and chunk multiples of 8).
// Spans = N * groups, each split into `slices` slices of `chunk` elements;
// `part` holds spans * slices * 3 floats when slices > 1, `tickets` spans
// zeroed ints. With `weight` (and `bias`, [C] float32): writes the folded
// (mean, a, b) of channel c of sample n at n * out_ld + c, FiLM optional
// (film_dtype as dtype, row stride film_ld). Without: writes mean and var
// [N * groups] to out_mean and out_a. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int group_norm_stats(int dtype, const void* x, int n, int c, int t, int groups,
                                int slices, long long chunk, int vec, float* part,
                                int* tickets, const float* weight, const float* bias,
                                float eps, const void* film_a, const void* film_b,
                                int film_dtype, long long film_ld, float* out_mean,
                                float* out_a, float* out_b, long long out_ld,
                                void* stream) {
  if (slices < 1 || slices > MAX_SLICES || groups < 1 || c % groups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cpg = c / groups;
  Args args{(long long)cpg * t, slices, chunk, groups, cpg, part, tickets, weight, bias,
            eps, film_a, film_b, film_dtype, film_ld, out_mean, out_a, out_b, out_ld};
  const int blocks = n * groups * slices;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = vec ? launch<float, 4>(x, blocks, args, s) : launch<float, 1>(x, blocks, args, s);
  } else {
    err = vec ? launch<__nv_bfloat16, 8>(x, blocks, args, s)
              : launch<__nv_bfloat16, 1>(x, blocks, args, s);
  }
  return static_cast<int>(err);
}
