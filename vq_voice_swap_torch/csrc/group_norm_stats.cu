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
// - Counts. A batch's count (at most 32), mean and M2 are float; a running
//   count is a double, exact for any span, so each merge weighs by exact
//   counts past 2^24 elements, where a float count stops being exact (at
//   4.4 minutes of 16 kHz audio at the first up level of a unet64, whose
//   groups span four channels).
// - Merge. Warps merge by shuffle, then through shared memory, in a fixed
//   tree. Each block of a multi-slice span writes its partial; the last
//   block to finish (a per-span ticket: __threadfence + atomicAdd, reset by
//   that block, so the counters need no clearing launch) merges the partials
//   in slice order. The result has the same bits from run to run, whatever
//   order the blocks run in. The wrapper gives each stream its own tickets
//   (ops/tickets.py).
// - Epilogue. The last block computes rsqrt(var + eps) and writes each
//   channel of its group, and on request the group (mean, var) that the
//   backward (csrc/group_norm_bwd.cu) takes. FiLM (ca, cb) is read in its
//   own dtype through a row stride, so the chunks of a [N, 2C] projection
//   need no copy; outputs go through a row stride, so several inputs can
//   fill the column slices of one [N, Cin] result.
// - int8 input (the int8 serving path, ops/qact.py::qact_group_norm): a
//   kernel of its own. x holds activation codes, each value code * scale[c]
//   (one float32 scale for the tensor, or one a channel after a channel
//   concat). No code is converted or scaled: each 32-bit word of a 16-byte
//   load goes into two __dp4a (the sum and the sum of squares of its four
//   codes), INT8_LOADS loads in flight a thread, and the int32 sums of one
//   pass are folded into 64-bit ones, exact for any span. With one scale
//   the span is one row; with one a channel each channel's T codes are a
//   row, summed apart (a block walks the rows of its slice in order; the
//   wrapper takes 16-byte loads there only where T is a multiple of 16, so
//   no load straddles two rows, and one code a load otherwise).
//   Integer sums are exact whatever their order, so blocks and slices add
//   them plainly; the last block takes the rows in channel order:
//     mean = sum_c s_c S1_c / n,  var = max(sum_c s_c^2 S2_c / n - mean^2, 0)
//   in double with explicit rounding (no contraction into an FMA), JAX's
//   one-pass formula (qact.py:138-142) on exact sums, so no cancellation;
//   mean and var are rounded to float once and folded as the float path's.
//   ops/group_norm.py::group_norm_coeffs_int8_plain is the same arithmetic.

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
  double n;  // an exact integer count, whatever the span
  float mean, m2;
};

// Chan's merge of b into a.
__device__ __forceinline__ void chan(Stat& a, const Stat& b) {
  if (b.n == 0.0) return;
  const double n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float r = static_cast<float>(b.n / n);
  a.mean = a.mean + d * r;
  a.m2 = a.m2 + b.m2 + d * d * static_cast<float>(a.n) * r;
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
  float* part;         // block partials (slices > 1), 16 bytes each: float
                       // [spans, slices] of the count as a double, then mean
                       // and M2; int8 [spans, rows, slices] of (S1, S2) int64
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
  float* out_group;    // coefficients only, or null: [2, N * G] group (mean, var)
  long long spans;     // N * G
  const float* scale;  // int8 input: [1] or [C] float32 dequantization scales
  int scale_stride;    //   0 (one scale) or 1 (one a channel)
  long long t;         //   T, a channel's row of codes
};

// The last block's epilogue. Thread 0 brings the span's (mean, var) and
// writes them, or, beside the coefficients, the group (mean, var) when
// out_group asks for them; then the block writes each channel's folded
// (mean, a, b). `shared` is two floats of the block's shared memory.
__device__ __forceinline__ void finish(const Args& args, int span_id, float mean, float var,
                                       float* shared) {
  if (threadIdx.x == 0) {
    if (args.weight == nullptr) {
      args.out_mean[span_id] = mean;
      args.out_a[span_id] = var;
    } else if (args.out_group != nullptr) {
      args.out_group[span_id] = mean;
      args.out_group[args.spans + span_id] = var;
    }
    shared[0] = mean;
    shared[1] = rsqrtf(var + args.eps);
  }
  if (args.weight == nullptr) return;
  __syncthreads();

  const int n = span_id / args.groups;
  const int g = span_id - n * args.groups;
  const float group_mean = shared[0], rstd = shared[1];
  for (int c = threadIdx.x; c < args.cpg; c += THREADS) {
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
    args.out_mean[o] = group_mean;
    args.out_a[o] = a;
    args.out_b[o] = b;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS, 4)
group_norm_stats_kernel(const T* __restrict__ x, Args args) {
  constexpr int LOADS = BATCH / V;
  __shared__ Stat warp_stat[WARPS];
  __shared__ Stat slice_stat[MAX_SLICES];
  __shared__ int is_last;
  __shared__ float s_finish[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span_id = blockIdx.x / args.slices;
  const int slice = blockIdx.x - span_id * args.slices;
  const long long start = slice * args.chunk;
  const long long end = min(args.span, start + args.chunk);
  const T* p = x + span_id * args.span + start;
  const long long nvec = start < end ? (end - start) / V : 0;

  Stat acc{0.0, 0.0f, 0.0f};
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
    const int count = valid * V;
    const float mean = valid == LOADS ? sum * (1.0f / BATCH) : sum / static_cast<float>(count);
    float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = vals[j * V + e] - mean;
        if (j < valid) q[(j * V + e) & 3] = fmaf(d, d, q[(j * V + e) & 3]);
      }
    }
    chan(acc, Stat{static_cast<double>(count), mean, (q[0] + q[1]) + (q[2] + q[3])});
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
    acc = lane < WARPS ? warp_stat[lane] : Stat{0.0, 0.0f, 0.0f};
#pragma unroll
    for (int o = WARPS / 2; o > 0; o >>= 1) {
      const Stat other = shfl_down(acc, o);
      if (lane < o) chan(acc, other);
    }
  }

  if (args.slices > 1) {
    // Publish this slice's partial; the last block of the span merges them.
    if (tid == 0) {
      float* out = args.part + (span_id * (long long)args.slices + slice) * 4;
      *reinterpret_cast<double*>(out) = acc.n;
      out[2] = acc.mean;
      out[3] = acc.m2;
      __threadfence();
      const int prev = atomicAdd(args.tickets + span_id, 1);
      is_last = prev == args.slices - 1;
      if (is_last) args.tickets[span_id] = 0;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const float* part = args.part + span_id * (long long)args.slices * 4;
    for (int s = tid; s < args.slices; s += THREADS) {
      slice_stat[s] = Stat{__ldcg(reinterpret_cast<const double*>(part + 4 * s)),
                           __ldcg(part + 4 * s + 2), __ldcg(part + 4 * s + 3)};
    }
    __syncthreads();
    if (tid == 0) {
      acc = slice_stat[0];
      for (int s = 1; s < args.slices; ++s) chan(acc, slice_stat[s]);
    }
  }

  finish(args, span_id, acc.mean, acc.m2 / static_cast<float>(acc.n), s_finish);
}

// ------------------------------------------------------------------- int8

constexpr int INT8_LOADS = 8;  // 16-byte loads a thread issues before it sums any
constexpr int INT8_BYTE_LOADS = 32;  // the same, one code a load

// This thread's share of the sums of the n codes at p: s1 += sum q,
// s2 += sum q^2. V = 16: p 16-byte aligned and n a multiple of 16, two
// __dp4a a 32-bit word; V = 1: one code a load. A pass's int32 sums (at
// most 128 codes: |a1| <= 127 * 128, a2 <= 16129 * 128) go into the 64-bit
// ones before the next pass.
template <int V>
__device__ __forceinline__ void sum_codes(const int8_t* p, long long n, long long& s1,
                                          long long& s2);

template <>
__device__ __forceinline__ void sum_codes<16>(const int8_t* p, long long n, long long& s1,
                                              long long& s2) {
  const int4* p4 = reinterpret_cast<const int4*>(p);
  const long long nvec = n / 16;
  for (long long v0 = threadIdx.x; v0 < nvec; v0 += (long long)THREADS * INT8_LOADS) {
    int4 q[INT8_LOADS];
#pragma unroll
    for (int j = 0; j < INT8_LOADS; ++j) {
      const long long v = v0 + j * THREADS;
      q[j] = v < nvec ? __ldg(p4 + v) : make_int4(0, 0, 0, 0);
    }
    int a1 = 0, a2 = 0;
#pragma unroll
    for (int j = 0; j < INT8_LOADS; ++j) {
      const int w[4] = {q[j].x, q[j].y, q[j].z, q[j].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a1 = __dp4a(w[k], 0x01010101, a1);
        a2 = __dp4a(w[k], w[k], a2);
      }
    }
    s1 += a1;
    s2 += a2;
  }
}

template <>
__device__ __forceinline__ void sum_codes<1>(const int8_t* p, long long n, long long& s1,
                                             long long& s2) {
  for (long long v0 = threadIdx.x; v0 < n; v0 += (long long)THREADS * INT8_BYTE_LOADS) {
    int q[INT8_BYTE_LOADS];
#pragma unroll
    for (int j = 0; j < INT8_BYTE_LOADS; ++j) {
      const long long v = v0 + j * THREADS;
      q[j] = v < n ? __ldg(p + v) : 0;
    }
    int a1 = 0, a2 = 0;
#pragma unroll
    for (int j = 0; j < INT8_BYTE_LOADS; ++j) {
      a1 += q[j];
      a2 += q[j] * q[j];
    }
    s1 += a1;
    s2 += a2;
  }
}

__device__ __forceinline__ void warp_sum(long long& s1, long long& s2, int width = 32) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, o);
    s2 += __shfl_down_sync(0xffffffffu, s2, o);
  }
}

// The block's sums of (s1, s2), in thread 0's. buf: 2 * WARPS of the
// block's shared memory, which the block must not write again before its
// next __syncthreads.
__device__ __forceinline__ void block_sum(long long& s1, long long& s2, long long* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_sum(s1, s2);
  if (lane == 0) {
    buf[warp] = s1;
    buf[WARPS + warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = lane < WARPS ? buf[lane] : 0;
    s2 = lane < WARPS ? buf[WARPS + lane] : 0;
    warp_sum(s1, s2, WARPS);
  }
}

// m1 += s S1 and m2 += s^2 S2 in double, each step rounded as written (no
// FMA): group_norm_coeffs_int8_plain's arithmetic, step for step.
__device__ __forceinline__ void add_row(double& m1, double& m2, float scale, long long s1,
                                        long long s2) {
  const double s = scale;
  m1 = __dadd_rn(m1, __dmul_rn(s, __ll2double_rn(s1)));
  m2 = __dadd_rn(m2, __dmul_rn(__dmul_rn(s, s), __ll2double_rn(s2)));
}

template <int V>
__global__ void __launch_bounds__(THREADS, 4)
group_norm_stats_int8_kernel(const int8_t* __restrict__ x, Args args) {
  __shared__ long long row_buf[2][2 * WARPS];  // block_sum's, by row parity
  __shared__ int is_last;
  __shared__ float s_finish[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span_id = blockIdx.x / args.slices;
  const int slice = blockIdx.x - span_id * args.slices;
  const long long start = slice * args.chunk;
  const long long end = min(args.span, start + args.chunk);
  const int8_t* p = x + span_id * args.span;
  // One scale: the span is one row. One a channel: each channel's T codes.
  const int rows = args.scale_stride ? args.cpg : 1;
  const long long row_len = args.scale_stride ? args.t : args.span;
  const float* scale = args.scale + (span_id % args.groups) * args.cpg * args.scale_stride;
  // This span's [rows, slices] partials (S1, S2): each slice's share of a row.
  long long* part =
      reinterpret_cast<long long*>(args.part) + span_id * (long long)rows * args.slices * 2;

  double m1 = 0.0, m2 = 0.0;  // thread 0: sum_c s_c S1_c and sum_c s_c^2 S2_c
  if (start < end) {
    const int last = static_cast<int>((end - 1) / row_len);
    for (int r = static_cast<int>(start / row_len), k = 0; r <= last; ++r, ++k) {
      const long long lo = max(start, r * row_len), hi = min(end, (r + 1) * row_len);
      long long s1 = 0, s2 = 0;
      sum_codes<V>(p + lo, hi - lo, s1, s2);
      block_sum(s1, s2, row_buf[k & 1]);
      if (tid == 0) {
        if (args.slices > 1) {
          long long* e = part + ((long long)r * args.slices + slice) * 2;
          e[0] = s1;
          e[1] = s2;
        } else {
          add_row(m1, m2, scale[r], s1, s2);
        }
      }
    }
  }

  if (args.slices > 1) {
    // Publish this slice's partials; the last block of the span adds them.
    if (tid == 0) {
      __threadfence();
      const int prev = atomicAdd(args.tickets + span_id, 1);
      is_last = prev == args.slices - 1;
      if (is_last) args.tickets[span_id] = 0;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // A warp a row: its total over the slices that hold a share of it,
    // written over the first one's partial; then thread 0 takes the rows
    // in channel order.
    for (int r = warp; r < rows; r += WARPS) {
      const int first = static_cast<int>(r * row_len / args.chunk);
      const int last = static_cast<int>(
          min((long long)args.slices - 1, ((r + 1) * row_len - 1) / args.chunk));
      long long s1 = 0, s2 = 0;
      for (int s = first + lane; s <= last; s += 32) {
        const long long* e = part + ((long long)r * args.slices + s) * 2;
        s1 += __ldcg(e);
        s2 += __ldcg(e + 1);
      }
      warp_sum(s1, s2);
      if (lane == 0) {
        long long* e = part + ((long long)r * args.slices + first) * 2;
        __stcg(e, s1);
        __stcg(e + 1, s2);
      }
    }
    __syncthreads();
    if (tid == 0) {
      for (int r = 0; r < rows; ++r) {
        const long long* e = part + ((long long)r * args.slices + r * row_len / args.chunk) * 2;
        add_row(m1, m2, scale[r], __ldcg(e), __ldcg(e + 1));
      }
    }
  }

  // JAX's one-pass formula on the exact sums, in double; one rounding to float.
  float mean = 0.0f, var = 0.0f;
  if (tid == 0) {
    const double n = static_cast<double>(args.span);
    const double mu = __ddiv_rn(m1, n);
    const double v = __dsub_rn(__ddiv_rn(m2, n), __dmul_rn(mu, mu));
    mean = __double2float_rn(mu);
    var = __double2float_rn(v > 0.0 ? v : 0.0);
  }
  finish(args, span_id, mean, var, s_finish);
}

template <typename T, int V>
cudaError_t launch(const void* x, int blocks, const Args& args, cudaStream_t stream) {
  group_norm_stats_kernel<T, V><<<blocks, THREADS, 0, stream>>>(static_cast<const T*>(x), args);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_int8(const void* x, int blocks, const Args& args, cudaStream_t stream) {
  group_norm_stats_int8_kernel<V>
      <<<blocks, THREADS, 0, stream>>>(static_cast<const int8_t*>(x), args);
  return cudaGetLastError();
}

}  // namespace

extern "C" int group_norm_stats_tile() { return TILE; }
extern "C" int group_norm_stats_max_slices() { return MAX_SLICES; }

// x [N, C, T] contiguous, float32 (dtype 0), bfloat16 (dtype 1) or int8
// codes (dtype 2, each value code * scale[c * scale_stride], scale float32
// and scale_stride 0 or 1); `vec` selects 16-byte loads (x 16-byte aligned,
// span and chunk multiples of 8; for int8 chunk a multiple of 16, and the
// span with one scale, T with one a channel).
// Spans = N * groups, each split into `slices` slices of `chunk` elements;
// when slices > 1, `part` holds spans * slices * 4 floats, 8-byte aligned
// (int8 with one scale a channel: spans * C/G * slices * 4), `tickets` spans
// zeroed ints. With `weight` (and `bias`, [C] float32): writes the folded
// (mean, a, b) of channel c of sample n at n * out_ld + c, FiLM optional
// (film_dtype as dtype, row stride film_ld), and, when `out_group` is not
// null, the group mean and var as [2, N * groups] there (the backward's
// statistics). Without: writes mean and var [N * groups] to out_mean and
// out_a. Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int group_norm_stats(int dtype, const void* x, int n, int c, int t, int groups,
                                int slices, long long chunk, int vec, float* part,
                                int* tickets, const float* weight, const float* bias,
                                float eps, const void* film_a, const void* film_b,
                                int film_dtype, long long film_ld, float* out_mean,
                                float* out_a, float* out_b, long long out_ld,
                                float* out_group, const float* scale, int scale_stride,
                                void* stream) {
  if (slices < 1 || slices > MAX_SLICES || groups < 1 || c % groups ||
      (dtype == 2 && scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cpg = c / groups;
  Args args{(long long)cpg * t, slices, chunk, groups, cpg, part, tickets, weight, bias,
            eps, film_a, film_b, film_dtype, film_ld, out_mean, out_a, out_b, out_ld,
            out_group, (long long)n * groups, scale, scale_stride, t};
  const int blocks = n * groups * slices;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = vec ? launch<float, 4>(x, blocks, args, s) : launch<float, 1>(x, blocks, args, s);
  } else if (dtype == 1) {
    err = vec ? launch<__nv_bfloat16, 8>(x, blocks, args, s)
              : launch<__nv_bfloat16, 1>(x, blocks, args, s);
  } else {
    err = vec ? launch_int8<16>(x, blocks, args, s) : launch_int8<1>(x, blocks, args, s);
  }
  return static_cast<int>(err);
}
