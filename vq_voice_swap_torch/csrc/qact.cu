// Symmetric per-tensor int8 quantization for Hopper (sm_90a), plain C
// interface: two launches, an amax reduce that writes the scale and an
// elementwise pass that writes the codes.
//
// Replaces no Pallas kernel: the JAX package leaves
// vq_voice_swap_tpu/ops/qact.py::quantize (ops/qact.py:67-79) to XLA. It
// computes, over the whole tensor (the batch included, as JAX does),
//
//   scale = max(max |x|, 1e-12) / 127
//   q     = clip(round_half_even(x / scale), -127, 127)
//
// with an IEEE division (__fdiv_rn) and round-half-even (__float2int_rn),
// so q has JAX's bits: a reciprocal multiply, or a division that is not
// correctly rounded, would move a value that sits on a .5 boundary. The
// scale stays on the card; nothing reads it back to the host.
//
// What bounds it on the card: bytes. x is read twice (once for the amax,
// once for the codes) and q written once; a handful of operations an
// element.
//
// Design: the amax launch takes a grid-stride slice of x a block (16-byte
// loads where x allows), reduces |x| by warp shuffles and shared memory,
// and writes one partial a block; the last block to finish (a ticket:
// __threadfence + atomicAdd, reset by that block, ops/tickets.py) reduces
// the partials and writes the scale. Max is exact in any order, so the
// scale has the same bits however the blocks run. The code launch reads the
// scale and x (16-byte loads) and writes 4 or 8 codes a store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1024;  // amax partials

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// V values starting at element i * V of p, as float.
template <typename T, int V>
__device__ __forceinline__ void load_values(const T* p, long long i, float* out);

template <>
__device__ __forceinline__ void load_values<float, 4>(const float* p, long long i, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

template <>
__device__ __forceinline__ void load_values<__nv_bfloat16, 8>(const __nv_bfloat16* p,
                                                              long long i, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
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
__device__ __forceinline__ void load_values<__nv_bfloat16, 1>(const __nv_bfloat16* p,
                                                              long long i, float* out) {
  out[0] = __bfloat162float(p[i]);
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS) amax_kernel(const T* __restrict__ x, long long nvec,
                                                       float* part, int* ticket,
                                                       float* scale) {
  __shared__ float warp_max[THREADS / 32];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float m = 0.0f;
  for (long long i = (long long)blockIdx.x * THREADS + tid; i < nvec;
       i += (long long)gridDim.x * THREADS) {
    float v[V];
    load_values<T, V>(x, i, v);
#pragma unroll
    for (int e = 0; e < V; ++e) m = fmaxf(m, fabsf(v[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, o));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
    part[blockIdx.x] = m;
    __threadfence();
    const int prev = atomicAdd(ticket, 1);
    is_last = prev == (int)gridDim.x - 1;
    if (is_last) *ticket = 0;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  m = 0.0f;
  for (int b = tid; b < (int)gridDim.x; b += THREADS) m = fmaxf(m, __ldcg(part + b));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, o));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
    *scale = __fdiv_rn(fmaxf(m, 1e-12f), 127.0f);
  }
}

__device__ __forceinline__ int8_t code(float x, float s) {
  const int r = __float2int_rn(__fdiv_rn(x, s));
  return static_cast<int8_t>(max(-127, min(127, r)));
}

template <int V> struct Codes;
template <> struct Codes<1> { using type = int8_t; };
template <> struct Codes<4> { using type = uint32_t; };
template <> struct Codes<8> { using type = uint2; };

template <int V>
__device__ __forceinline__ void store_codes(int8_t* q, long long i, const int8_t (&c)[V]) {
  *(reinterpret_cast<typename Codes<V>::type*>(q) + i) =
      *reinterpret_cast<const typename Codes<V>::type*>(c);
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS) quantize_kernel(const T* __restrict__ x,
                                                           long long nvec,
                                                           const float* scale, int8_t* q) {
  const float s = *scale;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < nvec;
       i += (long long)gridDim.x * THREADS) {
    float v[V];
    load_values<T, V>(x, i, v);
    alignas(V) int8_t c[V];
#pragma unroll
    for (int e = 0; e < V; ++e) c[e] = code(v[e], s);
    store_codes<V>(q, i, c);
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, long long n, int amax_blocks, int code_blocks, float* part,
                   int* ticket, float* scale, void* q, cudaStream_t stream) {
  const long long nvec = n / V;
  const T* xt = static_cast<const T*>(x);
  amax_kernel<T, V><<<amax_blocks, THREADS, 0, stream>>>(xt, nvec, part, ticket, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quantize_kernel<T, V><<<code_blocks, THREADS, 0, stream>>>(xt, nvec, scale,
                                                             static_cast<int8_t*>(q));
  return cudaGetLastError();
}

}  // namespace

extern "C" int qact_max_blocks() { return MAX_BLOCKS; }

// x: n contiguous float32 (dtype 0) or bfloat16 (1) values; `vec` selects
// 16-byte loads (x 16-byte aligned, q 8-byte aligned, n a multiple of 4 or
// 8). part: amax_blocks floats; ticket: one zeroed int; scale: one float;
// q: n int8. Two launches on `stream`; returns a CUDA error code (0 on
// success).
extern "C" int qact_quantize(int dtype, const void* x, long long n, int vec, int amax_blocks,
                             int code_blocks, float* part, int* ticket, float* scale, void* q,
                             void* stream) {
  if (amax_blocks < 1 || amax_blocks > MAX_BLOCKS || code_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = vec ? launch<float, 4>(x, n, amax_blocks, code_blocks, part, ticket, scale, q, s)
              : launch<float, 1>(x, n, amax_blocks, code_blocks, part, ticket, scale, q, s);
  } else {
    err = vec ? launch<__nv_bfloat16, 8>(x, n, amax_blocks, code_blocks, part, ticket, scale,
                                          q, s)
              : launch<__nv_bfloat16, 1>(x, n, amax_blocks, code_blocks, part, ticket, scale,
                                          q, s);
  }
  return static_cast<int>(err);
}
