// Fused same-resolution ResBlock for Hopper (sm_90a), plain C interface.
//
// Replaces attic/fused_resblock.py::_stats_kernel and ::_apply_kernel (the
// TPU pair behind packed_unet_predict(fuse_levels=K)). For x [N, Cin, T]
// (or two inputs whose channel concat is Cin, never materialised) the pair
// computes models/layers.py::ResBlock with scale_factor 1.0:
//
//   g   = gelu((x - mean1) * a1 + b1), zero outside [0, T), in the dtype
//   h1  = conv3(g, w_in) + b_in, rounded to the dtype
//   z   = gelu((h1 - mean2) * a2 + b2), zero outside [0, T), in the dtype
//   out = conv3_dilated(z, w_out) + b_out + skip,  skip = x or 1x1(x)
//
// (mean1, a1, b1) fold GroupNorm-1 and come from the caller; (mean2, a2, b2)
// fold GroupNorm-2 and the FiLM and come from the partials the stats kernel
// writes. Zero padding applies to g and z, the normalised activations, not
// to x: that is the convolution's SAME padding in the block.
//
// What bounds it on the card: operations. conv_in runs twice (once in each
// kernel, so h1 never reaches device memory) and conv_out once, 3 * 3 *
// Cin * Cout * 2 flops per position at Cin = Cout (73.7 kFLOP at 64
// channels) against x read twice and the output written once. On the CUDA
// cores' 67 TFLOP/s float32 rate that is ~14x the time of the bytes.
//
// Design: simple and exact first. A block owns one (n, tile of positions)
// and 256 threads, each holding a 4-channel x 8-position register tile of
// float32 sums (64 output channels x 128 positions per pass; wider outputs
// loop over 64-channel passes). Input channels stream through shared memory
// in stages of 32: the stage of g is built from x as it is loaded (norm,
// GELU, edge mask, rounding), next to the stage of weights, so the widest
// conv_in (192 channels, 147 KB of f32 weights) never has to fit at once.
// Every product is a float32 FMA on the CUDA cores: products of bf16 values
// are exact in float32, so one design serves both dtypes. The halo columns
// are read straight from [N, C, T] (no strips tensor), and the ragged last
// tile is masked. The apply kernel keeps z for all output channels of its
// window in shared memory (dynamic, up to 256 channels) and recomputes h1 over
// a window of 128 positions: 114 outputs plus a halo of up to 7 on each side
// for the dilated conv_out. GroupNorm-2 partials are two-pass within a tile
// (count, mean, M2) and merge with Chan's formula in the caller: no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int TG = 16;                 // thread groups along positions
constexpr int RC = 4;                  // output channels per thread
constexpr int RT = 8;                  // positions per thread (stride TG)
constexpr int CO_PASS = (THREADS / TG) * RC;   // 64 output channels a pass
constexpr int POS = TG * RT;           // 128 positions a pass
constexpr int CK = 32;                 // input channels per stage
constexpr int MAX_DIL = 7;             // largest conv_out dilation
constexpr int HALO = MAX_DIL + 1;      // x halo of the apply kernel
constexpr int STATS_TILE = POS;                  // 128 outputs per block
constexpr int APPLY_TILE = POS - 2 * MAX_DIL;    // 114 outputs per block
constexpr int GW = POS + 2;            // g columns for POS conv_in outputs
constexpr int GW_PAD = 132;            // row stride of the g stage
constexpr int ZW = POS + 2 * MAX_DIL + 2;  // 144: z row, read past POS
constexpr int MAX_COUT = 256;          // z rows the apply kernel can hold
constexpr int STAGE_FLOATS = CK * GW_PAD + 3 * CK * CO_PASS;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round a float32 value to the compute dtype and back.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

__device__ __forceinline__ float gelu(float y) {
  return 0.5f * y * (1.0f + erff(y * 0.70710678118654752f));
}

// Channel c of the (possibly two-input) concat at sample n: row pointer.
template <typename T>
__device__ __forceinline__ const T* channel_row(const T* x1, const T* x2,
                                                int c1, int c2, int n, int c,
                                                int T_len) {
  return c < c1 ? x1 + ((size_t)n * c1 + c) * T_len
                : x2 + ((size_t)n * c2 + (c - c1)) * T_len;
}

// Stage g for input channels [ci0, ci0 + CK) at positions [p0, p0 + GW):
// gelu(norm1(x)) rounded to the dtype, 0 outside [0, T) and past Cin.
template <typename T>
__device__ void load_g(float* gs, const T* x1, const T* x2, int c1, int c2,
                       const float* mean1, const float* a1, const float* b1,
                       int n, int ci0, int p0, int T_len) {
  const int cin = c1 + c2;
  for (int l = threadIdx.x; l < CK * GW; l += THREADS) {
    const int row = l / GW, j = l % GW;
    const int ci = ci0 + row, pos = p0 + j;
    float g = 0.0f;
    if (ci < cin && pos >= 0 && pos < T_len) {
      const float xv = to_f32<T>(channel_row(x1, x2, c1, c2, n, ci, T_len)[pos]);
      const size_t k = (size_t)n * cin + ci;
      g = round_to<T>(gelu((xv - mean1[k]) * a1[k] + b1[k]));
    }
    gs[row * GW_PAD + j] = g;
  }
}

// Stage x itself (the skip projection's input) at positions [p0, p0 + POS).
template <typename T>
__device__ void load_x(float* gs, const T* x1, const T* x2, int c1, int c2,
                       int n, int ci0, int p0, int T_len) {
  const int cin = c1 + c2;
  for (int l = threadIdx.x; l < CK * POS; l += THREADS) {
    const int row = l / POS, j = l % POS;
    const int ci = ci0 + row, pos = p0 + j;
    float v = 0.0f;
    if (ci < cin && pos < T_len)
      v = to_f32<T>(channel_row(x1, x2, c1, c2, n, ci, T_len)[pos]);
    gs[row * GW_PAD + j] = v;
  }
}

// Stage weights w [taps, cin, cout] for input channels [ci0, ci0 + CK) and
// output channels [co0, co0 + CO_PASS) as ws[tap][ci][co], 0 outside.
__device__ void load_w(float* ws, const float* w, int taps, int cin, int cout,
                       int ci0, int co0) {
  for (int l = threadIdx.x; l < taps * CK * CO_PASS; l += THREADS) {
    const int co = l % CO_PASS, rest = l / CO_PASS;
    const int ci = rest % CK, tap = rest / CK;
    const int gci = ci0 + ci, gco = co0 + co;
    ws[l] = (gci < cin && gco < cout) ? w[((size_t)tap * cin + gci) * cout + gco]
                                      : 0.0f;
  }
}

// acc[c][r] += sum over ci < nci, tap < taps of
//   ws[tap][ci][cg*RC + c] * src[ci * stride + off + tap * step + tg + TG*r]
__device__ __forceinline__ void accumulate(float (&acc)[RC][RT],
                                           const float* src, int stride,
                                           int off, int step, const float* ws,
                                           int nci, int taps) {
  const int tg = threadIdx.x % TG, cg = threadIdx.x / TG;
  for (int ci = 0; ci < nci; ++ci) {
    for (int tap = 0; tap < taps; ++tap) {
      const float4 wv =
          *reinterpret_cast<const float4*>(ws + (tap * CK + ci) * CO_PASS + cg * RC);
      const float* s = src + ci * stride + off + tap * step + tg;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float v = s[TG * r];
        acc[0][r] = fmaf(wv.x, v, acc[0][r]);
        acc[1][r] = fmaf(wv.y, v, acc[1][r]);
        acc[2][r] = fmaf(wv.z, v, acc[2][r]);
        acc[3][r] = fmaf(wv.w, v, acc[3][r]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[RC][RT]) {
#pragma unroll
  for (int c = 0; c < RC; ++c)
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[c][r] = 0.0f;
}

// acc = conv_in(g) over POS outputs whose first position is p0 + 1, for
// output channels [co0, co0 + CO_PASS); g is staged from position p0.
template <typename T>
__device__ void conv_in_pass(float (&acc)[RC][RT], float* gs, float* ws,
                             const T* x1, const T* x2, int c1, int c2,
                             const float* mean1, const float* a1,
                             const float* b1, const float* w_in, int cout,
                             int n, int co0, int p0, int T_len) {
  const int cin = c1 + c2;
  zero(acc);
  for (int ci0 = 0; ci0 < cin; ci0 += CK) {
    __syncthreads();
    load_g<T>(gs, x1, x2, c1, c2, mean1, a1, b1, n, ci0, p0, T_len);
    load_w(ws, w_in, 3, cin, cout, ci0, co0);
    __syncthreads();
    accumulate(acc, gs, GW_PAD, 0, 1, ws, min(CK, cin - ci0), 3);
  }
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int m = TG / 2; m > 0; m /= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Kernel 4: GroupNorm-2 partials of h1 = conv_in(g) per (n, channel, tile).
template <typename T>
__global__ void __launch_bounds__(THREADS)
resblock_stats_kernel(const T* __restrict__ x1, const T* __restrict__ x2, int c1, int c2,
             const float* __restrict__ mean1, const float* __restrict__ a1,
             const float* __restrict__ b1, const float* __restrict__ w_in,
             const float* __restrict__ b_in, float* __restrict__ part, int N,
             int T_len, int cout) {
  extern __shared__ float smem[];
  float* gs = smem;
  float* ws = gs + CK * GW_PAD;
  const int n = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int t0 = tile * STATS_TILE;
  const int tg = threadIdx.x % TG, cg = threadIdx.x / TG;
  const int valid = min(STATS_TILE, T_len - t0);
  const size_t plane = (size_t)N * cout * tiles;

  for (int co0 = 0; co0 < cout; co0 += CO_PASS) {
    float acc[RC][RT];
    conv_in_pass<T>(acc, gs, ws, x1, x2, c1, c2, mean1, a1, b1, w_in, cout, n,
                    co0, t0 - 1, T_len);
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int co = co0 + cg * RC + c;
      const float bias = co < cout ? b_in[co] : 0.0f;
      float h[RT];
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        h[r] = round_to<T>(acc[c][r] + bias);
        if (tg + TG * r < valid) sum += h[r];
      }
      const float mean = half_warp_sum(sum) / valid;
      float m2 = 0.0f;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float dv = h[r] - mean;
        if (tg + TG * r < valid) m2 = fmaf(dv, dv, m2);
      }
      m2 = half_warp_sum(m2);
      if (tg == 0 && co < cout) {
        const size_t k = ((size_t)n * cout + co) * tiles + tile;
        part[k] = (float)valid;
        part[plane + k] = mean;
        part[2 * plane + k] = m2;
      }
    }
  }
}

// Kernel 5: recompute h1 over the tile and its halo, apply GroupNorm-2 +
// FiLM + GELU into z, then out = conv_out(z) + b_out + skip.
template <typename T>
__global__ void __launch_bounds__(THREADS)
resblock_apply_kernel(const T* __restrict__ x1, const T* __restrict__ x2, int c1, int c2,
             const float* __restrict__ mean1, const float* __restrict__ a1,
             const float* __restrict__ b1, const float* __restrict__ w_in,
             const float* __restrict__ b_in, const float* __restrict__ mean2,
             const float* __restrict__ a2, const float* __restrict__ b2,
             const float* __restrict__ w_out, const float* __restrict__ b_out,
             const float* __restrict__ w_skip, const float* __restrict__ b_skip,
             T* __restrict__ out, int T_len, int cout, int dil) {
  extern __shared__ float smem[];
  float* gs = smem;
  float* ws = gs + CK * GW_PAD;
  float* zs = ws + 3 * CK * CO_PASS;  // [cout][ZW]: z at t0 - MAX_DIL + i
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * APPLY_TILE;
  const int tg = threadIdx.x % TG, cg = threadIdx.x / TG;
  const int cin = c1 + c2;

  for (int co0 = 0; co0 < cout; co0 += CO_PASS) {
    float acc[RC][RT];
    conv_in_pass<T>(acc, gs, ws, x1, x2, c1, c2, mean1, a1, b1, w_in, cout, n,
                    co0, t0 - HALO, T_len);
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int co = co0 + cg * RC + c;
      if (co >= cout) continue;
      const size_t k = (size_t)n * cout + co;
      const float m = mean2[k], a = a2[k], b = b2[k], bias = b_in[co];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = tg + TG * r;
        const int pos = t0 - MAX_DIL + i;
        const float h = round_to<T>(acc[c][r] + bias);
        zs[co * ZW + i] =
            (pos >= 0 && pos < T_len) ? round_to<T>(gelu((h - m) * a + b)) : 0.0f;
      }
    }
  }
  // Columns past POS only feed outputs past APPLY_TILE, which are not stored.
  for (int l = threadIdx.x; l < cout * (ZW - POS); l += THREADS)
    zs[(l / (ZW - POS)) * ZW + POS + l % (ZW - POS)] = 0.0f;

  for (int co0 = 0; co0 < cout; co0 += CO_PASS) {
    float acc[RC][RT];
    zero(acc);
    for (int ci0 = 0; ci0 < cout; ci0 += CK) {
      __syncthreads();
      load_w(ws, w_out, 3, cout, cout, ci0, co0);
      __syncthreads();
      accumulate(acc, zs + ci0 * ZW, ZW, MAX_DIL - dil, dil, ws,
                 min(CK, cout - ci0), 3);
    }
    if (w_skip != nullptr) {
      for (int ci0 = 0; ci0 < cin; ci0 += CK) {
        __syncthreads();
        load_x<T>(gs, x1, x2, c1, c2, n, ci0, t0, T_len);
        load_w(ws, w_skip, 1, cin, cout, ci0, co0);
        __syncthreads();
        accumulate(acc, gs, GW_PAD, 0, 0, ws, min(CK, cin - ci0), 1);
      }
    }
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int co = co0 + cg * RC + c;
      if (co >= cout) continue;
      const float bias = b_out[co] + (w_skip != nullptr ? b_skip[co] : 0.0f);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = tg + TG * r;
        const int t = t0 + i;
        if (i >= APPLY_TILE || t >= T_len) continue;
        float v = acc[c][r] + bias;
        if (w_skip == nullptr)
          v += to_f32<T>(channel_row(x1, x2, c1, c2, n, co, T_len)[t]);
        out[((size_t)n * cout + co) * T_len + t] = from_f32<T>(v);
      }
    }
  }
}

constexpr size_t kStatsSmem = sizeof(float) * STAGE_FLOATS;

size_t apply_smem(int cout) { return sizeof(float) * (STAGE_FLOATS + (size_t)cout * ZW); }

template <typename T>
int launch_stats(const void* x1, const void* x2, int c1, int c2,
                 const float* mean1, const float* a1, const float* b1,
                 const float* w_in, const float* b_in, float* part, int N,
                 int T_len, int cout, cudaStream_t stream) {
  const dim3 grid((T_len + STATS_TILE - 1) / STATS_TILE, N);
  cudaFuncSetAttribute(resblock_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kStatsSmem);
  resblock_stats_kernel<T><<<grid, THREADS, kStatsSmem, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2), c1, c2, mean1, a1, b1,
      w_in, b_in, part, N, T_len, cout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply(const void* x1, const void* x2, int c1, int c2,
                 const float* mean1, const float* a1, const float* b1,
                 const float* w_in, const float* b_in, const float* mean2,
                 const float* a2, const float* b2, const float* w_out,
                 const float* b_out, const float* w_skip, const float* b_skip,
                 void* out, int N, int T_len, int cout, int dil,
                 cudaStream_t stream) {
  const dim3 grid((T_len + APPLY_TILE - 1) / APPLY_TILE, N);
  const size_t smem = apply_smem(cout);
  cudaFuncSetAttribute(resblock_apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  resblock_apply_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2), c1, c2, mean1, a1, b1,
      w_in, b_in, mean2, a2, b2, w_out, b_out, w_skip, b_skip,
      static_cast<T*>(out), T_len, cout, dil);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tile sizes and limits, read by the Python wrapper so the two never drift.
extern "C" int fused_resblock_stats_tile() { return STATS_TILE; }
extern "C" int fused_resblock_max_dilation() { return MAX_DIL; }
extern "C" int fused_resblock_max_cout() { return MAX_COUT; }

// x1 [N, c1, T] and x2 [N, c2, T] (x2 may be null with c2 = 0) of one dtype
// (0 = float32, 1 = bfloat16), contiguous. mean1/a1/b1 [N, c1 + c2], w_in
// [3, c1 + c2, cout], b_in [cout]: float32 (weights already rounded to the
// dtype). Writes part [3, N, cout, tiles] = (count, mean, M2) of h1 per
// (n, channel, tile of 128 positions). Returns cudaGetLastError().
extern "C" int fused_resblock_stats(int dtype, const void* x1, const void* x2,
                                    int c1, int c2, const float* mean1,
                                    const float* a1, const float* b1,
                                    const float* w_in, const float* b_in,
                                    float* part, int N, int T_len, int cout,
                                    void* stream) {
  if (N == 0 || T_len == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_stats<__nv_bfloat16>(x1, x2, c1, c2, mean1, a1, b1, w_in, b_in,
                                       part, N, T_len, cout, s);
  return launch_stats<float>(x1, x2, c1, c2, mean1, a1, b1, w_in, b_in, part, N,
                             T_len, cout, s);
}

// As above, plus mean2/a2/b2 [N, cout] (GroupNorm-2 and FiLM folded),
// w_out [3, cout, cout], b_out [cout], and w_skip [c1 + c2, cout] with
// b_skip [cout], or both null for the identity skip (c1 + c2 == cout).
// out [N, cout, T] in the dtype; dil <= 7, cout <= 256.
extern "C" int fused_resblock_apply(int dtype, const void* x1, const void* x2,
                                    int c1, int c2, const float* mean1,
                                    const float* a1, const float* b1,
                                    const float* w_in, const float* b_in,
                                    const float* mean2, const float* a2,
                                    const float* b2, const float* w_out,
                                    const float* b_out, const float* w_skip,
                                    const float* b_skip, void* out, int N,
                                    int T_len, int cout, int dil, void* stream) {
  if (N == 0 || T_len == 0) return 0;
  if (dil < 1 || dil > MAX_DIL || cout > MAX_COUT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_apply<__nv_bfloat16>(x1, x2, c1, c2, mean1, a1, b1, w_in, b_in,
                                       mean2, a2, b2, w_out, b_out, w_skip, b_skip,
                                       out, N, T_len, cout, dil, s);
  return launch_apply<float>(x1, x2, c1, c2, mean1, a1, b1, w_in, b_in, mean2, a2,
                             b2, w_out, b_out, w_skip, b_skip, out, N, T_len, cout,
                             dil, s);
}
