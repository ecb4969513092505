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
// What bounds it on the card: conv_in runs twice (once in each kernel, so
// h1 never reaches device memory) and conv_out once, 3 * 3 * Cin * Cout * 2
// flops per position at Cin = Cout, against x read twice and the output
// written once. On the tensor cores (989 TFLOP/s bf16, 495 TF32, three TF32
// products per float32 product here) bf16 is bound by bytes and float32 by
// operations; the GELUs (erf) of g and z run on the CUDA cores beside them.
//
// Design: each convolution is an implicit GEMM per tap on the tensor cores.
// A block owns one (n, window of 128 positions) and 8 warps; a pass computes
// 64 output channels (M, 4 x m16) by 128 positions (N) over K = input
// channels x taps, each warp a 32 x 32 tile of mma.sync accumulators.
// Activations are staged transposed, [position][channel] in the operand
// type, rows padded so fragment reads are conflict-free, so tap k's B
// operand is the same buffer offset by k * dilation rows. Weights come from
// the wrapper as [tap][co][ci] in the operand type (A, row-major) and
// stream in stages of 32 input channels through a two-deep cp.async ring
// that loads the next stage while this one is multiplied. The g stage is
// computed from x as it is loaded (norm, GELU, edge mask, rounding; 16-byte
// loads where T allows, issued into registers before the previous stage's
// MMAs) and is rebuilt for each 64-channel output pass.
//
// - bf16: mma.sync m16n8k16 bf16 with float32 accumulators, fragments by
//   ldmatrix. Products of bf16 values are exact in float32, so only the
//   summation order differs from the plain version.
// - float32: 3xTF32, mma.sync m16n8k8 tf32: each operand splits into a TF32
//   head and tail at fragment load, a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
//   in float32 accumulators; the dropped a_lo.b_lo is ~2^-21 of a product.
//
// The apply kernel keeps z for all output channels of its window in shared
// memory ([position][channel], up to 256 channels) and recomputes h1 over a
// window of 128 positions: 114 outputs plus a halo of up to 7 on each side
// for the dilated conv_out. GroupNorm-2 partials are two-pass within a tile
// (count, mean, M2) and merge with Chan's formula in the caller: no atomics,
// the same bits from run to run. Input and output channels past Cin and
// Cout are zero-filled, and the ragged last tile is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;           // 8 warps: 2 along channels x 4 along positions
constexpr int WARPS = THREADS / 32;
constexpr int CO_PASS = 64;            // output channels a pass (M)
constexpr int POS = 128;               // positions a pass (N)
constexpr int CK = 32;                 // input channels a stage (K per tap)
constexpr int MAX_DIL = 7;             // largest conv_out dilation
constexpr int HALO = MAX_DIL + 1;      // x halo of the apply kernel
constexpr int STATS_TILE = POS;                  // 128 outputs per block
constexpr int APPLY_TILE = POS - 2 * MAX_DIL;    // 114 outputs per block
constexpr int GW = POS + 2;            // g rows for POS conv_in outputs
constexpr int ZW = POS + 2 * MAX_DIL + 2;  // 144: z rows, read past POS
constexpr int MAX_COUT = 256;          // z channels the apply kernel can hold
constexpr int W_ALIGN = 8;             // weight rows padded to 8 input channels

// Shared-memory layout in elements of the operand type T. Rows of the
// activation and weight stages hold CK channels plus padding: 36 floats
// (144 B, 4 banks apart for the scalar TF32 fragment reads) or 40 bf16
// (80 B, 8 rows on 8 distinct 16-byte bank groups for ldmatrix).
template <typename T> struct Layout {
  static constexpr int PAD = sizeof(T) == 4 ? 4 : 8;
  static constexpr int LDS = CK + PAD;
  static constexpr int GS = GW * LDS;             // activation stage
  static constexpr int WS = 3 * CO_PASS * LDS;    // one weight stage
  // z row stride for cp = Cout rounded up to CO_PASS: the same padding
  // keeps z's fragment reads conflict-free.
  static __host__ __device__ int zld(int cp) { return cp + PAD; }
};

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

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b on a 16 x 8 x 16 tile, bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b on a 16 x 8 x 8 tile, TF32 inputs, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A TF32 head and tail of v, v = hi + lo to ~2^-22 of v. hi is v rounded
// to 10 mantissa bits, half away from zero (as cvt.rna.tf32.f32), by two
// integer ops that run at full rate; lo is the remainder, whose low 13 bits
// the tensor cores ignore.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// ------------------------------------------------------------ staging

// Channel c of the (possibly two-input) concat at sample n: row pointer.
template <typename T>
__device__ __forceinline__ const T* channel_row(const T* x1, const T* x2,
                                                int c1, int c2, int n, int c,
                                                int T_len) {
  return c < c1 ? x1 + ((size_t)n * c1 + c) * T_len
                : x2 + ((size_t)n * c2 + (c - c1)) * T_len;
}

// Eight elements of x, held as the 16-byte loads return them until the
// stage is stored, so the loads stay in flight across the previous stage's
// MMAs.
template <typename T> struct Vec8;
template <> struct Vec8<float> { float4 lo, hi; };
template <> struct Vec8<__nv_bfloat16> { uint4 u; };

__device__ __forceinline__ void ldg8(Vec8<float>& r, const float* p) {
  r.lo = __ldg(reinterpret_cast<const float4*>(p));
  r.hi = __ldg(reinterpret_cast<const float4*>(p + 4));
}
__device__ __forceinline__ void ldg8(Vec8<__nv_bfloat16>& r, const __nv_bfloat16* p) {
  r.u = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void unpack8(float (&v)[8], const Vec8<float>& r) {
  v[0] = r.lo.x; v[1] = r.lo.y; v[2] = r.lo.z; v[3] = r.lo.w;
  v[4] = r.hi.x; v[5] = r.hi.y; v[6] = r.hi.z; v[7] = r.hi.w;
}
__device__ __forceinline__ void unpack8(float (&v)[8], const Vec8<__nv_bfloat16>& r) {
  const uint32_t w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// The B operand staged from x: rows [0, rows) of the stage are positions
// p0 + r, column c input channel ci0 + c. G: g = gelu(norm1(x)) rounded to
// T, else x itself; 0 outside [0, T) and past Cin. Lane c takes channel
// ci0 + c in chunks of 8 positions (warp w: chunks w, w + 8, w + 16), so
// each store instruction writes one row's 32 channels. load(ci0) issues a
// stage's 16-byte global loads into registers; store(ci0) turns them into
// the stage in shared memory (chunks at the ends of [0, T), or where T or
// the rows are not 16-byte aligned, load element by element there).
template <typename T, bool G>
struct ActStage {
  static constexpr int ROUNDS = 3;  // ceil(18 chunks of 8 for GW rows / 8 warps)
  T* gs;
  const T* x1;
  const T* x2;
  int c1, c2;
  const float* mean1;
  const float* a1;
  const float* b1;
  int n, p0, rows, T_len;
  bool vec;
  // The stage in flight.
  Vec8<T> r[ROUNDS];
  const T* xr;
  float m, a, b;
  bool live;

  __device__ __forceinline__ bool whole(int pos0) const {
    return vec && pos0 >= 0 && pos0 + 8 <= T_len;
  }

  __device__ __forceinline__ void load(int ci0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int cin = c1 + c2, ci = ci0 + lane;
    live = ci < cin;
    xr = live ? channel_row(x1, x2, c1, c2, n, ci, T_len) : x1;
    m = a = b = 0.0f;
    if (G && live) {
      const size_t k = (size_t)n * cin + ci;
      m = mean1[k];
      a = a1[k];
      b = b1[k];
    }
    const int base = p0 & ~7;  // floor to a multiple of 8, negative p0 too
#pragma unroll
    for (int u = 0; u < ROUNDS; ++u) {
      const int pos0 = base + 8 * (warp + WARPS * u);
      if (live && pos0 < p0 + rows && whole(pos0)) ldg8(r[u], xr + pos0);
    }
  }

  __device__ __forceinline__ int store(int) {
    constexpr int LDS = Layout<T>::LDS;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int base = p0 & ~7;
#pragma unroll
    for (int u = 0; u < ROUNDS; ++u) {
      const int pos0 = base + 8 * (warp + WARPS * u);
      if (pos0 >= p0 + rows) continue;
      float v[8];
      if (live && whole(pos0) && pos0 >= p0 && pos0 + 8 <= p0 + rows) {
        // The common chunk: inside the window and [0, T), no masks.
        unpack8(v, r[u]);
        T* dst = gs + (pos0 - p0) * LDS + lane;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e * LDS] = from_f32<T>(G ? gelu((v[e] - m) * a + b) : v[e]);
        continue;
      }
      if (!live) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.0f;
      } else if (whole(pos0)) {
        unpack8(v, r[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int p = pos0 + e;
          v[e] = (p >= 0 && p < T_len) ? to_f32<T>(xr[p]) : 0.0f;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int row = pos0 + e - p0;
        if (row >= 0 && row < rows) {
          const int p = pos0 + e;
          float out = 0.0f;
          if (live && p >= 0 && p < T_len) out = G ? gelu((v[e] - m) * a + b) : v[e];
          gs[row * LDS + lane] = from_f32<T>(out);
        }
      }
    }
    return 0;
  }
};

// The B operand already in shared memory (z): nothing to stage.
struct InPlace {
  __device__ __forceinline__ void load(int) {}
  __device__ __forceinline__ int store(int ci0) { return ci0; }
};

// Stage weights w [TAPS][cout][ldw] for output channels [co0, co0 + 64)
// and input channels [ci0, ci0 + CK) as ws[tap][co][k] by cp.async, 0
// outside.
template <typename T, int TAPS>
__device__ __forceinline__ void stage_w(T* ws, const T* w, int cout, int ldw, int co0,
                                        int ci0) {
  constexpr int LDS = Layout<T>::LDS;
  constexpr int V = 16 / sizeof(T);    // elements per 16-byte copy
  constexpr int PER_ROW = CK / V;
  for (int q = threadIdx.x; q < TAPS * CO_PASS * PER_ROW; q += THREADS) {
    const int row = q / PER_ROW, k = (q % PER_ROW) * V;  // row = tap * 64 + co
    const int tap = row / CO_PASS, co = co0 + row % CO_PASS;
    const bool valid = co < cout && ci0 + k < ldw;
    const T* src = valid ? w + ((size_t)tap * cout + co) * ldw + ci0 + k : w;
    cp_async16(ws + row * LDS + k, src, valid);
  }
}

// ------------------------------------------------------------ MMA core

// This warp's 32 output channels x 32 positions: acc[i][j] is m16 tile i
// (channels wm*32 + i*16 + {g, g+8}) by n8 tile j (positions wn*32 + j*8 +
// {2t, 2t+1}), in the mma C-fragment layout.
using Acc = float[2][4][4];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// acc += sum over taps and the stage's CK channels k of
//   ws[tap][co][k] * bs[(row0 + tap * step + pos) * ld + col0 + k].
template <int TAPS>
__device__ __forceinline__ void mma_stage(Acc& acc, const __nv_bfloat16* bs, int ld,
                                          int row0, int step, int col0,
                                          const __nv_bfloat16* ws) {
  constexpr int LDS = Layout<__nv_bfloat16>::LDS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap) {
    const __nv_bfloat16* wa =
        ws + (tap * CO_PASS + wm * 32 + (lane & 15)) * LDS + (lane >> 4) * 8;
    const __nv_bfloat16* bb =
        bs + (size_t)(row0 + tap * step + wn * 32 + (lane >> 4) * 8 + (lane & 7)) * ld + col0 +
        ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < CK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], wa + i * 16 * LDS + kk);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4(r, bb + (size_t)jj * 16 * ld + kk);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
}

template <int TAPS>
__device__ __forceinline__ void mma_stage(Acc& acc, const float* bs, int ld, int row0,
                                          int step, int col0, const float* ws) {
  constexpr int LDS = Layout<float>::LDS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap) {
    const float* wa = ws + (tap * CO_PASS + wm * 32 + g) * LDS + t;
    const float* bb = bs + (size_t)(row0 + tap * step + wn * 32 + g) * ld + col0 + t;
#pragma unroll
    for (int kk = 0; kk < CK; kk += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = wa + i * 16 * LDS + kk;
        split(p[0], ah[i][0], al[i][0]);
        split(p[8 * LDS], ah[i][1], al[i][1]);
        split(p[4], ah[i][2], al[i][2]);
        split(p[8 * LDS + 4], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* p = bb + (size_t)j * 8 * ld + kk;
        split(p[0], bh[j][0], bl[j][0]);
        split(p[4], bh[j][1], bl[j][1]);
      }
      // The small products first, each pass over all tiles (independent MMAs).
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
    }
  }
}

// One convolution pass: acc += sum over input channels [0, kdim) and TAPS
// taps of w[tap][co][ci] * B, for output channels [co0, co0 + 64). Weight
// stages go through the two-deep cp.async ring ws[2]; the B stager's
// store(ci0) stages B for channels [ci0, ci0 + CK) (or finds it in place)
// and returns its column in bs, and its load for the next stage is issued
// before this stage's MMAs, so the global loads overlap them.
template <typename T, int TAPS, typename Stager>
__device__ __forceinline__ void conv_pass(Acc& acc, T* ws, const T* w, int cout, int kdim,
                                          int co0, const T* bs, int ld, int row0, int step,
                                          Stager& stager) {
  constexpr int WS = Layout<T>::WS;
  const int ldw = (kdim + W_ALIGN - 1) / W_ALIGN * W_ALIGN;
  const int stages = (kdim + CK - 1) / CK;
  __syncthreads();  // the previous pass is done with ws and the B stage
  stage_w<T, TAPS>(ws, w, cout, ldw, co0, 0);
  cp_async_commit();
  stager.load(0);
  for (int s = 0; s < stages; ++s) {
    __syncthreads();  // every warp is done with stage s - 1
    if (s + 1 < stages)
      stage_w<T, TAPS>(ws + ((s + 1) & 1) * WS, w, cout, ldw, co0, (s + 1) * CK);
    cp_async_commit();
    const int col0 = stager.store(s * CK);
    if (s + 1 < stages) stager.load((s + 1) * CK);
    cp_async_wait<1>();  // stage s's weights landed; s + 1's may be in flight
    __syncthreads();
    mma_stage<TAPS>(acc, bs, ld, row0, step, col0, ws + (s & 1) * WS);
  }
}

// ------------------------------------------------------------ kernels

// Kernel 4: GroupNorm-2 partials of h1 = conv_in(g) per (n, channel, tile).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
resblock_stats_kernel(const T* __restrict__ x1, const T* __restrict__ x2, int c1, int c2,
                      const float* __restrict__ mean1, const float* __restrict__ a1,
                      const float* __restrict__ b1, const T* __restrict__ w_in,
                      const float* __restrict__ b_in, float* __restrict__ part, int N,
                      int T_len, int cout, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][4][CO_PASS];  // [sum | M2][position warp][channel]
  T* gs = reinterpret_cast<T*>(smem);
  T* ws = gs + Layout<T>::GS;
  const int n = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int t0 = tile * STATS_TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  const int valid = min(STATS_TILE, T_len - t0);
  const int cin = c1 + c2;
  const size_t plane = (size_t)N * cout * tiles;

  for (int co0 = 0; co0 < cout; co0 += CO_PASS) {
    Acc acc;
    zero(acc);
    ActStage<T, true> g_stage{gs, x1, x2, c1, c2, mean1, a1, b1, n, t0 - 1, GW, T_len, vec != 0};
    conv_pass<T, 3>(acc, ws, w_in, cout, cin, co0, gs, Layout<T>::LDS, 0, 1, g_stage);
    // h1 rounded; per channel the sum over this warp's valid positions
    // (8 per thread, then the quad), then over the 4 position warps.
    float mean[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + i * 16 + h * 8 + g;
        const float bias = co0 + r < cout ? b_in[co0 + r] : 0.0f;
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = round_to<T>(acc[i][j][2 * h + e] + bias);
            acc[i][j][2 * h + e] = v;
            if (wn * 32 + j * 8 + 2 * t + e < valid) s += v;
          }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (t == 0) red[0][wn][r] = s;
      }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + i * 16 + h * 8 + g;
        mean[i][h] = (red[0][0][r] + red[0][1][r] + red[0][2][r] + red[0][3][r]) / valid;
        float m2 = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dv = acc[i][j][2 * h + e] - mean[i][h];
            if (wn * 32 + j * 8 + 2 * t + e < valid) m2 = fmaf(dv, dv, m2);
          }
        m2 += __shfl_xor_sync(0xffffffffu, m2, 1);
        m2 += __shfl_xor_sync(0xffffffffu, m2, 2);
        if (t == 0) red[1][wn][r] = m2;
      }
    __syncthreads();
    if (wn == 0 && t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + i * 16 + h * 8 + g;
          if (co0 + r >= cout) continue;
          const size_t k = ((size_t)n * cout + co0 + r) * tiles + tile;
          part[k] = (float)valid;
          part[plane + k] = mean[i][h];
          part[2 * plane + k] = red[1][0][r] + red[1][1][r] + red[1][2][r] + red[1][3][r];
        }
    }
  }
}

// out[t], out[t + 1] of one row: a pair store where T is even (t is).
template <typename T>
__device__ __forceinline__ void store2(T* row, int t, int T_len, float v0, float v1) {
  if ((T_len & 1) == 0 && t + 1 < T_len) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(row + t) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(row + t) = __floats2bfloat162_rn(v0, v1);
    }
    return;
  }
  if (t < T_len) row[t] = from_f32<T>(v0);
  if (t + 1 < T_len) row[t + 1] = from_f32<T>(v1);
}

// Kernel 5: recompute h1 over the tile and its halo, apply GroupNorm-2 +
// FiLM + GELU into z, then out = conv_out(z) + b_out + skip.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
resblock_apply_kernel(const T* __restrict__ x1, const T* __restrict__ x2, int c1, int c2,
                      const float* __restrict__ mean1, const float* __restrict__ a1,
                      const float* __restrict__ b1, const T* __restrict__ w_in,
                      const float* __restrict__ b_in, const float* __restrict__ mean2,
                      const float* __restrict__ a2, const float* __restrict__ b2,
                      const T* __restrict__ w_out, const float* __restrict__ b_out,
                      const T* __restrict__ w_skip, const float* __restrict__ b_skip,
                      T* __restrict__ out, int T_len, int cout, int dil, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* gs = reinterpret_cast<T*>(smem);
  T* ws = gs + Layout<T>::GS;
  T* zs = ws + 2 * Layout<T>::WS;  // [ZW][zld]: z at position t0 - MAX_DIL + row
  const int cp = (cout + CO_PASS - 1) / CO_PASS * CO_PASS;
  const int zld = Layout<T>::zld(cp);
  const int n = blockIdx.y;
  const int t0 = blockIdx.x * APPLY_TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  const int cin = c1 + c2;

  for (int co0 = 0; co0 < cout; co0 += CO_PASS) {
    Acc acc;
    zero(acc);
    ActStage<T, true> g_stage{gs, x1, x2, c1, c2, mean1, a1, b1, n, t0 - HALO, GW, T_len,
                              vec != 0};
    conv_pass<T, 3>(acc, ws, w_in, cout, cin, co0, gs, Layout<T>::LDS, 0, 1, g_stage);
    // z into its transposed stage; channels past Cout are written as 0.
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = co0 + wm * 32 + i * 16 + h * 8 + g;
        const bool live = co < cout;
        float m = 0.0f, a = 0.0f, b = 0.0f, bias = 0.0f;
        if (live) {
          const size_t k = (size_t)n * cout + co;
          m = mean2[k];
          a = a2[k];
          b = b2[k];
          bias = b_in[co];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = wn * 32 + j * 8 + 2 * t + e;
            const int pos = t0 - MAX_DIL + r;
            float z = 0.0f;
            if (live && pos >= 0 && pos < T_len) {
              const float hv = round_to<T>(acc[i][j][2 * h + e] + bias);
              z = gelu((hv - m) * a + b);
            }
            zs[r * zld + co] = from_f32<T>(z);
          }
      }
  }
  // Rows past POS only feed outputs past APPLY_TILE, which are not stored.
  for (int l = threadIdx.x; l < (ZW - POS) * cp; l += THREADS)
    zs[(POS + l / cp) * zld + l % cp] = from_f32<T>(0.0f);

  for (int co0 = 0; co0 < cout; co0 += CO_PASS) {
    Acc acc;
    zero(acc);
    InPlace z_stage;
    conv_pass<T, 3>(acc, ws, w_out, cout, cout, co0, zs, zld, MAX_DIL - dil, dil, z_stage);
    if (w_skip != nullptr) {
      ActStage<T, false> x_stage{gs, x1, x2, c1, c2, mean1, a1, b1, n, t0, POS, T_len, vec != 0};
      conv_pass<T, 1>(acc, ws, w_skip, cout, cin, co0, gs, Layout<T>::LDS, 0, 0, x_stage);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = co0 + wm * 32 + i * 16 + h * 8 + g;
        if (co >= cout) continue;
        const float bias = b_out[co] + (w_skip != nullptr ? b_skip[co] : 0.0f);
        const T* xr = w_skip == nullptr ? channel_row(x1, x2, c1, c2, n, co, T_len) : nullptr;
        T* orow = out + ((size_t)n * cout + co) * T_len;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = wn * 32 + j * 8 + 2 * t;  // even, so r < 114 holds r + 1
          const int tt = t0 + r;
          if (r >= APPLY_TILE || tt >= T_len) continue;
          float v0 = acc[i][j][2 * h] + bias, v1 = acc[i][j][2 * h + 1] + bias;
          if (xr != nullptr) {
            v0 += to_f32<T>(xr[tt]);
            if (tt + 1 < T_len) v1 += to_f32<T>(xr[tt + 1]);
          }
          store2<T>(orow, tt, T_len, v0, v1);
        }
      }
  }
}

template <typename T>
constexpr size_t stats_smem() {
  return sizeof(T) * (Layout<T>::GS + 2 * Layout<T>::WS);
}

template <typename T>
size_t apply_smem(int cout) {
  const int cp = (cout + CO_PASS - 1) / CO_PASS * CO_PASS;
  return stats_smem<T>() + sizeof(T) * (size_t)ZW * Layout<T>::zld(cp);
}

// 16-byte loads of x: both inputs 16-byte aligned and T % 8 == 0.
bool vec_ok(const void* x1, const void* x2, int T_len) {
  return ((reinterpret_cast<uintptr_t>(x1) | reinterpret_cast<uintptr_t>(x2)) & 15) == 0 &&
         T_len % 8 == 0;
}

template <typename T>
int launch_stats(const void* x1, const void* x2, int c1, int c2, const float* mean1,
                 const float* a1, const float* b1, const void* w_in, const float* b_in,
                 float* part, int N, int T_len, int cout, cudaStream_t stream) {
  const dim3 grid((T_len + STATS_TILE - 1) / STATS_TILE, N);
  constexpr size_t smem = stats_smem<T>();
  cudaFuncSetAttribute(resblock_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  resblock_stats_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2), c1, c2, mean1, a1, b1,
      static_cast<const T*>(w_in), b_in, part, N, T_len, cout, vec_ok(x1, x2, T_len));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply(const void* x1, const void* x2, int c1, int c2, const float* mean1,
                 const float* a1, const float* b1, const void* w_in, const float* b_in,
                 const float* mean2, const float* a2, const float* b2, const void* w_out,
                 const float* b_out, const void* w_skip, const float* b_skip, void* out,
                 int N, int T_len, int cout, int dil, cudaStream_t stream) {
  const dim3 grid((T_len + APPLY_TILE - 1) / APPLY_TILE, N);
  const size_t smem = apply_smem<T>(cout);
  cudaFuncSetAttribute(resblock_apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  resblock_apply_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2), c1, c2, mean1, a1, b1,
      static_cast<const T*>(w_in), b_in, mean2, a2, b2, static_cast<const T*>(w_out), b_out,
      static_cast<const T*>(w_skip), b_skip, static_cast<T*>(out), T_len, cout, dil,
      vec_ok(x1, x2, T_len));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tile sizes and limits, read by the Python wrapper so the two never drift.
extern "C" int fused_resblock_stats_tile() { return STATS_TILE; }
extern "C" int fused_resblock_max_dilation() { return MAX_DIL; }
extern "C" int fused_resblock_max_cout() { return MAX_COUT; }
extern "C" int fused_resblock_weight_align() { return W_ALIGN; }

// x1 [N, c1, T] and x2 [N, c2, T] (x2 may be null with c2 = 0) of one dtype
// (0 = float32, 1 = bfloat16), contiguous. mean1/a1/b1 [N, c1 + c2] and
// b_in [cout]: float32. w_in [3, cout, ldw] in the dtype, ldw = c1 + c2
// rounded up to a multiple of 8 (zero-filled), 16-byte aligned. Writes
// part [3, N, cout, tiles] = (count, mean, M2) of h1 per (n, channel, tile
// of 128 positions). Returns cudaGetLastError().
extern "C" int fused_resblock_stats(int dtype, const void* x1, const void* x2,
                                    int c1, int c2, const float* mean1,
                                    const float* a1, const float* b1,
                                    const void* w_in, const float* b_in,
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
// w_out [3, cout, ldo] (ldo = cout rounded up to 8), b_out [cout], and
// w_skip [1, cout, ldw] with b_skip [cout], or both null for the identity
// skip (c1 + c2 == cout). out [N, cout, T] in the dtype; dil <= 7,
// cout <= 256.
extern "C" int fused_resblock_apply(int dtype, const void* x1, const void* x2,
                                    int c1, int c2, const float* mean1,
                                    const float* a1, const float* b1,
                                    const void* w_in, const float* b_in,
                                    const float* mean2, const float* a2,
                                    const float* b2, const void* w_out,
                                    const float* b_out, const void* w_skip,
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
