// int8 x int8 -> int32 1-D convolution of [N, Cin, T] for Hopper (sm_90a),
// with the float32 dequantising epilogue fused; plain C interface.
//
// Replaces no Pallas kernel: the JAX package leaves this convolution to XLA
// (vq_voice_swap_tpu/ops/qact.py::conv1d_int8, the int8 contraction with
// preferred_element_type int32 at ops/qact.py:185-193 and its epilogue at
// :194-199). PyTorch has no int8 convolution that sums into int32, so the
// port's int8 serving path needs one of its own. For activation codes q,
// per-output-channel weight codes kq and their scales it computes
//
//   acc[n, co, t] = sum_{k, ci} kq[k, co, ci] * q[n, ci, t + k * dil - pad]
//   out[n, co, t] = cast(((float)acc * w_scale[co]) * act_scale + bias[co])
//
// in that order, each step rounded in float32 (__fmul_rn / __fadd_rn, so nvcc
// contracts nothing into an FMA): the plain version's bits, and JAX's order.
// The int32 sums are exact (|q|, |kq| <= 127, so 16129 * Cin * taps stays far
// below 2^31 for every layer of the models), so the result does not depend
// on the summation order. q is zero outside [0, T): the convolution's SAME
// padding, pad = (taps - 1) * dil / 2.
//
// What bounds it on the card: bytes at the model's widths. At 64 -> 64
// channels and 3 taps a position costs 2 * 3 * 64 * 64 = 24.6 K int8
// operations against 64 bytes of q read and 64 * 4 (float32) or 64 * 2
// (bf16) bytes written: ~77 operations a byte, far below the ~590 at which
// the int8 tensor cores (1,979 TOP/s dense) would become the limit.
//
// Design (a simple implicit GEMM; wgmma and TMA are later work): a block of
// 256 threads owns 64 output channels (M) by 128 positions (N) of one
// sample; its 8 warps each hold a 32 x 32 tile of int32 accumulators
// (2 x 4 mma.sync.m16n8k32.s8 tiles). The input channels are taken in
// stages of up to 128 (Cin is padded to 32 by the wrapper):
// - the activations of the window [t0 - pad, t0 + 128 + pad) are staged
//   transposed, [position][channel], 4 channels packed in a 32-bit word,
//   so tap k's B operand is the same buffer k * dil rows down;
// - the weights come from the wrapper as [tap][Cout padded to 64][Cin
//   padded to 32] int8 (the A operand, row-major) and are staged whole for
//   the block's 64 channels with 16-byte loads;
// - rows are Cin-stage + 16 bytes apart, so the fragment reads (row g,
//   bytes 4 * tid_in_group) of a warp fall on 32 distinct banks.
// Each thread's operand registers hold 4 consecutive K (channel) elements,
// as m16n8k32 wants them. The epilogue writes two positions a thread
// (8 or 4 bytes when T is even).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 8 warps: 2 along channels x 4 along positions
constexpr int CO_TILE = 64;    // output channels a block (M)
constexpr int POS = 128;       // positions a block (N)
constexpr int CS = 128;        // input channels a stage
constexpr int LDS = CS + 16;   // bytes between staged rows
constexpr int MAX_TAPS = 3;
constexpr int MAX_SMEM = 232448;

struct Args {
  const int8_t* q;          // [N, Cin, T]
  const int8_t* w;          // [taps, cout_p, cin_p]
  const float* w_scale;     // [Cout]
  const float* act_scale;   // a float32 scalar, or null (folded into w)
  const float* bias;        // [Cout] or null
  void* out;                // [N, Cout, T], float32 or bfloat16
  int cin, cout, t, cin_p, cout_p, taps, dil, pad, rows;
};

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b on a 16 x 8 x 32 tile, int8 inputs, exact int32 accumulators.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store2(float* out, size_t o, float v0, float v1, bool pair,
                                       bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
  } else {
    out[o] = v0;
    if (second) out[o + 1] = v1;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, size_t o, float v0, float v1,
                                       bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(out + o) =
        __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
  } else {
    out[o] = __float2bfloat16_rn(v0);
    if (second) out[o + 1] = __float2bfloat16_rn(v1);
  }
}

template <typename O>
__global__ void __launch_bounds__(THREADS) conv1d_int8_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem;                    // [rows][LDS]
  unsigned char* ws = smem + (size_t)a.rows * LDS;  // [taps * CO_TILE][LDS]

  const int t0 = blockIdx.x * POS;
  const int co0 = blockIdx.y * CO_TILE;
  const int n = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;     // the warp's 32 x 32 tile
  const int g = lane >> 2, tg = lane & 3;
  const int8_t* qn = a.q + (size_t)n * a.cin * a.t;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  for (int c0 = 0; c0 < a.cin_p; c0 += CS) {
    const int cs = min(CS, a.cin_p - c0);      // a multiple of 32
    // Activations: one 32-bit word (4 channels at one position) a step,
    // neighbouring threads on neighbouring positions.
    const int words = cs / 4;
    for (int e = tid; e < a.rows * words; e += THREADS) {
      const int cw = e / a.rows, r = e - cw * a.rows;
      const int p = t0 - a.pad + r;
      uint32_t v = 0;
      if (p >= 0 && p < a.t) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + cw * 4 + j;
          if (c < a.cin) v |= (uint32_t)(uint8_t)__ldg(qn + (size_t)c * a.t + p) << (8 * j);
        }
      }
      *reinterpret_cast<uint32_t*>(xs + (size_t)r * LDS + cw * 4) = v;
    }
    // Weights: 16 bytes a step.
    const int vecs = cs / 16;
    for (int e = tid; e < a.taps * CO_TILE * vecs; e += THREADS) {
      const int v = e % vecs, row = e / vecs;  // row = tap * CO_TILE + channel
      const int k = row / CO_TILE, co = row - k * CO_TILE;
      const uint4 val = __ldg(reinterpret_cast<const uint4*>(
          a.w + ((size_t)k * a.cout_p + co0 + co) * a.cin_p + c0 + v * 16));
      *reinterpret_cast<uint4*>(ws + (size_t)row * LDS + v * 16) = val;
    }
    __syncthreads();

    for (int k = 0; k < a.taps; ++k) {
      const unsigned char* wk = ws + (size_t)(k * CO_TILE + wm * 32) * LDS;
      const unsigned char* xk = xs + (size_t)(k * a.dil + wn * 32) * LDS;
      for (int kk = 0; kk < cs; kk += 32) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const unsigned char* p = wk + (mi * 16 + g) * LDS + kk + tg * 4;
          af[mi][0] = ld32(p);
          af[mi][1] = ld32(p + 8 * LDS);
          af[mi][2] = ld32(p + 16);
          af[mi][3] = ld32(p + 8 * LDS + 16);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const unsigned char* p = xk + (ni * 8 + g) * LDS + kk + tg * 4;
          bf[ni][0] = ld32(p);
          bf[ni][1] = ld32(p + 16);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
      }
    }
    __syncthreads();
  }

  O* out = static_cast<O*>(a.out);
  const float act = a.act_scale != nullptr ? *a.act_scale : 1.0f;
  const bool even = (a.t & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = co0 + wm * 32 + mi * 16 + half * 8 + g;
      if (co >= a.cout) continue;
      const float s = a.w_scale[co];
      const float b = a.bias != nullptr ? a.bias[co] : 0.0f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int pos = t0 + wn * 32 + ni * 8 + tg * 2;
        if (pos >= a.t) continue;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float y = __fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + j]), s);
          if (a.act_scale != nullptr) y = __fmul_rn(y, act);
          if (a.bias != nullptr) y = __fadd_rn(y, b);
          v[j] = y;
        }
        const bool second = pos + 1 < a.t;
        store2(out, ((size_t)n * a.cout + co) * a.t + pos, v[0], v[1], even && second, second);
      }
    }
  }
}

size_t smem_bytes(int rows, int taps) { return (size_t)(rows + taps * CO_TILE) * LDS; }

template <typename O>
cudaError_t launch(const Args& a, int n, cudaStream_t stream) {
  // Allow the most shared memory once, outside any graph capture's launches.
  static const cudaError_t configured = cudaFuncSetAttribute(
      conv1d_int8_kernel<O>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (configured != cudaSuccess) return configured;
  const size_t smem = smem_bytes(a.rows, a.taps);
  const dim3 grid((a.t + POS - 1) / POS, a.cout_p / CO_TILE, n);
  conv1d_int8_kernel<O><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int conv1d_int8_co_tile() { return CO_TILE; }
extern "C" int conv1d_int8_max_smem() { return MAX_SMEM; }
extern "C" long long conv1d_int8_smem(int rows, int taps) {
  return static_cast<long long>(smem_bytes(rows, taps));
}

// q [N, Cin, T] int8 contiguous; w [taps, cout_p, cin_p] int8 contiguous,
// zero-padded, cout_p a multiple of 64 and cin_p of 32; w_scale [Cout] and
// bias [Cout] (or null) float32; act_scale a float32 scalar on the device or
// null; out [N, Cout, T] contiguous, float32 (out_dtype 0) or bfloat16 (1).
// Stride 1, taps 1 or 3, padding (taps - 1) * dil / 2. Launches on `stream`
// and returns a CUDA error code (0 on success).
extern "C" int conv1d_int8(const void* q, const void* w, const float* w_scale,
                           const float* act_scale, const float* bias, void* out,
                           int out_dtype, int n, int cin, int cout, int t, int cin_p,
                           int cout_p, int taps, int dil, void* stream) {
  if (taps < 1 || taps > MAX_TAPS || taps % 2 == 0 || dil < 1 || cin_p % 32 ||
      cout_p % CO_TILE || cin_p < cin || cout_p < cout) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pad = (taps - 1) * dil / 2;
  Args a{static_cast<const int8_t*>(q), static_cast<const int8_t*>(w), w_scale, act_scale,
         bias, out, cin, cout, t, cin_p, cout_p, taps, dil, pad, POS + (taps - 1) * dil};
  if (smem_bytes(a.rows, taps) > (size_t)MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || t == 0 || cout == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = out_dtype == 0 ? launch<float>(a, n, s) : launch<__nv_bfloat16>(a, n, s);
  return static_cast<int>(err);
}
