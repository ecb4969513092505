// Nearest-code VQ assignment for Hopper (sm_90a), plain C interface.
//
// Replaces vq_voice_swap_tpu/ops/vq_pallas.py::_assign_kernel: for each
// input row x [C] against a codebook [D, C], dist = |d|^2 - 2 x.d (|x|^2 is
// constant per row and dropped), idx = argmin over codes with ties going to
// the lowest index, and used[idx] = 1 for every real row.
//
// What bounds it on the card: 2*B*C*D float32 FMAs. The indices must equal
// the float32 reference's, so the dots run on the CUDA cores in full float32
// (no TF32, no tensor cores), and the 67 TFLOP/s float32 rate is the bound;
// the bytes (x and the codebook read once) are a few MB and far below it.
//
// Design: a block owns TB rows and walks the whole codebook in TD-code
// tiles, staging TK channels of rows and codes at a time in shared memory;
// each thread keeps a RM x RN register tile of dots accumulated with fmaf in
// a fixed k order (k = 0 .. C-1), then folds its codes into a running
// (dist, index) per row with a strict '<' over increasing code indices, so
// ties keep the lower index. A shared-memory pass merges the TX threads that
// share a row. Rows past B and codes past D are masked in the kernel, so the
// caller pads nothing. The [B, D] distance matrix never reaches device
// memory. The caller zeroes `used`; the kernel only stores ones into it.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int TX = 16;          // threads along codes
constexpr int TY = 16;          // threads along rows
constexpr int TB = 32;          // rows per block
constexpr int TD = 64;          // codes per tile
constexpr int TK = 32;          // channels per shared-memory stage
constexpr int RM = TB / TY;     // rows per thread
constexpr int RN = TD / TX;     // codes per thread

__global__ void __launch_bounds__(TX * TY)
assign_kernel(const float* __restrict__ x, const float* __restrict__ dict,
              const float* __restrict__ dict_norms, int* __restrict__ idx,
              int* __restrict__ used, int B, int C, int D) {
  __shared__ float xs[TK][TB + 1];
  __shared__ float ds[TK][TD + 1];
  __shared__ float red_dist[TB][TX];
  __shared__ int red_code[TB][TX];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int row0 = blockIdx.x * TB;

  float best_dist[RM];
  int best_code[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    best_dist[i] = INFINITY;
    best_code[i] = 0;
  }

  for (int d0 = 0; d0 < D; d0 += TD) {
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < C; k0 += TK) {
      for (int l = tid; l < TB * TK; l += TX * TY) {
        const int r = l / TK, k = l % TK;
        const int gr = row0 + r, gk = k0 + k;
        xs[k][r] = (gr < B && gk < C) ? x[(size_t)gr * C + gk] : 0.0f;
      }
      for (int l = tid; l < TD * TK; l += TX * TY) {
        const int r = l / TK, k = l % TK;
        const int gd = d0 + r, gk = k0 + k;
        ds[k][r] = (gd < D && gk < C) ? dict[(size_t)gd * C + gk] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < TK; ++k) {
        float a[RM], b[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = xs[k][ty + TY * i];
#pragma unroll
        for (int j = 0; j < RN; ++j) b[j] = ds[k][tx + TX * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int code = d0 + tx + TX * j;
      if (code < D) {
        const float dn = dict_norms[code];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float dist = dn - 2.0f * acc[i][j];
          if (dist < best_dist[i]) {
            best_dist[i] = dist;
            best_code[i] = code;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    red_dist[ty + TY * i][tx] = best_dist[i];
    red_code[ty + TY * i][tx] = best_code[i];
  }
  __syncthreads();
  if (tid < TB) {
    const int r = tid;
    float bd = red_dist[r][0];
    int bc = red_code[r][0];
    for (int t = 1; t < TX; ++t) {
      const float d = red_dist[r][t];
      const int c = red_code[r][t];
      if (d < bd || (d == bd && c < bc)) {
        bd = d;
        bc = c;
      }
    }
    const int gr = row0 + r;
    if (gr < B) {
      idx[gr] = bc;
      used[bc] = 1;
    }
  }
}

}  // namespace

// x [B, C], dict [D, C], dict_norms [D]: float32, contiguous, on one device.
// idx [B] and used [D] int32; used must be zeroed by the caller. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int vq_assign_f32(const float* x, const float* dict,
                             const float* dict_norms, int* idx, int* used,
                             int B, int C, int D, void* stream) {
  if (B > 0) {
    const dim3 block(TX, TY);
    const dim3 grid((B + TB - 1) / TB);
    assign_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        x, dict, dict_norms, idx, used, B, C, D);
  }
  return static_cast<int>(cudaGetLastError());
}
