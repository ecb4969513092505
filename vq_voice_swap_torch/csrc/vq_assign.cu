// Nearest-code VQ assignment for Hopper (sm_90a), plain C interface.
//
// Replaces vq_voice_swap_tpu/ops/vq_pallas.py::_assign_kernel: for each
// input row x [C] against a codebook [D, C], dist = |d|^2 - 2 x.d (|x|^2 is
// constant per row and dropped), idx = argmin over codes with ties going to
// the lowest index, and used[code] = 1 for every code some row picked.
//
// What bounds it on the card: 2*B*C*D float32 multiply-adds against a few
// MB of x and codebook, so operations. The TPU kernel runs its float32
// product as bf16 multi-pass on the MXU (Precision.HIGHEST); here it runs on
// the tensor cores as 3xTF32: each operand splits into a TF32 head and tail,
// hi = tf32(v), lo = v - hi, and x.d = x_lo.d_hi + x_hi.d_lo + x_hi.d_hi in
// float32 accumulators (mma.sync m16n8k8 tf32). The dropped x_lo.d_lo term
// and the tail's own rounding are ~2^-21 of each product, so the distances
// keep about float32 accuracy: a pick may differ from the float32 reference
// only where two codes' distances differ by ~1e-7 relative, a true tie at
// 1e-6. Every code column gets the same arithmetic, so duplicate codes tie
// exactly and go to the lowest index.
//
// Design:
// - Grid: a block owns BM = 64 rows x BN codes, (D/BN) x (B/BM) blocks, 4
//   warps of 32 rows x BN/2 codes each. BN is 64 or 32, the caller's choice:
//   64 at B = 3200, D = 512 (400 blocks, all resident at 4 per SM); 32 where
//   64 would leave SMs idle (B = 200: 64 blocks instead of 32), at the cost
//   of reading each x tile twice as often.
// - Loads: BK-channel stages of x and codebook tiles go to shared memory
//   by cp.async into a STAGES-deep ring, so the next stages load while the
//   tensor cores work on this one; rows padded to BK + 4 floats make the
//   fragment reads conflict-free.
// - Split: each warp splits the fragments it reads, with two integer ops
//   and one subtraction per value (full rate; cvt.rna.tf32.f32 runs on the
//   slower conversion path, and a split pass through shared memory made
//   shared-memory traffic the limit). The same reads fold |d|^2 of the
//   block's codes in a fixed k order, so the wrapper launches no norm ops.
// - Argmin in the kernel: each block writes a (distance, code) candidate
//   per row for its code range (strict '<' over increasing codes). The last
//   block to finish a row tile (a per-row-tile ticket: __threadfence +
//   atomicAdd, reset by that block) merges the candidates in code-tile
//   order and writes idx; the last row tile to finish (a second ticket)
//   clears `used` and marks every row's code. The result has the same bits
//   from run to run, whatever order the blocks run in. The wrapper gives
//   each stream its own tickets (ops/tickets.py).
// - Rows past B, codes past D and channels past C are zero-filled or masked
//   in the kernel, so the caller pads nothing; the [B, D] distance matrix
//   never reaches device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;        // 4 warps: 2 along rows x 2 along codes
constexpr int BM = 64;              // rows per block
constexpr int BK = 16;              // channels per stage
constexpr int STAGES = 4;           // cp.async ring depth
constexpr int LD = BK + 4;          // row stride (floats): 16-byte rows, conflict-free fragments

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// (d, c) beats (bd, bc): smaller distance, ties to the lower code.
__device__ __forceinline__ bool better(float d, int c, float bd, int bc) {
  return d < bd || (d == bd && c < bc);
}

// BN codes per block; VEC: 16-byte loads.
template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
vq_assign_kernel(const float* __restrict__ x, const float* __restrict__ dict,
                 float2* __restrict__ cand, int* __restrict__ tickets, int* __restrict__ idx,
                 int* __restrict__ used, int B, int C, int D) {
  constexpr int WN = BN / 2;  // codes per warp
  constexpr int NT = WN / 8;  // n8 tiles per warp
  __shared__ __align__(16) float xr[STAGES][BM][LD];
  __shared__ __align__(16) float dr[STAGES][BN][LD];
  __shared__ float norms[BN];
  __shared__ float red_d[2][BM];
  __shared__ int red_c[2][BM];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const int code_tile = blockIdx.x, row_tile = blockIdx.y;
  const int n_code_tiles = gridDim.x, n_row_tiles = gridDim.y;
  const int row0 = row_tile * BM, code0 = code_tile * BN;
  const int nk = (C + BK - 1) / BK;

  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * BK;
    // Copy q: row r of the x tile, then of the codebook tile, channel k
    // (with VEC, the first of 4).
    constexpr int V = VEC ? 4 : 1;
    static_assert(BM * BK / V % THREADS == 0 && BN * BK / V % THREADS == 0,
                  "every thread copies whole tiles' shares");
#pragma unroll
    for (int i = 0; i < (BM + BN) * BK / V / THREADS; ++i) {
      const int q = tid + i * THREADS;
      const bool is_x = q < BM * BK / V;
      const int qq = is_x ? q : q - BM * BK / V;
      const int r = qq / (BK / V), k = (qq % (BK / V)) * V;
      const float* src = is_x ? x : dict;
      const int row = (is_x ? row0 : code0) + r;
      const bool valid = k0 + k < C && row < (is_x ? B : D);
      float* dst = is_x ? &xr[slot][r][k] : &dr[slot][r][k];
      if (VEC) {
        cp_async16(dst, valid ? src + (size_t)row * C + k0 + k : src, valid);
      } else {
        cp_async4(dst, valid ? src + (size_t)row * C + k0 + k : src, valid);
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  // |d|^2 of code wn*WN + j*8 + g over channels = t (mod 4), in k order.
  float norm[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) norm[j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    const int next = kt + STAGES - 1;
    if (next < nk) load_stage(next % STAGES, next);
    cp_async_commit();
    const int slot = kt % STAGES;

#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const int k = kk * 8 + t;
      float av[2][4], bv[NT][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + g;
        av[i][0] = xr[slot][r][k];
        av[i][1] = xr[slot][r + 8][k];
        av[i][2] = xr[slot][r][k + 4];
        av[i][3] = xr[slot][r + 8][k + 4];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn * WN + j * 8 + g;
        bv[j][0] = dr[slot][n][k];
        bv[j][1] = dr[slot][n][k + 4];
      }
      uint32_t ah[2][4], al[2][4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) split(av[i][e], ah[i][e], al[i][e]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        norm[j] = fmaf(bv[j][0], bv[j][0], norm[j]);
        norm[j] = fmaf(bv[j][1], bv[j][1], norm[j]);
        split(bv[j][0], bh[j][0], bl[j][0]);
        split(bv[j][1], bh[j][1], bl[j][1]);
      }
      // The small products first, each pass over all tiles (independent MMAs).
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
    }
  }
  cp_async_wait<0>();
  // Codes' norms: the quad's four channel classes, in a fixed butterfly.
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    norm[j] += __shfl_xor_sync(0xffffffffu, norm[j], 1);
    norm[j] += __shfl_xor_sync(0xffffffffu, norm[j], 2);
  }
  if (wm == 0 && t == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j) norms[wn * WN + j * 8 + g] = norm[j];
  }
  __syncthreads();

  // Per thread: rows (i, h) -> wm*32 + i*16 + h*8 + g; codes wn*WN + j*8 + 2t + e.
  float bd[2][2];
  int bc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bd[i][h] = INFINITY;
      bc[i][h] = code0;
    }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int lc = wn * WN + j * 8 + 2 * t + e;
      if (code0 + lc < D) {
        const float dn = norms[lc];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float dist = dn - 2.0f * acc[i][j][2 * h + e];
            if (dist < bd[i][h]) {
              bd[i][h] = dist;
              bc[i][h] = code0 + lc;
            }
          }
      }
    }
  // Across the 4 lanes of a quad (t), then across the two code warps.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float d = bd[i][h];
      int c = bc[i][h];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, d, o);
        const int oc = __shfl_xor_sync(0xffffffffu, c, o);
        if (better(od, oc, d, c)) {
          d = od;
          c = oc;
        }
      }
      if (t == 0) {
        const int r = wm * 32 + i * 16 + h * 8 + g;
        red_d[wn][r] = d;
        red_c[wn][r] = c;
      }
    }
  __syncthreads();
  if (tid < BM && row0 + tid < B) {
    float d = red_d[0][tid];
    int c = red_c[0][tid];
    if (better(red_d[1][tid], red_c[1][tid], d, c)) {
      d = red_d[1][tid];
      c = red_c[1][tid];
    }
    cand[(size_t)(row0 + tid) * n_code_tiles + code_tile] = make_float2(d, __int_as_float(c));
  }

  // The last block of this row tile merges its candidates into idx.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(tickets + 1 + row_tile, 1);
    is_last = prev == n_code_tiles - 1;
    if (is_last) tickets[1 + row_tile] = 0;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (tid < BM && row0 + tid < B) {
    const float2* row_cand = cand + (size_t)(row0 + tid) * n_code_tiles;
    float2 best = __ldcg(row_cand);
#pragma unroll 8
    for (int ct = 1; ct < n_code_tiles; ++ct) {
      const float2 v = __ldcg(row_cand + ct);
      if (v.x < best.x) best = v;  // strict: ties keep the lower code tile
    }
    idx[row0 + tid] = __float_as_int(best.y);
  }

  // The last row tile to finish writes `used` from every row's code.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(tickets, 1);
    is_last = prev == n_row_tiles - 1;
    if (is_last) tickets[0] = 0;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int d = tid; d < D; d += THREADS) used[d] = 0;
  __syncthreads();
#pragma unroll 8
  for (int r = tid; r < B; r += THREADS) used[__ldcg(idx + r)] = 1;
}

template <int BN>
void launch(const float* x, const float* dict, float2* cand, int* tickets, int* idx,
            int* used, int B, int C, int D, bool vec, cudaStream_t s) {
  const dim3 grid((D + BN - 1) / BN, (B + BM - 1) / BM);
  if (vec) {
    vq_assign_kernel<BN, true><<<grid, THREADS, 0, s>>>(x, dict, cand, tickets, idx, used, B,
                                                        C, D);
  } else {
    vq_assign_kernel<BN, false><<<grid, THREADS, 0, s>>>(x, dict, cand, tickets, idx, used, B,
                                                         C, D);
  }
}

}  // namespace

extern "C" int vq_assign_block_rows() { return BM; }

// x [B, C], dict [D, C]: float32, contiguous, on one device; `block_codes`
// (BN) is 32 or 64; `vec` selects 16-byte loads (C % 4 == 0, both 16-byte
// aligned). cand: B * ceil(D / BN) float2 scratch; tickets: 1 + ceil(B / BM)
// zeroed ints, left zeroed. Writes idx [B] and used [D] (int32). Launches on
// `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for another block_codes.
extern "C" int vq_assign_f32(const float* x, const float* dict, void* cand, int* tickets,
                             int* idx, int* used, int B, int C, int D, int block_codes,
                             int vec, void* stream) {
  if (block_codes != 32 && block_codes != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && D > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float2* c = static_cast<float2*>(cand);
    if (block_codes == 64) {
      launch<64>(x, dict, c, tickets, idx, used, B, C, D, vec != 0, s);
    } else {
      launch<32>(x, dict, c, tickets, idx, used, B, C, D, vec != 0, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
