// bf16 x bf16 -> float32-accumulate 1-D convolution of [N, Cin, T] for
// Hopper (sm_90a), with the bias added in the epilogue; plain C interface.
//
// Replaces no Pallas kernel: the JAX package leaves this convolution to XLA
// (vq_voice_swap_tpu/models/layers.py, flax's nn.Conv). On the card PyTorch
// runs it through cuDNN, which on the port's [N, C, T] layout launches three
// kernels, a transpose of the input to channels-last, the implicit GEMM and
// a transpose of the output back, and then aten adds the bias in a fourth,
// broadcast pass. This kernel reads [N, Cin, T] and writes [N, Cout, T]
// itself, with the bias fused, for the serving forward (no autograd):
//
//   out[n, co, t] = bf16(sum_{k, ci} w[co, ci, k] * x[n, ci, t + k * dil - pad]
//                        + bias[co])
//
// the products exact and summed in float32 by the tensor cores, the bias
// (the bf16 value of the layer's bias, as float) added to the float32 sum,
// and one rounding to bf16. x is zero outside [0, T): SAME padding,
// pad = (taps - 1) * dil / 2; stride 1, taps 1 or 3.
//
// What bounds it on the card: bytes at the model's widths. At 64 -> 64
// channels and 3 taps a position costs 2 * 3 * 64 * 64 = 24.6 K operations
// against 128 bytes of x read and 128 written: ~96 operations a byte, below
// the ~295 at which the bf16 tensor cores (989 TFLOP/s dense) would become
// the limit; at 256 -> 256 it is ~384, near the line. So the design reads x
// once from device memory and writes the output once, and keeps the tensor
// cores' operands in shared memory.
//
// Design (csrc/conv1d_int8.cu's structure). A tile is 64 output channels (M)
// by 128 positions (N) of one sample; a block of 256 threads (8 warps, each
// a 32 x 32 tile of float32 accumulators in 2 x 4 mma.sync.m16n8k16 bf16
// tiles) is persistent: it owns one 64-channel slice of the output and
// walks the (n, t) tiles blockIdx.x, + gridDim.x, ... The work is a
// sequence of units, (tile, stage of up to 64 input channels), pipelined
// through a ring of shared-memory stages:
// - a unit's inputs come in as 16-byte cp.async copies of [channel][8
//   positions] straight from x's rows (T a multiple of 8: a chunk lies
//   wholly inside or outside [0, T), and one outside is zero-filled),
//   issued NST - 1 units ahead, so they are in flight while the tensor cores
//   run this one;
// - the weights (the A operand, [tap][64][Cin], row-major) are staged once
//   for the block where that leaves room for two blocks an SM (Cin up to
//   128 at 3 taps; three ring stages up to 64), else each stage carries its
//   unit's slice ([tap][64][64 channels]): at Cin 192-256 resident weights
//   cost the second block, which cost more than reading the slices again
//   from L2 (PERF.md);
// - each unit is then transposed in shared memory to [position][channel]
//   by 8 x 8 blocks, ldmatrix from the stage and stmatrix.trans into the
//   transposed buffer, so that tap k's B operand is the same buffer k * dil
//   rows down (ldmatrix needs 16-byte aligned rows, which a shift of one
//   position along a [channel][position] stage would not give);
// - the epilogue adds the bias to the accumulators, rounds them to bf16 into
//   shared memory ([channel][position], aliasing the transposed inputs),
//   from which each warp stores whole rows of the tile along T in 16-byte
//   runs (8 positions a thread). (Stores straight from the fragments, 4
//   bytes a thread, were 10% slower at 64 -> 64 channels.)
// Rows are an odd number of 16-byte chunks apart in the staged inputs and
// resident weights, and the slices' 128-byte rows are swizzled, so the
// eight rows of an ldmatrix or stmatrix block fall on distinct banks.
//
// What bounds it as built: shared memory and the block's phases, not the
// bytes. Each MMA takes two ldmatrix loads of its fragments, and within a
// block the transpose, the MMAs and the epilogue of a unit run in turn
// between barriers, overlapped only by the next units' copies and the
// other block; it reaches 51% of its byte bound at 64 -> 64 channels and
// 29% at 128 -> 128 (PERF.md, row 9). A wgmma version that staged with
// both warpgroups was no faster (one block an SM); a producer warp beside
// wgmma consumers is the next design (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int THREADS = 256;   // 8 warps: 2 along channels x 4 along positions
constexpr int CO_TILE = 64;    // output channels a block (M)
constexpr int POS = 128;       // positions a tile (N)
constexpr int CS = 64;         // input channels a unit
constexpr int CIN_ALIGN = 16;  // the MMA's depth: Cin is padded to it
constexpr int LDS = (CS + 8) * 2;  // bytes between transposed rows (144)
constexpr int LDO = POS + 8;   // elements between epilogue rows
constexpr int MAX_TAPS = 3;
constexpr int MAX_SMEM = 232448;
constexpr int SM_SMEM = 233472;    // shared memory of an SM (228 KB)
constexpr int BLOCK_RESERVED = 1024;  // shared memory the runtime keeps a block
constexpr int MAX_BLOCKS = 2;  // blocks an SM holds by registers (__launch_bounds__)

struct Args {
  const __nv_bfloat16* x;   // [N, Cin, T]
  const __nv_bfloat16* w;   // [taps, cout_p, cin_p]
  const float* bias;        // [Cout] or null
  __nv_bfloat16* out;       // [N, Cout, T]
  int cin, cout, t, cin_p, cout_p, taps, dil, pad;
  int off;        // first needed position minus the 8-aligned window start
  int rc;         // 8-position chunks a unit's window spans (even)
  int lr;         // chunks between raw rows (rc + 1, odd)
  int nst;        // ring stages (2 or 3)
  int resident;   // the weights are staged once (else a slice a unit)
  int tiles_t, tiles, ncs;  // tiles along T, all tiles, channel stages a tile
  int ld_w;       // bytes between staged weight rows
  size_t w_bytes, raw_bytes, stage_bytes;
};

// Shared-memory layout of one launch, in bytes: the resident weights (or
// none), nst stages (the raw inputs, then a unit's weight slice where the
// weights are not resident), then the transposed inputs.
size_t smem_of(int rc, int taps, int cin_p, int nst, bool resident) {
  const size_t raw = (size_t)CS * (rc + 1) * 16, slice = (size_t)taps * CO_TILE * CS * 2;
  return (resident ? (size_t)taps * CO_TILE * (2 * cin_p + 16) : 0) +
         (size_t)nst * (raw + (resident ? 0 : slice)) + (size_t)rc * 8 * LDS;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; thread t gets elements 2 (t % 4), +1 of row
// t / 4 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The inverse, transposed: matrix i's fragment (thread t holding elements
// 2 (t % 4), +1 of row t / 4) stored with its rows and columns swapped, lane
// l giving the address of stored row l % 8 of matrix l / 8.
__device__ __forceinline__ void stsm_x4_trans(void* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n"
               ::"r"(smem_addr(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's newest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a * b on a 16 x 8 x 16 tile, bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte offset of channel c's chunk j in a raw stage.
__device__ __forceinline__ int raw_offset(const Args& a, int c, int j) {
  return (c * a.lr + j) * 16;
}

// Stage unit u (tile, channel stage) into a ring stage: the inputs of the
// window [t0 - pad - off, ... + rc * 8) of its channels, zero outside [0, T)
// and beyond Cin, and its weight slice where the weights are not resident
// ([tap][64][64 channels], 128-byte rows whose 16-byte chunk j lies at
// j ^ (row % 8), so the 8 rows of an ldmatrix block fall on distinct banks).
__device__ void issue(const Args& a, int u, unsigned char* stage) {
  const int tile = blockIdx.x + (u / a.ncs) * gridDim.x;
  const int c0 = (u % a.ncs) * CS;
  const int cs = min(CS, a.cin_p - c0);
  const int w0 = (tile % a.tiles_t) * POS - a.pad - a.off;  // a multiple of 8
  const __nv_bfloat16* xn = a.x + (size_t)(tile / a.tiles_t) * a.cin * a.t;
  for (int e = threadIdx.x; e < cs * a.rc; e += THREADS) {
    const int c = e / a.rc, j = e - c * a.rc;
    const int ch = c0 + c, p = w0 + 8 * j;
    const bool in = ch < a.cin && p >= 0 && p < a.t;
    cp_async16(stage + raw_offset(a, c, j), in ? xn + (size_t)ch * a.t + p : a.x, in ? 16 : 0);
  }
  if (!a.resident) {
    const int co0 = blockIdx.y * CO_TILE, vecs = cs / 8;
    unsigned char* ws = stage + a.raw_bytes;
    for (int e = threadIdx.x; e < a.taps * CO_TILE * vecs; e += THREADS) {
      const int v = e % vecs, row = e / vecs;  // row = tap * CO_TILE + channel
      const int k = row / CO_TILE, co = row - k * CO_TILE;
      cp_async16(ws + (size_t)row * 128 + ((v ^ (row & 7)) * 16),
                 a.w + ((size_t)k * a.cout_p + co0 + co) * a.cin_p + c0 + v * 8, 16);
    }
  }
}

// The raw stage [channel][position] -> xs [position][channel]: a job is 16
// channels x 16 positions, four 8 x 8 blocks, one ldmatrix and one
// stmatrix.trans a warp.
__device__ void transpose(const Args& a, int cs, const unsigned char* raw, unsigned char* xs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = lane >> 3, r = lane & 7;
  const int cg = cs / 16, jobs = cg * (a.rc / 2);
  for (int job = warp; job < jobs; job += THREADS / 32) {
    const int c = (job % cg) * 16 + (m & 1) * 8;   // matrix m: channels c..c+7
    const int j = (job / cg) * 2 + (m >> 1);       // ... at positions 8j..8j+7
    uint32_t v[4];
    ldsm_x4(v, raw + raw_offset(a, c + r, j));
    stsm_x4_trans(xs + (size_t)(8 * j + r) * LDS + 2 * c, v);
  }
}

template <int NST, bool RES>
__global__ void __launch_bounds__(THREADS, MAX_BLOCKS) conv1d_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* wres = smem;                              // resident weights
  unsigned char* ring = smem + a.w_bytes;                  // NST stages
  unsigned char* xs = ring + NST * a.stage_bytes;          // transposed inputs

  const int my_tiles = blockIdx.x < a.tiles ? (a.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int units = my_tiles * a.ncs;
  if (units == 0) return;
  const int co0 = blockIdx.y * CO_TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;     // the warp's 32 x 32 tile
  const int g = lane >> 2, tg = lane & 3;
  // ldmatrix rows: lane l addresses row l % 8 of matrix l / 8.
  const int lq = lane >> 3, lr = lane & 7;

  if (RES) {  // the block's weights, once, in the first unit's group
    const int vecs = a.cin_p / 8;
    for (int e = tid; e < a.taps * CO_TILE * vecs; e += THREADS) {
      const int v = e % vecs, row = e / vecs;
      const int k = row / CO_TILE, co = row - k * CO_TILE;
      cp_async16(wres + (size_t)row * a.ld_w + v * 16,
                 a.w + ((size_t)k * a.cout_p + co0 + co) * a.cin_p + v * 8, 16);
    }
  }
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < units) issue(a, s, ring + s * a.stage_bytes);
    cp_async_commit();
  }

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.0f;

  // The bias of this thread's 4 rows.
  float rb[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = min(co0 + wm * 32 + mi * 16 + half * 8 + g, a.cout - 1);
      rb[mi][half] = a.bias != nullptr ? a.bias[co] : 0.0f;
    }

  for (int u = 0; u < units; ++u) {
    cp_async_wait<NST - 2>();  // unit u (and the weights) landed
    __syncthreads();           // ... for every thread; every warp is done with xs
    if (u + NST - 1 < units) {
      issue(a, u + NST - 1, ring + ((u + NST - 1) % NST) * a.stage_bytes);
    }
    cp_async_commit();
    const int cst = u % a.ncs;
    const int c0 = cst * CS;
    const int ncp = min(CS, a.cin_p - c0) / 16;  // 16-channel steps of the unit
    const unsigned char* stage = ring + (u % NST) * a.stage_bytes;
    transpose(a, ncp * 16, stage, xs);
    __syncthreads();

    // A: matrices (rows 0-7 | 8-15) x (channels 0-7 | 8-15) of a 16-row
    // tile; B: (channels 0-7 | 8-15) of two 8-position tiles.
    const unsigned char* wlane =
        RES ? wres + (size_t)(wm * 32 + (lq & 1) * 8 + lr) * a.ld_w + 2 * c0 + (lq >> 1) * 16
            : stage + a.raw_bytes + (size_t)(wm * 32 + (lq & 1) * 8 + lr) * 128;
    const unsigned char* xlane = xs + (size_t)(a.off + wn * 32 + (lq >> 1) * 8 + lr) * LDS +
                                 (lq & 1) * 16;
    for (int k = 0; k < a.taps; ++k) {
      const unsigned char* wk = wlane + (size_t)k * CO_TILE * (RES ? a.ld_w : 128);
      const unsigned char* xk = xlane + (size_t)k * a.dil * LDS;
#pragma unroll
      for (int step = 0; step < CS / 16; ++step) {  // 16 channels a step
        if (step < ncp) {
          uint32_t af[2][4], bf[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            ldsm_x4(af[mi], RES ? wk + (size_t)mi * 16 * a.ld_w + step * 32
                                : wk + mi * 16 * 128 + (((2 * step + (lq >> 1)) ^ lr) * 16));
          }
#pragma unroll
          for (int np = 0; np < 2; ++np) ldsm_x4(bf[np], xk + (size_t)np * 16 * LDS + step * 32);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              const uint32_t b[2] = {bf[ni >> 1][(ni & 1) * 2], bf[ni >> 1][(ni & 1) * 2 + 1]};
              mma_bf16(acc[mi][ni], af[mi], b);
            }
        }
      }
    }
    if (cst != a.ncs - 1) continue;

    // The tile's epilogue: + bias, bf16 into os, then 16-byte runs out.
    const int tile = blockIdx.x + (u / a.ncs) * gridDim.x;
    const int n = tile / a.tiles_t, t0 = (tile % a.tiles_t) * POS;
    __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(xs);
    __syncthreads();  // every warp is done reading xs, which os aliases
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm * 32 + mi * 16 + half * 8 + g;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          *reinterpret_cast<__nv_bfloat162*>(os + row * LDO + wn * 32 + ni * 8 + tg * 2) =
              __halves2bfloat162(
                  __float2bfloat16_rn(__fadd_rn(acc[mi][ni][half * 2], rb[mi][half])),
                  __float2bfloat16_rn(__fadd_rn(acc[mi][ni][half * 2 + 1], rb[mi][half])));
          acc[mi][ni][half * 2] = acc[mi][ni][half * 2 + 1] = 0.0f;
        }
      }
    }
    __syncthreads();
    constexpr int LANES = POS / 8;         // lanes that store one row, 8 positions each
    constexpr int ROWS = 32 / LANES;       // rows a warp stores at once
    const int col = (lane % LANES) * 8;
    if (t0 + col >= a.t) continue;         // T is a multiple of 8: a run is whole
    __nv_bfloat16* tile_out = a.out + ((size_t)n * a.cout + co0) * a.t + t0 + col;
    const int rows = min(CO_TILE, a.cout - co0);
    for (int row = warp * ROWS + lane / LANES; row < rows; row += (THREADS / 32) * ROWS) {
      *reinterpret_cast<uint4*>(tile_out + (size_t)row * a.t) =
          *reinterpret_cast<const uint4*>(os + row * LDO + col);
    }
  }
}

// The launch's geometry from the shapes: the window offset and chunks, and
// the layout that keeps the most blocks on an SM (shared memory and
// registers both bound it): the weights resident with
// three stages, or with two, or a weight slice a unit with two stages, in
// that order where they tie.
Args geometry(int cin, int cout, int t, int cin_p, int cout_p, int taps, int dil) {
  Args a{};
  a.cin = cin; a.cout = cout; a.t = t; a.cin_p = cin_p; a.cout_p = cout_p;
  a.taps = taps; a.dil = dil;
  a.pad = (taps - 1) * dil / 2;
  a.off = (8 - a.pad % 8) % 8;  // (-pad) mod 8
  const int rows = a.off + POS + (taps - 1) * dil;
  a.rc = ((rows + 15) / 16) * 2;
  a.lr = a.rc + 1;
  a.ncs = (cin_p + CS - 1) / CS;
  a.ld_w = 2 * cin_p + 16;
  const int options[3][2] = {{3, 1}, {2, 1}, {2, 0}};
  int best = -1;
  for (int i = 0; i < 3; ++i) {
    const size_t s = smem_of(a.rc, taps, cin_p, options[i][0], options[i][1]);
    const int blocks =
        s <= (size_t)MAX_SMEM ? min(MAX_BLOCKS, (int)(SM_SMEM / (s + BLOCK_RESERVED))) : 0;
    if (blocks > best) {
      best = blocks;
      a.nst = options[i][0];
      a.resident = options[i][1];
    }
  }
  a.w_bytes = a.resident ? (size_t)taps * CO_TILE * a.ld_w : 0;
  a.raw_bytes = (size_t)CS * a.lr * 16;
  a.stage_bytes = a.raw_bytes + (a.resident ? 0 : (size_t)taps * CO_TILE * CS * 2);
  return a;
}

size_t smem_bytes(const Args& a) {
  return smem_of(a.rc, a.taps, a.cin_p, a.nst, a.resident);
}

template <int NST, bool RES>
cudaError_t configure() {
  return cudaFuncSetAttribute(conv1d_bf16_kernel<NST, RES>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
}

// The kernel of a layout: stages and resident weights.
using Kernel = void (*)(Args);
Kernel kernel_of(const Args& a) {
  if (!a.resident) return conv1d_bf16_kernel<2, false>;
  return a.nst == 3 ? conv1d_bf16_kernel<3, true> : conv1d_bf16_kernel<2, true>;
}

// The blocks of `smem` bytes resident on an SM for the kernel, asked of the
// runtime once and kept: the first call allows the most shared memory,
// outside any graph capture's launches.
cudaError_t occupancy(int* per_sm, Kernel kernel, size_t smem) {
  static const cudaError_t configured = [] {
    cudaError_t err = configure<3, true>();
    if (err == cudaSuccess) err = configure<2, true>();
    return err == cudaSuccess ? configure<2, false>() : err;
  }();
  struct Entry { int device; Kernel kernel; size_t smem; int per_sm; };
  static std::mutex lock;
  static Entry kept[64];
  static int n_kept = 0;
  if (configured != cudaSuccess) return configured;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < n_kept; ++i) {
    if (kept[i].device == device && kept[i].kernel == kernel && kept[i].smem == smem) {
      *per_sm = kept[i].per_sm;
      return cudaSuccess;
    }
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, THREADS, smem);
  if (err == cudaSuccess && n_kept < 64) kept[n_kept++] = Entry{device, kernel, smem, *per_sm};
  return err;
}

}  // namespace

// x [N, Cin, T] bf16 contiguous, 16-byte aligned, T a multiple of 8; w
// [taps, cout_p, cin_p] bf16 contiguous, zero-padded, cout_p a multiple of
// 64 and cin_p of 16; bias [Cout] float32 or null; out [N, Cout, T] bf16
// contiguous, 16-byte aligned. Stride 1, taps 1 or 3, padding (taps - 1) * dil / 2; `sms`
// the card's SM count. Launches on `stream` and returns a CUDA error code
// (0 on success).
extern "C" int conv1d_bf16(const void* x, const void* w, const float* bias, void* out, int n,
                           int cin, int cout, int t, int cin_p, int cout_p, int taps, int dil,
                           int sms, void* stream) {
  if (taps < 1 || taps > MAX_TAPS || taps % 2 == 0 || dil < 1 || cin_p % CIN_ALIGN ||
      cout_p % CO_TILE || cin_p < cin || cout_p < cout || t % 8 || sms < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = geometry(cin, cout, t, cin_p, cout_p, taps, dil);
  const size_t smem = smem_bytes(a);
  if (smem > (size_t)MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || t == 0 || cout == 0) return static_cast<int>(cudaGetLastError());
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = bias;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.tiles_t = (t + POS - 1) / POS;
  a.tiles = n * a.tiles_t;
  const Kernel kernel = kernel_of(a);
  int per_sm = 0;
  cudaError_t err = occupancy(&per_sm, kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int co_tiles = a.cout_p / CO_TILE;
  const int slots = max(1, max(per_sm, 1) * sms / co_tiles);
  const dim3 grid(min(a.tiles, slots), co_tiles);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
