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
// the int8 tensor cores (1,979 TOP/s dense) would become the limit. So the
// design is about moving bytes; mma.sync m16n8k32 issues far more int8
// operations than the bytes allow, and wgmma would not move the bound.
//
// Design. A tile is 64 output channels (M) by 128 positions (N) of one
// sample; a block of 256 threads (8 warps, each a 32 x 32 tile of int32
// accumulators in 2 x 4 mma.sync.m16n8k32.s8 tiles) is persistent: it owns
// one 64-channel slice of the output, stages that slice's weights once
// ([tap][64][Cin padded to 32], the A operand, row-major) and walks the
// (n, t) tiles blockIdx.x, + gridDim.x, ... The work is a sequence of units,
// (tile, stage of up to 64 input channels), pipelined through a ring of
// three shared-memory stages:
// - a unit's codes come in as 16-byte cp.async copies of [channel][16
//   positions] straight from q's rows (T a multiple of 16: a 16-byte chunk
//   lies wholly inside or outside [0, T), and one outside is zero-filled),
//   issued two units ahead, so the copies of the next two units are in
//   flight while the tensor cores run this one;
// - each unit is then transposed in shared memory to [position][channel],
//   4 channels packed in a 32-bit word (the K-major words that m16n8k32's
//   B operand takes, so tap k's operand is the same buffer k * dil rows
//   down) by 4 x 4 byte-block transposes with __byte_perm: 4 16-byte reads
//   (4 channels x 16 positions), 32 permutes and 16 word stores a thread;
// - the raw stages are swizzled (a 16-byte chunk j of channel c at chunk
//   j ^ ((c >> 3) & 3) of a row of an odd number of chunks), so the
//   transpose's 16-byte reads fall on distinct banks, and its word stores
//   are staggered by 4 rows between the two half-warps for the same reason;
// - the epilogue writes each warp's accumulators, scaled and cast to the
//   output type, into shared memory ([channel][position], aliasing the
//   transposed codes), from which each warp stores whole rows of the tile
//   along T in 16-byte runs (4 float32 or 8 bfloat16 a thread). A
//   warp-private tile without the two barriers this costs was no faster
//   (and in float32 its extra shared memory halved the resident blocks
//   where Cin is 128).
// Rows are Cin-stage + 16 bytes apart in the transposed and weight
// buffers, so the fragment reads of a warp fall on 32 distinct banks.
// The fragments come from shared memory by ldmatrix (four 8 x 16-byte
// matrices an instruction). Where T is not a multiple of 16 (or q not
// 16-byte aligned), the units are staged with byte loads instead, and where
// the weights do not fit in shared memory beside the ring, each unit stages
// its own slice of them. Two blocks share an SM (three with bfloat16 out,
// whose epilogue tile is half the size).
//
// What bounds it as built: on the card it comes near its byte bound with
// float32 out but not with bfloat16 out, where neither the bytes nor the
// tensor cores are the limit: within a block the transpose, the MMAs and
// the epilogue of a unit run in turn between barriers, and only the next
// units' copies overlap them. A producer warp beside consumer warps would
// overlap them too (PERF.md, ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 8 warps: 2 along channels x 4 along positions
constexpr int CO_TILE = 64;    // output channels a block (M)
constexpr int POS = 128;       // positions a tile (N)
constexpr int CS = 64;         // input channels a unit
constexpr int LDS = CS + 16;   // bytes between transposed rows
constexpr int NST = 3;         // ring stages
constexpr int LDO = POS + 8;   // elements between epilogue rows
constexpr int MAX_TAPS = 3;
constexpr int MAX_SMEM = 232448;

struct Args {
  const int8_t* q;          // [N, Cin, T]
  const int8_t* w;          // [taps, cout_p, cin_p]
  const float* w_scale;     // [Cout]
  const float* act_scale;   // a float32 scalar, or null (folded into w)
  const float* bias;        // [Cout] or null
  void* out;                // [N, Cout, T], float32 or bfloat16
  int n, cin, cout, t, cin_p, cout_p, taps, dil, pad;
  int off;        // first needed position minus the 16-aligned window start
  int rc;         // 16-position chunks a unit's window spans
  int lr;         // chunks between raw rows (odd, >= rc rounded up to 4)
  int tiles_t, tiles, ncs;  // tiles along T, all tiles, channel stages a tile
  int resident;   // the weights are staged once (else a slice per unit)
  int ld_w;       // bytes between staged weight rows
  size_t raw_bytes, stage_bytes, w_bytes, xo_bytes;
};

// Shared-memory layout of one launch, in bytes: the resident weights (or
// none), NST stages (raw codes, then a unit's weight slice where the weights
// are not resident), then the transposed codes aliased with the epilogue's
// output tile (out_size bytes an element).
struct Layout {
  size_t w_bytes, raw_bytes, stage_bytes, xo_bytes, total;
};

Layout layout(int rc, int lr, int taps, int cin_p, bool resident, int out_size) {
  Layout l;
  l.w_bytes = resident ? (size_t)taps * CO_TILE * (cin_p + 16) : 0;
  l.raw_bytes = (size_t)CS * lr * 16;
  l.stage_bytes = l.raw_bytes + (resident ? 0 : (size_t)taps * CO_TILE * LDS);
  const size_t xs = (size_t)rc * 16 * LDS, os = (size_t)CO_TILE * LDO * out_size;
  l.xo_bytes = xs > os ? xs : os;
  l.total = l.w_bytes + NST * l.stage_bytes + l.xo_bytes;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 16-byte matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8; thread t gets bytes 4 (t % 4).. of row t / 4
// of each: an m16n8k32 operand's fragments in one instruction.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const unsigned char* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

__device__ __forceinline__ uint32_t word(const uint4& v, int m) {
  return m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w;
}

// Byte offset of channel c's 16-byte chunk j in a raw stage.
__device__ __forceinline__ int raw_offset(const Args& a, int c, int j) {
  return (c * a.lr + (j ^ ((c >> 3) & 3))) * 16;
}

// Stage unit u (tile, channel stage) into raw stage `st`: the codes of the
// window [t0 - pad - off, ... + rc * 16) of its channels, and its weight
// slice where the weights are not resident.
// One 16-byte chunk of unit codes: channel c (of the stage) at chunk j.
template <bool ALIGNED>
__device__ __forceinline__ void stage_chunk(const Args& a, const int8_t* qn, int c0, int w0,
                                            int c, int j, unsigned char* stage) {
  const int ch = c0 + c, p = w0 + 16 * j;
  unsigned char* dst = stage + raw_offset(a, c, j);
  if (ALIGNED) {
    const bool in = ch < a.cin && p >= 0 && p < a.t;
    cp_async16(dst, in ? qn + (size_t)ch * a.t + p : a.q, in ? 16 : 0);
  } else {
    alignas(16) unsigned char v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int pi = p + i;
      v[i] = ch < a.cin && pi >= 0 && pi < a.t
                 ? static_cast<unsigned char>(__ldg(qn + (size_t)ch * a.t + pi))
                 : 0;
    }
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

// Stage unit u (tile, channel stage) into a ring stage: the codes of the
// window [t0 - pad - off, ... + rc * 16) of its channels, and its weight
// slice where the weights are not resident.
template <bool ALIGNED>
__device__ void issue(const Args& a, int u, unsigned char* stage) {
  const int tile = blockIdx.x + (u / a.ncs) * gridDim.x;
  const int c0 = (u % a.ncs) * CS;
  const int cs = min(CS, a.cin_p - c0);
  const int n = tile / a.tiles_t;
  const int w0 = (tile % a.tiles_t) * POS - a.pad - a.off;  // a multiple of 16
  const int8_t* qn = a.q + (size_t)n * a.cin * a.t;
  if (a.rc <= 16) {  // 16 threads a channel row, one chunk each
    const int j = threadIdx.x & 15;
    if (j < a.rc) {
      for (int c = threadIdx.x >> 4; c < cs; c += THREADS / 16) {
        stage_chunk<ALIGNED>(a, qn, c0, w0, c, j, stage);
      }
    }
  } else {  // windows of more than 16 chunks (dilations of about 64 and more)
    for (int e = threadIdx.x; e < cs * a.rc; e += THREADS) {
      const int c = e / a.rc;
      stage_chunk<ALIGNED>(a, qn, c0, w0, c, e - c * a.rc, stage);
    }
  }
  if (!a.resident) {
    const int co0 = blockIdx.y * CO_TILE;
    unsigned char* ws = stage + a.raw_bytes;
    const int vecs = cs / 16;
    for (int e = threadIdx.x; e < a.taps * CO_TILE * vecs; e += THREADS) {
      const int v = e % vecs, row = e / vecs;  // row = tap * CO_TILE + channel
      const int k = row / CO_TILE, co = row - k * CO_TILE;
      cp_async16(ws + (size_t)row * LDS + v * 16,
                 a.w + ((size_t)k * a.cout_p + co0 + co) * a.cin_p + c0 + v * 16, 16);
    }
  }
}

// The raw stage [channel][position] -> xs [position][channel words]: a job
// is 4 channels x 16 positions, 4 x 4 byte blocks transposed by permutes.
__device__ void transpose(const Args& a, int cs, const unsigned char* raw, unsigned char* xs) {
  const int shift = cs == CS ? 4 : 3;  // log2 of the channel groups (cs 64 or 32)
  for (int e = threadIdx.x; e < (a.rc << shift); e += THREADS) {
    const int cw = e & ((1 << shift) - 1), j = e >> shift;
    uint4 r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i] = *reinterpret_cast<const uint4*>(raw + raw_offset(a, 4 * cw + i, j));
    }
    uint32_t o[16];  // o[p]: channels 4cw..4cw+3 at position 16j + p
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t t0 = __byte_perm(word(r[0], m), word(r[1], m), 0x5140);
      const uint32_t t1 = __byte_perm(word(r[0], m), word(r[1], m), 0x7362);
      const uint32_t t2 = __byte_perm(word(r[2], m), word(r[3], m), 0x5140);
      const uint32_t t3 = __byte_perm(word(r[2], m), word(r[3], m), 0x7362);
      o[4 * m + 0] = __byte_perm(t0, t2, 0x5410);
      o[4 * m + 1] = __byte_perm(t0, t2, 0x7632);
      o[4 * m + 2] = __byte_perm(t1, t3, 0x5410);
      o[4 * m + 3] = __byte_perm(t1, t3, 0x7632);
    }
    // Odd columns store 4 rows ahead of even ones (16 rows are 0 mod 32
    // banks apart), so a warp's two columns fall on distinct banks.
    const bool odd = j & 1;
    unsigned char* base = xs + (size_t)16 * j * LDS + 4 * cw;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const int row = odd ? (p + 4) & 15 : p;
      *reinterpret_cast<uint32_t*>(base + (size_t)row * LDS) = odd ? o[(p + 4) & 15] : o[p];
    }
  }
}

__device__ __forceinline__ void put2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ void put2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
}

template <typename O, bool ALIGNED>
__global__ void __launch_bounds__(THREADS, sizeof(O) == 2 ? 3 : 2) conv1d_int8_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* wres = smem;                              // resident weights
  unsigned char* ring = smem + a.w_bytes;                  // NST stages
  unsigned char* xs = ring + NST * a.stage_bytes;          // transposed codes
  O* os = reinterpret_cast<O*>(xs);                        // the epilogue (aliased)

  const int my_tiles = blockIdx.x < a.tiles ? (a.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int units = my_tiles * a.ncs;
  if (units == 0) return;
  const int co0 = blockIdx.y * CO_TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;     // the warp's 32 x 32 tile
  const int g = lane >> 2, tg = lane & 3;
  // ldmatrix rows: lane l addresses row l % 8 of matrix l / 8.
  const int lq = lane >> 3, lr = lane & 7;

  if (a.resident) {  // the block's weights, once, in the first unit's group
    const int vecs = a.cin_p / 16;
    for (int e = tid; e < a.taps * CO_TILE * vecs; e += THREADS) {
      const int v = e % vecs, row = e / vecs;
      const int k = row / CO_TILE, co = row - k * CO_TILE;
      cp_async16(wres + (size_t)row * a.ld_w + v * 16,
                 a.w + ((size_t)k * a.cout_p + co0 + co) * a.cin_p + v * 16, 16);
    }
  }
  issue<ALIGNED>(a, 0, ring);
  cp_async_commit();
  if (units > 1) issue<ALIGNED>(a, 1, ring + a.stage_bytes);
  cp_async_commit();

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  // Per-row epilogue constants of this thread's 4 rows.
  float rs[2][2], rb[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = min(co0 + wm * 32 + mi * 16 + half * 8 + g, a.cout - 1);
      rs[mi][half] = a.w_scale[co];
      rb[mi][half] = a.bias != nullptr ? a.bias[co] : 0.0f;
    }
  const float act = a.act_scale != nullptr ? *a.act_scale : 1.0f;
  O* out = static_cast<O*>(a.out);
  constexpr int RUN = 16 / sizeof(O);  // positions a 16-byte run
  const bool vec_out = ((size_t)a.t * sizeof(O)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.out) % 16 == 0;

  for (int u = 0; u < units; ++u) {
    cp_async_wait_one();  // unit u (and the weights) landed
    __syncthreads();      // ... for every thread; every warp is done with xs
    if (u + 2 < units) issue<ALIGNED>(a, u + 2, ring + ((u + 2) % NST) * a.stage_bytes);
    cp_async_commit();
    unsigned char* stage = ring + (u % NST) * a.stage_bytes;
    const int cst = u % a.ncs;
    const int c0 = cst * CS;
    const int cs = min(CS, a.cin_p - c0);
    transpose(a, cs, stage, xs);
    __syncthreads();

    const unsigned char* wbase = a.resident ? wres + c0 : stage + a.raw_bytes;
    const int ldw = a.resident ? a.ld_w : LDS;
    // A: matrices (rows 0-7 | 8-15) x (bytes 0-15 | 16-31) of a 16-row tile;
    // B: (bytes 0-15 | 16-31) of two 8-row tiles.
    const unsigned char* wlane = wbase + (size_t)(wm * 32 + (lq & 1) * 8 + lr) * ldw +
                                 (lq >> 1) * 16;
    const unsigned char* xlane = xs + (size_t)(a.off + wn * 32 + (lq >> 1) * 8 + lr) * LDS +
                                 (lq & 1) * 16;
    for (int k = 0; k < a.taps; ++k) {
      const unsigned char* wk = wlane + (size_t)k * CO_TILE * ldw;
      const unsigned char* xk = xlane + (size_t)k * a.dil * LDS;
      for (int kk = 0; kk < cs; kk += 32) {
        uint32_t af[2][4], bf[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) ldsm_x4(af[mi], wk + (size_t)mi * 16 * ldw + kk);
#pragma unroll
        for (int np = 0; np < 2; ++np) ldsm_x4(bf[np], xk + (size_t)np * 16 * LDS + kk);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const uint32_t b[2] = {bf[ni >> 1][(ni & 1) * 2], bf[ni >> 1][(ni & 1) * 2 + 1]};
            mma_s8(acc[mi][ni], af[mi], b);
          }
      }
    }
    if (cst != a.ncs - 1) continue;

    // Epilogue of the tile: scaled values into os, then 16-byte runs out.
    const int tile = blockIdx.x + (u / a.ncs) * gridDim.x;
    const int n = tile / a.tiles_t, t0 = (tile % a.tiles_t) * POS;
    __syncthreads();  // every warp is done reading xs, which os aliases
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm * 32 + mi * 16 + half * 8 + g;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          float v[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float y = __fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + j]), rs[mi][half]);
            if (a.act_scale != nullptr) y = __fmul_rn(y, act);
            if (a.bias != nullptr) y = __fadd_rn(y, rb[mi][half]);
            v[j] = y;
            acc[mi][ni][half * 2 + j] = 0;
          }
          put2(os + row * LDO + wn * 32 + ni * 8 + tg * 2, v[0], v[1]);
        }
      }
    }
    __syncthreads();
    constexpr int LANES = POS / RUN;       // lanes that store one row
    constexpr int ROWS = 32 / LANES;       // rows a warp stores at once
    const int col = (lane % LANES) * RUN;
    O* tile_out = out + ((size_t)n * a.cout + co0) * a.t + t0 + col;
    const int left = a.t - t0 - col;       // positions of this lane's run inside T
    const int rows = min(CO_TILE, a.cout - co0);
    for (int row = warp * ROWS + lane / LANES; row < rows; row += (THREADS / 32) * ROWS) {
      O* dst = tile_out + (size_t)row * a.t;
      const O* src = os + row * LDO + col;
      if (vec_out && left >= RUN) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int i = 0; i < RUN && i < left; ++i) dst[i] = src[i];
      }
    }
  }
}

// The launch's geometry from the shapes: the window offset, chunks, and
// whether the weights stay resident.
Args geometry(int cin, int cout, int t, int cin_p, int cout_p, int taps, int dil,
              int out_size) {
  Args a{};
  a.cin = cin; a.cout = cout; a.t = t; a.cin_p = cin_p; a.cout_p = cout_p;
  a.taps = taps; a.dil = dil;
  a.pad = (taps - 1) * dil / 2;
  a.off = ((a.pad % 16) == 0) ? 0 : 16 - a.pad % 16;  // (-pad) mod 16
  const int rows = POS + (taps - 1) * dil;
  a.rc = (a.off + rows + 15) / 16;
  a.lr = ((a.rc + 3) / 4) * 4 + 1;
  a.ncs = (cin_p + CS - 1) / CS;
  Layout l = layout(a.rc, a.lr, taps, cin_p, true, out_size);
  a.resident = l.total <= (size_t)MAX_SMEM;
  if (!a.resident) l = layout(a.rc, a.lr, taps, cin_p, false, out_size);
  a.ld_w = cin_p + 16;
  a.w_bytes = l.w_bytes; a.raw_bytes = l.raw_bytes;
  a.stage_bytes = l.stage_bytes; a.xo_bytes = l.xo_bytes;
  return a;
}

size_t smem_bytes(const Args& a) {
  return a.w_bytes + NST * a.stage_bytes + a.xo_bytes;
}

// The blocks of `smem` bytes resident on an SM, after allowing the most
// shared memory (once, outside any graph capture's launches).
template <typename O, bool ALIGNED>
cudaError_t occupancy(int* per_sm, size_t smem) {
  static const cudaError_t configured = cudaFuncSetAttribute(
      conv1d_int8_kernel<O, ALIGNED>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (configured != cudaSuccess) return configured;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, conv1d_int8_kernel<O, ALIGNED>,
                                                       THREADS, smem);
}

template <typename O, bool ALIGNED>
cudaError_t launch(Args a, int sms, cudaStream_t stream) {
  const size_t smem = smem_bytes(a);
  int per_sm = 0;
  cudaError_t err = occupancy<O, ALIGNED>(&per_sm, smem);
  if (err != cudaSuccess) return err;
  const int co_tiles = a.cout_p / CO_TILE;
  const int slots = max(1, max(per_sm, 1) * sms / co_tiles);
  const dim3 grid(min(a.tiles, slots), co_tiles);
  conv1d_int8_kernel<O, ALIGNED><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int conv1d_int8_co_tile() { return CO_TILE; }
extern "C" int conv1d_int8_max_smem() { return MAX_SMEM; }

// Shared memory a launch of these shapes takes (the weights staged once
// where they fit, else a slice a unit).
extern "C" long long conv1d_int8_smem(int cin_p, int taps, int dil) {
  return static_cast<long long>(smem_bytes(geometry(cin_p, CO_TILE, POS, cin_p, CO_TILE,
                                                    taps, dil, sizeof(float))));
}

// q [N, Cin, T] int8 contiguous; w [taps, cout_p, cin_p] int8 contiguous,
// zero-padded, cout_p a multiple of 64 and cin_p of 32; w_scale [Cout] and
// bias [Cout] (or null) float32; act_scale a float32 scalar on the device or
// null; out [N, Cout, T] contiguous, float32 (out_dtype 0) or bfloat16 (1).
// Stride 1, taps 1 or 3, padding (taps - 1) * dil / 2; `sms` the card's SM
// count. Launches on `stream` and returns a CUDA error code (0 on success).
extern "C" int conv1d_int8(const void* q, const void* w, const float* w_scale,
                           const float* act_scale, const float* bias, void* out,
                           int out_dtype, int n, int cin, int cout, int t, int cin_p,
                           int cout_p, int taps, int dil, int sms, void* stream) {
  if (taps < 1 || taps > MAX_TAPS || taps % 2 == 0 || dil < 1 || cin_p % 32 ||
      cout_p % CO_TILE || cin_p < cin || cout_p < cout || sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = geometry(cin, cout, t, cin_p, cout_p, taps, dil,
                    out_dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16));
  if (smem_bytes(a) > (size_t)MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || t == 0 || cout == 0) return static_cast<int>(cudaGetLastError());
  a.q = static_cast<const int8_t*>(q);
  a.w = static_cast<const int8_t*>(w);
  a.w_scale = w_scale;
  a.act_scale = act_scale;
  a.bias = bias;
  a.out = out;
  a.n = n;
  a.tiles_t = (t + POS - 1) / POS;
  a.tiles = n * a.tiles_t;
  const bool aligned = t % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_dtype == 0) {
    err = aligned ? launch<float, true>(a, sms, s) : launch<float, false>(a, sms, s);
  } else {
    err = aligned ? launch<__nv_bfloat16, true>(a, sms, s)
                  : launch<__nv_bfloat16, false>(a, sms, s);
  }
  return static_cast<int>(err);
}
