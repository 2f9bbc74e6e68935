// The dequantize-matmul of the quantized frozen base at training rows, for
// Hopper, sm_90a:
//   K5, tile path   y  = x  @ W     packed int4, bf16 x, M > 16 rows
//   K6              dx = dy @ W^T   packed int4, bf16 dy, every row count
//   K7, tile path   y  = x  @ W     int8, bf16 x, M > 16 rows
//   K8              dx = dy @ W^T   int8, bf16 dy, every row count
// with W (in, out) the dequantized weight, each cell rounded to bf16 once,
//   W[j, o] = round_bf16( q(j, o) * scales[(j / group) * out + o] ),
// int4: q the offset-8 nibble of byte packed[(j mod h) * out + o], h = in /
// 2: the low nibble for j < h, the high one for j >= h;
// int8: q = q_t[j * out + o], one scale row (group = in).
// Sums in fp32, the output rounded to bf16 once.  Each cell's arithmetic is
// quant_matmul.cu's `dequant_group` (the code byte, int8's with its sign
// bit flipped, placed in 2^23 by a byte permute, the offset subtracted, the
// f32 scale multiplied, pairs rounded with __floats2bfloat162_rn), so the
// cells are the decode kernel's and the JAX kernels' bit for bit.
//
// Replaces the Pallas TPU kernels of sparse_matrix_fine_tuning_tpu/
// kernels/quant_matmul.py at these row counts: `_fwd_kernel` (K5, :115),
// `_bwd_kernel` (K6, :141), `_fwd8_kernel` (K7, :305) and `_bwd8_kernel`
// (K8, :312).  The decode rows (M <= 16) and f32 activations stay in
// quant_matmul.cu, whose smft_quant_mm dispatches here.
//
// What bounds it: operations (2 M in out; at M = 2048 every projection of
// the 1.1B model is above the card's 295 operations a byte).  Only wgmma
// reaches the tensor cores' full rate, and it takes bf16 operands, so the
// codes are dequantized on chip beside the MMAs, one way a format:
//  * int4, qwgmma_kernel: the dequantized weight is wgmma's B operand in
//    shared memory, written by dequant warpgroups of its own (below);
//  * int8, qwgmma_rs_kernel: it is wgmma's A operand in registers, built by
//    the consumer warpgroups themselves, in the transposed product (after
//    qwgmma_kernel).  int8 through qwgmma_kernel (one code a byte, a
//    128-code-row stage) was slower at every shape of the 1.1B model
//    (PERF.md §6).
//
// qwgmma_kernel, a warp-specialised mixed-input GEMM, a CTA computing a
// 128 x 128 output tile with 576 threads:
//   * two producer warps: lane 0 of one issues the TMA loads of the
//     activations (two (128 x 64) boxes of x or dy a stage), lane 0 of the
//     other those of the code tiles (64 code rows x 128 bytes of out a
//     stage, uint8), all in the 128-byte swizzle (an unswizzled uint8 box
//     loaded at a fraction of the rate), each into its own ring with full
//     and empty mbarriers;
//   * two dequant warpgroups wait for a code stage, convert its bytes to
//     bf16 in registers and write them straight into the swizzled layout
//     wgmma reads, run fence.proxy.async (without it wgmma may read stale
//     shared memory) and arrive on the B stage's full barrier.  A thread
//     keeps 8 columns of 4 code rows; it reads their f32 scales from global
//     memory through the read-only cache, a stage ahead when the 4 rows
//     share a scale row (group % 4 == 0);
//   * two consumer warpgroups (64 rows each) run m64n128k16 wgmma on the
//     activation and B stages, release both as soon as the stage's MMAs are
//     done (so that the dequant of stage kt + 2 overlaps the MMAs of kt + 1),
//     and round the fp32 sums to bf16 in the epilogue, straight from the
//     fragments.
// So the unpack runs beside the MMAs, not before them, as it did in the
// mma.sync kernel this replaces.  Each code byte serves both halves: it
// leaves memory once and is unpacked once a CTA, as on the TPU:
//   forward: a stage holds code rows r0 .. r0 + 63 x 128 columns of out;
//     its bytes become two B tiles, lo (input columns r0 + r) and hi
//     (h + r0 + r), MN-major as K15's w tile (64-column boxes of 64 k-rows
//     x 128 bytes), which meet x[:, r0:r0+64] and x[:, h+r0:h+r0+64]: k =
//     128 a stage into one accumulator;
//   dx: a CTA's 128 output columns are 64 low columns j0 .. j0 + 63 and
//     their partners h + j0 ..; a stage holds their 64 code rows x 128
//     columns of out o0 ..: one K-major B tile (n: the 64 lo columns, then
//     the 64 hi; k: two 64-column halves), as K15's x tile, against dy's
//     columns o0 .. o0 + 127.
// The scale row of code row r is r / group for lo and (h + r) / group =
// r / group + h / group for hi (h % group == 0).
//
// Budget (BM = 128 rows): a dequantized cell feeds 128 multiply-adds, 1/16
// of a clock of the SM's 2048 bf16 FMA a clock; its unpack takes about 3.5
// thread-instructions (permute, subtract, multiply, half a pair conversion,
// the store), 3.5/128 of a clock of the SM's four issue slots: the unpack
// needs about 44% of the MMA's time, beside it.  What holds it instead is
// the bytes each SM takes in: a stage's 40 KB (32 KB of x, re-read by
// every column tile, and 8 KB of codes) against 1,024 clocks of MMA
// (scripts/probe_int4_wgmma.py measures it; PERF.md §6).  A wider tile
// (BN = 256) would halve x's share, but m64n256's 128 fp32 sums a consumer
// thread leave room for 384 threads, one dequant warpgroup, too few to
// unpack for it.
//
// Edges: a zero code byte is -8 s, not 0, so TMA's zero fill does not give
// zero weights: the dequant warpgroups write 0 for every code row past h
// and every column past out, and read no scale there.  x columns past h in
// a lo tile are real x values, which the zeroed B rows cancel; rows past M
// and columns past in or out come in as zeros.  x's high half starts at
// column h, where a TMA box must start on 16 bytes: where h % 8 != 0 the
// forward reads an aligned copy of x instead, (M, 2 h8) with h8 = h rounded
// up to 8, its low half at column 0, its high half at h8 and zeros between
// (one pass over x into the call's scratch, at widths no model of the
// repository has; the zeros meet zeroed B rows).
//
// Few output tiles (k_proj and v_proj, out 256; small M): the reduction is
// split over CTAs (blockIdx.z, slices of whole stages), each writing fp32
// partial sums that quant_matmul.cu's second pass (smft_split_sum_bf16)
// adds in a fixed order (no atomics: dx repeats bit for bit).
//
// The C interface takes raw pointers and returns a cudaError_t;
// quant_matmul.cu's smft_quant_mm calls it, and ops.cpp binds that.

#include <cuda.h>  // CUtensorMap and its enums: types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

// quant_matmul.cu: the split reduction's second pass.
extern "C" int smft_split_sum_bf16(const float* partial, void* y, int64_t total, int slices,
                                   void* stream);

namespace {

using namespace smft_hopper;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;        // output rows a CTA: two consumer warpgroups of 64
constexpr int kBN = 128;        // output columns a CTA
constexpr int kRows = 64;       // code rows of a stage's code tile
constexpr int kCols = 128;      // columns of out of a stage's code tile (128 bytes)
constexpr int kConsumers = 2;   // warpgroups 0 and 1
constexpr int kDequant = 2;     // warpgroups 2 and 3
constexpr int kThreads = 128 * (kConsumers + kDequant) + 64;  // and two producer warps
constexpr int kAtomBytes = 1024;  // 8 rows of 128 bytes: the swizzle's period
constexpr int kBox = kBM * 64 * 2;  // one (128 x 64) bf16 activation box, 16 KB
constexpr int kABytes = 2 * kBox;   // a stage's activations: two boxes, k = 128
constexpr int kCBytes = kRows * kCols;  // a stage's code tile, 8 KB
constexpr int kBBytes = 128 * kBN * 2;  // a stage's B: k = 128 x 128 bf16
constexpr int kSa = 4, kSc = 4, kSb = 2;  // ring depths
constexpr int kSmem = kSa * kABytes + kSc * kCBytes + kSb * kBBytes +
                      8 * 2 * (kSa + kSc + kSb) + kAtomBytes;
static_assert(kSmem <= 232448, "the stages must fit in 227 KB of shared memory");

struct Params {
  bf16* y;          // (M, N) bf16 output, N = out (forward) or in (dx)
  float* partial;   // (slices, M, N) fp32 partial sums where the reduction is split
  const float* scales;  // (in / group, out) f32
  int64_t M;
  int h;            // code rows, in / 2
  int x_hi;         // forward: the column of the activations' high half (h, or h8)
  int out;          // columns of the codes
  int group;
  int steps;        // stages of the whole reduction
  int per_slice;    // stages a slice (blockIdx.z)
};

// One cell: byte e of `u`, a code offset by kOffset (an int4 nibble, already
// shifted to the low half of its byte: 8), times its scale, in f32:
// quant_matmul.cu's dequant_group.
template <int e, int kOffset>
__device__ __forceinline__ float cell(uint32_t u, float s) {
  return (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) - (8388608.f + kOffset)) * s;
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 8 bf16 cells of 8 code bytes (w, little-endian: column c in byte c),
// the low nibbles (shift 0) or the high ones (shift 4), with their scales.
__device__ __forceinline__ uint4 dequant8(uint2 w, int shift, const float (&s)[8]) {
  const uint32_t u0 = (w.x >> shift) & 0x0F0F0F0Fu, u1 = (w.y >> shift) & 0x0F0F0F0Fu;
  return make_uint4(bf16x2(cell<0, 8>(u0, s[0]), cell<1, 8>(u0, s[1])),
                    bf16x2(cell<2, 8>(u0, s[2]), cell<3, 8>(u0, s[3])),
                    bf16x2(cell<0, 8>(u1, s[4]), cell<1, 8>(u1, s[5])),
                    bf16x2(cell<2, 8>(u1, s[6]), cell<3, 8>(u1, s[7])));
}

__device__ __forceinline__ void ldg8(float (&s)[8], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  s[0] = a.x, s[1] = a.y, s[2] = a.z, s[3] = a.w, s[4] = b.x, s[5] = b.y, s[6] = b.z, s[7] = b.w;
}

// A stage's code tile is code rows row0 .. + 63 x columns col0 .. + 127 of
// out: forward (row0, col0) = (64 kt, n0), dx (j0, 128 kt).
template <bool kDx>
__device__ __forceinline__ void stage_origin(int kt, int n0, int& row0, int& col0) {
  row0 = kDx ? n0 : kt * kRows;
  col0 = kDx ? kt * kCols : n0;
}

template <bool kDx>
__global__ void __launch_bounds__(kThreads, 1)
    qwgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_codes, const Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + kAtomBytes - 1) & ~static_cast<uint32_t>(kAtomBytes - 1);
  uint8_t* const gbase = smem_raw + (base - raw_u32);  // the same, as a generic pointer
  const uint32_t a_smem = base;                     // kSa stages of activations
  const uint32_t c_smem = a_smem + kSa * kABytes;   // kSc stages of codes and scales
  const uint32_t b_smem = c_smem + kSc * kCBytes;   // kSb stages of dequantized B
  const uint32_t bars = b_smem + kSb * kBBytes;
  const uint32_t a_full = bars, a_empty = a_full + 8 * kSa;
  const uint32_t c_full = a_empty + 8 * kSa, c_empty = c_full + 8 * kSc;
  const uint32_t b_full = c_empty + 8 * kSc, b_empty = b_full + 8 * kSb;

  const int m0 = blockIdx.x * kBM;
  // forward: the tile's first column of out; dx: its first code row j0
  const int n0 = blockIdx.y * (kDx ? kBN / 2 : kBN);
  const int kt0 = blockIdx.z * p.per_slice;
  const int steps = min(p.per_slice, p.steps - kt0);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSa; ++s) {
      mbar_init(a_full + 8 * s, 1);            // the producer's arrive + bytes
      mbar_init(a_empty + 8 * s, kConsumers);  // one arrive a consumer warpgroup
    }
    for (int s = 0; s < kSc; ++s) {
      mbar_init(c_full + 8 * s, 1);
      mbar_init(c_empty + 8 * s, 4 * kDequant);  // one arrive a dequant warp
    }
    for (int s = 0; s < kSb; ++s) {
      mbar_init(b_full + 8 * s, 4 * kDequant);
      mbar_init(b_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers + kDequant) {
    // The producer warps; lane 0 of each issues its ring's TMA loads: the
    // activations, two (128 x 64) boxes a stage at k r0 and h + r0
    // (forward) or o0 and o0 + 64 (dx); the code tiles.
    if (threadIdx.x % 32 != 0) return;
    const bool acts = threadIdx.x / 32 == 4 * (kConsumers + kDequant);
    const CUtensorMap* map = acts ? &map_a : &map_codes;
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
    const int depth = acts ? kSa : kSc;
    const uint32_t full0 = acts ? a_full : c_full, empty0 = acts ? a_empty : c_empty;
    for (int kt = 0; kt < steps; ++kt) {
      const int s = kt % depth;
      if (kt >= depth) wait_or_trap(empty0 + 8 * s, ((kt / depth) - 1) & 1);
      const uint32_t full = full0 + 8 * s;
      int row0, col0;
      stage_origin<kDx>(kt0 + kt, n0, row0, col0);
      if (acts) {
        mbar_expect_tx(full, kABytes);
        const int k0 = kDx ? col0 : row0;
        const uint32_t dst = a_smem + s * kABytes;
        tma_load_2d(dst, &map_a, full, k0, m0);
        tma_load_2d(dst + kBox, &map_a, full, kDx ? k0 + 64 : p.x_hi + k0, m0);
      } else {
        mbar_expect_tx(full, kCBytes);
        tma_load_2d(c_smem + s * kCBytes, &map_codes, full, col0, row0);
      }
    }
    return;
  }

  if (wg >= kConsumers) {
    // A dequant thread: columns col0 + 8 cg .. + 7 of code rows 4 rs .. 4 rs
    // + 3 of each stage's tile.  Its B cells: forward, B MN-major (k = the
    // code row, lo then hi; n = the column, in 64-column boxes); dx, B
    // K-major (n = the code row, lo then hi; k = the column, in 64-column
    // halves).  A row of 128 bytes holds 16-byte chunk c at c ^ (row % 8).
    const int t = threadIdx.x - 128 * kConsumers;
    const int cg = t % 16, rs = t / 16;
    const int sw = 4 * (rs % 2);  // (4 rs + i) % 8 = sw + i
    const int st_off = kDx ? (cg / 8) * (kBBytes / 2) + 4 * rs * 128
                           : (cg / 8) * (64 * 128) + 4 * rs * 128;
    const int hi_off = kDx ? 64 * 128 : kBBytes / 2;
    const int64_t hi_rows = static_cast<int64_t>(p.h / p.group) * p.out;  // lo to hi scales
    // The scales of code row `row`, columns col .. col + 7, lo and hi, read
    // through the read-only cache (zeros where the cells are masked).
    auto fetch = [&](int row, int col, float (&lo)[8], float (&hi)[8]) {
      if (row < p.h && col < p.out) {
        const float* q = p.scales + static_cast<int64_t>(row / p.group) * p.out + col;
        ldg8(lo, q);
        ldg8(hi, q + hi_rows);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) lo[e] = hi[e] = 0.f;
      }
    };
    // When the group is a multiple of 4 the thread's 4 rows share one scale
    // row, fetched a stage ahead; otherwise each row's at its use.
    const bool uniform = p.group % 4 == 0;
    float s_lo[8], s_hi[8], n_lo[8], n_hi[8];
    if (uniform) {
      int row0, col0;
      stage_origin<kDx>(kt0, n0, row0, col0);
      fetch(row0 + 4 * rs, col0 + 8 * cg, s_lo, s_hi);
    }
    for (int kt = 0; kt < steps; ++kt) {
      const int sc = kt % kSc, sb = kt % kSb;
      if (uniform && kt + 1 < steps) {
        int row0, col0;
        stage_origin<kDx>(kt0 + kt + 1, n0, row0, col0);
        fetch(row0 + 4 * rs, col0 + 8 * cg, n_lo, n_hi);
      }
      int row0, col0;
      stage_origin<kDx>(kt0 + kt, n0, row0, col0);
      const bool col_ok = col0 + 8 * cg < p.out;
      wait_or_trap(c_full + 8 * sc, (kt / kSc) & 1);
      const uint8_t* cs = gbase + (c_smem - base) + sc * kCBytes;
      uint2 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * rs + i;
        w[i] = *reinterpret_cast<const uint2*>(cs + r * 128 + (((cg / 2) ^ (r % 8)) << 4) +
                                               (cg % 2) * 8);
      }
      if (kt >= kSb) wait_or_trap(b_empty + 8 * sb, ((kt / kSb) - 1) & 1);
      uint8_t* b = gbase + (b_smem - base) + sb * kBBytes + st_off;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * rs + i;
        if (!uniform) fetch(row0 + r, col0 + 8 * cg, s_lo, s_hi);
        uint4 lo = dequant8(w[i], 0, s_lo), hi = dequant8(w[i], 4, s_hi);
        if (!col_ok || row0 + r >= p.h) lo = hi = make_uint4(0u, 0u, 0u, 0u);
        const int off = i * 128 + (((cg % 8) ^ (sw + i)) << 4);
        *reinterpret_cast<uint4*>(b + off) = lo;
        *reinterpret_cast<uint4*>(b + hi_off + off) = hi;
      }
      fence_proxy_async();
      __syncwarp();
      if (t % 32 == 0) {
        mbar_arrive(b_full + 8 * sb);
        mbar_arrive(c_empty + 8 * sc);  // after the stores that used the codes
      }
      if (uniform) {
#pragma unroll
        for (int e = 0; e < 8; ++e) s_lo[e] = n_lo[e], s_hi[e] = n_hi[e];
      }
    }
    return;
  }

  // A consumer warpgroup: rows m0 + 64 wg .. + 63 of the tile.
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_acc(acc);
  const uint32_t a_rows = wg * 64 * 128;  // the warpgroup's rows in an activation box
  for (int kt = 0; kt < steps; ++kt) {
    const int sa = kt % kSa, sb = kt % kSb;
    wait_or_trap(a_full + 8 * sa, (kt / kSa) & 1);
    wait_or_trap(b_full + 8 * sb, (kt / kSb) & 1);
    wgmma_fence();
    const uint32_t a = a_smem + sa * kABytes + a_rows;
    const uint32_t b = b_smem + sb * kBBytes;
    // k = 128: two halves of 64 (x_lo and x_hi, or dy's two boxes), four
    // k16 steps each.  A K-major: 32 bytes a step in its swizzled rows.
    // B forward MN-major: 16 rows of 128 bytes a step, the two 64-column
    // boxes 8192 bytes apart; dx K-major as A.
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = sw128_desc(a + half * kBox + kk * 32, 16, kAtomBytes);
        if constexpr (kDx) {
          const uint64_t db = sw128_desc(b + half * (kBBytes / 2) + kk * 32, 16, kAtomBytes);
          wgmma_m64n128k16<0>(acc, da, db);
        } else {
          const uint64_t db =
              sw128_desc(b + half * (kBBytes / 2) + kk * 2048, 64 * 128, kAtomBytes);
          wgmma_m64n128k16<1>(acc, da, db);
        }
      }
    wgmma_commit();
    // Release the stage as soon as its MMAs are done, so that the dequant
    // warpgroups fill it with stage kt + kSb while stage kt + 1 multiplies.
    wgmma_wait<0>();
    if (threadIdx.x % 128 == 0) {
      mbar_arrive(a_empty + 8 * sa);
      mbar_arrive(b_empty + 8 * sb);
    }
  }
  fence_acc(acc);

  // The fragment: warp w of the warpgroup holds rows 16w + lane/4 and +8;
  // acc[4j .. 4j+3] are tile columns 8j + 2*(lane%4) and +1 of those rows.
  // dx: tile column n < 64 is dx column n0 + n, n >= 64 is h + n0 + n - 64.
  const int tl = threadIdx.x % 128;
  const int64_t row = m0 + wg * 64 + (tl / 32) * 16 + (tl % 32) / 4;
  const int64_t N = kDx ? 2 * static_cast<int64_t>(p.h) : p.out;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int n = 8 * j + 2 * (tl % 4);
    int64_t col;
    if constexpr (kDx) {
      const int jj = n0 + n % 64;
      if (jj >= p.h) continue;
      col = n < 64 ? jj : p.h + jj;
    } else {
      col = n0 + n;
      if (col >= p.out) continue;
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int64_t r = row + 8 * hr;
      if (r >= p.M) continue;
      const float v0 = acc[4 * j + 2 * hr], v1 = acc[4 * j + 2 * hr + 1];
      if (gridDim.z == 1) {
        *reinterpret_cast<__nv_bfloat162*>(p.y + r * N + col) = __floats2bfloat162_rn(v0, v1);
      } else {
        *reinterpret_cast<float2*>(p.partial + (blockIdx.z * p.M + r) * N + col) =
            make_float2(v0, v1);
      }
    }
  }
}

// -- int8: A in registers ----------------------------------------------------
//
// K7's tile path and K8 run the transposed product, the dequantized weight
// wgmma's A operand in registers and the activations B from shared memory:
//   forward  y^T  = W^T x^T: A rows the columns o of out, k = j;
//   dx       dx^T = W dy^T:  A rows the code rows j, k = o;
// B the tokens (rows of x or dy, K-major as TMA loads them), m64n256k16.
// Each dequantized cell feeds 256 multiply-adds, not 128, and never passes
// through shared memory: the dequant warpgroups, the B ring and its
// hand-off of the kernel above go, and the code bytes a stage brings in
// per multiply-add halve.  A CTA computes 128 output columns (two consumer
// warpgroups of 64) x 256 tokens; a producer warpgroup, which gives its
// registers up to them (setmaxnreg), issues from one thread the TMA loads
// of a stage (a (256 x 64) box of x or dy, 32 KB, and the stage's codes,
// 8 KB) into a ring of 5.  Each consumer thread builds its A fragment of
// the next wgmma group straight from the code bytes while the groups
// before it run.  Fragment row g of warp w's 16 is output column (or code
// row) 16 w + 2 g and row g + 8 the next one, so that a thread's two rows
// are adjacent: one 2-byte load gives both rows' codes at one k, a byte
// permute pairs them along k, and the epilogue stores bf16 pairs.  The
// codes: forward, a stage's 64 code rows j x 128 columns of out (128-byte
// swizzle); dx, the CTA's 128 code rows x the stage's 64 columns of out
// (64-byte swizzle: 16-byte chunk c of row r at c ^ ((r / 2) % 4)).
// Scales: forward the thread's two columns', for the whole loop; dx four a
// k16 step along k, through the read-only cache, a group ahead.  Zero
// weights past in and out: the scales of columns past out are 0, and codes
// and activations past in come in as TMA's zeros (an int8 zero code is
// weight 0).
//
// What holds it is the consumers' own work, not the loads: a stage's MMAs
// take about 1,024 clocks of its period of about 1,850, the consumers wait
// for a stage about 5% of it and the producer most of it for a free slot
// (scripts/probe_int4_wgmma.py --bits 8 traces it; PERF.md §6).  The A
// build beside the wgmmas is what registers limit: ptxas compiles every
// role at the launch bound's 168 registers a thread (setmaxnreg does not
// lift that), and m64n256's 128 sums leave room for few A registers; past
// that it serializes the wgmmas (C7512) and spills.  The schedule of each
// direction is the fastest of the kGroup x kBufs that fit (the probe's
// g<G>b<B> variants): the forward 4 buffers of one k16 step (three wgmmas
// in flight while the next A is built), dx one buffer of a whole stage
// (build, then 4 wgmmas, then wait: the two consumer warpgroups alternate
// on the tensor cores).

constexpr int kRsThreads = 3 * 128;  // two consumer warpgroups, a producer warpgroup
constexpr int kRsBM = 128;  // output columns (forward) or code rows (dx) a CTA
constexpr int kRsBN = 256;  // tokens a CTA
constexpr int kRsK = 64;    // k a stage
constexpr int kRsStages = 5;
constexpr int kRsXBytes = kRsBN * kRsK * 2;  // 32 KB
constexpr int kRsStage = kRsXBytes + kRsBM * kRsK;  // and 8 KB of codes
constexpr int kRsSmem = kRsStages * kRsStage + 16 * kRsStages + kAtomBytes;
static_assert(kRsSmem <= 232448, "the stages must fit in 227 KB of shared memory");

// The schedule of a direction: k16 steps a wgmma group, and A buffers
// (groups in flight while the next group's A is built).
template <bool kDx>
struct RsSchedule;
template <>
struct RsSchedule<false> {
  static constexpr int kGroup = 1, kBufs = 4;
};
template <>
struct RsSchedule<true> {
  static constexpr int kGroup = 4, kBufs = 1;
};

struct RsParams {
  bf16* y;          // (M, N) bf16 output, N = out (forward) or in (dx)
  float* partial;   // (slices, M, N) fp32 partial sums where the reduction is split
  const float* scales;  // (1, out) f32
  int64_t M;
  int in, out;
  int steps, per_slice;
};

__device__ __forceinline__ uint32_t lds16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// Two A registers, fragment rows g and g + 8 at k and k + 1, from two
// 2-byte code loads `lo` and `hi`: `perm` orders their bytes as the codes
// of (g, k), (g, k + 1), (g + 8, k), (g + 8, k + 1); s<row><k> their
// scales.
__device__ __forceinline__ void a_pair(uint32_t lo, uint32_t hi, uint32_t perm, float s00,
                                       float s01, float s10, float s11, uint32_t& r0,
                                       uint32_t& r1) {
  const uint32_t u = __byte_perm(lo, hi, perm) ^ 0x80808080u;
  r0 = bf16x2(cell<0, 128>(u, s00), cell<1, 128>(u, s01));
  r1 = bf16x2(cell<2, 128>(u, s10), cell<3, 128>(u, s11));
}

template <bool kDx>
__global__ void __launch_bounds__(kRsThreads, 1)
    qwgmma_rs_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_codes, const RsParams p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + kAtomBytes - 1) & ~static_cast<uint32_t>(kAtomBytes - 1);
  const uint8_t* const gbase = smem_raw + (base - raw_u32);
  const uint32_t full0 = base + kRsStages * kRsStage, empty0 = full0 + 8 * kRsStages;

  const int m0 = blockIdx.x * kRsBN;  // the first token
  const int n0 = blockIdx.y * kRsBM;  // the first output column (forward) or code row (dx)
  const int kt0 = blockIdx.z * p.per_slice;
  const int steps = min(p.per_slice, p.steps - kt0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRsStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);  // one arrive a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // The producer warpgroup gives up its registers to the consumers; its
    // thread 0 loads each stage's activations (k0 .. k0 + 63 of 256 tokens)
    // and codes (forward: code rows k0 .. x columns n0 .. of out; dx: code
    // rows n0 .. x columns k0 ..).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 256) return;
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map_x)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map_codes))
                 : "memory");
    for (int kt = 0; kt < steps; ++kt) {
      const int s = kt % kRsStages;
      if (kt >= kRsStages) wait_or_trap(empty0 + 8 * s, ((kt / kRsStages) - 1) & 1);
      const uint32_t full = full0 + 8 * s, dst = base + s * kRsStage;
      const int k0 = (kt0 + kt) * kRsK;
      mbar_expect_tx(full, kRsStage);
      tma_load_2d(dst, &map_x, full, k0, m0);
      tma_load_2d(dst + kRsXBytes, &map_codes, full, kDx ? k0 : n0, kDx ? n0 : k0);
    }
    return;
  }

  // A consumer thread: fragment rows g and g + 8 of warp w of warpgroup wg
  // are the tile's output columns (or code rows) r and r + 1.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x / 128, w = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int r = 64 * wg + 16 * w + 2 * g;
  float s0 = 0.f, s1 = 0.f;  // forward: the scales of columns n0 + r and + 1
  if (!kDx && n0 + r < p.out) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p.scales + n0 + r));
    s0 = v.x, s1 = v.y;
  }
  // dx: the scales of k16 step q's k columns o, o + 1 and o + 8, o + 9
  // (stage q / 4, its step kk = q % 4, o = 16 kk + 2 t), zeros past out;
  // read a group ahead (at the step, their latency would hold the build).
  auto load_scales = [&](int q, float2 (&sc)[2]) {
    if constexpr (kDx) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = (kt0 + q / 4) * kRsK + 16 * (q % 4) + 2 * t + 8 * h;
        sc[h] = col < p.out ? __ldg(reinterpret_cast<const float2*>(p.scales + col))
                            : make_float2(0.f, 0.f);
      }
    }
  };
  // The four A registers of k16 step q from the stage's codes.
  auto build = [&](int q, const float2 (&sc)[2], uint32_t (&a)[4]) {
    const int kk = q % 4;
    const uint8_t* cs = gbase + ((q / 4) % kRsStages) * kRsStage + kRsXBytes;
    if constexpr (kDx) {
      // rows r, r + 1; k = columns o, o + 1 and o + 8, o + 9 of the stage
      const int o = 16 * kk + 2 * t;
      const uint8_t* row0 = cs + r * 64;
      const int sw = ((r / 2) % 4) << 4;  // r and r + 1 share it
      const int c0 = ((o & 48) ^ sw) | (o & 15), c1 = (((o + 8) & 48) ^ sw) | ((o + 8) & 15);
      a_pair(lds16(row0 + c0), lds16(row0 + 64 + c0), 0x5410, sc[0].x, sc[0].y, sc[0].x,
             sc[0].y, a[0], a[1]);
      a_pair(lds16(row0 + c1), lds16(row0 + 64 + c1), 0x5410, sc[1].x, sc[1].y, sc[1].x,
             sc[1].y, a[2], a[3]);
    } else {
      // code rows j, j + 1 and j + 8, j + 9 of the stage; columns r, r + 1
      const int j = 16 * kk + 2 * t;
      const int chunk = r >> 4, byte = r & 15;
      auto at = [&](int jj) { return lds16(cs + jj * 128 + ((chunk ^ (jj % 8)) << 4) + byte); };
      a_pair(at(j), at(j + 1), 0x5140, s0, s0, s1, s1, a[0], a[1]);
      a_pair(at(j + 8), at(j + 9), 0x5140, s0, s0, s1, s1, a[2], a[3]);
    }
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  fence_acc(acc);
  // Group q of kGroup k16 steps: issue its wgmmas, wait until at most
  // kBufs - 1 groups run (releasing a stage after its last), and build
  // group q + 1's A while they do, into the buffer of the group that ended.
  constexpr int kGroup = RsSchedule<kDx>::kGroup, kBufs = RsSchedule<kDx>::kBufs;
  const int total = steps * (kRsK / 16) / kGroup;
  uint32_t a[kBufs][kGroup][4];
  float2 sc[kBufs][kGroup][2];
  auto load_group = [&](int q, float2 (&s)[kGroup][2]) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) load_scales(q * kGroup + i, s[i]);
  };
  // Group q's A; its first k16 step of a stage waits for the stage.
  auto build_group = [&](int q, const float2 (&s)[kGroup][2], uint32_t (&x)[kGroup][4]) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int k16 = q * kGroup + i, kt = k16 / 4;
      if (k16 % 4 == 0) wait_or_trap(full0 + 8 * (kt % kRsStages), (kt / kRsStages) & 1);
      build(k16, s[i], x[i]);
    }
  };
  if (total > 0) {
    load_group(0, sc[0]);
    build_group(0, sc[0], a[0]);
  }
  auto step = [&](int q, const uint32_t (&cur)[kGroup][4], float2 (&sc_next)[kGroup][2],
                  uint32_t (&next)[kGroup][4]) {
    if (q + 1 < total) load_group(q + 1, sc_next);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int k16 = q * kGroup + i;
      const uint32_t xs = base + ((k16 / 4) % kRsStages) * kRsStage;
      wgmma_m64n256k16_rs(acc, cur[i], sw128_desc(xs + (k16 % 4) * 32, 16, kAtomBytes));
    }
    wgmma_commit();
    wgmma_wait<kBufs - 1>();
    const int done = (q - kBufs + 2) * kGroup;  // k16 steps completed
    if (done > 0 && done % 4 == 0 && threadIdx.x % 128 == 0)
      mbar_arrive(empty0 + 8 * ((done / 4 - 1) % kRsStages));
    if (q + 1 < total) build_group(q + 1, sc_next, next);
  };
  for (int q = 0; q < total; q += kBufs) {
#pragma unroll
    for (int b = 0; b < kBufs; ++b)
      if (q + b < total) step(q + b, a[b], sc[(b + 1) % kBufs], a[(b + 1) % kBufs]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // The sums: acc[4i .. 4i+3] are tokens 8i + 2t and + 1 of rows r
  // (acc[4i], acc[4i + 1]) and r + 1 (acc[4i + 2], acc[4i + 3]).
  const int64_t N = kDx ? p.in : p.out;
  const int64_t col = n0 + r;
  if (col >= N) return;
#pragma unroll
  for (int i = 0; i < kRsBN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int64_t tok = m0 + 8 * i + 2 * t + e;
      if (tok >= p.M) continue;
      const float v0 = acc[4 * i + e], v1 = acc[4 * i + 2 + e];
      if (gridDim.z == 1) {
        *reinterpret_cast<__nv_bfloat162*>(p.y + tok * N + col) = __floats2bfloat162_rn(v0, v1);
      } else {
        *reinterpret_cast<float2*>(p.partial + (blockIdx.z * p.M + tok) * N + col) =
            make_float2(v0, v1);
      }
    }
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The grid: row tiles, column tiles (128 columns of out, or 64 code rows
// for dx, whose tile also holds their 64 partners), and slices of the
// reduction's stages (64 code rows forward, 128 columns of out dx).  The
// reduction is split only where the tiles leave SMs idle, into slices of
// at least 2 stages.
struct Plan {
  int64_t row_tiles, col_tiles, steps, per_slice, slices;
};

// The plan's slices of the reduction: one, unless `split`; then enough for
// every SM to get a CTA, each slice at least 2 stages.
void slice(Plan& p, bool split, int num_sms) {
  int64_t slices = 1;
  if (split) {
    slices = cdiv(num_sms, p.row_tiles * p.col_tiles);
    if (slices > p.steps / 2) slices = p.steps / 2;
    if (slices < 1) slices = 1;
  }
  p.per_slice = cdiv(p.steps, slices);
  p.slices = cdiv(p.steps, p.per_slice);
}

// int4's forward at h % 8 != 0 reads an aligned copy of x, (M, 2 h8) bf16,
// from the start of the scratch: its size in floats, 0 where none is made.
int64_t x_copy_floats(int bits, bool dx, int64_t M, int64_t in_f) {
  const int64_t h = in_f / 2;
  return bits == 4 && !dx && h % 8 != 0 ? M * cdiv(h, 8) * 8 : 0;
}

// The aligned copy: x's low half to columns [0, h), its high half to [h8,
// h8 + h), zeros in [h, h8) and [h8 + h, 2 h8); on `stream`.
cudaError_t copy_x(const void* x, void* copy, int64_t M, int64_t h, cudaStream_t stream) {
  const int64_t h8 = cdiv(h, 8) * 8;
  const size_t pitch = static_cast<size_t>(2 * h8) * 2, src_pitch = static_cast<size_t>(2 * h) * 2;
  const size_t half = static_cast<size_t>(h) * 2, pad = static_cast<size_t>(h8 - h) * 2;
  char* dst = static_cast<char*>(copy);
  const char* src = static_cast<const char*>(x);
  cudaError_t err = cudaMemset2DAsync(dst + half, pitch, 0, pad, M, stream);
  if (err == cudaSuccess) err = cudaMemset2DAsync(dst + h8 * 2 + half, pitch, 0, pad, M, stream);
  if (err == cudaSuccess)
    err = cudaMemcpy2DAsync(dst, pitch, src, src_pitch, half, M, cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess)
    err = cudaMemcpy2DAsync(dst + h8 * 2, pitch, src + half, src_pitch, half, M,
                            cudaMemcpyDeviceToDevice, stream);
  return err;
}

Plan make_plan(bool dx, int64_t M, int64_t in_f, int64_t out_f, int num_sms) {
  Plan p{};
  const int64_t h = in_f / 2;
  p.row_tiles = cdiv(M, kBM);
  p.col_tiles = dx ? cdiv(h, kBN / 2) : cdiv(out_f, kBN);
  p.steps = dx ? cdiv(out_f, kCols) : cdiv(h, kRows);
  slice(p, p.row_tiles * p.col_tiles < num_sms, num_sms);
  return p;
}

template <bool kDx>
cudaError_t launch(const void* a, const void* codes, const float* scales, void* out,
                   float* work, int64_t M, int64_t in_f, int64_t out_f, int group, int num_sms,
                   cudaStream_t stream) {
  EncodeTiled encode = nullptr;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const Plan pl = make_plan(kDx, M, in_f, out_f, num_sms);
  if (pl.col_tiles > 65535 || pl.slices > 65535 || pl.row_tiles > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int64_t h = in_f / 2;
  // The activations: x, or its aligned copy at the start of the scratch
  // (x_copy_floats), whose high half starts at column h8.
  const int64_t copy = x_copy_floats(4, kDx, M, in_f);
  const int64_t x_hi = copy ? cdiv(h, 8) * 8 : h;
  if (copy) {
    err = copy_x(a, work, M, h, stream);
    if (err != cudaSuccess) return err;
  }
  CUtensorMap map_a, map_codes;
  const bool ok = make_map(encode, &map_a, copy ? work : a, M,
                           kDx ? out_f : copy ? 2 * x_hi : in_f, kBM, 64) &&
                  make_map(encode, &map_codes, codes, h, out_f, kRows, kCols,
                           CU_TENSOR_MAP_DATA_TYPE_UINT8, 1);
  if (!ok) return cudaErrorInvalidValue;
  Params p;
  p.y = static_cast<bf16*>(out);
  p.partial = work + copy;
  p.scales = scales;
  p.M = M;
  p.h = static_cast<int>(h);
  p.x_hi = static_cast<int>(x_hi);
  p.out = static_cast<int>(out_f);
  p.group = group;
  p.steps = static_cast<int>(pl.steps);
  p.per_slice = static_cast<int>(pl.per_slice);
  auto kernel = qwgmma_kernel<kDx>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(pl.row_tiles), static_cast<unsigned>(pl.col_tiles),
                  static_cast<unsigned>(pl.slices));
  kernel<<<grid, kThreads, kSmem, stream>>>(map_a, map_codes, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || pl.slices == 1) return err;
  return static_cast<cudaError_t>(smft_split_sum_bf16(p.partial, out, M * (kDx ? in_f : out_f),
                                                     static_cast<int>(pl.slices), stream));
}

// The register-A grid: token tiles of 256, column tiles of 128 (out
// forward, in dx), slices of the reduction's stages of 64.  Split only
// where the tiles fill at most half the SMs: q_proj's 128 tiles at a
// micro-batch fill 97% of them, and split they would run in two waves.
Plan make_rs_plan(bool dx, int64_t M, int64_t in_f, int64_t out_f, int num_sms) {
  Plan p{};
  p.row_tiles = cdiv(M, kRsBN);
  p.col_tiles = cdiv(dx ? in_f : out_f, kRsBM);
  p.steps = cdiv(dx ? out_f : in_f, kRsK);
  slice(p, 2 * p.row_tiles * p.col_tiles <= num_sms, num_sms);
  return p;
}

template <bool kDx>
cudaError_t launch_rs(const void* a, const void* codes, const float* scales, void* out,
                      float* work, int64_t M, int64_t in_f, int64_t out_f, int num_sms,
                      cudaStream_t stream) {
  EncodeTiled encode = nullptr;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const Plan pl = make_rs_plan(kDx, M, in_f, out_f, num_sms);
  if (pl.col_tiles > 65535 || pl.slices > 65535 || pl.row_tiles > 0x7fffffff)
    return cudaErrorInvalidValue;
  CUtensorMap map_x, map_codes;
  const bool ok =
      make_map(encode, &map_x, a, M, kDx ? out_f : in_f, kRsBN, kRsK) &&
      (kDx ? make_map(encode, &map_codes, codes, in_f, out_f, kRsBM, kRsK,
                      CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, CU_TENSOR_MAP_SWIZZLE_64B)
           : make_map(encode, &map_codes, codes, in_f, out_f, kRsK, kRsBM,
                      CU_TENSOR_MAP_DATA_TYPE_UINT8, 1));
  if (!ok) return cudaErrorInvalidValue;
  RsParams p;
  p.y = static_cast<bf16*>(out);
  p.partial = work;
  p.scales = scales;
  p.M = M;
  p.in = static_cast<int>(in_f);
  p.out = static_cast<int>(out_f);
  p.steps = static_cast<int>(pl.steps);
  p.per_slice = static_cast<int>(pl.per_slice);
  auto kernel = qwgmma_rs_kernel<kDx>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRsSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(pl.row_tiles), static_cast<unsigned>(pl.col_tiles),
                  static_cast<unsigned>(pl.slices));
  kernel<<<grid, kRsThreads, kRsSmem, stream>>>(map_x, map_codes, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || pl.slices == 1) return err;
  return static_cast<cudaError_t>(smft_split_sum_bf16(work, out, M * (kDx ? in_f : out_f),
                                                     static_cast<int>(pl.slices), stream));
}

}  // namespace

// fp32 scratch of a call, in floats: the split reduction's partial sums,
// after int4's aligned copy of x (M x h8 floats, M x 2 h8 bf16) where the
// forward's h % 8 != 0; -1 when the device's SM count cannot be read.
extern "C" int64_t smft_quant_wgmma_workspace(int bits, int device, int dx, int64_t M,
                                              int64_t in_f, int64_t out_f) {
  if (M == 0) return 0;
  int num_sms = 0;
  if (cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  const Plan pl = bits == 8 ? make_rs_plan(dx != 0, M, in_f, out_f, num_sms)
                            : make_plan(dx != 0, M, in_f, out_f, num_sms);
  return x_copy_floats(bits, dx != 0, M, in_f) +
         (pl.slices > 1 ? pl.slices * M * (dx ? in_f : out_f) : 0);
}

// bits 4 (K5's tile path, K6) or 8 (K7's tile path, K8); dx 0: a = x (M,
// in), out = y (M, out); dx 1: a = dy (M, out), out = dx (M, in); bf16.
// Codes: packed uint8 (in/2, out) or int8 (in, out); scales f32 (in/group,
// out), int8's one row (group = in).  All contiguous on `device` and aligned
// to 16 bytes, in % 8 == 0, out % 16 == 0, int4's group >= 8 and (in/2) %
// group == 0: the binding checks.  `work` holds smft_quant_wgmma_workspace
// floats.  Returns the cudaError_t of the launches.
extern "C" int smft_quant_wgmma(int bits, int device, int dx, const void* a, const void* codes,
                                const float* scales, void* out, float* work, int64_t M,
                                int64_t in_f, int64_t out_f, int group, void* stream) {
  // This library carries its own (static) CUDA runtime, whose current
  // device is not PyTorch's: set it to the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M == 0) return cudaSuccess;
  if (bits != 4 && bits != 8) return cudaErrorInvalidValue;
  int num_sms = 0;
  err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (bits == 8) {
    return dx ? launch_rs<true>(a, codes, scales, out, work, M, in_f, out_f, num_sms, s)
              : launch_rs<false>(a, codes, scales, out, work, M, in_f, out_f, num_sms, s);
  }
  return dx ? launch<true>(a, codes, scales, out, work, M, in_f, out_f, group, num_sms, s)
            : launch<false>(a, codes, scales, out, work, M, in_f, out_f, group, num_sms, s);
}
