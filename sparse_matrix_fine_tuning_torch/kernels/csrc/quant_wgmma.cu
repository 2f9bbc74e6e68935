// The int4 dequantize-matmul of the quantized frozen base at training rows,
// for Hopper, sm_90a:
//   K5, tile path   y  = x  @ W     bf16 x, M > 16 rows (prefill, training)
//   K6              dx = dy @ W^T   bf16 dy, every row count
// with W (in, out) the dequantized weight, each cell rounded to bf16 once,
//   W[j, o] = round_bf16( q(j, o) * scales[(j / group) * out + o] ),
// q the offset-8 nibble of byte packed[(j mod h) * out + o], h = in / 2: the
// low nibble for j < h, the high one for j >= h.  Sums in fp32, the output
// rounded to bf16 once.  Each cell's arithmetic is quant_matmul.cu's
// `dequant_group` (a byte permute into 2^23, the offset subtracted, the f32
// scale multiplied, pairs rounded with __floats2bfloat162_rn), so the cells
// are K5's decode kernel's bit for bit.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (K5, :115) and
// `_bwd_kernel` (K6, :141) of sparse_matrix_fine_tuning_tpu/kernels/
// quant_matmul.py at these row counts; the decode rows (M <= 16), f32
// activations and int8 stay in quant_matmul.cu, whose smft_quant_mm
// dispatches here.
//
// What bounds it: operations (2 M in out; at M = 2048 every projection of
// the 1.1B model is above the card's 295 operations a byte).  Only wgmma
// reaches the tensor cores' full rate, and its B operand must lie in shared
// memory as bf16, so the design is a warp-specialised mixed-input GEMM, a
// CTA computing a 128 x 128 output tile with 576 threads:
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
// and columns past in or out come in as zeros.
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
  int out;          // columns of the codes
  int group;
  int steps;        // stages of the whole reduction
  int per_slice;    // stages a slice (blockIdx.z)
};

// mbar_wait, except that a wait that never ends traps, so that a fault in
// the pipeline is a launch error and not a hung card.
__device__ __forceinline__ void wait_or_trap(uint32_t bar, uint32_t parity) {
  uint32_t spins = 0;
  while (!mbar_try_wait(bar, parity)) {
    if (++spins == (1u << 22)) __trap();
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One cell: the nibble in byte e of `u` (already shifted to the low half of
// each byte) times its scale, in f32: quant_matmul.cu's dequant_group.
template <int e>
__device__ __forceinline__ float cell(uint32_t u, float s) {
  return (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) - (8388608.f + 8.f)) * s;
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 8 bf16 cells of 8 code bytes (w, little-endian: column c in byte c),
// the low nibbles (shift 0) or the high ones (shift 4), with their scales.
__device__ __forceinline__ uint4 dequant8(uint2 w, int shift, const float (&s)[8]) {
  const uint32_t u0 = (w.x >> shift) & 0x0F0F0F0Fu, u1 = (w.y >> shift) & 0x0F0F0F0Fu;
  return make_uint4(bf16x2(cell<0>(u0, s[0]), cell<1>(u0, s[1])),
                    bf16x2(cell<2>(u0, s[2]), cell<3>(u0, s[3])),
                    bf16x2(cell<0>(u1, s[4]), cell<1>(u1, s[5])),
                    bf16x2(cell<2>(u1, s[6]), cell<3>(u1, s[7])));
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
        tma_load_2d(dst + kBox, &map_a, full, kDx ? k0 + 64 : p.h + k0, m0);
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

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The grid: row tiles, column tiles (128 columns of out, or 64 code rows
// for dx, whose tile also holds their 64 partners), and slices of the
// reduction's stages (64 code rows forward, 128 columns of out dx).  The
// reduction is split only where the tiles leave SMs idle, into slices of
// at least 2 stages.
struct Plan {
  int64_t row_tiles, col_tiles, steps, per_slice, slices;
};

Plan make_plan(bool dx, int64_t M, int64_t in_f, int64_t out_f, int num_sms) {
  Plan p{};
  const int64_t h = in_f / 2;
  p.row_tiles = cdiv(M, kBM);
  p.col_tiles = dx ? cdiv(h, kBN / 2) : cdiv(out_f, kBN);
  p.steps = dx ? cdiv(out_f, kCols) : cdiv(h, kRows);
  int64_t slices = 1;
  const int64_t tiles = p.row_tiles * p.col_tiles;
  if (tiles < num_sms) {
    slices = cdiv(num_sms, tiles);
    if (slices > p.steps / 2) slices = p.steps / 2;
    if (slices < 1) slices = 1;
  }
  p.per_slice = cdiv(p.steps, slices);
  p.slices = cdiv(p.steps, p.per_slice);
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
  CUtensorMap map_a, map_codes;
  const bool ok = make_map(encode, &map_a, a, M, kDx ? out_f : in_f, kBM, 64) &&
                  make_map(encode, &map_codes, codes, h, out_f, kRows, kCols,
                           CU_TENSOR_MAP_DATA_TYPE_UINT8, 1);
  if (!ok) return cudaErrorInvalidValue;
  Params p;
  p.y = static_cast<bf16*>(out);
  p.partial = work;
  p.scales = scales;
  p.M = M;
  p.h = static_cast<int>(h);
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
  return static_cast<cudaError_t>(smft_split_sum_bf16(work, out, M * (kDx ? in_f : out_f),
                                                     static_cast<int>(pl.slices), stream));
}

}  // namespace

// fp32 scratch of a call (the split reduction's partial sums), in floats;
// -1 when the device's SM count cannot be read.
extern "C" int64_t smft_int4_wgmma_workspace(int device, int dx, int64_t M, int64_t in_f,
                                             int64_t out_f) {
  if (M == 0) return 0;
  int num_sms = 0;
  if (cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  const Plan pl = make_plan(dx != 0, M, in_f, out_f, num_sms);
  return pl.slices > 1 ? pl.slices * M * (dx ? in_f : out_f) : 0;
}

// K5's tile path (dx 0: a = x (M, in), out = y (M, out)) and K6 (dx 1:
// a = dy (M, out), out = dx (M, in)), bf16; packed codes uint8 (in/2, out),
// scales f32 (in/group, out).  All contiguous on `device` and aligned to 16
// bytes, in % 8 == 0, out % 16 == 0, group >= 8, (in/2) % group == 0: the
// binding checks.  `work` holds smft_int4_wgmma_workspace floats.  Returns
// the cudaError_t of the launches.
extern "C" int smft_int4_wgmma(int device, int dx, const void* a, const void* codes,
                               const float* scales, void* out, float* work, int64_t M,
                               int64_t in_f, int64_t out_f, int group, void* stream) {
  // This library carries its own (static) CUDA runtime, whose current
  // device is not PyTorch's: set it to the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M == 0) return cudaSuccess;
  int num_sms = 0;
  err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  return dx ? launch<true>(a, codes, scales, out, work, M, in_f, out_f, group, num_sms, s)
            : launch<false>(a, codes, scales, out, work, M, in_f, out_f, group, num_sms, s);
}
