// Dequantize-matmul kernels of the quantized frozen base for Hopper, sm_90a:
//   K7  y  = x  @ W   for int8 codes       K8  dx = dy @ W^T  for int8 codes
//   K5  y  = x  @ W   for packed int4      K6  dx = dy @ W^T  for packed int4
//
// Replace the Pallas TPU kernels of
// sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py: `_fwd8_kernel` (K7),
// `_bwd8_kernel` (K8), `_fwd_kernel` (K5) and `_bwd_kernel` (K6).  Written
// from the math, not carried over block by block:
//
//   W (in, out), the dequantized weight, each cell rounded to T once:
//     W[j, o] = round_T( code(j, o) * scales[(j / group) * out + o] )
//   int8:  code = q_t[j * out + o] (int8), one scale row (group = in);
//   int4:  byte = packed_t[(j mod h) * out + o], h = in / 2; code = the low
//          nibble - 8 for j < h, the high nibble - 8 for j >= h.
//   forward:  y[m, o]  = round_T( sum_j x[m, j]  * W[j, o] )   (fp32 sums)
//   dx:       dx[m, j] = round_T( sum_o dy[m, o] * W[j, o] )   (fp32 sums, all of out)
// T is the dtype of x (float or bf16).  No sum is ever kept in bf16.
//
// Where each path runs, what bounds it on this card, and what the design
// does about it (smft_quant_mm dispatches):
//  * Decode (forward, M <= 16 rows, either dtype, either format): the
//    bytes of the codes, and at 7 calls a decoder layer of 0.1-3.4 us of
//    bytes each, the launch and each CTA's fixed latencies.  `qgemv_kernel`
//    here is one launch a call, one wave of CTAs: a CTA owns 64 output
//    columns x one slice of the code rows; each of its 8 warps streams its
//    own k16 steps of that slice (16 code rows x 64 bytes) through a ring
//    of 4 slots in shared memory, filled by 16-byte cp.async copies (64 KB
//    in flight an SM at two CTAs an SM); x and the slice's scale rows enter
//    shared memory once.  With bf16 x the product runs on the tensor
//    cores, mma.sync m16n8k16 with the operands swapped (A = the
//    dequantized W^T tile, built in registers from the ring; B = x^T from
//    shared memory; M <= 8 one n8 tile, up to 16 two); with f32 x (the
//    checks' path) on the CUDA cores in f32 (no TF32).  The slices of a
//    column tile form a thread block cluster (at most 8; as many as the
//    occupancy calculator says the card holds in one wave) and their sums
//    meet in the owner CTA by st.async, added in rank order, in the same
//    launch: deterministic, no second pass.
//  * Training and prefill with bf16 activations (the forward above 16
//    rows, and every dx; int8 and int4): operations.  quant_wgmma.cu's
//    warp-specialised wgmma + TMA kernels: int4's dequant warpgroups unpack
//    each code byte once for both halves into the bf16 B tile beside the
//    MMAs; int8's consumers build the dequantized weight as wgmma's A
//    operand in registers (the transposed product, m64n256k16).  Their
//    split reduction's second pass is smft_split_sum_bf16 here.
//  * f32 activations (the forward above 16 rows, and every dx): `qgemm_f32`
//    here, a tile kernel with f32 FMA on the CUDA cores (no TF32), its
//    reduction split over CTAs where the output has fewer tiles than the
//    card has SMs (k_proj and v_proj, prefill's few rows) and the fp32
//    partial sums added by `qsplit_sum` in a fixed order.
//  * The codes become floats through their bits: the byte or nibble is
//    placed in 2^23 by a byte permute and the offset subtracted, with no
//    conversion instruction.  The TPU kernel's int32-lane unpack, its
//    f32-operand branch for small batches, its tile pickers and VMEM
//    budgets are TPU workarounds and are not here.
//
// K16, the int4 dequantize-arithmetic variants, runs through `qgemv_kernel`
// with its per-cell arithmetic as a template parameter (`Arith`).  It
// replaces the Pallas kernels of scripts/exp_int4_dequant_variants.py:
// `_fwd_kernel` via `make_call` (:108, the f32mul, bf16mul, mul3d and
// ucorr unpacks), `_gdot_kernel` via `gdot_call` (:123) and
// `_ukern_kernel` via `make_ukern_call` (:142).  x is bf16; W's cells and
// the raw output y = round_bf16(fp32 sums) of each (u = the nibble, q =
// u - 8, s = the f32 scale, bf() = round to bf16):
//   f32mul   sum x * bf(q * s)             K5's arithmetic, bit for bit K5
//   bf16mul  sum x * bf(q * bf(s))         (mul3d: the same function)
//   ucorr    sum x * bf(u * bf(s))         (the caller subtracts 8 * gsum(x) @ s)
//   ugdot    sum_groups s * (sum x * u)    (the caller subtracts the same)
//   f32dot   sum x * (q * s)               (f32 cells: the JAX int4 kernel at b <= 64)
//   u2dot    sum x * (u * s) - 8 * sum x * s
// The bf16-celled variants (f32mul, bf16mul, ucorr) take the mma product,
// their cells built as bf16 pairs along k: f32mul extracts, subtracts the
// offset, multiplies by the f32 scale and rounds a pair (about 4 thread
// instructions a cell); bf16mul puts two nibbles under the bf16 exponent
// of 128 (a byte permute), HSUB2 136, HMUL2 bf(s); ucorr HFMA2 (128 + u) *
// bf(s) - 128 bf(s), exact before its one rounding.  The f32-celled
// variants (f32dot, u2dot) and ugdot, whose group partials are multiplied
// by s at each group's end, take the FMA product, as f32 x does, on 4 rows
// of x a block (2 for u2dot and ugdot, whose second and third sets of sums
// stay in registers).  Rows past 16 (K16 only) are a grid dimension of
// blocks of rows, each streaming the codes again (from L2 after the first).
//
// The C interface below takes raw pointers and returns a cudaError_t, so
// this file needs no PyTorch header; ops.cpp binds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kDecodeRows = 16;  // forward row counts up to this take qgemv

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as JAX's astype
}

template <typename T>
__device__ __forceinline__ float round_t(float v) { return to_f32(from_f32<T>(v)); }

// The quantized weight: codes, scales and their geometry.
struct QuantW {
  const uint8_t* codes;  // int8 codes as bytes, or packed int4 bytes; rows of `out` bytes
  const float* scales;   // (in / group, out)
  int64_t in, out;       // W is (in, out)
  int64_t h;             // rows of codes: in for int8, in / 2 for int4
  int64_t group;         // input rows per scale row (in for int8)
};

__device__ __forceinline__ int64_t code_row(const QuantW& w, int64_t j) {
  return j < w.h ? j : j - w.h;
}

// The scale row of input row j, in 32-bit arithmetic (the binding keeps in
// and out under 2^31; a 64-bit division is a long software routine).
__device__ __forceinline__ int scale_row(const QuantW& w, int64_t j) {
  return static_cast<int>(j) / static_cast<int>(w.group);
}

// -- decode: forward with few rows, one launch ----------------------------

// The per-cell arithmetic of the decode kernel (K5 and K7 are kF32Mul; K16 all six).
enum Arith : int { kF32Mul = 0, kBf16Mul = 1, kUCorr = 2, kUGdot = 3, kF32Dot = 4, kU2Dot = 5 };

__host__ __device__ constexpr bool fma_arith(int a) {
  return a == kUGdot || a == kF32Dot || a == kU2Dot;
}
// Rows of x a block on the FMA product: 2 where a second and third set of
// sums must stay in registers beside the first.
__host__ __device__ constexpr int fma_rows(int a) { return a == kUGdot || a == kU2Dot ? 2 : 4; }

constexpr int kGemvWarps = kThreads / 32;
constexpr int kGemvCols = 64;    // output columns a CTA: a 64-byte code-row segment
constexpr int kStep = 16;        // code rows a k16 step
constexpr int kStages = 4;       // ring slots a warp
// A slot's rows are 80 bytes apart: the 8-byte loads of rows 2t (t = 0..3)
// by a half-warp then fall in four distinct 32-byte bank quarters.
constexpr int kRowBytes = kGemvCols + 16;
constexpr int kSlot = kStep * kRowBytes;
constexpr int kRing = kGemvWarps * kStages * kSlot;  // 40 KB
constexpr int kMaxSlices = 8;    // the CTAs of a (portable) cluster
constexpr int kCtasPerSm = 2;
constexpr int kGemvSmem = 112 * 1024;  // a CTA's dynamic shared memory at most: two an SM
static_assert(kRing >= kGemvWarps * 16 * kGemvCols * 4, "the warps' sums reuse the ring");

// n / d for 0 <= n < 2^31 and a divisor d >= 2 known on the host: the
// multiply-high method of division by invariant integers, with m and the
// shift l (2^(l-1) < d <= 2^l) computed once a call.
struct DivBy {
  uint32_t m, l, d;
};

inline DivBy div_by(uint32_t d) {
  uint32_t l = 0;
  while ((uint64_t{1} << l) < d) ++l;
  const uint32_t m =
      static_cast<uint32_t>(((uint64_t{1} << 32) * ((uint64_t{1} << l) - d)) / d + 1);
  return {m, l, d};
}

__device__ __forceinline__ int divide(int n, const DivBy& v) {
  const uint32_t t = __umulhi(v.m, static_cast<uint32_t>(n));
  return static_cast<int>((t + ((static_cast<uint32_t>(n) - t) >> 1)) >> (v.l - 1));
}

struct GemvParams {
  const void* x;          // (M, in) T
  const uint8_t* codes;   // (h, out)
  const float* scales;    // (in / group, out)
  void* y;                // (M, out) T
  int M, in, out, h, group;
  DivBy by_group;         // division by group
  DivBy share;            // by the elements of a CTA's sums each cluster rank adds
  int slice_steps;        // k16 steps a slice (blockIdx.y)
  int chunk_steps;        // k16 steps whose x and scales shared memory holds at once
  int srows;              // scale rows a half in shared memory
  int xstride;            // elements between rows of x in shared memory
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; `bytes` 0 writes
// 16 zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait for the barrier's phase of parity `parity`; a wait that never ends
// traps, so that a fault is a launch error and not a hung card.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar, uint32_t parity) {
  uint32_t spins = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (++spins == (1u << 22)) __trap();
  }
}
// The address of this CTA's shared `addr` in cluster rank `rank`'s.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// v into another CTA's shared memory, its 4 bytes counted on that CTA's
// barrier `bar` (both cluster addresses from map_rank).
__device__ __forceinline__ void st_async_f32(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// d += a b: m16n8k16, bf16 operands, fp32 sums.  a: rows g and g + 8 at k
// 2t, 2t + 1 (a[0], a[1]) and 2t + 8, 2t + 9 (a[2], a[3]); b: k 2t, 2t + 1
// (b0) and 2t + 8, 2t + 9 (b1) of column g; d: rows g (d0, d1) and g + 8
// (d2, d3), columns 2t and 2t + 1 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2, float& d3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 pairs in 32-bit lanes: element 0 in the low 16 bits.
__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bf2_of(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}
__device__ __forceinline__ uint32_t bf2_pack(float lo, float hi) {
  return bf2_bits(__floats2bfloat162_rn(lo, hi));  // round to nearest even
}
// Round to nearest even: sub and mul of two bf16 values, fma of three with
// one rounding.
__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  return bf2_bits(__hsub2(bf2_of(a), bf2_of(b)));
}
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  return bf2_bits(__hmul2(bf2_of(a), bf2_of(b)));
}
__device__ __forceinline__ uint32_t bf2_fma(uint32_t a, uint32_t b, uint32_t c) {
  return bf2_bits(__hfma2(bf2_of(a), bf2_of(b), bf2_of(c)));
}

// Byte e of `u` (a code offset to 0..255) as the float 2^23 + byte.
template <int e>
__device__ __forceinline__ float biased(uint32_t u) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e));
}

// Two A registers from u: bytes (row j, column c), (j + 1, c), (j, c + 1),
// (j + 1, c + 1), each an offset code (int8 with its sign bit flipped, or
// an int4 nibble); sa the scales of row j at columns c and c + 1, sb row
// j + 1's.  lo: column c at k j, j + 1; hi: column c + 1.
template <int kBits, int kArith>
__device__ __forceinline__ void a_pairs(uint32_t u, float2 sa, float2 sb, uint32_t& lo,
                                        uint32_t& hi) {
  if constexpr (kArith == kF32Mul) {
    constexpr float off = kBits == 8 ? 8388608.f + 128.f : 8388608.f + 8.f;
    lo = bf2_pack((biased<0>(u) - off) * sa.x, (biased<1>(u) - off) * sb.x);
    hi = bf2_pack((biased<2>(u) - off) * sa.y, (biased<3>(u) - off) * sb.y);
  } else {
    // bf(128 + u) of two nibbles: u under the exponent of 128, whose bf16
    // ulp is 1
    const uint32_t v0 = __byte_perm(u, 0x43u, 0x4140), v1 = __byte_perm(u, 0x43u, 0x4342);
    const uint32_t s0 = bf2_pack(sa.x, sb.x), s1 = bf2_pack(sa.y, sb.y);
    if constexpr (kArith == kBf16Mul) {
      lo = bf2_mul(bf2_sub(v0, 0x43084308u), s0);  // q = (128 + u) - 136, exact
      hi = bf2_mul(bf2_sub(v1, 0x43084308u), s1);
    } else {  // kUCorr: -128 bf(s) is exact in bf16
      lo = bf2_fma(v0, s0, bf2_pack(-128.f * round_t<bf16>(sa.x), -128.f * round_t<bf16>(sb.x)));
      hi = bf2_fma(v1, s1, bf2_pack(-128.f * round_t<bf16>(sa.y), -128.f * round_t<bf16>(sb.y)));
    }
  }
}

// The scale row (in shared memory, relative to the chunk's first) of the
// row d rows past the one whose scale row is q with remainder rem; past
// the chunk's last scale row (rows past h) it is the last, whose cells
// meet zeros in x.  d < 16 and group >= 8: at most two rows further.
__device__ __forceinline__ int srow_at(int q, int rem, int d, int group, int last) {
  const int e = rem + d;
  return min(q + (e >= group) + (e >= 2 * group), last);
}

template <typename XS, typename T>
__device__ __forceinline__ XS to_xs(T v) {
  if constexpr (std::is_same<XS, T>::value) {
    return v;
  } else {
    return to_f32(v);
  }
}

// One CTA: 8 warps, output columns [c0, c0 + 64) (blockIdx.x), the k16
// steps [s_beg, s_end) of the code rows (the slice, blockIdx.y; a cluster
// spans the slices), rows [m0, m0 + MR) of x (blockIdx.z).  Warp w takes
// the slice's k16 steps w, w + 8, ...; its lanes copy each step's 16 code
// rows x 64 bytes into the warp's own ring slot, 4 steps ahead, and wait
// for them with cp.async.wait_group: no barrier between warps in the loop.
// The slice is taken in chunks of `chunk_steps` (one on the main path),
// each staging x (zeros past M and past in) and the chunk's scale rows
// (zeros past out) first.  Thread (g, t) = (lane / 4, lane % 4) reads code
// rows 2t, 2t + 1, 2t + 8, 2t + 9 of a step at columns 8g .. 8g + 7:
//  * mma (bf16 x): m16n8k16 tile b (0..3) takes output column 8g + 2b as
//    A row g and 8g + 2b + 1 as row g + 8, so that the two rows' codes sit
//    in one byte pair of the 8-byte load and a byte permute pairs them
//    along k; int4's low nibbles meet x's first half, its high nibbles x's
//    second half, each byte read once;
//  * FMA (f32 x, and K16's f32-celled variants and ugdot): the thread's
//    cells times its rows of x, MR tokens, summed over t by shuffles.
// The warps' sums are added in warp order in shared memory, then the
// cluster's in rank order in the CTA that owns each element.
template <typename T, int kBits, int kArith, int MR, bool kMma>
__global__ void __launch_bounds__(kThreads, kCtasPerSm) qgemv_kernel(const GemvParams p) {
  static_assert(kArith == kF32Mul || (kBits == 4 && sizeof(T) == 2), "K16 takes int4 and bf16");
  static_assert(!kMma || (sizeof(T) == 2 && !fma_arith(kArith) && MR % 8 == 0),
                "the mma product takes bf16 x and bf16 cells");
  using XS = typename std::conditional<kMma, bf16, float>::type;  // x in shared memory
  constexpr int kHalves = kBits == 4 ? 2 : 1;
  constexpr int NT = kMma ? MR / 8 : 1;  // n8 tiles of tokens
  constexpr int kAcc = kMma ? 4 * NT * 4 : 8 * MR;
  constexpr int kOutTile = MR * kGemvCols;
  extern __shared__ __align__(16) uint8_t smem[];
  float* part = reinterpret_cast<float*>(smem + kRing);  // [slices][per]: the slices' sums
  float* ss = part + kOutTile + kMaxSlices;              // [half][srows][64]
  XS* xs = reinterpret_cast<XS*>(ss + kHalves * p.srows * kGemvCols);  // [half][MR][xstride]
  const T* x = static_cast<const T*>(p.x);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int c0 = blockIdx.x * kGemvCols;
  const int m0 = blockIdx.z * MR;
  const int mrows = min(MR, p.M - m0);
  const int steps = (p.h + kStep - 1) / kStep;
  const int s_beg = blockIdx.y * p.slice_steps;
  const int s_end = min(s_beg + p.slice_steps, steps);
  uint8_t* ring = smem + warp * kStages * kSlot;
  // the lane's copies (issue) and its code rows 2t, 2t + 1, 2t + 8, 2t + 9
  // at columns 8g .. 8g + 7 in a slot
  const bool col_ok = c0 + 16 * (lane % 4) < p.out;
  const uint8_t* csrc = p.codes + static_cast<int64_t>(lane / 4) * p.out + c0 + 16 * (lane % 4);
  const int cdst = (lane / 4) * kRowBytes + 16 * (lane % 4);
  const int crow = 2 * t * kRowBytes + 8 * g;
  // int4: the rows a warp's next step lies past its current one, in scale
  // rows and a remainder
  const int adv_q = divide(kGemvWarps * kStep, p.by_group);
  const int adv_r = kGemvWarps * kStep - adv_q * p.group;
  const int slices = gridDim.y;
  // The slices' sums arrive in each owner's `part` on this barrier (the
  // epilogue).  A CTA may write into another's shared memory only once
  // that one runs and has set its barrier up: a cluster arrival after the
  // first copies are issued, waited for before the loop, says so.
  __shared__ uint64_t sums_bar;
  if (slices > 1 && threadIdx.x == 0) {
    mbar_init(smem_addr(&sums_bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  float acc[kAcc];
  // u2dot: sum x * s; ugdot: the current group's partial sums of each half
  float aux[kArith == kU2Dot || kArith == kUGdot ? 8 * MR : 1];
  float aux2[kArith == kUGdot ? 8 * MR : 1];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kArith == kU2Dot || kArith == kUGdot ? 8 * MR : 1); ++i) aux[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kArith == kUGdot ? 8 * MR : 1); ++i) aux2[i] = 0.f;

  for (int ch = s_beg; ch < s_end; ch += p.chunk_steps) {
    const int ch_end = min(ch + p.chunk_steps, s_end);
    const int r0 = ch * kStep;                  // the chunk's first code row
    const int r1 = min(ch_end * kStep, p.h);    // past its last
    // its scale rows: [sf0, sl0] for the low half (or int8), [sf1, sl1] high
    const int sf0 = divide(r0, p.by_group), sl0 = divide(r1 - 1, p.by_group);
    const int sf1 = divide(p.h + r0, p.by_group), sl1 = divide(p.h + r1 - 1, p.by_group);
    // x of the chunk, rows [m0, m0 + MR) of each half, zeros past M and past
    // h; in the same group of copies as the scales where no conversion is
    // needed and each 16 bytes lie on 16 bytes (int4 bf16: h % 8 == 0)
    const int xrows = (ch_end - ch) * kStep;
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements a copy
    if (std::is_same<XS, T>::value && (kBits == 8 || p.h % kVec == 0)) {
      for (int row = warp; row < kHalves * MR; row += kGemvWarps) {  // half * MR + m
        const int m = row % MR;
        const T* src = x + static_cast<int64_t>(m0 + m) * p.in + (row / MR) * p.h + r0;
        for (int piece = lane; piece * kVec < xrows; piece += 32) {
          const bool ok = m < mrows && r0 + piece * kVec < p.h;
          cp_async16(xs + row * p.xstride + piece * kVec, ok ? src + piece * kVec : x,
                     ok ? 16 : 0);
        }
      }
    } else {
      // by registers, converted; 4 loads in flight a lane
      for (int row = warp; row < kHalves * MR; row += kGemvWarps) {
        const int m = row % MR;
        const T* src = x + static_cast<int64_t>(m0 + m) * p.in + (row / MR) * p.h + r0;
        XS* dst = xs + row * p.xstride;
        for (int r = lane; r < xrows; r += 4 * 32) {
          T v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int rr = r + 32 * u;
            v[u] = m < mrows && rr < xrows && r0 + rr < p.h ? src[rr] : T(0.f);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (r + 32 * u < xrows) dst[r + 32 * u] = to_xs<XS>(v[u]);
        }
      }
    }
    // the scale rows, 16 pieces a row: a half-warp a row
    for (int i = threadIdx.x / 16; i < kHalves * p.srows; i += kThreads / 16) {
      const int half = i >= p.srows, row = i - half * p.srows, col = c0 + 4 * (lane % 16);
      const int sr = (half ? sf1 : sf0) + row;
      const bool ok = sr <= (half ? sl1 : sl0) && col < p.out;
      cp_async16(ss + i * kGemvCols + 4 * (lane % 16),
                 ok ? p.scales + static_cast<int64_t>(sr) * p.out + col : p.scales, ok ? 16 : 0);
    }
    cp_async_commit();

    // Copy the warp's next step (s_next: its steps in order, kGemvWarps
    // apart) into slot k % kStages: the lane copies 16 bytes (piece lane %
    // 4) of code rows lane / 4 and lane / 4 + 8.  A group is committed even
    // when there is no step, so that the count of groups stays uniform.
    int s_next = ch + warp;
    const uint8_t* src_next = csrc + static_cast<int64_t>(s_next) * kStep * p.out;
    auto issue = [&](int k) {
      if (s_next < ch_end) {
        uint8_t* slot = ring + (k % kStages) * kSlot + cdst;
        const int r = s_next * kStep + lane / 4;
        const bool ok0 = col_ok && r < p.h, ok1 = col_ok && r + 8 < p.h;
        cp_async16(slot, ok0 ? src_next : p.codes, ok0 ? 16 : 0);
        cp_async16(slot + 8 * kRowBytes, ok1 ? src_next + 8 * p.out : p.codes, ok1 ? 16 : 0);
      }
      cp_async_commit();
      s_next += kGemvWarps;
      src_next += static_cast<int64_t>(kGemvWarps) * kStep * p.out;
    };
#pragma unroll
    for (int k = 0; k < kStages; ++k) issue(k);
    if (slices > 1 && ch == s_beg)
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

    cp_async_wait<kStages>();  // x and the scales: the oldest group
    __syncthreads();

    float s8[kBits == 8 ? 8 : 1];  // int8: the one scale row, columns 8g .. 8g + 7
    if constexpr (kBits == 8) {
#pragma unroll
      for (int c = 0; c < 8; ++c) s8[c] = ss[8 * g + c];
    }
    int grp0 = -1, grp1 = -1;  // ugdot: the scale row of each half's partial sums

    // ugdot: acc += partial * s (its scale row `grp`), partial = 0
    auto flush = [&](float (&tq)[8 * MR], int half, int grp) {
      if constexpr (kArith == kUGdot) {
        const float* sp = ss + (half * p.srows + grp) * kGemvCols + 8 * g;
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            acc[c * MR + m] += tq[c * MR + m] * sp[c];
            tq[c * MR + m] = 0.f;
          }
      }
    };

    // int4: the scale row of the warp's step's first code row in each
    // half, relative to the chunk's first (sq), and its remainder (sr),
    // carried from step to step without a division
    int sq[kHalves], sr[kHalves];
#pragma unroll
    for (int half = 0; half < kHalves; ++half) {
      const int base = half * p.h + (ch + warp) * kStep;
      const int q = divide(base, p.by_group);
      sq[half] = q - (half ? sf1 : sf0);
      sr[half] = base - q * p.group;
    }
    // every CTA of the cluster runs (its barrier set up) before the
    // epilogue writes into it: waited for here, beside the first copies
    if (slices > 1 && ch == s_beg)
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    int k = 0;
    for (int s = ch + warp; s < ch_end; s += kGemvWarps, ++k) {
      cp_async_wait<kStages - 1>();
      __syncwarp();
      const uint8_t* slot = ring + (k % kStages) * kSlot + crow;
      const int xr = s * kStep - r0;  // the step's first row in xs
      uint2 w[4];                     // code rows 2t, 2t + 1, 2t + 8, 2t + 9
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = *reinterpret_cast<const uint2*>(slot + ((i & 1) + 8 * (i >> 1)) * kRowBytes);
#pragma unroll
      for (int half = 0; half < kHalves; ++half) {
        // int4: the scale rows of the four code rows, relative to the
        // chunk's first (si), and their columns 8g .. 8g + 7 (sp); the rows
        // share one unless a group ends inside the step (one_row, the same
        // for the whole warp)
        const int slast = half ? sl1 - sf1 : sl0 - sf0;
        const bool one_row = kBits == 8 || sr[half] + kStep <= p.group;
        auto scale_rows = [&](int (&si)[4], const float* (&sp)[4], auto same) {
          if constexpr (kBits == 4) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if constexpr (decltype(same)::value) {
                si[i] = min(sq[half], slast);
              } else {
                si[i] = srow_at(sq[half], sr[half], 2 * t + (i & 1) + 8 * (i >> 1), p.group,
                                slast);
              }
              sp[i] = ss + (half * p.srows + si[i]) * kGemvCols + 8 * g;
            }
          }
        };
        if constexpr (kMma) {
          uint32_t bx[NT][2];  // x^T: k 2t, 2t + 1 and 2t + 8, 2t + 9 of tokens 8n + g
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const XS* xp = xs + (half * MR + 8 * n + g) * p.xstride + xr + 2 * t;
            bx[n][0] = *reinterpret_cast<const uint32_t*>(xp);
            bx[n][1] = *reinterpret_cast<const uint32_t*>(xp + 8);
          }
          // one load of scales serves the four rows where they share one
          auto build = [&](auto same) {
          int si[4];
          const float* sp[4];
          scale_rows(si, sp, same);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            // columns 8g + 2b, + 1: bytes 2b % 4 and its neighbour of word b / 2
            const uint32_t sel = b % 2 ? 0x7362u : 0x5140u;
            auto word = [&](int i) { return b < 2 ? w[i].x : w[i].y; };
            uint32_t u01 = __byte_perm(word(0), word(1), sel);
            uint32_t u89 = __byte_perm(word(2), word(3), sel);
            if constexpr (kBits == 4) {
              u01 = (half ? u01 >> 4 : u01) & 0x0F0F0F0Fu;
              u89 = (half ? u89 >> 4 : u89) & 0x0F0F0F0Fu;
            } else {
              u01 ^= 0x80808080u;
              u89 ^= 0x80808080u;
            }
            float2 sc[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if constexpr (kBits == 8) {
                sc[i] = make_float2(s8[2 * b], s8[2 * b + 1]);
              } else if constexpr (decltype(same)::value) {
                sc[i] = *reinterpret_cast<const float2*>(sp[0] + 2 * b);
              } else {
                sc[i] = *reinterpret_cast<const float2*>(sp[i] + 2 * b);
              }
            }
            uint32_t a[4];
            a_pairs<kBits, kArith>(u01, sc[0], sc[1], a[0], a[1]);
            a_pairs<kBits, kArith>(u89, sc[2], sc[3], a[2], a[3]);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const int o = (b * NT + n) * 4;
              mma_bf16(acc[o], acc[o + 1], acc[o + 2], acc[o + 3], a, bx[n][0], bx[n][1]);
            }
          }
          };
          if (one_row) {
            build(std::true_type{});
          } else {
            build(std::false_type{});
          }
        } else {
          int si[4];
          const float* sp[4];
          scale_rows(si, sp, std::false_type{});
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int d = 2 * t + (i & 1) + 8 * (i >> 1);
            float xv[MR];
#pragma unroll
            for (int m = 0; m < MR; ++m) xv[m] = xs[(half * MR + m) * p.xstride + xr + d];
            float s[8];
            if constexpr (kBits == 8) {
#pragma unroll
              for (int c = 0; c < 8; ++c) s[c] = s8[c];
            } else {
              const float4 lo = *reinterpret_cast<const float4*>(sp[i]);
              const float4 hi = *reinterpret_cast<const float4*>(sp[i] + 4);
              s[0] = lo.x, s[1] = lo.y, s[2] = lo.z, s[3] = lo.w;
              s[4] = hi.x, s[5] = hi.y, s[6] = hi.z, s[7] = hi.w;
            }
            if constexpr (kArith == kUGdot) {
              if (half == 0 && si[i] != grp0) {
                if (grp0 >= 0) flush(aux, 0, grp0);
                grp0 = si[i];
              }
              if (half == 1 && si[i] != grp1) {
                if (grp1 >= 0) flush(aux2, 1, grp1);
                grp1 = si[i];
              }
            }
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const uint32_t byte = ((c < 4 ? w[i].x : w[i].y) >> (8 * (c % 4))) & 0xffu;
              float cell;  // x's multiplier: W's cell, or u (ugdot)
              if constexpr (kBits == 8) {
                cell = static_cast<float>(static_cast<int8_t>(byte)) * s[c];
              } else {
                const int u = static_cast<int>(half ? byte >> 4 : byte & 15u);
                if constexpr (kArith == kU2Dot) {
                  cell = static_cast<float>(u) * s[c];
                } else if constexpr (kArith == kUGdot) {
                  cell = static_cast<float>(u);
                } else {  // f32 x: round_T is exact; f32dot keeps f32 cells
                  cell = static_cast<float>(u - 8) * s[c];
                }
              }
#pragma unroll
              for (int m = 0; m < MR; ++m) {
                if constexpr (kArith == kUGdot) {
                  if (half) {
                    aux2[c * MR + m] += xv[m] * cell;
                  } else {
                    aux[c * MR + m] += xv[m] * cell;
                  }
                } else {
                  acc[c * MR + m] += xv[m] * cell;
                  if constexpr (kArith == kU2Dot) aux[c * MR + m] += xv[m] * s[c];
                }
              }
            }
          }
        }
      }
      __syncwarp();  // every lane has read the slot
      issue(k + kStages);
      if constexpr (kBits == 4) {
#pragma unroll
        for (int half = 0; half < kHalves; ++half) {
          sq[half] += adv_q;
          sr[half] += adv_r;
          if (sr[half] >= p.group) {
            sr[half] -= p.group;
            ++sq[half];
          }
        }
      }
    }
    if constexpr (kArith == kUGdot) {  // the chunk's scales leave shared memory
      if (grp0 >= 0) flush(aux, 0, grp0);
      if (grp1 >= 0) flush(aux2, 1, grp1);
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // The warps' sums, [warp][token][column], over the ring.
  float* red = reinterpret_cast<float*>(smem) + warp * kOutTile;
  if constexpr (kMma) {
    // acc[(b NT + n) 4 + i]: columns 8g + 2b (i 0, 1) and + 1 (i 2, 3),
    // tokens 8n + 2t (i 0, 2) and + 1 (i 1, 3)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int o = (b * NT + n) * 4;
        float* r = red + (8 * n + 2 * t) * kGemvCols + 8 * g + 2 * b;
        *reinterpret_cast<float2*>(r) = make_float2(acc[o], acc[o + 2]);
        *reinterpret_cast<float2*>(r + kGemvCols) = make_float2(acc[o + 1], acc[o + 3]);
      }
  } else {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      float v = acc[i];
      if constexpr (kArith == kU2Dot) v -= 8.f * aux[i];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      acc[i] = v;
    }
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int m = 0; m < MR; ++m) red[m * kGemvCols + 8 * g + c] = acc[c * MR + m];
    }
  }
  __syncthreads();

  T* y = static_cast<T*>(p.y);
  auto store = [&](int e, float v) {
    const int m = e / kGemvCols, c = c0 + e % kGemvCols;
    if (m < mrows && c < p.out) y[static_cast<int64_t>(m0 + m) * p.out + c] = from_f32<T>(v);
  };
  const float* sums = reinterpret_cast<const float*>(smem);
  // Rank q of the cluster owns the tile's elements [q per, (q + 1) per):
  // every rank sends its sum of each into the owner's `part` [rank][...]
  // by st.async, which counts the bytes on the owner's barrier; each owner
  // waits for the other ranks' bytes, adds its elements in rank order
  // (deterministic) and stores them.  No rank reads another's shared
  // memory, so none waits for the others to leave.
  const int per = p.share.d;  // elements a rank owns: kOutTile / slices, rounded up
  int rank = 0;  // this CTA's rank in its cluster
  if (slices > 1) asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int mine = min(per, kOutTile - rank * per);  // elements this rank owns
  for (int e = threadIdx.x; e < kOutTile; e += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < kGemvWarps; ++wp) v += sums[wp * kOutTile + e];
    const int owner = divide(e, p.share);
    if (slices == 1) {
      store(e, v);
    } else if (owner == rank) {
      part[rank * per + e - owner * per] = v;
    } else {
      st_async_f32(map_rank(smem_addr(part + rank * per + e - owner * per), owner), v,
                   map_rank(smem_addr(&sums_bar), owner));
    }
  }
  if (slices > 1) {
    const uint32_t bar = smem_addr(&sums_bar);
    if (threadIdx.x == 0) mbar_expect_tx(bar, 4u * (slices - 1) * mine);
    __syncthreads();  // this rank's own sums are in `part`
    mbar_wait_or_trap(bar, 0);
    for (int i = threadIdx.x; i < mine; i += kThreads) {
      float v = part[i];
      for (int q = 1; q < slices; ++q) v += part[q * per + i];
      store(rank * per + i, v);
    }
  }
}

// The launch floor: no work, at the decode kernel's grid, cluster, threads
// and shared memory.
__global__ void __launch_bounds__(kThreads) qgemv_empty_kernel(const GemvParams) {}

// y = round_T(sum over the splits, in order, of the fp32 partial sums).
template <typename T>
__global__ void __launch_bounds__(kThreads)
qsplit_sum_kernel(const float* __restrict__ partial, T* __restrict__ y, int64_t total,
                  int ksplit) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += partial[k * total + i];
  y[i] = from_f32<T>(s);
}

// -- f32 tiled product: C (M, N) = A (M, K) @ B (K, N), B dequantized per tile
//
// forward (kDx false): A = x (M, in), K = in, N = out, B(k, n) = W[k, n];
// dx (kDx true):      A = dy (M, out), K = out, N = in, B(k, n) = W[n, k].
// A group is 4 cells of B that lie in 4 contiguous code bytes: along n for
// the forward, along k for dx.

constexpr int kTile = 128;  // a 128 x 128 output tile, 8 warps

struct BGroup {
  uint32_t code;
  float4 s;
  bool high;
};

template <int kBits, bool kDx, int BK, int BN>
__device__ __forceinline__ BGroup load_group(const QuantW& w, int64_t k0, int64_t n0, int g) {
  int64_t j, o;
  if constexpr (kDx) {
    const int n = g / (BK / 4), k = (g % (BK / 4)) * 4;
    j = n0 + n;
    o = k0 + k;
  } else {
    const int k = g / (BN / 4), n = (g % (BN / 4)) * 4;
    j = k0 + k;
    o = n0 + n;
  }
  BGroup b{0u, make_float4(0.f, 0.f, 0.f, 0.f), false};
  if (j < w.in && o < w.out) {  // out % 16 == 0: the group is whole
    b.code = *reinterpret_cast<const uint32_t*>(w.codes + code_row(w, j) * w.out + o);
    b.s = *reinterpret_cast<const float4*>(w.scales + scale_row(w, j) * w.out + o);
    b.high = kBits == 4 && j >= w.h;
  }
  return b;
}

// The 4 cells of a group times their scales, in f32.  Each code byte (int8
// offset to 0..255, or an int4 nibble) is placed in the low bits of the
// float 2^23 by a byte permute, and the offset subtracted: exact, with no
// integer-to-float conversion instruction.
template <int kBits>
__device__ __forceinline__ void dequant_group(const BGroup& b, float (&v)[4]) {
  const float s[4] = {b.s.x, b.s.y, b.s.z, b.s.w};
  const uint32_t u = kBits == 8 ? b.code ^ 0x80808080u
                                : (b.high ? b.code >> 4 : b.code) & 0x0F0F0F0Fu;
  const float offset = kBits == 8 ? 8388608.f + 128.f : 8388608.f + 8.f;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) - offset) * s[e];
}

// The B tile in shared memory, laid out so that a warp's stores of its
// groups of 4 cells are contiguous: forward Bs[k][n] (n contiguous), dx
// Bs[n][k] (k contiguous).  `pad` keeps the loads free of bank conflicts.
template <typename T, bool kDx, int BK, int BN, int kPad>
struct BTile {
  static constexpr int kLd = kDx ? BK + kPad : BN + kPad;
  static constexpr int kSize = kDx ? BN * kLd : BK * kLd;
  T* p;
  __device__ __forceinline__ T* at(int k, int n) const {
    return kDx ? p + n * kLd + k : p + k * kLd + n;
  }
  // Group g's first cell: the forward's groups run along n, dx's along k.
  __device__ __forceinline__ T* group(int g) const {
    if constexpr (kDx) {
      return at((g % (BK / 4)) * 4, g / (BK / 4));
    } else {
      return at(g / (BN / 4), (g % (BN / 4)) * 4);
    }
  }
};

// f32: 16 x 16 threads, each an 8 x 8 micro tile (rows ty + 16 i, columns
// tx + 16 j).  A's shared rows are padded to 17 floats and dx's B rows too,
// so that the 16 distinct rows a warp reads fall in 16 banks; the
// forward's B rows (n contiguous) need no pad.  blockIdx.z selects a slice
// [z * kchunk, (z + 1) * kchunk) of K, of whole k steps: with one slice the
// CTA writes C, with more its fp32 partial sums to `partial` (z, M, N),
// which qsplit_sum adds.
constexpr int kF32BK = 16;

template <int kBits, bool kDx>
__global__ void __launch_bounds__(kThreads)
qgemm_f32_kernel(const float* __restrict__ A, QuantW w, float* __restrict__ C,
                 float* __restrict__ partial, int64_t M, int64_t N, int64_t K, int64_t kchunk) {
  constexpr int BK = kF32BK;
  constexpr int kBM = kTile, kBN = kTile;
  constexpr int LDA = BK + 1;
  constexpr int kGroups = kBN * BK / 4 / kThreads;  // 2 B groups a thread
  using Tile = BTile<float, kDx, BK, kBN, kDx ? 1 : 0>;
  __shared__ float As[kBM][LDA];
  __shared__ __align__(16) float Bsm[Tile::kSize];
  const Tile Bs{Bsm};
  const int t = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;

  float4 a_reg[2];
  BGroup b_reg[kGroups];
  auto load = [&](int64_t k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = t + i * kThreads;
      const int row = c / 4, kc = (c % 4) * 4;
      a_reg[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + row < M && k0 + kc < K)
        a_reg[i] = *reinterpret_cast<const float4*>(A + (m0 + row) * K + k0 + kc);
    }
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
      b_reg[i] = load_group<kBits, kDx, BK, kBN>(w, k0, n0, t + i * kThreads);
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = t + i * kThreads;
      const int row = c / 4, kc = (c % 4) * 4;
      As[row][kc] = a_reg[i].x;
      As[row][kc + 1] = a_reg[i].y;
      As[row][kc + 2] = a_reg[i].z;
      As[row][kc + 3] = a_reg[i].w;
    }
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      float v[4];
      dequant_group<kBits>(b_reg[i], v);
      float* dst = Bs.group(t + i * kThreads);
      if constexpr (kDx) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = v[e];  // padded rows: no 16-byte store
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  const int ty = t / 16, tx = t % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int64_t kbeg = static_cast<int64_t>(blockIdx.z) * kchunk;
  const int64_t kend = K - kbeg < kchunk ? K : kbeg + kchunk;
  load(kbeg);
  for (int64_t k0 = kbeg; k0 < kend; k0 += BK) {
    store();
    __syncthreads();
    if (k0 + BK < kend) load(k0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = *Bs.at(k, tx + 16 * j);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t col = n0 + tx + 16 * j;
      if (col >= N) continue;
      if (gridDim.z == 1) {
        C[row * N + col] = acc[i][j];
      } else {
        partial[(blockIdx.z * M + row) * N + col] = acc[i][j];
      }
    }
  }
}


// -- host side ------------------------------------------------------------

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The decode kernel's launch: column tiles x slices (a cluster) x blocks of
// rows; the k16 steps a slice and a chunk of it, and the shared memory.
struct GemvPlan {
  int64_t col_tiles, slices, row_blocks;
  int rows;          // rows of x a block (MR)
  int slice_steps, chunk_steps, srows, xstride;
  bool mma;
  size_t smem;
};

size_t gemv_smem(int halves, int rows, bool mma, int chunk_steps, int srows) {
  const size_t x_elem = mma ? 2 : 4;
  return kRing + sizeof(float) * (kGemvCols * (rows + static_cast<size_t>(halves) * srows) +
                                   kMaxSlices) +
         x_elem * halves * rows * (static_cast<size_t>(chunk_steps) * kStep + 8);
}

// The clusters of `size` CTAs the card holds at once at two CTAs an SM
// (the most shared memory a CTA takes), from the occupancy calculator:
// fewer than SMs x 2 / size where a cluster must sit in one GPC (132 SMs
// hold 30 clusters of 8, 79 of 3).  Cached a device; -1 where it cannot
// be read.
int max_clusters(int device, int size) {
  static int cache[64][kMaxSlices + 1] = {};  // 0: not read yet
  if (device < 0 || device >= 64 || size < 1 || size > kMaxSlices) return -1;
  int& n = cache[device][size];
  if (n == 0) {
    const void* fn = reinterpret_cast<const void*>(qgemv_empty_kernel);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, static_cast<unsigned>(size), 1);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kGemvSmem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = static_cast<unsigned>(size);
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemvSmem) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess || n <= 0) {
      cudaGetLastError();
      n = -1;
    }
  }
  return n;
}

// dtype: 0 = float32 x, 1 = bfloat16.  One wave: column tiles x row blocks
// x slices stay within the card's resident CTAs (two an SM) and the
// clusters of that many slices it holds at once; the slices split only as
// far as that allows, at most a cluster's 8, each giving every warp at
// least one k16 step.  A slice is taken in one chunk unless its x and
// scale rows would not fit beside the ring (K16 at many rows).
GemvPlan gemv_plan(int bits, int dtype, int arith, int64_t M, int64_t in_f, int64_t out_f,
                   int group, int device, int num_sms) {
  GemvPlan p{};
  p.mma = dtype == 1 && !fma_arith(arith);
  p.rows = p.mma ? (M <= 8 ? 8 : 16) : fma_rows(arith);
  p.row_blocks = cdiv(M, p.rows);
  p.col_tiles = cdiv(out_f, kGemvCols);
  const int64_t h = bits == 4 ? in_f / 2 : in_f;
  const int halves = bits == 4 ? 2 : 1;
  if (bits == 8) group = static_cast<int>(in_f);
  const int64_t steps = cdiv(h, kStep);
  const int64_t tiles = p.col_tiles * p.row_blocks;
  int64_t slices = 1;
  for (int64_t s = steps / kGemvWarps < kMaxSlices ? steps / kGemvWarps : kMaxSlices; s > 1; --s) {
    if (tiles * s <= static_cast<int64_t>(num_sms) * kCtasPerSm &&
        tiles <= max_clusters(device, static_cast<int>(s))) {
      slices = s;
      break;
    }
  }
  p.slice_steps = static_cast<int>(cdiv(steps, slices));
  p.slices = cdiv(steps, p.slice_steps);
  // the scale rows of a half that `c` steps of code rows can span
  auto srows = [&](int64_t c) {
    return bits == 8 ? 1 : static_cast<int>((c * kStep - 1) / group + 2);
  };
  int64_t c = p.slice_steps;
  while (c > 1 && gemv_smem(halves, p.rows, p.mma, static_cast<int>(c), srows(c)) > kGemvSmem)
    c = (c + 1) / 2;
  p.chunk_steps = static_cast<int>(c);
  p.srows = srows(c);
  p.xstride = p.chunk_steps * kStep + 8;  // 4 words past a multiple of 8: B's loads hit 32 banks
  p.smem = gemv_smem(halves, p.rows, p.mma, p.chunk_steps, p.srows);
  return p;
}

// Each instantiation of the decode kernel: K5/K7 in bf16 (mma, 8 and 16
// rows) and f32 (FMA), and K16's other variants.
struct GemvInst {
  int bits, dtype, arith, rows;
  const void* fn;
};
const GemvInst kGemvInsts[] = {
    {8, 1, kF32Mul, 8, reinterpret_cast<const void*>(qgemv_kernel<bf16, 8, kF32Mul, 8, true>)},
    {8, 1, kF32Mul, 16, reinterpret_cast<const void*>(qgemv_kernel<bf16, 8, kF32Mul, 16, true>)},
    {4, 1, kF32Mul, 8, reinterpret_cast<const void*>(qgemv_kernel<bf16, 4, kF32Mul, 8, true>)},
    {4, 1, kF32Mul, 16, reinterpret_cast<const void*>(qgemv_kernel<bf16, 4, kF32Mul, 16, true>)},
    {8, 0, kF32Mul, 4, reinterpret_cast<const void*>(qgemv_kernel<float, 8, kF32Mul, 4, false>)},
    {4, 0, kF32Mul, 4, reinterpret_cast<const void*>(qgemv_kernel<float, 4, kF32Mul, 4, false>)},
    {4, 1, kBf16Mul, 8, reinterpret_cast<const void*>(qgemv_kernel<bf16, 4, kBf16Mul, 8, true>)},
    {4, 1, kBf16Mul, 16, reinterpret_cast<const void*>(qgemv_kernel<bf16, 4, kBf16Mul, 16, true>)},
    {4, 1, kUCorr, 8, reinterpret_cast<const void*>(qgemv_kernel<bf16, 4, kUCorr, 8, true>)},
    {4, 1, kUCorr, 16, reinterpret_cast<const void*>(qgemv_kernel<bf16, 4, kUCorr, 16, true>)},
    {4, 1, kUGdot, 2, reinterpret_cast<const void*>(qgemv_kernel<bf16, 4, kUGdot, 2, false>)},
    {4, 1, kF32Dot, 4, reinterpret_cast<const void*>(qgemv_kernel<bf16, 4, kF32Dot, 4, false>)},
    {4, 1, kU2Dot, 2, reinterpret_cast<const void*>(qgemv_kernel<bf16, 4, kU2Dot, 2, false>)},
};
constexpr int kGemvInstCount = sizeof(kGemvInsts) / sizeof(kGemvInsts[0]);

const void* gemv_fn(int bits, int dtype, int arith, int rows) {
  for (const GemvInst& i : kGemvInsts)
    if (i.bits == bits && i.dtype == dtype && i.arith == arith && i.rows == rows) return i.fn;
  return nullptr;
}

// Launch `fn` (the decode kernel or the empty one) at the plan: the slices
// of a column tile as one cluster.  The shared memory limit is raised once
// a device for each kernel.
cudaError_t launch_plan(const void* fn, const GemvParams& prm, const GemvPlan& pl, int device,
                        cudaStream_t stream) {
  if (fn == nullptr || pl.row_blocks > 65535 || pl.col_tiles > 0x7fffffff)
    return cudaErrorInvalidValue;
  struct Raised {
    const void* fn;
    uint64_t devices;
  };
  static Raised raised[kGemvInstCount + 1] = {};
  Raised* r = nullptr;
  for (Raised& e : raised) {
    if (e.fn == fn || e.fn == nullptr) {
      e.fn = fn;
      r = &e;
      break;
    }
  }
  if (r == nullptr) return cudaErrorInvalidValue;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (!(r->devices & bit)) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemvSmem);
    if (err != cudaSuccess) return err;
    r->devices |= bit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(pl.col_tiles), static_cast<unsigned>(pl.slices),
                     static_cast<unsigned>(pl.row_blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(pl.slices);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.slices > 1 ? 1 : 0;
  void* args[] = {const_cast<GemvParams*>(&prm)};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) cudaGetLastError();  // clear it: the caller gets it here
  return err;
}

// The decode kernel (or, `empty`, its launch floor) on x (M, in) of dtype
// 0 (float32) or 1 (bfloat16): y (M, out) in x's dtype, one launch.
cudaError_t run_gemv(int dtype, int bits, int arith, const void* x, const QuantW& w, void* y,
                     int64_t M, int device, int num_sms, cudaStream_t stream, bool empty) {
  const GemvPlan pl = gemv_plan(bits, dtype, arith, M, w.in, w.out, static_cast<int>(w.group),
                                device, num_sms);
  GemvParams prm{};
  prm.x = x;
  prm.codes = w.codes;
  prm.scales = w.scales;
  prm.y = y;
  prm.M = static_cast<int>(M);
  prm.in = static_cast<int>(w.in);
  prm.out = static_cast<int>(w.out);
  prm.h = static_cast<int>(w.h);
  prm.group = static_cast<int>(w.group);
  prm.by_group = div_by(static_cast<uint32_t>(w.group));
  const int64_t tile = int64_t{pl.rows} * kGemvCols;
  prm.share = div_by(static_cast<uint32_t>(cdiv(tile, pl.slices)));
  prm.slice_steps = pl.slice_steps;
  prm.chunk_steps = pl.chunk_steps;
  prm.srows = pl.srows;
  prm.xstride = pl.xstride;
  const void* fn = empty ? reinterpret_cast<const void*>(qgemv_empty_kernel)
                         : gemv_fn(bits, dtype, arith, pl.rows);
  return launch_plan(fn, prm, pl, device, stream);
}

// The f32 tile kernel's split of K: none where the output has at least as
// many 128 x 128 tiles as the card has SMs; else slices of whole k steps,
// each at least 256 long, for about two CTAs an SM.
struct GemmSplit {
  int64_t ksplit, kchunk;
};

GemmSplit gemm_split(int dx, int64_t M, int64_t in_f, int64_t out_f, int num_sms) {
  const int64_t K = dx ? out_f : in_f, N = dx ? in_f : out_f;
  const int64_t tiles = cdiv(M, kTile) * cdiv(N, kTile);
  int64_t ks = 1;
  if (tiles < num_sms) {
    ks = cdiv(2 * static_cast<int64_t>(num_sms), tiles);
    if (ks > K / 256) ks = K / 256;
    if (ks < 1) ks = 1;
  }
  const int64_t chunk = cdiv(cdiv(K, ks), kF32BK) * kF32BK;
  return {cdiv(K, chunk), chunk};
}

template <int kBits, bool kDx>
cudaError_t launch_gemm_f32(const void* a, const QuantW& w, void* out, float* work, int64_t M,
                            int num_sms, cudaStream_t stream) {
  const int64_t K = kDx ? w.out : w.in;
  const int64_t N = kDx ? w.in : w.out;
  const int64_t row_tiles = cdiv(M, kTile);
  if (row_tiles > 65535) return cudaErrorInvalidValue;
  const GemmSplit sp = gemm_split(kDx, M, w.in, w.out, num_sms);
  const dim3 grid(static_cast<unsigned>(cdiv(N, kTile)), static_cast<unsigned>(row_tiles),
                  static_cast<unsigned>(sp.ksplit));
  qgemm_f32_kernel<kBits, kDx><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a), w, static_cast<float*>(out), work, M, N, K, sp.kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sp.ksplit == 1) return err;
  const int64_t total = M * N;
  qsplit_sum_kernel<float><<<static_cast<unsigned>(cdiv(total, kThreads)), kThreads, 0, stream>>>(
      work, static_cast<float*>(out), total, static_cast<int>(sp.ksplit));
  return cudaGetLastError();
}

QuantW make_w(int bits, const void* codes, const float* scales, int64_t in_f, int64_t out_f,
              int group) {
  QuantW w;
  w.codes = static_cast<const uint8_t*>(codes);
  w.scales = scales;
  w.in = in_f;
  w.out = out_f;
  w.h = bits == 4 ? in_f / 2 : in_f;
  w.group = bits == 4 ? group : in_f;
  return w;
}


bool use_decode(int dx, int64_t M) { return !dx && M <= kDecodeRows; }

bool known_arith(int a) { return a >= kF32Mul && a <= kU2Dot; }

}  // namespace

// The split reduction's second pass for bf16 outputs, for quant_wgmma.cu:
// y (total) = round_bf16(sum over the slices, in order, of the fp32
// partial sums (slices, total)).  Returns the launch's cudaError_t.
extern "C" int smft_split_sum_bf16(const float* partial, void* y, int64_t total, int slices,
                                   void* stream) {
  qsplit_sum_kernel<bf16><<<static_cast<unsigned>(cdiv(total, kThreads)), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(partial, static_cast<bf16*>(y),
                                                                 total, slices);
  return cudaGetLastError();
}

// quant_wgmma.cu: the bf16 tile path, K5 and K7 above 16 rows, K6 and K8.
extern "C" int64_t smft_quant_wgmma_workspace(int bits, int device, int dx, int64_t M,
                                              int64_t in_f, int64_t out_f);
extern "C" int smft_quant_wgmma(int bits, int device, int dx, const void* a, const void* codes,
                                const float* scales, void* out, float* work, int64_t M,
                                int64_t in_f, int64_t out_f, int group, void* stream);

// fp32 scratch the call needs (the partial sums of a split reduction), in
// floats; -1 when the device's SM count cannot be read.  The decode rows
// need none.
extern "C" int64_t smft_quant_mm_workspace(int dtype, int device, int bits, int dx, int64_t M,
                                           int64_t in_f, int64_t out_f) {
  if (M == 0 || use_decode(dx, M)) return 0;
  if (dtype == 1) return smft_quant_wgmma_workspace(bits, device, dx, M, in_f, out_f);
  int num_sms = 0;
  if (cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  const GemmSplit sp = gemm_split(dx, M, in_f, out_f, num_sms);
  return sp.ksplit > 1 ? sp.ksplit * M * (dx ? in_f : out_f) : 0;
}

// dtype: 0 = float32, 1 = bfloat16.  bits: 8 or 4.  dx: 0 for the forward
// (a = x (M, in), out = y (M, out)), 1 for dx (a = dy (M, out), out = dx
// (M, in)).  codes: int8 (in, out) or packed uint8 (in/2, out); scales f32
// (in/group, out).  All contiguous on `device`, a and codes and scales
// aligned to 16 bytes, in % 8 == 0, out % 16 == 0: the binding checks.
// Returns the cudaError_t of the launches.
extern "C" int smft_quant_mm(int dtype, int device, int bits, int dx, const void* a,
                             const void* codes, const float* scales, void* out, float* work,
                             int64_t M, int64_t in_f, int64_t out_f, int group, void* stream) {
  // This library carries its own (static) CUDA runtime, whose current
  // device is not PyTorch's: set it to the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M == 0) return cudaSuccess;
  if ((dtype != 0 && dtype != 1) || (bits != 4 && bits != 8)) return cudaErrorInvalidValue;
  const QuantW w = make_w(bits, codes, scales, in_f, out_f, group);
  auto s = static_cast<cudaStream_t>(stream);
  int num_sms = 0;
  err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (use_decode(dx, M)) return run_gemv(dtype, bits, kF32Mul, a, w, out, M, device, num_sms, s,
                                         false);
  if (dtype == 1) {
    return smft_quant_wgmma(bits, device, dx, a, codes, scales, out, work, M, in_f, out_f,
                            w.group, stream);
  }
  if (bits == 8) {
    return dx ? launch_gemm_f32<8, true>(a, w, out, work, M, num_sms, s)
              : launch_gemm_f32<8, false>(a, w, out, work, M, num_sms, s);
  }
  return dx ? launch_gemm_f32<4, true>(a, w, out, work, M, num_sms, s)
            : launch_gemm_f32<4, false>(a, w, out, work, M, num_sms, s);
}

// The decode kernel's plan of a forward of M rows (dtype 0 float32, 1
// bfloat16 x; arith an Arith, K16's, 0 for K5/K7) into `plan[11]`: column
// tile, slices (the cluster), CTAs, ring stages a warp, CTAs an SM (the
// occupancy of the instantiation at the plan's shared memory), row blocks,
// rows a block, code rows a slice, code rows a chunk, shared memory bytes,
// and 1 for the mma product or 0 for the FMA one.  Returns a cudaError_t.
extern "C" int smft_quant_decode_plan(int device, int bits, int dtype, int arith, int64_t M,
                                      int64_t in_f, int64_t out_f, int group, int64_t* plan) {
  if (!known_arith(arith) || M <= 0 || (bits != 4 && bits != 8) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int num_sms = 0;
  err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const GemvPlan p = gemv_plan(bits, dtype, arith, M, in_f, out_f, group, device, num_sms);
  const void* fn = gemv_fn(bits, dtype, arith, p.rows);
  if (fn == nullptr) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemvSmem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, p.smem);
  if (err != cudaSuccess) return err;
  const int64_t out[11] = {kGemvCols, p.slices, p.col_tiles * p.slices * p.row_blocks, kStages,
                           per_sm, p.row_blocks, p.rows, int64_t{p.slice_steps} * kStep,
                           int64_t{p.chunk_steps} * kStep, static_cast<int64_t>(p.smem), p.mma};
  for (int i = 0; i < 11; ++i) plan[i] = out[i];
  return cudaSuccess;
}

// Each instantiation of the decode kernel, 8 values a row into `out`
// (room for `capacity` rows): bits, dtype, arith, rows a block, registers a
// thread, local memory bytes a thread, CTAs an SM at the most shared memory
// a CTA takes, threads a CTA.  `count`: the instantiations.  Returns a
// cudaError_t.
extern "C" int smft_quant_decode_attrs(int device, int64_t* out, int capacity, int* count) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  *count = kGemvInstCount;
  for (int k = 0; k < kGemvInstCount && k < capacity; ++k) {
    const GemvInst& i = kGemvInsts[k];
    cudaFuncAttributes a{};
    err = cudaFuncGetAttributes(&a, i.fn);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(i.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemvSmem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, i.fn, kThreads, kGemvSmem);
    if (err != cudaSuccess) return err;
    const int64_t row[8] = {i.bits, i.dtype, i.arith, i.rows, a.numRegs,
                            static_cast<int64_t>(a.localSizeBytes), per_sm, a.maxThreadsPerBlock};
    for (int j = 0; j < 8; ++j) out[8 * k + j] = row[j];
  }
  return cudaSuccess;
}

// The launch floor of a decode call: the empty kernel at the plan's grid,
// cluster, threads and shared memory, on `stream`.
extern "C" int smft_quant_decode_empty(int device, int bits, int dtype, int64_t M, int64_t in_f,
                                       int64_t out_f, int group, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0 || (bits != 4 && bits != 8) || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  int num_sms = 0;
  err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const QuantW w = make_w(bits, nullptr, nullptr, in_f, out_f, group);
  return run_gemv(dtype, bits, kF32Mul, nullptr, w, nullptr, M, device, num_sms,
                  static_cast<cudaStream_t>(stream), true);
}

// K16: y (M, out) bf16, the raw output of variant `arith` (an Arith) of
// x (M, in) bf16 and the packed int4 codes (in/2, out) with f32 scales
// (in/group, out); contiguous on `device`, aligned to 16 bytes,
// (in/2) % group == 0, out % 16 == 0: the binding checks.  One launch;
// returns its cudaError_t.
extern "C" int smft_int4_variant_mm(int device, int arith, const void* x, const void* codes,
                                    const float* scales, void* y, int64_t M, int64_t in_f,
                                    int64_t out_f, int group, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!known_arith(arith)) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const QuantW w = make_w(4, codes, scales, in_f, out_f, group);
  int num_sms = 0;
  err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  return run_gemv(1, 4, arith, x, w, y, M, device, num_sms, static_cast<cudaStream_t>(stream),
                  false);
}
