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
//    bytes of the codes.  `qdecode` here streams every code byte once from
//    device memory, with 4-16 byte loads (a warp reads 4 rows x 32-128
//    contiguous bytes), keeps x's rows of the CTA's slice of `in` in shared
//    memory and M x 4-16 fp32 sums in registers.  `in` is split over CTAs
//    so that k_proj and v_proj (out 256) still give the card work; each CTA
//    writes fp32 partial sums and `qsplit_sum` adds them in a fixed order
//    (deterministic; no atomics).  The TPU's sequential grid carried the
//    sum from step to step: here the split and its second pass take that
//    place.
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
// K16, the int4 dequantize-arithmetic variants, runs through `qdecode`
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
// What bounds it here: at M <= 16 the bytes of the codes and the f32
// scales (the decode streams them once); at M = 256 the operations, which
// run on the CUDA cores (2 M in out / 67 TFLOP/s, no tensor cores): each
// block of 16 rows (8 for ugdot and u2dot) streams the codes again, from
// L2 after the first.  What each variant changes in the per-cell work
// (the MR fp32 FMAs a cell are common to all):
//   f32mul   extract, int->f32 convert (the "- 8" on the integer), FMUL,
//            round to bf16 and widen back: 5-6 instructions a cell;
//   bf16mul  two cells a 32-bit lane: a LOP3 puts two nibbles under the
//            bf16 exponent of 128 (bf(128 + u)), HSUB2 subtracts 136, HMUL2
//            scales: with the widening, 2.5-3 a cell;
//   ucorr    HFMA2 (128 + u) * s - 128 * s replaces HSUB2 + HMUL2, exact
//            before its one rounding: 2-2.5 a cell;
//   ugdot    HSUB2 128 and no scale: about 2 a cell, plus MR FMAs a column
//            at each group's end; a second and third set of sums (the
//            group partials of each half);
//   f32dot   extract, convert, FMUL, no rounding: 3-4 a cell;
//   u2dot    extract, convert, FMUL, and MR more FMAs (x * s) a cell; a
//            second set of sums.
// ugdot and u2dot keep 32 sums a set and take at most 8 rows a block
// (the single-set variants 64 and 16, as K5), so that the sets stay in
// registers.
//
// The C interface below takes raw pointers and returns a cudaError_t, so
// this file needs no PyTorch header; ops.cpp binds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kDecodeRows = 16;  // forward row counts up to this take qdecode

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

// The code of one cell from its byte: `high` selects the int4 high nibble.
template <int kBits>
__device__ __forceinline__ float code_of(uint32_t byte, bool high) {
  if constexpr (kBits == 8) {
    return static_cast<float>(static_cast<int8_t>(byte));
  } else {
    return static_cast<float>(static_cast<int>(high ? (byte >> 4) : (byte & 15u)) - 8);
  }
}

__device__ __forceinline__ int64_t code_row(const QuantW& w, int64_t j) {
  return j < w.h ? j : j - w.h;
}

// The scale row of input row j, in 32-bit arithmetic (the binding keeps in
// and out under 2^31; a 64-bit division is a long software routine).
__device__ __forceinline__ int scale_row(const QuantW& w, int64_t j) {
  return static_cast<int>(j) / static_cast<int>(w.group);
}

// -- decode: forward with few rows, streaming the codes once ---------------

// Load CPT code bytes of one row (16, 8 or 4 bytes, aligned) into words.
template <int CPT>
__device__ __forceinline__ void load_codes(const uint8_t* p, uint32_t (&c)[CPT / 4]) {
  if constexpr (CPT == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
  } else if constexpr (CPT == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    c[0] = v.x; c[1] = v.y;
  } else {
    c[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

template <int CPT>
__device__ __forceinline__ void load_scales(const float* p, float (&s)[CPT]) {
#pragma unroll
  for (int i = 0; i < CPT / 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * i);
    s[4 * i] = v.x; s[4 * i + 1] = v.y; s[4 * i + 2] = v.z; s[4 * i + 3] = v.w;
  }
}

// The per-cell arithmetic of the decode kernel (K5 is kF32Mul; K16 all six).
enum Arith : int { kF32Mul = 0, kBf16Mul = 1, kUCorr = 2, kUGdot = 3, kF32Dot = 4, kU2Dot = 5 };

__host__ __device__ constexpr bool packed_arith(int a) {
  return a == kBf16Mul || a == kUCorr || a == kUGdot;
}
__host__ __device__ constexpr int arith_sums(int a) { return a == kUGdot || a == kU2Dot ? 32 : 64; }

// bf16 pairs in 32-bit lanes: element 0 in the low 16 bits.
__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bf2_of(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}
__device__ __forceinline__ uint32_t bf2_pack(float lo, float hi) {
  return bf2_bits(__floats2bfloat162_rn(lo, hi));
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

// The packed variants' scales of CPT columns as bf16 pairs: pair 2k + e
// holds columns 4k + e and 4k + e + 2, as `variant_cells` pairs the nibbles
// of a code word.  `neg` (ucorr): -128 * bf(s), exact in bf16.
template <bool kNeg, int CPT, int NP, int NN>
__device__ __forceinline__ void pack_scales(const float (&s)[CPT], uint32_t (&sp)[NP],
                                            uint32_t (&neg)[NN]) {
#pragma unroll
  for (int k = 0; k < CPT / 4; ++k)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = s[4 * k + e], b = s[4 * k + e + 2];
      sp[2 * k + e] = bf2_pack(a, b);
      if constexpr (kNeg)
        neg[2 * k + e] = bf2_pack(-128.f * round_t<bf16>(a), -128.f * round_t<bf16>(b));
    }
}

template <int MR, int CPT>
__device__ __forceinline__ void fma_cell(float (&sums)[MR][CPT], const float (&xv)[MR], int c,
                                         float wv) {
#pragma unroll
  for (int m = 0; m < MR; ++m) sums[m][c] += xv[m] * wv;
}

// One half (`kHigh`: the high nibbles) of one code row for K16's variants
// other than f32mul: `words` the row's CPT code bytes, xv the MR inputs of
// that half, s its f32 scales (sp, neg their bf16 pairs).  The sums go to
// `acc`, ugdot's to `aux` (the group's partials); u2dot's x * s to `aux`.
template <int MR, int CPT, int kArith, bool kHigh, int NP, int NN>
__device__ __forceinline__ void variant_cells(const uint32_t (&words)[CPT / 4],
                                              const float (&xv)[MR], const float (&s)[CPT],
                                              const uint32_t (&sp)[NP], const uint32_t (&neg)[NN],
                                              float (&acc)[MR][CPT], float (&aux)[MR][CPT]) {
  if constexpr (kArith == kF32Dot || kArith == kU2Dot) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const uint32_t byte = (words[c / 4] >> (8 * (c % 4))) & 0xffu;
      if constexpr (kArith == kF32Dot) {
        fma_cell<MR, CPT>(acc, xv, c, code_of<4>(byte, kHigh) * s[c]);
      } else {
        const float u = static_cast<float>(static_cast<int>(kHigh ? byte >> 4 : byte & 15u));
        fma_cell<MR, CPT>(acc, xv, c, u * s[c]);
        fma_cell<MR, CPT>(aux, xv, c, s[c]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < CPT / 4; ++k) {
      const uint32_t v = kHigh ? words[k] >> 4 : words[k];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // bf(128 + u) of the nibbles of bytes e and e + 2: u under the
        // exponent of 128, whose bf16 ulp is 1
        const uint32_t b = ((v >> (8 * e)) & 0x000F000Fu) | 0x43004300u;
        uint32_t wv;
        if constexpr (kArith == kBf16Mul) {
          wv = bf2_mul(bf2_sub(b, 0x43084308u), sp[2 * k + e]);  // q = (128 + u) - 136, exact
        } else if constexpr (kArith == kUCorr) {
          wv = bf2_fma(b, sp[2 * k + e], neg[2 * k + e]);
        } else {
          wv = bf2_sub(b, 0x43004300u);  // u, exact
        }
        const float w0 = __uint_as_float(wv << 16), w1 = __uint_as_float(wv & 0xffff0000u);
        if constexpr (kArith == kUGdot) {
          fma_cell<MR, CPT>(aux, xv, 4 * k + e, w0);
          fma_cell<MR, CPT>(aux, xv, 4 * k + e + 2, w1);
        } else {
          fma_cell<MR, CPT>(acc, xv, 4 * k + e, w0);
          fma_cell<MR, CPT>(acc, xv, 4 * k + e + 2, w1);
        }
      }
    }
  }
}

// ugdot at the end of a scale group: acc += t * s; t = 0.
template <int MR, int CPT>
__device__ __forceinline__ void flush_group(float (&acc)[MR][CPT], float (&t)[MR][CPT],
                                            const float (&s)[CPT]) {
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      acc[m][c] += t[m][c] * s[c];
      t[m][c] = 0.f;
    }
}

// One CTA: 8 warps; a warp is 8 column threads x 4 row groups, so the CTA
// covers 8 * CPT output columns and 32 row groups over its slice of code
// rows [r0, r0 + kchunk), for the rows [m0, m0 + MR) of x (blockIdx.z; K5
// has M <= MR, one block).  Rows of x past M are zeros in shared memory,
// so the inner loop has no guard.  MR * CPT = 64 sums a thread (32 a set
// for ugdot and u2dot).
template <typename T, int kBits, int MR, int CPT, int kArith = kF32Mul>
__global__ void __launch_bounds__(kThreads)
qdecode_kernel(const T* __restrict__ x, QuantW w, T* __restrict__ y, float* __restrict__ partial,
               int64_t M, int kchunk, int ksplit) {
  static_assert(kArith == kF32Mul || (kBits == 4 && sizeof(T) == 2), "K16 takes int4 and bf16");
  extern __shared__ float smem[];
  constexpr int kHalves = kBits == 4 ? 2 : 1;
  constexpr int kCols = 8 * CPT;
  constexpr bool kPacked = packed_arith(kArith);
  float* xs = smem;                              // [kHalves][MR][kchunk]
  float* red = smem + kHalves * MR * kchunk;     // [8 warps][MR][kCols]
  const int64_t rows_total = w.h;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kchunk;
  const int64_t left = rows_total - r0;
  const int rows = left < kchunk ? static_cast<int>(left) : kchunk;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kCols;
  const int64_t m0 = static_cast<int64_t>(blockIdx.z) * MR;
  const int64_t mrows = M - m0 < MR ? M - m0 : MR;  // rows of x in this block

  for (int i = threadIdx.x; i < kHalves * MR * kchunk; i += kThreads) {
    const int half = i / (MR * kchunk);
    const int m = (i / kchunk) % MR;
    const int r = i % kchunk;
    float v = 0.f;
    if (m < mrows && r < rows) v = to_f32(x[(m0 + m) * w.in + half * w.h + r0 + r]);
    xs[i] = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cg = lane % 8;
  const int rg = warp * 4 + lane / 8;
  const int64_t col = c0 + cg * CPT;
  const int run = (rows + 31) / 32;
  const int rbeg = rg * run;
  const int rend = rbeg + run < rows ? rbeg + run : rows;

  float acc[MR][CPT];
  // ugdot: the current group's partial sums of the low (t_lo) and high
  // (t_hi) half; u2dot: sum x * s (t_lo)
  float t_lo[MR][CPT], t_hi[MR][CPT];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      acc[m][c] = 0.f;
      if constexpr (kArith == kUGdot || kArith == kU2Dot) t_lo[m][c] = 0.f;
      if constexpr (kArith == kUGdot) t_hi[m][c] = 0.f;
    }

  if (col < w.out && rbeg < rend) {
    float s_lo[CPT], s_hi[CPT];
    uint32_t p_lo[kPacked ? CPT / 2 : 1], p_hi[kPacked ? CPT / 2 : 1];  // bf16 pairs of s
    uint32_t n_lo[kArith == kUCorr ? CPT / 2 : 1], n_hi[kArith == kUCorr ? CPT / 2 : 1];
    int64_t srow_lo = -1, srow_hi = -1;
    constexpr int kUnroll = 4;  // code loads of 4 rows in flight at once
    for (int r4 = rbeg; r4 < rend; r4 += kUnroll) {
      uint32_t rows_words[kUnroll][CPT / 4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r4 + u < rend) load_codes<CPT>(w.codes + (r0 + r4 + u) * w.out + col, rows_words[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r4 + u;
        if (r >= rend) break;
        const int64_t j = r0 + r;  // code row; for int4 also input column j + h
        const int64_t g_lo = scale_row(w, j);
        if (g_lo != srow_lo) {
          if constexpr (kArith == kUGdot) {
            if (srow_lo >= 0) flush_group<MR, CPT>(acc, t_lo, s_lo);
          }
          load_scales<CPT>(w.scales + g_lo * w.out + col, s_lo);
          if constexpr (kPacked) pack_scales<kArith == kUCorr>(s_lo, p_lo, n_lo);
          srow_lo = g_lo;
        }
        if constexpr (kBits == 4) {
          const int64_t g_hi = scale_row(w, j + w.h);
          if (g_hi != srow_hi) {
            if constexpr (kArith == kUGdot) {
              if (srow_hi >= 0) flush_group<MR, CPT>(acc, t_hi, s_hi);
            }
            load_scales<CPT>(w.scales + g_hi * w.out + col, s_hi);
            if constexpr (kPacked) pack_scales<kArith == kUCorr>(s_hi, p_hi, n_hi);
            srow_hi = g_hi;
          }
        }
        const uint32_t (&words)[CPT / 4] = rows_words[u];
        float xv[MR];
#pragma unroll
        for (int m = 0; m < MR; ++m) xv[m] = xs[m * kchunk + r];
        if constexpr (kArith == kF32Mul) {
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const uint32_t byte = (words[c / 4] >> (8 * (c % 4))) & 0xffu;
            const float wl = round_t<T>(code_of<kBits>(byte, false) * s_lo[c]);
#pragma unroll
            for (int m = 0; m < MR; ++m) acc[m][c] += xv[m] * wl;
          }
          if constexpr (kBits == 4) {
#pragma unroll
            for (int m = 0; m < MR; ++m) xv[m] = xs[(MR + m) * kchunk + r];
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              const uint32_t byte = (words[c / 4] >> (8 * (c % 4))) & 0xffu;
              const float wh = round_t<T>(code_of<kBits>(byte, true) * s_hi[c]);
#pragma unroll
              for (int m = 0; m < MR; ++m) acc[m][c] += xv[m] * wh;
            }
          }
        } else {
          variant_cells<MR, CPT, kArith, false>(words, xv, s_lo, p_lo, n_lo, acc, t_lo);
#pragma unroll
          for (int m = 0; m < MR; ++m) xv[m] = xs[(MR + m) * kchunk + r];
          if constexpr (kArith == kUGdot) {
            variant_cells<MR, CPT, kArith, true>(words, xv, s_hi, p_hi, n_hi, acc, t_hi);
          } else {
            variant_cells<MR, CPT, kArith, true>(words, xv, s_hi, p_hi, n_hi, acc, t_lo);
          }
        }
      }
    }
    if constexpr (kArith == kUGdot) {  // the last group of the thread's rows
      flush_group<MR, CPT>(acc, t_lo, s_lo);
      flush_group<MR, CPT>(acc, t_hi, s_hi);
    }
  }
  if constexpr (kArith == kU2Dot) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[m][c] -= 8.f * t_lo[m][c];
  }

  // Sum the warp's 4 row groups (lane bits 3 and 4), then the 8 warps in
  // order through shared memory.
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  if (lane < 8) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int c = 0; c < CPT; ++c) red[(warp * MR + m) * kCols + cg * CPT + c] = acc[m][c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MR * kCols; i += kThreads) {
    const int m = i / kCols;
    const int64_t o = c0 + i % kCols;
    if (m >= mrows || o >= w.out) continue;
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < 8; ++wp) s += red[(wp * MR + m) * kCols + i % kCols];
    if (ksplit == 1) {
      y[(m0 + m) * w.out + o] = from_f32<T>(s);
    } else {
      partial[(static_cast<int64_t>(blockIdx.y) * M + m0 + m) * w.out + o] = s;
    }
  }
}

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

struct DecodePlan {
  int mr, cpt, kchunk, ksplit, col_ctas;
  size_t smem;
};

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// `sums`: the sums a thread keeps a set (64 for K5; K16 passes arith_sums).
DecodePlan decode_plan(int bits, int64_t M, int64_t in_f, int64_t out_f, int num_sms,
                       int sums = 64) {
  DecodePlan p{};
  p.mr = M <= 4 ? 4 : M <= 8 ? 8 : 16;
  p.cpt = sums / p.mr;
  const int64_t cols = 8 * p.cpt;
  p.col_ctas = static_cast<int>(cdiv(out_f, cols));
  const int halves = bits == 4 ? 2 : 1;
  const int64_t rows = bits == 4 ? in_f / 2 : in_f;
  // x's slice in shared memory stays within 32 KB; the partial sums (the
  // split's second pass) cost ksplit * M * out fp32, so each CTA keeps at
  // least 64 code rows.
  const int64_t max_chunk = 8192 / (p.mr * halves);
  int64_t ksplit = cdiv(2 * static_cast<int64_t>(num_sms), p.col_ctas);
  const int64_t cap = rows / 64 > 1 ? rows / 64 : 1;
  if (ksplit > cap) ksplit = cap;
  if (ksplit < 1) ksplit = 1;
  int64_t chunk = cdiv(cdiv(rows, ksplit), 32) * 32;
  if (chunk > max_chunk) chunk = max_chunk;
  p.kchunk = static_cast<int>(chunk);
  p.ksplit = static_cast<int>(cdiv(rows, chunk));
  p.smem = sizeof(float) * (halves * p.mr * chunk + 8 * p.mr * cols);
  return p;
}

// grid.z: the blocks of MR rows of x (one for K5, whose M <= MR).
template <typename T, int kBits, int MR, int CPT, int kArith = kF32Mul>
cudaError_t launch_decode(const void* x, const QuantW& w, void* y, float* work, int64_t M,
                          const DecodePlan& p, cudaStream_t stream) {
  const int64_t row_blocks = cdiv(M, MR);
  if (row_blocks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(p.col_ctas), static_cast<unsigned>(p.ksplit),
                  static_cast<unsigned>(row_blocks));
  qdecode_kernel<T, kBits, MR, CPT, kArith><<<grid, kThreads, p.smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), work, M, p.kchunk, p.ksplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.ksplit == 1) return err;
  const int64_t total = M * w.out;
  qsplit_sum_kernel<T><<<static_cast<unsigned>(cdiv(total, kThreads)), kThreads, 0, stream>>>(
      work, static_cast<T*>(y), total, p.ksplit);
  return cudaGetLastError();
}

template <typename T, int kBits>
cudaError_t dispatch_decode(const void* x, const QuantW& w, void* y, float* work, int64_t M,
                            const DecodePlan& p, cudaStream_t stream) {
  if (p.mr == 4) return launch_decode<T, kBits, 4, 16>(x, w, y, work, M, p, stream);
  if (p.mr == 8) return launch_decode<T, kBits, 8, 8>(x, w, y, work, M, p, stream);
  return launch_decode<T, kBits, 16, 4>(x, w, y, work, M, p, stream);
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

// K16: the decode plan of one block of rows (at most 16, 8 for ugdot and
// u2dot), as K5 plans the same rows, with the variant's sums a set.
bool known_arith(int a) { return a >= kF32Mul && a <= kU2Dot; }

DecodePlan variant_plan(int arith, int64_t M, int64_t in_f, int64_t out_f, int num_sms) {
  const int sums = arith_sums(arith);
  const int64_t block_rows = sums == 64 ? kDecodeRows : 8;
  return decode_plan(4, M < block_rows ? M : block_rows, in_f, out_f, num_sms, sums);
}

template <int kArith>
cudaError_t launch_variant(const void* x, const QuantW& w, void* y, float* work, int64_t M,
                           const DecodePlan& p, cudaStream_t stream) {
  constexpr int kSums = arith_sums(kArith);
  if (p.mr == 4) return launch_decode<bf16, 4, 4, kSums / 4, kArith>(x, w, y, work, M, p, stream);
  if (p.mr == 8) return launch_decode<bf16, 4, 8, kSums / 8, kArith>(x, w, y, work, M, p, stream);
  if constexpr (kSums == 64) {
    return launch_decode<bf16, 4, 16, 4, kArith>(x, w, y, work, M, p, stream);
  }
  return cudaErrorInvalidValue;
}

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
// floats; -1 when the device's SM count cannot be read.
extern "C" int64_t smft_quant_mm_workspace(int dtype, int device, int bits, int dx, int64_t M,
                                           int64_t in_f, int64_t out_f) {
  if (M == 0) return 0;
  int num_sms = 0;
  if (cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (use_decode(dx, M)) {
    const DecodePlan p = decode_plan(bits, M, in_f, out_f, num_sms);
    return p.ksplit > 1 ? static_cast<int64_t>(p.ksplit) * M * out_f : 0;
  }
  if (dtype == 1) return smft_quant_wgmma_workspace(bits, device, dx, M, in_f, out_f);
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
  if (use_decode(dx, M)) {
    const DecodePlan p = decode_plan(bits, M, in_f, out_f, num_sms);
    if (dtype == 0) {
      return bits == 8 ? dispatch_decode<float, 8>(a, w, out, work, M, p, s)
                       : dispatch_decode<float, 4>(a, w, out, work, M, p, s);
    }
    return bits == 8 ? dispatch_decode<bf16, 8>(a, w, out, work, M, p, s)
                     : dispatch_decode<bf16, 4>(a, w, out, work, M, p, s);
  }
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

// K16.  The plan of a call (mr, cpt, kchunk, ksplit, col_ctas, row blocks)
// into `plan[6]`; returns a cudaError_t.
extern "C" int smft_int4_variant_plan(int device, int arith, int64_t M, int64_t in_f,
                                      int64_t out_f, int64_t* plan) {
  if (!known_arith(arith) || M <= 0) return cudaErrorInvalidValue;
  int num_sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const DecodePlan p = variant_plan(arith, M, in_f, out_f, num_sms);
  const int64_t out[6] = {p.mr, p.cpt, p.kchunk, p.ksplit, p.col_ctas, cdiv(M, p.mr)};
  for (int i = 0; i < 6; ++i) plan[i] = out[i];
  return cudaSuccess;
}

// fp32 scratch of a K16 call (the split's partial sums), in floats; -1 when
// the device's SM count cannot be read.
extern "C" int64_t smft_int4_variant_mm_workspace(int device, int arith, int64_t M, int64_t in_f,
                                                  int64_t out_f) {
  if (M == 0 || !known_arith(arith)) return 0;
  int num_sms = 0;
  if (cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  const DecodePlan p = variant_plan(arith, M, in_f, out_f, num_sms);
  return p.ksplit > 1 ? static_cast<int64_t>(p.ksplit) * M * out_f : 0;
}

// K16: y (M, out) bf16, the raw output of variant `arith` (an Arith) of
// x (M, in) bf16 and the packed int4 codes (in/2, out) with f32 scales
// (in/group, out); contiguous on `device`, aligned to 16 bytes,
// (in/2) % group == 0, out % 16 == 0: the binding checks.  Returns the
// cudaError_t of the launches.
extern "C" int smft_int4_variant_mm(int device, int arith, const void* x, const void* codes,
                                    const float* scales, void* y, float* work, int64_t M,
                                    int64_t in_f, int64_t out_f, int group, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!known_arith(arith)) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const QuantW w = make_w(4, codes, scales, in_f, out_f, group);
  auto s = static_cast<cudaStream_t>(stream);
  int num_sms = 0;
  err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const DecodePlan p = variant_plan(arith, M, in_f, out_f, num_sms);
  switch (arith) {
    case kF32Mul: return launch_variant<kF32Mul>(x, w, y, work, M, p, s);
    case kBf16Mul: return launch_variant<kBf16Mul>(x, w, y, work, M, p, s);
    case kUCorr: return launch_variant<kUCorr>(x, w, y, work, M, p, s);
    case kUGdot: return launch_variant<kUGdot>(x, w, y, work, M, p, s);
    case kF32Dot: return launch_variant<kF32Dot>(x, w, y, work, M, p, s);
    default: return launch_variant<kU2Dot>(x, w, y, work, M, p, s);
  }
}
