// The fused dense + Monarch linear for Hopper, sm_90a:
//   K9   y  = x    @ Wd^T + monarch(x)            (forward)
//   K10  dx = dout @ Wd   + monarch^T(dout)       (input gradient)
// K11, the factor gradients, launches K4's kernel (monarch_bwd.cu): the TPU
// kernel `_dw_kernel` computes the same function as `_dw_only_kernel`.
//
// Replace the Pallas TPU kernels `_fwd_kernel` (K9, :52-77) and `_dx_kernel`
// (K10, :80-105) of sparse_matrix_fine_tuning_tpu/kernels/experimental/
// more_linear.py.  Written from the math, with the factors indexed directly
// (the TPU kernel's expanded W1bd / W2hat are never built):
//
//   x (M, n), n = K*P;  dout (M, m), m = S*L;  Wd (m, n), frozen;
//   w1 (K, Q, P);  w2 (L, S, R);  J = K*Q = L*R.
//   out1[b, k*Q + q]  = round_T( sum_p x[b, k*P + p] * w1[k, q, p] )
//   y[b, s*L + l]     = round_T( sum_i x[b, i] * Wd[s*L + l, i]
//                                + sum_r out1[b, r*L + l] * w2[l, s, r] )
//   dout1[b, r*L + l] = round_T( sum_s dout[b, s*L + l] * w2[l, s, r] )
//   dx[b, k*P + p]    = round_T( sum_j dout[b, j] * Wd[j, k*P + p]
//                                + sum_q dout1[b, k*Q + q] * w1[k, q, p] )
// T is the dtype of x (float or bf16).  Every sum is fp32 and the output is
// rounded once, as the TPU kernel's epilogue does.
//
// What bounds them on this card: operations.  The dense product does
// 2*M*n*m flops over (M*(n + m) + n*m) elements, hundreds of flops a byte at
// the Llama shapes; the Monarch term adds under 1% to either.  The design:
//  * `summary_kernel`, a pre-pass, computes out1 (forward) or dout1 (dx) once
//    for each row into fp32 scratch (M, J), rounded to T: one warp per (row,
//    block, 4 of Q or R), lanes along the block, fixed-order warp sums.  It
//    reads x (or dout) once more, M*n*itemsize bytes.  The TPU kernel
//    instead recomputed out1 for every output tile (J/tm more multiply-adds
//    of the mainloop), which here would be CUDA-core work beside the tensor
//    cores' or a padded mma (Q and R are 4-16, mma's n is 8).
//  * `gemm_bf16` is quant_matmul.cu's bf16 mainloop without the
//    dequantization: a 128 x 128 output tile per CTA, 8 warps of 64 x 32,
//    mma.sync m16n8k16 (bf16 in, fp32 sums), cp.async three stages deep (two
//    k steps ahead), fragments by ldmatrix, two CTAs an SM.  The forward
//    reads Wd as (N, K) (its rows are the output columns), dx as (K, N); each
//    is copied to shared memory as it lies, and the B fragments are loaded
//    plain or transposed accordingly.
//  * The epilogue stages the tile's rows of the summary and its columns'
//    factor entries in shared memory (the pipeline's buffers, free by then)
//    and adds the Monarch term, R (or Q) FMAs an output, to each fp32 sum
//    before the one rounding.
//  * f32 takes `gemm_f32`, a CUDA-core tile kernel (no TF32), the checks'
//    path.
// The reduction over K stays inside a CTA: no split, no atomics, the same
// bits from run to run.  Rows past M are never loaded; widths must be
// multiples of 8 (16-byte copies) and J at most kMaxJ: the binding checks.
//
// The C interface below takes raw pointers and returns a cudaError_t, so
// this file needs no PyTorch header; ops.cpp binds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;  // both tile kernels: a 128 x 128 output tile, 8 warps
constexpr int kMaxJ = 64;   // the epilogue's staging holds J = K*Q up to this

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Geom {
  int64_t M, n, m;  // rows, input width (K*P), output width (S*L)
  int K, Q, P, L, S, R;
};

// -- the row summaries: out1 (forward) or dout1 (dx) ------------------------
//
// s[b, j] (M, J) fp32, rounded to T.  Forward (kDx false): a = x (M, n),
// j = k*Q + q; dx: a = dout (M, m), j = r*L + l.  One warp per (row b,
// block k or l, DB consecutive q or r), lanes along p or s.
template <typename T, bool kDx, int DB>
__global__ void __launch_bounds__(kThreads)
summary_kernel(const T* __restrict__ a, const T* __restrict__ w1, const T* __restrict__ w2,
               float* __restrict__ s, Geom g) {
  const int lane = threadIdx.x % 32;
  const int blocks = kDx ? g.L : g.K;
  const int groups = (kDx ? g.R : g.Q) / DB;
  const int64_t task = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (task >= g.M * blocks * groups) return;  // a whole warp at once
  const int64_t b = task / (blocks * groups);
  const int rest = static_cast<int>(task % (blocks * groups));
  const int blk = rest / groups;
  const int d0 = (rest % groups) * DB;
  float acc[DB];
#pragma unroll
  for (int u = 0; u < DB; ++u) acc[u] = 0.f;
  if constexpr (kDx) {
    const T* ar = a + b * g.m + blk;                                     // dout[b, s*L + l]
    const T* wr = w2 + static_cast<int64_t>(blk) * g.S * g.R + d0;       // w2[l, s, d0 + u]
    for (int si = lane; si < g.S; si += 32) {
      const float v = to_f32(ar[static_cast<int64_t>(si) * g.L]);
#pragma unroll
      for (int u = 0; u < DB; ++u) acc[u] += v * to_f32(wr[static_cast<int64_t>(si) * g.R + u]);
    }
  } else {
    const T* ar = a + b * g.n + static_cast<int64_t>(blk) * g.P;         // x[b, k*P + p]
    const T* wr = w1 + (static_cast<int64_t>(blk) * g.Q + d0) * g.P;     // w1[k, d0 + u, p]
    for (int p = lane; p < g.P; p += 32) {
      const float v = to_f32(ar[p]);
#pragma unroll
      for (int u = 0; u < DB; ++u) acc[u] += v * to_f32(wr[static_cast<int64_t>(u) * g.P + p]);
    }
  }
  const int J = g.K * g.Q;
#pragma unroll
  for (int u = 0; u < DB; ++u) {
    const float total = warp_sum(acc[u]);
    if (lane == 0) {
      const int j = kDx ? (d0 + u) * g.L + blk : blk * g.Q + d0 + u;
      s[b * J + j] = round_t<T>(total);
    }
  }
}

// -- the epilogue, shared by both tile kernels -------------------------------
//
// The Monarch term of output (row, col) is sum_d ss[row][jb + d * js] *
// fs[col][d] over d < D: forward D = R, jb = col % L, js = L, fs[col][r] =
// w2[l, s, r]; dx D = Q, jb = (col / P) * Q, js = 1, fs[col][q] = w1[k, q, p].
// ss holds the tile's kTile summary rows and fs its kTile columns' factor
// entries, rows of J + 1 floats (odd, so a warp's rows fall in distinct banks).
struct Epi {
  const float* ss;
  const float* fs;
  int ld, D, js;
};

template <typename T, bool kDx>
__device__ Epi stage_epilogue(float* smem, const float* __restrict__ summ,
                              const T* __restrict__ w1, const T* __restrict__ w2,
                              const Geom& g, int64_t m0, int64_t n0, int64_t N) {
  const int J = g.K * g.Q;
  const int ld = J + 1;
  const int D = kDx ? g.Q : g.R;
  float* ss = smem;
  float* fs = smem + kTile * ld;
  for (int i = threadIdx.x; i < kTile * J; i += kThreads) {
    const int r = i / J, j = i % J;
    ss[r * ld + j] = m0 + r < g.M ? summ[(m0 + r) * J + j] : 0.f;
  }
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int c = i / D, d = i % D;
    const int64_t col = n0 + c;
    float v = 0.f;
    if (col < N) {
      if constexpr (kDx) {  // col = k*P + p: w1[k, d, p]
        const int64_t k = col / g.P, p = col % g.P;
        v = to_f32(w1[(k * g.Q + d) * g.P + p]);
      } else {              // col = s*L + l: w2[l, s, d]
        const int64_t l = col % g.L, s = col / g.L;
        v = to_f32(w2[(l * g.S + s) * g.R + d]);
      }
    }
    fs[c * ld + d] = v;
  }
  return Epi{ss, fs, ld, D, kDx ? 1 : g.L};
}

// The first summary index of a column: forward col % L, dx (col / P) * Q.
template <bool kDx>
__device__ __forceinline__ int epi_base(const Geom& g, int64_t col) {
  return kDx ? static_cast<int>(col / g.P) * g.Q : static_cast<int>(col % g.L);
}

__device__ __forceinline__ float monarch_term(const Epi& e, int row_l, int col_l, int jb) {
  const float* sr = e.ss + row_l * e.ld + jb;
  const float* fc = e.fs + col_l * e.ld;
  float v = 0.f;
  for (int d = 0; d < e.D; ++d) v += sr[d * e.js] * fc[d];
  return v;
}

int epi_bytes(int J) { return 2 * kTile * (J + 1) * static_cast<int>(sizeof(float)); }

// -- bf16: the pipelined tensor-core tile kernel ----------------------------
//
// C (M, N) = A (M, Kd) @ B (Kd, N), B(k, nn) = Wd[nn, k] for the forward
// (N = m, Kd = n) and Wd[k, nn] for dx (N = n, Kd = m).  A k step of BK; the
// A tile and the B tile of kPipe - 1 steps ahead are in flight while a step
// computes.
constexpr int kPipe = 3;
constexpr int BK = 64;
constexpr int kLdA = BK + 8;  // bf16 per row of the A tile; 144 bytes: ldmatrix without conflicts
constexpr int kABytes = kTile * kLdA * 2;

template <bool kDx>
struct BLayout {
  // forward Bs[nn][k] (k contiguous, as Wd's rows), dx Bs[k][nn] (nn contiguous)
  static constexpr int kLd = kDx ? kTile + 8 : BK + 8;
  static constexpr int kBytes = (kDx ? BK : kTile) * kLd * 2;
  static constexpr int kStage = kABytes + kBytes;
  static constexpr int kSmem = kPipe * kStage;  // 105-108 KB: two CTAs an SM
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 bf16 matrices from shared memory, lane l addressing row l % 8
// of matrix l / 8 (`trans`: each matrix transposed on the way).
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kDx>
__global__ void __launch_bounds__(kThreads, 2)
gemm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ Wd, const bf16* __restrict__ w1,
          const bf16* __restrict__ w2, const float* __restrict__ summ, bf16* __restrict__ C,
          Geom g) {
  using BL = BLayout<kDx>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t M = g.M;
  const int64_t N = kDx ? g.n : g.m;
  const int64_t Kd = kDx ? g.m : g.n;
  const int t = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTile;
  auto stage_a = [&](int s) { return reinterpret_cast<bf16*>(smem + s * BL::kStage); };
  auto stage_b = [&](int s) { return reinterpret_cast<bf16*>(smem + s * BL::kStage + kABytes); };

  auto issue = [&](int s, int64_t k0) {
    bf16* as = stage_a(s);
#pragma unroll
    for (int i = 0; i < kTile * BK / 8 / kThreads; ++i) {  // A: 128 rows x BK / 8 chunks
      const int c = t + i * kThreads;
      const int row = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const bool ok = m0 + row < M && k0 + kc < Kd;
      cp_async16(as + row * kLdA + kc, ok ? A + (m0 + row) * Kd + k0 + kc : A, ok);
    }
    bf16* bs = stage_b(s);
#pragma unroll
    for (int i = 0; i < kTile * BK / 8 / kThreads; ++i) {
      const int c = t + i * kThreads;
      if constexpr (kDx) {  // BK rows k x 128 columns nn of Wd (m, n)
        const int k = c / (kTile / 8), nc = (c % (kTile / 8)) * 8;
        const bool ok = k0 + k < Kd && n0 + nc < N;
        cp_async16(bs + k * BL::kLd + nc, ok ? Wd + (k0 + k) * N + n0 + nc : Wd, ok);
      } else {              // 128 rows nn x BK columns k of Wd (m, n)
        const int nn = c / (BK / 8), kc = (c % (BK / 8)) * 8;
        const bool ok = n0 + nn < N && k0 + kc < Kd;
        cp_async16(bs + nn * BL::kLd + kc, ok ? Wd + (n0 + nn) * Kd + k0 + kc : Wd, ok);
      }
    }
  };

  const int warp = t / 32, lane = t % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int gr = lane / 4, qc = lane % 4;
  const int mat = lane / 8, rim = lane % 8;  // the ldmatrix row this lane addresses
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // 32-bit step counts (Kd < 2^31, the binding checks): a 64-bit modulo
  // is a long software routine
  const int steps = static_cast<int>((Kd + BK - 1) / BK);
#pragma unroll
  for (int s = 0; s < kPipe - 1; ++s) {
    if (s < steps) issue(s, static_cast<int64_t>(s) * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kPipe - 2>();
    __syncthreads();  // step kt has landed; every warp is done with step kt - 1
    if (kt + kPipe - 1 < steps)
      issue((kt + kPipe - 1) % kPipe, static_cast<int64_t>(kt + kPipe - 1) * BK);
    cp_async_commit();
    const int s = kt % kPipe;
    const bf16* as = stage_a(s);
    const bf16* bs = stage_b(s);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      // A: matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
      // of each 16 x 16 block; B: (k 0-7, k 8-15) of two 8-column blocks
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4<false>(a[mi], as + (wm * 64 + mi * 16 + (mat % 2) * 8 + rim) * kLdA + ks +
                                  (mat / 2) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        const int c = wn * 32 + (np * 2 + mat / 2) * 8;
        if constexpr (kDx) {
          ldsm_x4<true>(r, bs + (ks + (mat % 2) * 8 + rim) * BL::kLd + c);  // Bs[k][nn]: rows k
        } else {
          ldsm_x4<false>(r, bs + (c + rim) * BL::kLd + ks + (mat % 2) * 8);  // Bs[nn][k]: rows nn
        }
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages: the epilogue reuses them

  const Epi e = stage_epilogue<bf16, kDx>(reinterpret_cast<float*>(smem), summ, w1, w2, g, m0,
                                          n0, N);
  __syncthreads();
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col_l = wn * 32 + ni * 8 + 2 * qc;  // even; N is even
    const int64_t col = n0 + col_l;
    if (col >= N) continue;
    const int jb0 = epi_base<kDx>(g, col), jb1 = epi_base<kDx>(g, col + 1);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row_l = wm * 64 + mi * 16 + gr + 8 * hr;
        const int64_t row = m0 + row_l;
        if (row >= M) continue;
        const float v0 = acc[mi][ni][2 * hr] + monarch_term(e, row_l, col_l, jb0);
        const float v1 = acc[mi][ni][2 * hr + 1] + monarch_term(e, row_l, col_l + 1, jb1);
        *reinterpret_cast<__nv_bfloat162*>(C + row * N + col) = __floats2bfloat162_rn(v0, v1);
      }
  }
}

// -- f32: a CUDA-core tile kernel -----------------------------------------
//
// 16 x 16 threads, each an 8 x 8 micro tile (rows ty + 16 i, columns
// tx + 16 j), a k step of 16.  A's shared rows and the forward's B rows
// (Bs[nn][k]) are padded to 17 floats, so that the 16 distinct rows a warp
// reads fall in 16 banks; dx's B rows (Bs[k][nn]) need no pad.
constexpr int kF32BK = 16;
constexpr int kF32Ld = kF32BK + 1;
constexpr int kF32Smem = (kTile * kF32Ld + kTile * kF32Ld) * static_cast<int>(sizeof(float));

template <bool kDx>
__global__ void __launch_bounds__(kThreads)
gemm_f32(const float* __restrict__ A, const float* __restrict__ Wd, const float* __restrict__ w1,
         const float* __restrict__ w2, const float* __restrict__ summ, float* __restrict__ C,
         Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // [128][17]
  float* Bs = As + kTile * kF32Ld;             // forward [128 nn][17], dx [16 k][128 nn]
  const int64_t M = g.M;
  const int64_t N = kDx ? g.n : g.m;
  const int64_t Kd = kDx ? g.m : g.n;
  const int t = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTile;

  float4 a_reg[2], b_reg[2];
  auto load = [&](int64_t k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 128 x 16 floats of A and of B, float4 each
      const int c = t + i * kThreads;
      const int row = c / 4, kc = (c % 4) * 4;
      a_reg[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + row < M && k0 + kc < Kd)
        a_reg[i] = *reinterpret_cast<const float4*>(A + (m0 + row) * Kd + k0 + kc);
      b_reg[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kDx) {
        const int k = c / (kTile / 4), nc = (c % (kTile / 4)) * 4;
        if (k0 + k < Kd && n0 + nc < N)
          b_reg[i] = *reinterpret_cast<const float4*>(Wd + (k0 + k) * N + n0 + nc);
      } else {
        if (n0 + row < N && k0 + kc < Kd)
          b_reg[i] = *reinterpret_cast<const float4*>(Wd + (n0 + row) * Kd + k0 + kc);
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = t + i * kThreads;
      const int row = c / 4, kc = (c % 4) * 4;
      float* ad = As + row * kF32Ld + kc;
      ad[0] = a_reg[i].x; ad[1] = a_reg[i].y; ad[2] = a_reg[i].z; ad[3] = a_reg[i].w;
      if constexpr (kDx) {
        const int k = c / (kTile / 4), nc = (c % (kTile / 4)) * 4;
        *reinterpret_cast<float4*>(Bs + k * kTile + nc) = b_reg[i];
      } else {
        float* bd = Bs + row * kF32Ld + kc;  // padded rows: no 16-byte store
        bd[0] = b_reg[i].x; bd[1] = b_reg[i].y; bd[2] = b_reg[i].z; bd[3] = b_reg[i].w;
      }
    }
  };

  const int ty = t / 16, tx = t % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  for (int64_t k0 = 0; k0 < Kd; k0 += kF32BK) {
    store();
    __syncthreads();
    if (k0 + kF32BK < Kd) load(k0 + kF32BK);
#pragma unroll
    for (int k = 0; k < kF32BK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty + 16 * i) * kF32Ld + k];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = kDx ? Bs[k * kTile + tx + 16 * j] : Bs[(tx + 16 * j) * kF32Ld + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  const Epi e = stage_epilogue<float, kDx>(reinterpret_cast<float*>(smem), summ, w1, w2, g, m0,
                                           n0, N);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col_l = tx + 16 * j;
    const int64_t col = n0 + col_l;
    if (col >= N) continue;
    const int jb = epi_base<kDx>(g, col);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row_l = ty + 16 * i;
      if (m0 + row_l >= M) continue;
      C[(m0 + row_l) * N + col] = acc[i][j] + monarch_term(e, row_l, col_l, jb);
    }
  }
}

// -- host side ------------------------------------------------------------

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T, bool kDx>
cudaError_t launch(const void* a, const void* wd, const void* w1, const void* w2, void* out,
                   float* work, const Geom& g, cudaStream_t stream) {
  const T* at = static_cast<const T*>(a);
  const T* w1t = static_cast<const T*>(w1);
  const T* w2t = static_cast<const T*>(w2);
  const int D = kDx ? g.R : g.Q;
  const int64_t blocks = kDx ? g.L : g.K;
  const int db = D % 4 == 0 ? 4 : 1;
  const int64_t tasks = g.M * blocks * (D / db);
  const unsigned sgrid = static_cast<unsigned>(cdiv(tasks, kWarps));
  if (db == 4) {
    summary_kernel<T, kDx, 4><<<sgrid, kThreads, 0, stream>>>(at, w1t, w2t, work, g);
  } else {
    summary_kernel<T, kDx, 1><<<sgrid, kThreads, 0, stream>>>(at, w1t, w2t, work, g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t N = kDx ? g.n : g.m;
  const int64_t row_tiles = cdiv(g.M, kTile);
  if (row_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(cdiv(N, kTile)), static_cast<unsigned>(row_tiles));
  const int epi = epi_bytes(g.K * g.Q);
  if constexpr (sizeof(T) == 2) {
    auto kernel = gemm_bf16<kDx>;
    const int smem = BLayout<kDx>::kSmem > epi ? BLayout<kDx>::kSmem : epi;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(at, static_cast<const bf16*>(wd), w1t, w2t, work,
                                             static_cast<bf16*>(out), g);
  } else {
    auto kernel = gemm_f32<kDx>;
    const int smem = kF32Smem > epi ? kF32Smem : epi;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(at, static_cast<const float*>(wd), w1t, w2t, work,
                                             static_cast<float*>(out), g);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  dx: 0 for K9 (a = x (M, n), out = y
// (M, m)), 1 for K10 (a = dout (M, m), out = dx (M, n)).  wd (m, n), w1
// (K, Q, P), w2 (L, S, R), all of that dtype, contiguous on `device`; a and
// wd start on 16 bytes; n % 8 == 0, m % 8 == 0, K*P == n, S*L == m,
// L*R == K*Q <= 64: the binding checks.  work: M*K*Q fp32 (the row
// summaries).  Returns the cudaError_t of the launches.
extern "C" int smft_more_linear(int dtype, int device, int dx, const void* a, const void* wd,
                                const void* w1, const void* w2, void* out, float* work,
                                int64_t M, int64_t n, int64_t m, int K, int Q, int P, int L,
                                int S, int R, void* stream) {
  // This library carries its own (static) CUDA runtime, whose current
  // device is not PyTorch's: set it to the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M == 0) return cudaSuccess;
  if (K * Q > kMaxJ || L * R != K * Q || n % 8 != 0 || m % 8 != 0) return cudaErrorInvalidValue;
  const Geom g{M, n, m, K, Q, P, L, S, R};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dx ? launch<float, true>(a, wd, w1, w2, out, work, g, s)
              : launch<float, false>(a, wd, w1, w2, out, work, g, s);
  }
  if (dtype == 1) {
    return dx ? launch<bf16, true>(a, wd, w1, w2, out, work, g, s)
              : launch<bf16, false>(a, wd, w1, w2, out, work, g, s);
  }
  return cudaErrorInvalidValue;
}
