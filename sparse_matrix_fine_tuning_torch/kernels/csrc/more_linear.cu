// The fused dense + Monarch linear for Hopper, sm_90a:
//   K9   y  = x    @ Wd^T + monarch(x)            (forward)
//   K10  dx = dout @ Wd   + monarch^T(dout)       (input gradient)
// K11, the factor gradients, launches K4's kernel (monarch_bwd.cu): the TPU
// kernel `_dw_kernel` computes the same function as `_dw_only_kernel`.
//
// Replace the Pallas TPU kernels `_fwd_kernel` (K9, :52-77) and `_dx_kernel`
// (K10, :80-105) of sparse_matrix_fine_tuning_tpu/kernels/experimental/
// more_linear.py.  Written from the math, with the factors indexed directly
// (the TPU kernel's expanded W1bd / W2hat are never written to memory):
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
// rounded once, as the TPU kernel's epilogue does.  In matrix form, with
// W1bd (n, J), W1bd[k*P + p, k*Q + q] = w1[k, q, p], and W2hat (J, m),
// W2hat[r*L + l, s*L + l] = w2[l, s, r] (zero elsewhere):
//   y  = round_T( x Wd^T + round_T(x W1bd) W2hat ),
//   dx = round_T( dout Wd + round_T(dout W2hat^T) W1bd^T ).
//
// What bounds them on this card: operations.  The dense product does
// 2*M*n*m flops over (M*(n + m) + n*m) elements, hundreds of flops a byte at
// the Llama shapes.  Only wgmma reaches the tensor cores' full rate, so
// bf16 runs one warp-specialised kernel a call, `fused_kernel`, K15's
// (tiled_matmul.cu) design with the Monarch term folded in:
//  * a CTA owns a BM x BN output tile (the plan, `make_plan`: 128 rows where
//    128 x 256 tiles fill the SMs, 256 columns at JK = 16 and narrower
//    above, else 64 x 128); a ring of 4 stages holds, for a k step of 64,
//    the A tile (x or dout, BM x 64) and the B tile of Wd, loaded by TMA in
//    the 128-byte swizzle (K9 reads Wd's rows K-major as they lie, K10 reads
//    them MN-major, as K15 reads w), and a slice of the row summaries'
//    factor, 64 k x JK (JK = J rounded up to 16, at most 64);
//  * a producer warpgroup: one thread of warp 0 issues the TMA loads; warps
//    1-3 take the steps in turn and write each stage's factor slice (K9:
//    W1bd[k0 : k0 + 64, :]; K10: W2hat^T[k0 : k0 + 64, :]) from w1 or w2
//    straight into the swizzled layout (only its nonzero entries where
//    their places repeat from step to step: `FastSlice`), fence it to the
//    async proxy and arrive on the stage's full barrier; and the tile's
//    Monarch factor, JK x BN (W2hat[:, n0 :] or W1bd^T[:, n0 :]);
//  * BM / 64 consumer warpgroups: per k step, four wgmma m64nBNk16 into the
//    tile's fp32 sums and four wgmma m64nJKk16 into a second accumulator,
//    the rows' summaries (out1 or dout1: the TPU kernel's per-tile
//    recomputation, JK / BN more multiply-adds), one group in flight; then
//    the summaries rounded to bf16 are the A fragments (registers) of
//    JK / 16 wgmma m64nBNk16 against the tile's Monarch factor, added into
//    the same fp32 sums, which are rounded to bf16 once and leave through
//    shared memory by TMA stores.
// What holds it (scripts/probe_more_linear.py; PERF.md §6): the mainloop
// runs at K15's rate, and the summaries' wgmmas and the slices each add
// about 6-8% to it; the 2.5 waves of 128 x 256 tiles at the bench's qkv
// shape leave part of the last wave idle.
// The reduction over k stays inside a CTA: no split, no atomics, the same
// bits from run to run.  TMA zero-fills rows past M and k past the width;
// the factor slices are written as zeros there and past J.  Every mbarrier
// wait traps after 2^22 polls, so a pipeline fault is a launch error and
// not a hung card.
//
// f32 (the checks' path) takes `summary_kernel`, a pre-pass computing out1
// or dout1 into fp32 scratch (M, J) (one warp per row, block and 4 of Q or
// R), then `gemm_f32`, a CUDA-core tile kernel (no TF32) whose epilogue adds
// the Monarch term from the staged summaries.  Widths must be multiples of
// 8 (16-byte rows: TMA's stride rule) and J at most kMaxJ: the binding
// checks.
//
// The C interface below takes raw pointers and returns a cudaError_t, so
// this file needs no PyTorch header; ops.cpp binds it.

#include <cuda.h>  // CUtensorMap and its enums: types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace smft_hopper;
using bf16 = __nv_bfloat16;

constexpr int kMaxJ = 64;  // J = K*Q the kernels take

struct Geom {
  int64_t M, n, m;  // rows, input width (K*P), output width (S*L)
  int K, Q, P, L, S, R;
};

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// -- f32: the row summaries, then a CUDA-core tile kernel -------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;  // gemm_f32: a 128 x 128 output tile, 16 x 16 threads

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// s[b, j] (M, J) fp32.  Forward (kDx false): a = x (M, n), j = k*Q + q; dx:
// a = dout (M, m), j = r*L + l.  One warp per (row b, block k or l, DB
// consecutive q or r), lanes along p or s.
template <bool kDx, int DB>
__global__ void __launch_bounds__(kThreads)
summary_kernel(const float* __restrict__ a, const float* __restrict__ w1,
               const float* __restrict__ w2, float* __restrict__ s, Geom g) {
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
    const float* ar = a + b * g.m + blk;                                 // dout[b, s*L + l]
    const float* wr = w2 + static_cast<int64_t>(blk) * g.S * g.R + d0;   // w2[l, s, d0 + u]
    for (int si = lane; si < g.S; si += 32) {
      const float v = ar[static_cast<int64_t>(si) * g.L];
#pragma unroll
      for (int u = 0; u < DB; ++u) acc[u] += v * wr[static_cast<int64_t>(si) * g.R + u];
    }
  } else {
    const float* ar = a + b * g.n + static_cast<int64_t>(blk) * g.P;     // x[b, k*P + p]
    const float* wr = w1 + (static_cast<int64_t>(blk) * g.Q + d0) * g.P; // w1[k, d0 + u, p]
    for (int p = lane; p < g.P; p += 32) {
      const float v = ar[p];
#pragma unroll
      for (int u = 0; u < DB; ++u) acc[u] += v * wr[static_cast<int64_t>(u) * g.P + p];
    }
  }
  const int J = g.K * g.Q;
#pragma unroll
  for (int u = 0; u < DB; ++u) {
    const float total = warp_sum(acc[u]);
    if (lane == 0) {
      const int j = kDx ? (d0 + u) * g.L + blk : blk * g.Q + d0 + u;
      s[b * J + j] = total;
    }
  }
}

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

template <bool kDx>
__device__ Epi stage_epilogue(float* smem, const float* __restrict__ summ,
                              const float* __restrict__ w1, const float* __restrict__ w2,
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
        v = w1[(k * g.Q + d) * g.P + p];
      } else {              // col = s*L + l: w2[l, s, d]
        const int64_t l = col % g.L, s = col / g.L;
        v = w2[(l * g.S + s) * g.R + d];
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

  const Epi e = stage_epilogue<kDx>(reinterpret_cast<float*>(smem), summ, w1, w2, g, m0, n0, N);
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

template <bool kDx>
cudaError_t launch_f32(const float* a, const float* wd, const float* w1, const float* w2,
                       float* out, float* work, const Geom& g, cudaStream_t stream) {
  const int D = kDx ? g.R : g.Q;
  const int64_t blocks = kDx ? g.L : g.K;
  const int db = D % 4 == 0 ? 4 : 1;
  const int64_t tasks = g.M * blocks * (D / db);
  const unsigned sgrid = static_cast<unsigned>(cdiv(tasks, kWarps));
  if (db == 4) {
    summary_kernel<kDx, 4><<<sgrid, kThreads, 0, stream>>>(a, w1, w2, work, g);
  } else {
    summary_kernel<kDx, 1><<<sgrid, kThreads, 0, stream>>>(a, w1, w2, work, g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t N = kDx ? g.n : g.m;
  const int64_t row_tiles = cdiv(g.M, kTile);
  if (row_tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(cdiv(N, kTile)), static_cast<unsigned>(row_tiles));
  auto kernel = gemm_f32<kDx>;
  const int epi = epi_bytes(g.K * g.Q);
  const int smem = kF32Smem > epi ? kF32Smem : epi;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a, wd, w1, w2, work, out, g);
  return cudaGetLastError();
}

// -- bf16: the warp-specialised wgmma + TMA kernel --------------------------

constexpr int kBK = 64;           // k a stage: 64 bf16, one 128-byte swizzle row
constexpr int kAtomBytes = 1024;  // 8 rows of 128 bytes: the swizzle's period
constexpr int kBoxBytes = kBK * 64 * 2;  // K10: one 64-column box of Wd's (64 x BN) tile
constexpr int kSmemMax = 232448;  // 227 KB a CTA

// A tile shape: BM x BN outputs, JK summary columns; BM / 64 consumer
// warpgroups and a producer warpgroup (warp 0 issues the TMA loads, warps 1
// to 3 write the factor operands: ptxas gives every thread of a wgmma
// kernel the registers of whole warpgroups, so a producer warp alone would
// save none).
template <int BM, int BN, int JK>
struct Tile {
  static_assert((BM == 128 && (BN == 256 || BN == 224 || BN == 192)) || (BM == 64 && BN == 128),
                "tile");
  static_assert(JK == 16 || JK == 32 || JK == 64, "summary width");
  static constexpr int kConsumers = BM / 64;
  static constexpr int kProducers = 4;
  static constexpr int kBuilders = 32 * (kProducers - 1);  // threads writing factors
  static constexpr int kThreads = 128 * kConsumers + 32 * kProducers;
  static constexpr int kABytes = BM * kBK * 2;  // a stage of x or dout
  static constexpr int kBoxes = (BN + 63) / 64;  // 64-column groups of the output tile
  static constexpr int kBBytes = kBK * 64 * kBoxes * 2;  // a stage of Wd (K10: whole boxes)
  static constexpr int kSBytes = JK * kBK * 2;  // a stage's factor slice: JK rows x 128 bytes
  static constexpr int kStage = kABytes + kBBytes + kSBytes;
  static constexpr int kEBytes = JK * 64 * kBoxes * 2;  // the Monarch factor: kBoxes of JK rows
  // the Monarch factor, the barriers (full, empty: 4 each at most; epi)
  // and slack to align the tiles on the swizzle's period
  static constexpr int kFixed = kEBytes + 8 * 9 + kAtomBytes;
  static constexpr int kFit = (kSmemMax - kFixed) / kStage;  // stages that fit
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "two stages must fit in 227 KB of shared memory");
  static constexpr int kSmem = kStages * kStage + kFixed;
};

struct Params {
  bf16* y;             // (M, N) output
  const bf16* w1;      // (K, Q, P)
  const bf16* w2;      // (L, S, R)
  int M, N, Kd;        // rows, output width, reduction width
  int K, Q, P, L, S, R, J;
  int w1_vec;          // w1 starts on 16 bytes and P % 8 == 0: W1bd's rows by 16-byte loads
  int fast;            // the factor slices' zeros stay in place from step to step (below)
  int fast_epi;        // K9: the Monarch factor by runs of w2 (R % 4 == 0, R <= 16, 8 bytes)
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

// The output tile goes out through shared memory by TMA: 32-column boxes of
// 64 rows, 64-byte swizzled (16-byte chunk c of row r at c ^ ((r / 2) % 4):
// a warp's 4-byte stores of a fragment column fall in distinct banks); TMA
// clips rows past M and columns past N.
constexpr int kOutBox = 64 * 32 * 2;  // one (64 x 32) box of the output, 4 KB

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bits_of(bf16 v) {
  return *reinterpret_cast<const uint16_t*>(&v);
}

// Eight consecutive entries, columns c0 .. c0 + 7, of row j of W1bd^T (J, n)
// (kW1bd) or of W2hat (J, m), zeros at j >= J and columns >= limit:
//   W1bd^T[j, i] = w1[k, q, i - k*P] where i / P == k, j = k*Q + q;
//   W2hat[j, c]  = w2[l, c / L, r]   where c % L == l, j = r*L + l.
template <bool kW1bd>
__device__ __forceinline__ uint4 factor_chunk(const Params& p, int j, int c0, int limit) {
  // (every index below is a constant after unrolling: h stays in registers)
  uint32_t h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (j < p.J && c0 < limit) {  // limit % 8 == 0: the whole chunk is below it
    if constexpr (kW1bd) {
      const int k = j / p.Q;
      const int lo = k * p.P - c0, hi = lo + p.P;  // block k's columns, from c0
      const bf16* row = p.w1 + static_cast<int64_t>(j) * p.P + c0 - static_cast<int64_t>(k) * p.P;
      if (p.w1_vec) {  // the chunk lies in one block, wholly inside or outside k's
        if (lo <= 0 && hi > 0) return __ldg(reinterpret_cast<const uint4*>(row));
        return make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e >= lo && e < hi) h[e] = bits_of(row[e]);
    } else {
      const int l = j % p.L, r = j / p.L;
      int cl = c0 % p.L;                 // column c0 + e is (s, cl) of w2's (S, L)
      const bf16* col = p.w2 + (static_cast<int64_t>(l) * p.S + c0 / p.L) * p.R + r;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (cl == l) h[e] = bits_of(*col);
        if (++cl == p.L) cl = 0, col += p.R;
      }
    }
  }
  return make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16, h[6] | h[7] << 16);
}

// Writes rows 0 .. JK - 1 of a factor operand, columns c0 .. c0 + COLS - 1
// (COLS a multiple of 8), in 128-byte swizzled rows: row j's 64-column
// group g at dst + g * group_bytes + j * 128, its 16-byte chunk c at
// c ^ (j % 8).  NT threads, `tid` this one's index; loads first, four chunks
// at a time.
template <bool kW1bd, int JK, int NT, int COLS>
__device__ __forceinline__ void write_factor(uint8_t* dst, int group_bytes, const Params& p,
                                             int c0, int limit, int tid) {
  constexpr int per_row = COLS / 8;
  constexpr int chunks = JK * per_row;
  for (int base = tid; base < chunks; base += 4 * NT) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * NT;
      const int j = i / per_row, c = i % per_row;
      v[u] = i < chunks ? factor_chunk<kW1bd>(p, j, c0 + 8 * c, limit) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * NT;
      if (i >= chunks) break;
      const int j = i / per_row, c = i % per_row;
      *reinterpret_cast<uint4*>(dst + (c / 8) * group_bytes + j * 128 +
                                (((c % 8) ^ (j % 8)) << 4)) = v[u];
    }
  }
}

// The byte offset of entry (row j, column kk) of a factor slice: 128-byte
// rows, 16-byte chunk c at c ^ (j % 8).
__device__ __forceinline__ int slice_at(int j, int kk) {
  return j * 128 + ((((kk >> 3) ^ (j & 7)) << 4) | ((kk & 7) << 1));
}

// The fast paths of a stage's factor slice, F1[k0 : k0 + 64, :] K-major,
// where its zeros lie in the same places at every step (`Params::fast`),
// one warp a step.  Every stage's slice is zeroed once before the first;
// then a step writes only what is not zero, and what was not zero in the
// stage's previous use but is now:
//  * K9, W1bd (P % 64 == 0, Q <= 16, w1 on 16 bytes): the step lies in block
//    k = k0 / P, so rows k*Q .. k*Q + Q - 1 are w1[k, q, k0 - k*P ..]
//    (16-byte loads) and every other row is zero: the previous block's rows
//    are zeroed where the block changed;
//  * K10, W2hat^T (64 % L == 0, R % 4 == 0, R <= 16, w2 on 8 bytes): column
//    kk = s*L + l of the step holds w2[l, s, r] at row r*L + l, the same
//    places at every step; each column's R values are one run of w2 (8-byte
//    loads), written row by row; columns past the width keep the previous
//    step's finite values, against A's zeros.
// `fetch` issues the step's loads (before the stage is free), `store` writes
// them.
template <bool kDx>
struct FastSlice {
  uint4 v1[4];     // K9: the lane's chunks i = lane + 32 u of the block's 8 Q
  uint2 v2[2][4];  // K10: the lane's columns kk = lane + 32 u, 4 runs of 4 r

  __device__ __forceinline__ void fetch(const Params& p, int k0, int lane) {
    if constexpr (!kDx) {
      const int k = k0 / p.P;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = lane + 32 * u, j = k * p.Q + (i / 8) % p.Q;
        if (i < 8 * p.Q)
          v1[u] = __ldg(reinterpret_cast<const uint4*>(
              p.w1 + static_cast<int64_t>(j) * p.P + k0 - k * p.P + 8 * (i % 8)));
      }
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = k0 + lane + 32 * u;
        if (c >= p.Kd) continue;
        const bf16* src = p.w2 + (static_cast<int64_t>(c % p.L) * p.S + c / p.L) * p.R;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          if (4 * g < p.R) v2[u][g] = __ldg(reinterpret_cast<const uint2*>(src + 4 * g));
      }
    }
  }

  __device__ __forceinline__ void store(uint8_t* dst, const Params& p, int k0, int kt,
                                        int stages, int lane) const {
    if constexpr (!kDx) {
      const int k = k0 / p.P;
      const int prev = kt >= stages ? (k0 - stages * 64) / p.P : k;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = lane + 32 * u, c = i % 8, q = (i / 8) % p.Q;
        if (i >= 8 * p.Q) continue;
        int j = k * p.Q + q;
        *reinterpret_cast<uint4*>(dst + j * 128 + ((c ^ (j & 7)) << 4)) = v1[u];
        if (prev != k) {  // the previous block's row, zeroed
          j = prev * p.Q + q;
          *reinterpret_cast<uint4*>(dst + j * 128 + ((c ^ (j & 7)) << 4)) =
              make_uint4(0u, 0u, 0u, 0u);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kk = lane + 32 * u, l = (k0 + kk) % p.L;
        if (k0 + kk >= p.Kd) continue;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (4 * g >= p.R) continue;
          const uint32_t h[4] = {v2[u][g].x & 0xffffu, v2[u][g].x >> 16, v2[u][g].y & 0xffffu,
                                 v2[u][g].y >> 16};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            *reinterpret_cast<uint16_t*>(dst + slice_at((4 * g + e) * p.L + l, kk)) =
                static_cast<uint16_t>(h[e]);
        }
      }
    }
  }
};

template <int BN, int kTransB>
__device__ __forceinline__ void mma_main(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256) {
    wgmma_m64n256k16<kTransB>(d, da, db);
  } else if constexpr (BN == 224) {
    wgmma_m64n224k16<kTransB>(d, da, db);
  } else if constexpr (BN == 192) {
    wgmma_m64n192k16<kTransB>(d, da, db);
  } else {
    wgmma_m64n128k16<kTransB>(d, da, db);
  }
}

template <int JK>
__device__ __forceinline__ void mma_summary(float (&d)[JK / 2], uint64_t da, uint64_t db) {
  if constexpr (JK == 16) {
    wgmma_m64n16k16<0>(d, da, db);
  } else if constexpr (JK == 32) {
    wgmma_m64n32k16<0>(d, da, db);
  } else {
    wgmma_m64n64k16<0>(d, da, db);
  }
}

template <int BN>
__device__ __forceinline__ void mma_monarch(float (&d)[BN / 2], const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (BN == 256) {
    wgmma_m64n256k16_rs<1>(d, a, db);
  } else if constexpr (BN == 224) {
    wgmma_m64n224k16_rs<1>(d, a, db);
  } else if constexpr (BN == 192) {
    wgmma_m64n192k16_rs<1>(d, a, db);
  } else {
    wgmma_m64n128k16_rs<1>(d, a, db);
  }
}

// y (M, N) = round_bf16( A B + round_bf16(A F1) F2 ) with, for K9, A = x,
// B = Wd^T, F1 = W1bd, F2 = W2hat; for K10, A = dout, B = Wd, F1 = W2hat^T,
// F2 = W1bd^T.  Grid: (row tiles, column tiles).
template <int BM, int BN, int JK, bool kDx>
__global__ void __launch_bounds__(Tile<BM, BN, JK>::kThreads, 1)
    fused_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_y, const Params p) {
  using T = Tile<BM, BN, JK>;
  constexpr int S = T::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw_u32 = smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + kAtomBytes - 1) & ~static_cast<uint32_t>(kAtomBytes - 1);
  uint8_t* const gbase = smem_raw + (base - raw_u32);  // the same, as a generic pointer
  const uint32_t a_smem = base;                        // S stages of A (BM x 64)
  const uint32_t b_smem = a_smem + S * T::kABytes;     // S stages of Wd's tile
  const uint32_t f_smem = b_smem + S * T::kBBytes;     // S stages of the factor slice
  const uint32_t e_smem = f_smem + S * T::kSBytes;     // the tile's Monarch factor
  const uint32_t bars = e_smem + T::kEBytes;           // full[S], empty[S], epi
  const uint32_t epi = bars + 16 * S;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int num_k = (p.Kd + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // the TMA thread's arrive with the bytes, and the step's builder warp's
      mbar_init(bars + 8 * s, 2);
      mbar_init(bars + 8 * (S + s), T::kConsumers);  // one arrive a consumer warpgroup
    }
    mbar_init(epi, T::kProducers - 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg >= T::kConsumers) {
    const int pt = threadIdx.x - 128 * T::kConsumers;
    if (pt < 32) {
      // Warp 0 of the producers: one thread issues every TMA load.
      if (pt != 0) return;
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map_a)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
      for (int kt = 0; kt < num_k; ++kt) {
        const int s = kt % S;
        // the stage's previous k tile must have been released
        if (kt >= S) wait_or_trap(bars + 8 * (S + s), ((kt / S) - 1) & 1);
        const uint32_t full = bars + 8 * s;
        const int k0 = kt * kBK;
        // K9 loads BN rows of Wd; K10 whole 64-column boxes (the last one
        // past BN where BN % 64 != 0: its columns are loaded, not used)
        mbar_expect_tx(full, T::kABytes + (kDx ? T::kBBytes : BN * 128));
        tma_load_2d(a_smem + s * T::kABytes, &map_a, full, k0, m0);
        if constexpr (kDx) {  // Wd rows k0 .., whole boxes of 64 columns
#pragma unroll
          for (int j = 0; j < T::kBoxes; ++j)
            tma_load_2d(b_smem + s * T::kBBytes + j * kBoxBytes, &map_b, full, n0 + 64 * j, k0);
        } else {              // Wd rows n0 .. n0 + BN - 1, k0 .. k0 + 63
          tma_load_2d(b_smem + s * T::kBBytes, &map_b, full, k0, n0);
        }
      }
      return;
    }
    // The other producer warps write the factor operands from w1 and w2:
    // builder warp b the slices of steps b, b + NB, ... (a step's loads,
    // stores and fence take longer than a step's MMAs, so NB run at once),
    // and its share of the tile's Monarch factor after its first step.
    const int tid = pt - 32, lane = tid % 32, bw = tid / 32;
    constexpr int NB = T::kProducers - 1;
    uint8_t* const slices = gbase + (f_smem - base);
    uint8_t* const mon = gbase + (e_smem - base);
    // zero what the fast paths leave zero, once: every stage's slice, the
    // Monarch factor
    if (p.fast || p.fast_epi) {
      for (int i = tid; i < S * T::kSBytes / 16; i += T::kBuilders)
        if (p.fast) reinterpret_cast<uint4*>(slices)[i] = make_uint4(0u, 0u, 0u, 0u);
      for (int i = tid; i < T::kEBytes / 16; i += T::kBuilders)
        if (p.fast_epi) reinterpret_cast<uint4*>(mon)[i] = make_uint4(0u, 0u, 0u, 0u);
      fence_proxy_async();  // each thread's zeros, before the MMAs read them
      asm volatile("bar.sync 1, %0;" ::"n"(T::kBuilders) : "memory");
    }
    // the tile's Monarch factor, F2[:, n0 : n0 + BN] as kBoxes MN-major
    // boxes of JK k-rows (K9: W2hat, K10: W1bd^T); K9's fast path: column
    // c = s*L + l holds w2[l, s, r] at row r*L + l, one run of w2 a column
    auto write_monarch = [&]() {
      if (!kDx && p.fast_epi) {
        for (int cl = tid; cl < BN && n0 + cl < p.N; cl += T::kBuilders) {
          const int c = n0 + cl, l = c % p.L;
          const bf16* src = p.w2 + (static_cast<int64_t>(l) * p.S + c / p.L) * p.R;
          uint2 v[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            if (4 * g < p.R) v[g] = __ldg(reinterpret_cast<const uint2*>(src + 4 * g));
          uint8_t* const col = mon + (cl / 64) * (JK * 128) + ((cl % 8) << 1);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            if (4 * g >= p.R) continue;
            const uint32_t h[4] = {v[g].x & 0xffffu, v[g].x >> 16, v[g].y & 0xffffu,
                                   v[g].y >> 16};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = (4 * g + e) * p.L + l;
              *reinterpret_cast<uint16_t*>(col + j * 128 + ((((cl % 64) >> 3) ^ (j & 7)) << 4)) =
                  static_cast<uint16_t>(h[e]);
            }
          }
        }
      } else {
        write_factor<kDx, JK, T::kBuilders, BN>(mon, JK * 128, p, n0, p.N, tid);
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(epi);
    };
    FastSlice<kDx> fs;
    for (int kt = bw; kt < num_k; kt += NB) {
      const int s = kt % S;
      const int k0 = kt * kBK;
      if (p.fast) fs.fetch(p, k0, lane);
      // one lane polls the stage's empty barrier, so that the waiting warp
      // takes no issue slots from the consumers
      if (kt >= S && lane == 0) wait_or_trap(bars + 8 * (S + s), ((kt / S) - 1) & 1);
      __syncwarp();
      // F1[k0 : k0 + 64, :] K-major: row j holds F1[k0 + kk, j] (K9: W1bd,
      // whose rows of W1bd^T are w1's; K10: W2hat^T, W2hat's rows)
      uint8_t* const slice = slices + s * T::kSBytes;
      if (p.fast) {
        fs.store(slice, p, k0, kt, S, lane);
      } else {
        write_factor<!kDx, JK, 32, kBK>(slice, 0, p, k0, p.Kd, lane);
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * s);
      if (kt == bw) write_monarch();
    }
    if (num_k <= bw) write_monarch();
    return;
  }

  // A consumer warpgroup: rows m0 + 64 * wg .. + 63 of the tile.
  float acc[BN / 2];
  float sacc[JK / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < JK / 2; ++i) sacc[i] = 0.f;
  fence_acc(acc);
  fence_acc(sacc);
  const uint32_t a_rows = a_smem + wg * 64 * 128;
  for (int kt = 0; kt < num_k; ++kt) {
    const int s = kt % S;
    wait_or_trap(bars + 8 * s, (kt / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = sw128_desc(a_rows + s * T::kABytes + kk * 32, 16, kAtomBytes);
      if constexpr (kDx) {  // Wd's tile MN-major, as K15's w
        mma_main<BN, 1>(acc, da,
                        sw128_desc(b_smem + s * T::kBBytes + kk * 2048, kBoxBytes, kAtomBytes));
      } else {              // Wd's rows K-major, as the A tile
        mma_main<BN, 0>(acc, da, sw128_desc(b_smem + s * T::kBBytes + kk * 32, 16, kAtomBytes));
      }
      mma_summary<JK>(sacc, da, sw128_desc(f_smem + s * T::kSBytes + kk * 32, 16, kAtomBytes));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous k tile's MMAs are done: release its stage
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(bars + 8 * (S + (kt - 1) % S));
  }
  wgmma_wait<0>();
  fence_acc(acc);
  fence_acc(sacc);

  // The summaries rounded to bf16 are the A fragments of the Monarch term:
  // sacc[8q .. 8q + 7] are rows g, g + 8 at columns 16q + 2t, + 1 and 16q +
  // 8 + 2t, + 1, in the order of the register A fragment of k16 step q.
  uint32_t af[JK / 16][4];
#pragma unroll
  for (int q = 0; q < JK / 16; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) af[q][i] = pack_bf16(sacc[8 * q + 2 * i], sacc[8 * q + 2 * i + 1]);
  wait_or_trap(epi, 0);
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < JK / 16; ++q)  // F2 MN-major: 16 k-rows a step, boxes JK rows apart
    mma_monarch<BN>(acc, af[q], sw128_desc(e_smem + q * 2048, JK * 128, kAtomBytes));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);

  // The fragment: warp w of the warpgroup holds rows 16w + lane/4 and +8;
  // acc[4j .. 4j+3] are columns 8j + 2*(lane%4) and +1 of those two rows.
  const int t = threadIdx.x % 128;
  // every consumer is done with the ring: the warpgroup's 64 rows go to its
  // share of Wd's stages, as BN / 32 boxes
  asm volatile("bar.sync 2, %0;" ::"n"(128 * T::kConsumers) : "memory");
  const uint32_t out = b_smem + wg * (BN / 32) * kOutBox;
  uint8_t* const outp = gbase + (out - base);
  const int r = (t / 32) * 16 + (t % 32) / 4;  // and r + 8: the same swizzle
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    uint8_t* const at = outp + (j / 4) * kOutBox + r * 64 +
                        ((((j % 4) ^ ((r >> 1) & 3)) << 4) | ((t % 4) << 2));
    // round to nearest even, as __float2bfloat16
    *reinterpret_cast<uint32_t*>(at) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(at + 8 * 64) = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;" ::"r"(3 + wg) : "memory");
  if (t == 0) {
    const int rows = m0 + wg * 64;
    if (rows < p.M) {
      for (int b = 0; b < BN / 32 && n0 + 32 * b < p.N; ++b)
        tma_store_2d(&map_y, out + b * kOutBox, n0 + 32 * b, rows);
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // the smem is read
  }
}

// The plan of a bf16 call: 128-row tiles where 128 x 256 ones make at least
// one wave of CTAs, else 64 x 128; JK = J rounded up to a multiple of 16
// (48 to 64).  The 128-row tiles are 256 columns wide at JK = 16, and
// narrower above, so that the BN / 2 fp32 sums and JK / 2 summaries a thread
// stay under the 168 registers ptxas gives 384 threads: 224 at JK = 32 for
// K9 (K-major Wd: whole rows), 192 for K10 (MN-major Wd: whole 64-column
// boxes) and at JK = 64.
struct Plan {
  int bm, bn, jk, stages;
  int64_t row_tiles, col_tiles;
  int threads, smem;
};

template <int BM, int BN, int JK>
void fill(Plan& pl) {
  using T = Tile<BM, BN, JK>;
  pl.bm = BM, pl.bn = BN, pl.jk = JK, pl.stages = T::kStages, pl.threads = T::kThreads;
  pl.smem = T::kSmem;
}

template <bool kDx>
void fill_plan(Plan& pl, bool big, int jk) {
  if (big) {
    if (jk == 16) {
      fill<128, 256, 16>(pl);
    } else if (jk == 32) {
      fill<128, kDx ? 192 : 224, 32>(pl);
    } else {
      fill<128, 192, 64>(pl);
    }
  } else if (jk == 16) {
    fill<64, 128, 16>(pl);
  } else if (jk == 32) {
    fill<64, 128, 32>(pl);
  } else {
    fill<64, 128, 64>(pl);
  }
}

Plan make_plan(bool dx, int64_t M, int64_t n, int64_t m, int J, int num_sms) {
  Plan pl{};
  const int64_t N = dx ? n : m;
  const int jk = J <= 16 ? 16 : J <= 32 ? 32 : 64;
  const bool big = cdiv(M, 128) * cdiv(N, 256) >= num_sms;
  if (dx) {
    fill_plan<true>(pl, big, jk);
  } else {
    fill_plan<false>(pl, big, jk);
  }
  pl.row_tiles = cdiv(M, pl.bm);
  pl.col_tiles = cdiv(N, pl.bn);
  return pl;
}

template <int BM, int BN, int JK, bool kDx>
cudaError_t launch_tile(const CUtensorMap& map_a, const CUtensorMap& map_b,
                        const CUtensorMap& map_y, const Params& p, const Plan& pl,
                        cudaStream_t stream) {
  using T = Tile<BM, BN, JK>;
  auto kernel = fused_kernel<BM, BN, JK, kDx>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(pl.row_tiles), static_cast<unsigned>(pl.col_tiles));
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(map_a, map_b, map_y, p);
  return cudaGetLastError();
}

template <bool kDx>
cudaError_t launch_bf16(const void* a, const void* wd, const void* w1, const void* w2, void* out,
                        const Geom& g, int num_sms, cudaStream_t stream) {
  EncodeTiled encode = nullptr;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const int J = g.K * g.Q;
  const Plan pl = make_plan(kDx, g.M, g.n, g.m, J, num_sms);
  if (pl.row_tiles > 0x7fffffff || pl.col_tiles > 65535) return cudaErrorInvalidValue;
  const int64_t Kd = kDx ? g.m : g.n;
  CUtensorMap map_a, map_b, map_y;
  // A (M, Kd) in (BM x 64) boxes; Wd (m, n): K9 (BN rows x 64 k), K10 (64
  // k-rows x 64); the output (M, N) in (64 x 32) boxes, 64-byte swizzled
  const int64_t N = kDx ? g.n : g.m;
  const bool ok = make_map(encode, &map_a, a, g.M, Kd, pl.bm, kBK) &&
                  make_map(encode, &map_b, wd, g.m, g.n, kDx ? kBK : pl.bn, 64) &&
                  make_map(encode, &map_y, out, g.M, N, 64, 32, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                           2, CU_TENSOR_MAP_SWIZZLE_64B);
  if (!ok) return cudaErrorInvalidValue;
  Params p;
  p.y = static_cast<bf16*>(out);
  p.w1 = static_cast<const bf16*>(w1);
  p.w2 = static_cast<const bf16*>(w2);
  p.M = static_cast<int>(g.M);
  p.N = static_cast<int>(N);
  p.Kd = static_cast<int>(Kd);
  p.K = g.K, p.Q = g.Q, p.P = g.P, p.L = g.L, p.S = g.S, p.R = g.R, p.J = J;
  p.w1_vec = g.P % 8 == 0 && reinterpret_cast<uintptr_t>(w1) % 16 == 0;
  const bool fast =
      kDx ? 64 % g.L == 0 && g.R % 4 == 0 && g.R <= 16 && reinterpret_cast<uintptr_t>(w2) % 8 == 0
          : g.P % 64 == 0 && g.Q <= 16 && reinterpret_cast<uintptr_t>(w1) % 16 == 0;
  p.fast = fast;
  p.fast_epi = !kDx && g.R % 4 == 0 && g.R <= 16 && reinterpret_cast<uintptr_t>(w2) % 8 == 0;
  switch (pl.bn * 1000 + pl.jk) {
    case 256016: return launch_tile<128, 256, 16, kDx>(map_a, map_b, map_y, p, pl, stream);
    case (kDx ? 192032 : 224032):
      return launch_tile<128, kDx ? 192 : 224, 32, kDx>(map_a, map_b, map_y, p, pl, stream);
    case 192064: return launch_tile<128, 192, 64, kDx>(map_a, map_b, map_y, p, pl, stream);
    case 128016: return launch_tile<64, 128, 16, kDx>(map_a, map_b, map_y, p, pl, stream);
    case 128032: return launch_tile<64, 128, 32, kDx>(map_a, map_b, map_y, p, pl, stream);
    case 128064: return launch_tile<64, 128, 64, kDx>(map_a, map_b, map_y, p, pl, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The plan of a bf16 call on `device`: (bm, bn, jk, stages, row tiles,
// column tiles, threads, shared memory bytes) into plan[0 .. 7].  dx 0: K9
// (the output m wide), 1: K10 (n wide).
extern "C" int smft_more_linear_plan(int device, int dx, int64_t M, int64_t n, int64_t m, int J,
                                     int64_t* plan) {
  int num_sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (J < 1 || J > kMaxJ) return cudaErrorInvalidValue;
  const Plan pl = make_plan(dx != 0, M, n, m, J, num_sms);
  const int64_t fields[8] = {pl.bm, pl.bn, pl.jk, pl.stages, pl.row_tiles, pl.col_tiles,
                             pl.threads, pl.smem};
  for (int i = 0; i < 8; ++i) plan[i] = fields[i];
  return cudaSuccess;
}

// dtype: 0 = float32, 1 = bfloat16.  dx: 0 for K9 (a = x (M, n), out = y
// (M, m)), 1 for K10 (a = dout (M, m), out = dx (M, n)).  wd (m, n), w1
// (K, Q, P), w2 (L, S, R), all of that dtype, contiguous on `device`; a and
// wd start on 16 bytes; n % 8 == 0, m % 8 == 0, K*P == n, S*L == m,
// L*R == K*Q <= 64: the binding checks.  work: M*K*Q fp32 (the row
// summaries) for float32, unused (may be null) for bfloat16.  Returns the
// cudaError_t of the launches (one for bfloat16, two for float32).
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
    const auto* at = static_cast<const float*>(a);
    const auto* wdt = static_cast<const float*>(wd);
    const auto* w1t = static_cast<const float*>(w1);
    const auto* w2t = static_cast<const float*>(w2);
    auto* o = static_cast<float*>(out);
    return dx ? launch_f32<true>(at, wdt, w1t, w2t, o, work, g, s)
              : launch_f32<false>(at, wdt, w1t, w2t, o, work, g, s);
  }
  if (dtype == 1) {
    if (M > 0x7fffffff) return cudaErrorInvalidValue;
    int num_sms = 0;
    err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    return dx ? launch_bf16<true>(a, wd, w1, w2, out, g, num_sms, s)
              : launch_bf16<false>(a, wd, w1, w2, out, g, num_sms, s);
  }
  return cudaErrorInvalidValue;
}
