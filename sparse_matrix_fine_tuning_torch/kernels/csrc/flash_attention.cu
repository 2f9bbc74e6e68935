// Causal flash attention for the splash-attention path, for Hopper, sm_90a:
// the forward (K17), dq (K18) and dk/dv (K19).
//
// Replaces the three Pallas TPU kernels that `_splash_attention` of
// sparse_matrix_fine_tuning_tpu/models/llama.py:57 runs through JAX's splash
// attention (jax/experimental/pallas/ops/tpu/splash_attention/
// splash_attention_kernel.py): `flash_attention_kernel` (the forward, with
// the logsumexp saved for the backward), `_flash_attention_dq_kernel` and
// `_flash_attention_dkv_kernel`.  Written from the math, not block by block:
//
//   q, k, v, dout (B, T, H, D), q already scaled by 1/sqrt(D); causal mask
//   s[t, u]  = sum_d q[t, d] k[u, d]                         (fp32, u <= t)
//   lse[t]   = log(sum_u exp(s[t, u] - m[t])) + m[t],  m[t] = max_u s[t, u]
//   o[t]     = round_T( (sum_u exp(s[t, u] - m[t]) v[u]) * (1 / l[t]) )
//   p[t, u]  = exp(s[t, u] - lse[t])
//   dp[t, u] = sum_d dout[t, d] v[u, d],   ds = p (dp - di[t])
//   dq[t]    = round_T( sum_u round_T(ds[t, u]) k[u] )                       K18
//   dv[u]    = round_T( sum_t round_T(p[t, u]) dout[t] )                     K19
//   dk[u]    = round_T( sum_t round_T(ds[t, u]) q[t] )                       K19
//
// di[t] = sum_d o[t, d] dout[t, d] in fp32 comes in from the caller, as the
// JAX backward computes it outside its kernels.  T (the tensors' dtype) is
// float32 or bfloat16; every sum is fp32.  The forward in bf16 rounds P to
// bf16 for the tensor cores' P.V (the TPU kernel keeps P in fp32 and casts v
// to fp32), the one place where the arithmetic differs; f32 keeps P in fp32.
//
// What bounds it: in bf16 the tensor cores at long T; at the training
// micro-batch (T = 512, D = 64) the bytes.  A 128-row tile of q does
// 4 * 128 * D multiply-adds for every 128 x D tile of k and v it reads, far
// past the card's ~295 operations a byte, so q (k and v in K19) stays in
// shared memory while the other operands stream through a ring, and the
// T x T scores never leave the registers.
//
// Design, bf16 (after FlashAttention-3): all three kernels are persistent:
//   one CTA an SM walks its work items, longest first (ws_item; K18 in
//   units of equal work, dq_unit); a producer warp issues TMA loads into a
//   ring of stages and runs on from one item into the next; two consumer
//   warpgroups of 64 rows each multiply on the tensor cores through wgmma
//   (S and dP from shared memory; P.V, dV, dK and dQ with the bf16
//   probabilities or dS as register A fragments).
//   K17: an item is (batch * head, 128-row q tile); per kv tile S_j is
//        issued before P_{j-1}.V_{j-1}, and the softmax of S_j runs while
//        P.V does; the two warpgroups take turns to issue, so that one's
//        softmax overlaps the other's products; the next item's q tile
//        loads while this one runs; only the diagonal tiles are masked; o
//        leaves by TMA store.
//   K18: an item is (batch * head, 128-row q tile), as K17's, taken in
//        units of a head's longest and shortest q tile, head by head (so
//        that the CTAs that run at once share k and v in L2); q, dout, lse
//        and di for the item (the next item's while this one runs), k and
//        v through the ring in 64-row tiles; per kv tile S_j is issued
//        with dS_{j-1} k_{j-1}, the exponentials of tile j run while the
//        latter does, then dP_j; only the diagonal tile is masked; dq
//        leaves by TMA store from the item's dout tile, which no product
//        reads any more.
//   K19: an item is (batch * head, 128-row kv tile), k and v resident
//        (at D = 64 the next item's load beside them); q, dout, lse and di
//        stream a 64-row step at a time; S^T, dP^T, then dV += P^T dout and
//        dK += dS^T q, masked without branches; a warpgroup skips the steps
//        wholly before its rows; dk and dv leave by TMA store.
// K18 and K19 stay separate, as the splash kernels do: no atomics, so every
// gradient is deterministic.
// f32 (the checks' path) runs on FMA: 32-row tiles, 8 threads a row.
//
// D must be 64 or 128; any T is taken, ragged against every tile: rows past
// T load as zeros (TMA's zero fill, or the f32 kernels' own), add nothing to
// any sum that is stored, and are never stored.  The kernels need 16-byte aligned, contiguous
// (B, T, H, D) tensors and contiguous fp32 (B, H, T) lse and di (ops.cpp
// checks).

#include <cuda.h>  // CUtensorMap and its enums: types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace smft_hopper;
using bf16 = __nv_bfloat16;

constexpr int kF32Threads = 256;
constexpr int kF32Tile = 32;    // f32: the rows a CTA owns and the tile it walks

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* o;       // K17: o; K18: dq; K19: dk
  void* o2;      // K19: dv
  float* lse;    // K17 writes it, K18/K19 read it: (B, H, T)
  const float* di;  // (B, H, T)
  int T;
  int H;
};

// -- PTX helpers --------------------------------------------------------------

// Two fp32 values rounded to a bf16x2 register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Head {
  int64_t base;    // element offset of (batch, head, row 0, 0)
  int64_t stride;  // elements between rows: H * D
  int64_t lse;     // offset of (batch, head) in lse and di
};

template <int D>
__device__ __forceinline__ Head head_of(const Params& p) {
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  return {(static_cast<int64_t>(b) * p.T * p.H + h) * D, static_cast<int64_t>(p.H) * D,
          static_cast<int64_t>(bh) * p.T};
}

// -- f32 (FMA) ------------------------------------------------------------------
// A CTA owns 32 rows; thread (r, c) = (tid / 8, tid % 8) owns row r and the
// columns c, c + 8, ... of the 32-column score tile and of the D-wide
// output.  Arrays a thread reads by its own row have row stride D + 4 (the
// warp's 4 rows on distinct banks), arrays read by column D + 1.

// ROWS x D rows from row0 into shared memory at row stride LDS; zeros past T.
template <int D>
__device__ __forceinline__ void load_f32(float* dst, int lds, const float* src, int row0, int T,
                                         int64_t stride) {
  for (int c = threadIdx.x; c < kF32Tile * D; c += kF32Threads) {
    const int r = c / D, d = c % D, row = row0 + r;
    dst[r * lds + d] = row < T ? src[row * stride + d] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot_f32(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

constexpr int kPS = kF32Tile + 1;  // row stride of the 32 x 32 score tiles

// K17, f32.
template <int D>
__global__ void __launch_bounds__(kF32Threads) fwd_f32_kernel(const Params p) {
  constexpr int LR = D + 4, LC = D + 1;
  extern __shared__ float fsm[];
  float* sQ = fsm;                  // [32][LR]
  float* sK = sQ + kF32Tile * LR;   // [32][LC]
  float* sV = sK + kF32Tile * LC;   // [32][D]
  float* sP = sV + kF32Tile * D;    // [32][kPS]
  const Head hd = head_of<D>(p);
  const float* q = static_cast<const float*>(p.q) + hd.base;
  const float* k = static_cast<const float*>(p.k) + hd.base;
  const float* v = static_cast<const float*>(p.v) + hd.base;
  const int T = p.T, qt = gridDim.y - 1 - blockIdx.y, r = threadIdx.x >> 3, c = threadIdx.x & 7;
  const int row = qt * kF32Tile + r;
  load_f32<D>(sQ, LR, q, qt * kF32Tile, T, hd.stride);
  float acc[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j <= qt; ++j) {
    __syncthreads();
    load_f32<D>(sK, LC, k, j * kF32Tile, T, hd.stride);
    load_f32<D>(sV, D, v, j * kF32Tile, T, hd.stride);
    __syncthreads();
    float s[4], mx = m;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = c + 8 * i;
      s[i] = j * kF32Tile + col > row ? -INFINITY : dot_f32<D>(sQ + r * LR, sK + col * LC);
      mx = fmaxf(mx, s[i]);
    }
    mx = row_max8(mx);
    const float alpha = expf(m - mx);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = expf(s[i] - mx);
      sum += s[i];
      sP[r * kPS + c + 8 * i] = s[i];
    }
    l = l * alpha + row_sum8(sum);
    __syncwarp();
#pragma unroll 4
    for (int i = 0; i < D / 8; ++i) {
      float o = acc[i] * alpha;
      for (int u = 0; u < kF32Tile; ++u) o = fmaf(sP[r * kPS + u], sV[u * D + c + 8 * i], o);
      acc[i] = o;
    }
  }
  if (row < T) {
    float* out = static_cast<float*>(p.o) + hd.base + row * hd.stride;
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) out[c + 8 * i] = acc[i] * inv;
    if (c == 0) p.lse[hd.lse + row] = logf(l) + m;
  }
}

// K18, f32.
template <int D>
__global__ void __launch_bounds__(kF32Threads) dq_f32_kernel(const Params p) {
  constexpr int LR = D + 4, LC = D + 1;
  extern __shared__ float fsm[];
  float* sQ = fsm;                  // [32][LR]
  float* sO = sQ + kF32Tile * LR;   // dout [32][LR]
  float* sK = sO + kF32Tile * LR;   // [32][LC]
  float* sV = sK + kF32Tile * LC;   // [32][LC]
  float* sS = sV + kF32Tile * LC;   // ds [32][kPS]
  const Head hd = head_of<D>(p);
  const float* q = static_cast<const float*>(p.q) + hd.base;
  const float* k = static_cast<const float*>(p.k) + hd.base;
  const float* v = static_cast<const float*>(p.v) + hd.base;
  const float* dout = static_cast<const float*>(p.dout) + hd.base;
  const int T = p.T, qt = gridDim.y - 1 - blockIdx.y, r = threadIdx.x >> 3, c = threadIdx.x & 7;
  const int row = qt * kF32Tile + r;
  load_f32<D>(sQ, LR, q, qt * kF32Tile, T, hd.stride);
  load_f32<D>(sO, LR, dout, qt * kF32Tile, T, hd.stride);
  const float lse = row < T ? p.lse[hd.lse + row] : 0.f;
  const float di = row < T ? p.di[hd.lse + row] : 0.f;
  float acc[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i] = 0.f;
  for (int j = 0; j <= qt; ++j) {
    __syncthreads();
    load_f32<D>(sK, LC, k, j * kF32Tile, T, hd.stride);
    load_f32<D>(sV, LC, v, j * kF32Tile, T, hd.stride);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = c + 8 * i;
      float ds = 0.f;
      if (j * kF32Tile + col <= row) {
        const float pv = expf(dot_f32<D>(sQ + r * LR, sK + col * LC) - lse);
        ds = pv * (dot_f32<D>(sO + r * LR, sV + col * LC) - di);
      }
      sS[r * kPS + col] = ds;
    }
    __syncwarp();
#pragma unroll 4
    for (int i = 0; i < D / 8; ++i) {
      float a = acc[i];
      for (int u = 0; u < kF32Tile; ++u) a = fmaf(sS[r * kPS + u], sK[u * LC + c + 8 * i], a);
      acc[i] = a;
    }
  }
  if (row < T) {
    float* out = static_cast<float*>(p.o) + hd.base + row * hd.stride;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) out[c + 8 * i] = acc[i];
  }
}

// K19, f32.  grid (B * H, kv tiles), kv tile 0 first.
template <int D>
__global__ void __launch_bounds__(kF32Threads) dkv_f32_kernel(const Params p) {
  constexpr int LR = D + 4, LC = D + 1;
  extern __shared__ float fsm[];
  float* sK = fsm;                   // [32][LR]
  float* sV = sK + kF32Tile * LR;    // [32][LR]
  float* sQ = sV + kF32Tile * LR;    // [32][LC]
  float* sO = sQ + kF32Tile * LC;    // dout [32][LC]
  float* sP = sO + kF32Tile * LC;    // p^T [32][kPS]
  float* sS = sP + kF32Tile * kPS;   // ds^T [32][kPS]
  float* sL = sS + kF32Tile * kPS;   // [32]
  float* sDi = sL + kF32Tile;        // [32]
  const Head hd = head_of<D>(p);
  const float* q = static_cast<const float*>(p.q) + hd.base;
  const float* k = static_cast<const float*>(p.k) + hd.base;
  const float* v = static_cast<const float*>(p.v) + hd.base;
  const float* dout = static_cast<const float*>(p.dout) + hd.base;
  const int T = p.T, kt = blockIdx.y, r = threadIdx.x >> 3, c = threadIdx.x & 7;
  const int row = kt * kF32Tile + r;  // this thread's kv row
  const int nq = (T + kF32Tile - 1) / kF32Tile;
  load_f32<D>(sK, LR, k, kt * kF32Tile, T, hd.stride);
  load_f32<D>(sV, LR, v, kt * kF32Tile, T, hd.stride);
  float dk[D / 8], dv[D / 8];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dk[i] = dv[i] = 0.f;
  for (int i = kt; i < nq; ++i) {
    __syncthreads();
    load_f32<D>(sQ, LC, q, i * kF32Tile, T, hd.stride);
    load_f32<D>(sO, LC, dout, i * kF32Tile, T, hd.stride);
    if (threadIdx.x < kF32Tile) {
      const int qrow = i * kF32Tile + threadIdx.x;
      sL[threadIdx.x] = qrow < T ? p.lse[hd.lse + qrow] : 0.f;
      sDi[threadIdx.x] = qrow < T ? p.di[hd.lse + qrow] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = c + 8 * n, qrow = i * kF32Tile + col;
      float pv = 0.f, ds = 0.f;
      if (qrow >= row && qrow < T) {
        pv = expf(dot_f32<D>(sK + r * LR, sQ + col * LC) - sL[col]);
        ds = pv * (dot_f32<D>(sV + r * LR, sO + col * LC) - sDi[col]);
      }
      sP[r * kPS + col] = pv;
      sS[r * kPS + col] = ds;
    }
    __syncwarp();
#pragma unroll 4
    for (int n = 0; n < D / 8; ++n) {
      float a = dv[n], b = dk[n];
      for (int u = 0; u < kF32Tile; ++u) {
        a = fmaf(sP[r * kPS + u], sO[u * LC + c + 8 * n], a);
        b = fmaf(sS[r * kPS + u], sQ[u * LC + c + 8 * n], b);
      }
      dv[n] = a;
      dk[n] = b;
    }
  }
  if (row < T) {
    float* out_k = static_cast<float*>(p.o) + hd.base + row * hd.stride;
    float* out_v = static_cast<float*>(p.o2) + hd.base + row * hd.stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      out_k[c + 8 * n] = dk[n];
      out_v[c + 8 * n] = dv[n];
    }
  }
}

// -- bf16 K17-K19 on Hopper: TMA, wgmma, a producer warp ------------------------
// Two consumer warpgroups (threads 0-255), each owning 64 rows of a 128-row
// tile, and one producer warp (threads 256-287) whose lane 0 issues every TMA
// load.  ptxas compiles every role at 168 registers a thread (the launch
// bound of 288 threads, one CTA an SM, rounds to warpgroups); a producer
// warpgroup that gives its registers up to the consumers (setmaxnreg) did
// not lift that bound (its SASS held USETMAXREG, its spills stayed), so the
// tiles are sized to fit it: K17 walks kv tiles of 128 rows at D = 64 and
// 64 at D = 128 (S and P in registers beside o), K18 kv tiles of 64 rows
// (S, dP and the last tile's dS beside dq), and K19 at D = 128 takes two
// passes over q, dv then dk (one sum of 64 x 128 fp32 beside S and dP).
//
// Layouts: a tile of (B, T, H, D) rows is D / 64 boxes of (rows x 64
// columns), 128-byte rows, 128-byte swizzled, box after box.  A K-major
// operand (q, k or v over D; dout over D for K18's dP; q or dout over D for
// K19's S^T and dP^T) steps
// 32 bytes a k16 inside the box's rows and a box every 4 k16 steps, 8-row
// groups 1024 bytes apart (SBO).  An MN-major operand (v for P.V; k for
// dS.k; dout and q for dV and dK, k along their rows) steps 16 rows (2048
// bytes) a k16, its
// 64-column boxes LBO apart.  TMA reads a (B, T, H, D) tensor through a 4-D
// map (D, H, T, B): rows past T come in as zeros per (batch, head), and the
// epilogues' TMA stores drop them.

constexpr int kWsConsumers = 2;                      // warpgroups of 64 rows
constexpr int kWsThreads = kWsConsumers * 128 + 32;  // + the producer warp
constexpr int kWsTile = kWsConsumers * 64;  // rows a tile: K17's and K18's q tile, K19's kv tile
constexpr int kAtomBytes = 1024;            // the 128-byte swizzle's period
constexpr int kSmemLimit = 232448;          // shared memory a CTA may take (227 KB)

__host__ __device__ constexpr int round_up(int x, int a) { return (x + a - 1) / a * a; }

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special function unit (ex2.approx: 2 ulp; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// K17's kv tile rows and K19's passes over q (2: dv, then dk) at head dim
// D; K18's kv tile rows and K19's q step rows.
__host__ __device__ constexpr int fwd_kv_rows(int D) { return D == 64 ? 128 : 64; }
__host__ __device__ constexpr int dkv_passes(int D) { return D == 64 ? 1 : 2; }
constexpr int kDqRows = 64;
constexpr int kDkvRows = 64;

// A launch's work: items (batch * head, 128-row tile) taken longest first.
// K17's and K18's item (bh, q tile qt) walks the kv tiles up to its
// diagonal; K19's (bh, kv tile kt) walks the q steps from the first that
// reaches kt's rows to the last (twice at D = 128).
struct WsSched {
  int bh;     // B * H
  int tiles;  // 128-row tiles of T
  int items;  // K17, K19: bh * tiles; K18: bh * dq_units(tiles)
  int steps;  // K17, K18: kv tiles of T; K19: q steps of T
};

// Item w of a launch: rank r = w / bh of the tiles by length, head w % bh.
// K17 and K18 (`last_first`) take the last q tile (the most kv tiles)
// first, K19 kv tile 0 (the most q steps).  CTA c takes items c, c + ctas,
// ...: each CTA's items never grow longer.
__host__ __device__ inline void ws_item(const WsSched& s, bool last_first, int w, int& bh,
                                        int& tile) {
  const int rank = w / s.bh;
  bh = w - rank * s.bh;
  tile = last_first ? s.tiles - 1 - rank : rank;
}

// K17's or K18's kv tiles (of `rows` rows) of q tile qt: those up to its
// diagonal, none past T.
__host__ __device__ inline int q_kv_tiles(const WsSched& s, int qt, int rows) {
  const int n = (qt + 1) * kWsTile / rows;
  return n < s.steps ? n : s.steps;
}

struct WsArgs {
  WsSched s;
  int T, H;
  float* lse;       // (B, H, T): K17 writes it, K18 and K19 read it
  const float* di;  // (B, H, T): K18 and K19 read it
};

// A consumer warpgroup's named barrier (1 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// K17's two consumer warpgroups take turns to issue their wgmmas (named
// barriers 3 + wg): warpgroup wg waits for its turn, issues, and hands the
// turn on, so that one's softmax runs while the other's products do.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(3 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(4 - wg) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// The k16 steps' A fragments of the 64 x (16 N) fp32 accumulator `s`,
// rounded to bf16: step kk from s's 8-column groups 2 kk and 2 kk + 1.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N][4], const float (&s)[8 * N]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// d (64 x N) += A B over one k16: A K-major at `da`, B K-major at `db`.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 128) {
    wgmma_m64n128k16<0>(d, da, db);
  } else {
    static_assert(N == 64, "N");
    wgmma_m64n64k16<0>(d, da, db);
  }
}

// d (64 x N) += A B over one k16: A from registers, B MN-major at `db`.
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 128) {
    wgmma_m64n128k16_rs<1>(d, a, db);
  } else {
    static_assert(N == 64, "N");
    wgmma_m64n64k16_rs<1>(d, a, db);
  }
}

// K-major descriptor of k16 step kk of a tile of `rows` rows at `tile`
// (its D / 64 boxes rows * 128 bytes apart), from row `row0` on.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row0, int kk) {
  return sw128_desc(tile + (kk / 4) * rows * 128 + row0 * 128 + (kk % 4) * 32, 16, kAtomBytes);
}

// MN-major descriptor of k16 step kk (rows 16 kk ..) of a tile of `rows`
// rows at `tile`, N along its D columns.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  return sw128_desc(tile + kk * 2048, rows * 128, kAtomBytes);
}

// kmajor and mnmajor of step kk as their step 0's descriptor plus the
// step's offset (the start address field counts 16 bytes and a tile lies
// below 256 KB: no carry), so that a loop keeps one base and not a
// descriptor a step in registers.
__device__ __forceinline__ uint64_t kmajor_step(uint64_t d0, int rows, int kk) {
  return d0 + static_cast<uint64_t>(((kk / 4) * rows * 128 + (kk % 4) * 32) >> 4);
}

__device__ __forceinline__ uint64_t mnmajor_step(uint64_t d0, int kk) {
  return d0 + static_cast<uint64_t>(kk * 2048 >> 4);
}

// Writes a warpgroup's 64 x D fp32 accumulator, times scale[row half], as
// bf16 into `stage`: D / 64 boxes of 64 x 64 (kBoxBytes apart: 8192, or
// 16384 where the rows are half of a 128-row tile's boxes), 128-byte
// swizzled (a TMA store's source).  Thread t holds rows r and r + 8, r = 16
// (t / 32) + (t % 32) / 4; acc[4 j ..] are columns 8 j + 2 (t % 4), + 1 of
// them.
template <int D, int kBoxBytes = 8192>
__device__ __forceinline__ void stage_rows(uint8_t* stage, const float (&acc)[D / 2], int t,
                                           const float (&scale)[2]) {
  const int r = (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    uint8_t* const at =
        stage + (j / 8) * kBoxBytes + r * 128 + ((((j % 8) ^ (r & 7)) << 4) | ((t % 4) << 2));
    *reinterpret_cast<uint32_t*>(at) = pack_bf16(acc[4 * j] * scale[0], acc[4 * j + 1] * scale[0]);
    *reinterpret_cast<uint32_t*>(at + 8 * 128) =
        pack_bf16(acc[4 * j + 2] * scale[1], acc[4 * j + 3] * scale[1]);
  }
}

// K17's shared memory: two q tiles (128 rows; item n in q tile n % 2, so
// that the next item's q loads while this one runs), kStages stages of k and
// v (kBc rows each), the epilogue's staging of o (128 rows), then the
// barriers q_full[2], q_empty[2], k_full[S], v_full[S], kv_empty[S].
template <int D>
struct FwdWs {
  static constexpr int kBc = fwd_kv_rows(D);
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kWsTile * D * 2;  // a q tile, and o's staging
  static constexpr int kKvBytes = kBc * D * 2;     // k or v a stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + 2 * kQBytes;  // stage st: k at kK + 2 st kKvBytes, v after it
  static constexpr int kO = kK + 2 * kStages * kKvBytes;
  static constexpr int kBars = kO + kQBytes;
  static constexpr int kSmem = kBars + 8 * (4 + 3 * kStages) + kAtomBytes;
  static_assert(kSmem <= kSmemLimit, "K17's tiles must fit in 227 KB");
};

// K17, bf16: persistent, items longest first (ws_item).  The producer loads
// an item's q tile (into the q tile the item before last used), then its
// kv tiles through the ring, and runs on into the next item as stages
// free.  A consumer warpgroup, per kv tile j, in its turn: issues S_j = q
// k_j^T (wgmma, both from shared memory), then P_{j-1} v_{j-1} (wgmma, P
// the bf16 A fragments in registers), and hands the turn on; then takes the
// online softmax of S_j while P.V runs, and rescales o once P.V is done.
// Only the tiles that reach past the warpgroup's first row are masked, and
// it walks only the tiles up to its last row's diagonal.  The epilogue
// scales o by 1 / l and stores it by TMA from a staging of its own; lse by
// plain stores.
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_o, const WsArgs a) {
  using C = FwdWs<D>;
  constexpr int S = C::kStages, kBc = C::kBc, kBoxes = D / 64, kSteps = kBc / 16;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtomBytes - 1) & ~static_cast<uint32_t>(kAtomBytes - 1);
  const uint32_t q_full = base + C::kBars, q_empty = q_full + 16, k_full = q_full + 32;
  const uint32_t v_full = k_full + 8 * S, kv_empty = v_full + 8 * S;
  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full + 8 * qb, 1);
      mbar_init(q_empty + 8 * qb, kWsConsumers);
    }
    for (int st = 0; st < S; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, kWsConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kWsConsumers) {  // the producer warp: lane 0 issues every load
    if (threadIdx.x != kWsConsumers * 128) return;
    uint32_t it = 0, n = 0;
    for (int w = blockIdx.x; w < a.s.items; w += gridDim.x, ++n) {
      int bh, qt;
      ws_item(a.s, true, w, bh, qt);
      const int b = bh / a.H, h = bh - b * a.H, nkv = q_kv_tiles(a.s, qt, kBc);
      const uint32_t qf = q_full + 8 * (n % 2), qs = base + C::kQ + (n % 2) * C::kQBytes;
      if (n >= 2) wait_or_trap(q_empty + 8 * (n % 2), ((n / 2) - 1) & 1);
      mbar_expect_tx(qf, C::kQBytes);
#pragma unroll
      for (int x = 0; x < kBoxes; ++x)
        tma_load_4d(qs + x * kWsTile * 128, &map_q, qf, 64 * x, h, qt * kWsTile, b);
      for (int j = 0; j < nkv; ++j, ++it) {
        const int st = it % S;
        if (it >= S) wait_or_trap(kv_empty + 8 * st, ((it / S) - 1) & 1);
        const uint32_t ks = base + C::kK + 2 * st * C::kKvBytes, vs = ks + C::kKvBytes;
        mbar_expect_tx(k_full + 8 * st, C::kKvBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tma_load_4d(ks + x * kBc * 128, &map_k, k_full + 8 * st, 64 * x, h, j * kBc, b);
        mbar_expect_tx(v_full + 8 * st, C::kKvBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x)
          tma_load_4d(vs + x * kBc * 128, &map_v, v_full + 8 * st, 64 * x, h, j * kBc, b);
      }
    }
    return;
  }

  // A consumer warpgroup: rows 64 wg .. + 63 of each q tile; thread t holds
  // rows r and r + 8 of them and, in each 8-column group of S, columns
  // 2 (t % 4) and + 1.
  const int t = threadIdx.x % 128;
  const int r = (t / 32) * 16 + (t % 32) / 4, cq = 2 * (t % 4);
  const uint32_t stage = base + C::kO + wg * (C::kQBytes / 2);
  uint8_t* const stagep = smem_raw + (stage - raw);
  if (wg == 1) turn_pass(wg);  // warpgroup 0 takes the first turn
  uint32_t it = 0, n = 0;
  for (int w = blockIdx.x; w < a.s.items; w += gridDim.x, ++n) {
    int bh, qt;
    ws_item(a.s, true, w, bh, qt);
    const int b = bh / a.H, h = bh - b * a.H, nkv = q_kv_tiles(a.s, qt, kBc);
    const int row0 = qt * kWsTile + 64 * wg;  // the warpgroup's first q row
    const uint32_t qs = base + C::kQ + (n % 2) * C::kQBytes, qe = q_empty + 8 * (n % 2);
    float o[D / 2], s[kBc / 2];
    uint32_t p[kSteps][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

    // S_j = q k_j^T into s (zeroed first)
    auto issue_qk = [&](uint32_t ks) {
#pragma unroll
      for (int i = 0; i < kBc / 2; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<kBc>(s, kmajor(qs, kWsTile, 64 * wg, kk), kmajor(ks, kBc, 0, kk));
      wgmma_commit();
    };
    // kv tile j's keys after the query masked, where it reaches past the
    // warpgroup's first row
    auto mask = [&](int j) {
      if (j * kBc + kBc - 1 <= row0) return;
#pragma unroll
      for (int jj = 0; jj < kBc / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * kBc + 8 * jj + cq + (e & 1) > row0 + r + 8 * (e >> 1)) s[4 * jj + e] = -INFINITY;
    };
    // The online softmax of s: the new row maxima, alpha = exp(m_old - m),
    // s = exp(s - m), l = l alpha + the thread's sums; exp(x - m) as
    // 2^(x log2 e - m log2 e), one fused multiply-add and the unit's ex2.
    // Every row has a finite score in kv tile 0 (key 0), so m is finite
    // from the first tile on (a later tile wholly masked leaves it, alpha =
    // 1) and alpha = exp(-inf) = 0 there.
    auto softmax = [&]() {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = m[rr];
#pragma unroll
        for (int jj = 0; jj < kBc / 8; ++jj)
          mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * rr], s[4 * jj + 2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[rr] = ex2((m[rr] - mx) * kLog2e);
        m[rr] = mx;
        const float ml = mx * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < kBc / 8; ++jj) {
          s[4 * jj + 2 * rr] = ex2(fmaf(s[4 * jj + 2 * rr], kLog2e, -ml));
          s[4 * jj + 2 * rr + 1] = ex2(fmaf(s[4 * jj + 2 * rr + 1], kLog2e, -ml));
          sum += s[4 * jj + 2 * rr] + s[4 * jj + 2 * rr + 1];
        }
        l[rr] = l[rr] * alpha[rr] + sum;
      }
    };
    auto issue_pv = [&](uint32_t vs) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) mma_rs<D>(o, p[kk], mnmajor(vs, kBc, kk));
      wgmma_commit();
    };
    auto kv_stage = [&](uint32_t i) { return base + C::kK + 2 * (i % S) * C::kKvBytes; };

    // the warpgroup's kv tiles: those up to its last row's diagonal; the
    // item's tiles after them (at kBc = 64, the one past the first 64 rows'
    // diagonal) it only releases
    const int last_j = (row0 + 63) / kBc < nkv - 1 ? (row0 + 63) / kBc : nkv - 1;
    wait_or_trap(q_full + 8 * (n % 2), (n / 2) & 1);
    wait_or_trap(k_full + 8 * (it % S), (it / S) & 1);
    turn_wait(wg);
    issue_qk(kv_stage(it));
    turn_pass(wg);
    wgmma_wait<0>();
    fence_acc(s);
    if (last_j == 0 && t == 0) mbar_arrive(qe);  // this warpgroup's last read of q
    mask(0);
    softmax();
    pack_a<kSteps>(p, s);
    for (int j = 1; j <= last_j; ++j) {
      const uint32_t cur = it + j, prev = cur - 1;
      wait_or_trap(k_full + 8 * (cur % S), (cur / S) & 1);
      wait_or_trap(v_full + 8 * (prev % S), (prev / S) & 1);
      turn_wait(wg);
      issue_qk(kv_stage(cur));
      issue_pv(kv_stage(prev) + C::kKvBytes);
      turn_pass(wg);
      wgmma_wait<1>();  // S_j is done; P_{j-1} v_{j-1} may run on
      fence_acc(s);
      if (j == last_j && t == 0) mbar_arrive(qe);
      mask(j);
      softmax();
      wgmma_wait<0>();
      fence_acc(o);
      fence_regs(p);
      if (t == 0) mbar_arrive(kv_empty + 8 * (prev % S));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_a<kSteps>(p, s);
    }
    {
      const uint32_t last = it + last_j;
      wait_or_trap(v_full + 8 * (last % S), (last / S) & 1);
      issue_pv(kv_stage(last) + C::kKvBytes);
      wgmma_wait<0>();
      fence_acc(o);
      fence_regs(p);
      if (t == 0) mbar_arrive(kv_empty + 8 * (last % S));
    }
    for (int j = last_j + 1; j < nkv; ++j) {  // tiles wholly after this warpgroup's rows
      const uint32_t cur = it + j;
      wait_or_trap(k_full + 8 * (cur % S), (cur / S) & 1);
      wait_or_trap(v_full + 8 * (cur % S), (cur / S) & 1);
      if (t == 0) mbar_arrive(kv_empty + 8 * (cur % S));
      turn_wait(wg);  // a turn a tile, as the other warpgroup takes
      turn_pass(wg);
    }
    it += nkv;

    // The epilogue: lse, then o / l through the staging by TMA.
    float inv[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
      inv[rr] = 1.f / l[rr];
      const int row = row0 + r + 8 * rr;
      if (t % 4 == 0 && row < a.T)
        a.lse[static_cast<int64_t>(bh) * a.T + row] = logf(l[rr]) + m[rr];
    }
    if (t == 0) tma_store_wait_read();  // the staging's last stores have read it
    warpgroup_sync(wg);
    stage_rows<D>(stagep, o, t, inv);
    fence_proxy_async();
    warpgroup_sync(wg);
    if (t == 0 && row0 < a.T) {
#pragma unroll
      for (int x = 0; x < kBoxes; ++x) tma_store_4d(&map_o, stage + x * 8192, 64 * x, h, row0, b);
      tma_store_commit();
    }
  }
  if (t == 0) tma_store_wait_read();  // the staging is read before the CTA leaves
}

// K18's shared memory: two item buffers (item n in buffer n % 2, so that
// the next item's loads while this one runs), each a q tile and a dout
// tile (128 rows; the dout tile then stages dq for its TMA store) and the
// tile's lse and di rows (fp32); kStages stages of k and v (kBc rows each);
// then the barriers q_full[2], q_empty[2], kv_full[S], kv_empty[S].
template <int D>
struct DqWs {
  static constexpr int kBc = kDqRows;
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr int kQBytes = kWsTile * D * 2;  // a q or dout tile
  static constexpr int kKvBytes = kBc * D * 2;     // k or v a stage
  static constexpr int kItem = 2 * kQBytes + 2 * kWsTile * 4;  // q, dout, lse, di
  static constexpr int kQ = 0;          // buffer qb at kQ + qb kItem: q, dout after it
  static constexpr int kK = kQ + 2 * kItem;  // stage st: k at kK + 2 st kKvBytes, v after it
  static constexpr int kBars = kK + 2 * kStages * kKvBytes;
  static constexpr int kSmem = kBars + 8 * (4 + 2 * kStages) + kAtomBytes;
  static_assert(kItem % kAtomBytes == 0, "an item buffer must keep the swizzle's alignment");
  static_assert(kSmem <= kSmemLimit, "K18's tiles must fit in 227 KB");
};

// K18's units of work: a unit is a pair of q tiles of one (batch * head),
// the one with the most kv tiles and the one with the fewest (tiles - 1 -
// p and p), so that every unit but an odd middle tile's holds the same
// work; units head by head, so that the CTAs that run at once share their
// heads' k and v in L2.
__host__ __device__ constexpr int dq_units(int tiles) { return (tiles + 1) / 2; }

// Unit u: its (batch * head) and q tiles, the longer first (lo = -1: none).
__host__ __device__ inline void dq_unit(const WsSched& s, int u, int& bh, int& hi, int& lo) {
  const int per = dq_units(s.tiles);
  bh = u / per;
  const int p = u - bh * per;
  hi = s.tiles - 1 - p;
  lo = p < hi ? p : -1;
}

// K18, bf16: persistent, CTA c takes units c, c + ctas, ... (dq_unit), and
// a unit's q tiles, the longer first; an item is one q tile (128 rows).  The
// producer loads an item's q and dout tiles (TMA) and its lse and di rows
// (its lanes' plain loads, as K19's: no 1-D TMA) into the buffer the item
// before last used, then its kv tiles through the ring, and runs on into
// the next item as stages free.  A consumer warpgroup owns 64 q rows; per
// kv tile j it issues S_j = q k_j^T (wgmma from shared memory, k K-major)
// and dq += dS_{j-1} k_{j-1} (wgmma, dS the bf16 A fragments in registers,
// k MN-major); takes p = exp(S_j - lse) while that product runs; then
// issues dP_j = dout v_j^T (v K-major) and takes dS_j = p (dP_j - di),
// packed as the next tile's A fragments.  (dP_j issued beside S_j spilled
// at D = 128 and was slower at 64, and S_{j+1} issued before the
// exponentials of tile j, where the registers allowed it (D = 64), was
// slower too: PERF.md §6.)  Only the diagonal tile is masked, without
// branches, and the warpgroup walks only the tiles up to its rows'
// diagonal.  The epilogue stages dq in the warpgroup's own rows of the dout
// tile, whose last reader (dP) is done, and stores it by TMA; the buffer is
// handed back (q_empty) once that store has read it, at the next item's
// first products.  No atomics.
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_dq, const WsArgs a) {
  using C = DqWs<D>;
  constexpr int S = C::kStages, kBc = C::kBc, kBoxes = D / 64, kSteps = kBc / 16;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtomBytes - 1) & ~static_cast<uint32_t>(kAtomBytes - 1);
  const uint32_t q_full = base + C::kBars, q_empty = q_full + 16, kv_full = q_full + 32;
  const uint32_t kv_empty = kv_full + 8 * S;
  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full + 8 * qb, 2);  // the producer's TMA bytes, then its lse and di
      mbar_init(q_empty + 8 * qb, kWsConsumers);
    }
    for (int st = 0; st < S; ++st) {
      mbar_init(kv_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, kWsConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kWsConsumers) {
    // The producer warp: lane 0 issues the TMA loads; every lane copies its
    // share of the item's lse and di rows (zeros past T), and lane 0 then
    // arrives on the buffer's barrier (its second arrival).
    const int lane = threadIdx.x % 32;
    uint32_t it = 0, n = 0;
    for (int u = blockIdx.x; u < a.s.items; u += gridDim.x) {
      int bh, hi, lo;
      dq_unit(a.s, u, bh, hi, lo);
      const int b = bh / a.H, h = bh - b * a.H;
      const float* lse = a.lse + static_cast<int64_t>(bh) * a.T;
      const float* di = a.di + static_cast<int64_t>(bh) * a.T;
      for (int half = 0; half < 2; ++half, ++n) {
        const int qt = half == 0 ? hi : lo;
        if (qt < 0) break;
        const int nkv = q_kv_tiles(a.s, qt, kBc);
        const uint32_t qf = q_full + 8 * (n % 2), qs = base + C::kQ + (n % 2) * C::kItem;
        const uint32_t os = qs + C::kQBytes;
        float lrow[kWsTile / 32], drow[kWsTile / 32];  // loaded before the buffer frees
#pragma unroll
        for (int c = 0; c < kWsTile / 32; ++c) {
          const int row = qt * kWsTile + 32 * c + lane;
          lrow[c] = row < a.T ? lse[row] : 0.f;
          drow[c] = row < a.T ? di[row] : 0.f;
        }
        if (lane == 0) {
          if (n >= 2) wait_or_trap(q_empty + 8 * (n % 2), ((n / 2) - 1) & 1);
          mbar_expect_tx(qf, 2 * C::kQBytes);
#pragma unroll
          for (int x = 0; x < kBoxes; ++x) {
            tma_load_4d(qs + x * kWsTile * 128, &map_q, qf, 64 * x, h, qt * kWsTile, b);
            tma_load_4d(os + x * kWsTile * 128, &map_do, qf, 64 * x, h, qt * kWsTile, b);
          }
        }
        __syncwarp();  // the buffer is free
        float* sl = reinterpret_cast<float*>(smem_raw + (os + C::kQBytes - raw));
#pragma unroll
        for (int c = 0; c < kWsTile / 32; ++c) {
          sl[32 * c + lane] = lrow[c];
          sl[kWsTile + 32 * c + lane] = drow[c];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(qf);
        for (int j = 0; j < nkv; ++j, ++it) {
          if (lane != 0) continue;
          const int st = it % S;
          if (it >= S) wait_or_trap(kv_empty + 8 * st, ((it / S) - 1) & 1);
          const uint32_t ks = base + C::kK + 2 * st * C::kKvBytes, vs = ks + C::kKvBytes;
          mbar_expect_tx(kv_full + 8 * st, 2 * C::kKvBytes);
#pragma unroll
          for (int x = 0; x < kBoxes; ++x) {
            tma_load_4d(ks + x * kBc * 128, &map_k, kv_full + 8 * st, 64 * x, h, j * kBc, b);
            tma_load_4d(vs + x * kBc * 128, &map_v, kv_full + 8 * st, 64 * x, h, j * kBc, b);
          }
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows 64 wg .. + 63 of each q tile; thread t holds
  // rows r and r + 8 of them and, in each 8-column group of S and dP,
  // columns 2 (t % 4) and + 1.
  const int t = threadIdx.x % 128;
  const int r = (t / 32) * 16 + (t % 32) / 4, cq = 2 * (t % 4);
  uint32_t it = 0, n = 0;
  for (int u = blockIdx.x; u < a.s.items; u += gridDim.x) {
    int bh, hi, lo;
    dq_unit(a.s, u, bh, hi, lo);
    for (int half = 0; half < 2; ++half, ++n) {
      const int qt = half == 0 ? hi : lo;
      if (qt < 0) break;
      const int nkv = q_kv_tiles(a.s, qt, kBc);
      const int row0 = qt * kWsTile + 64 * wg;  // the warpgroup's first q row
      const uint32_t qs = base + C::kQ + (n % 2) * C::kItem, os = qs + C::kQBytes;
      const float* sl = reinterpret_cast<const float*>(smem_raw + (os + C::kQBytes - raw));
      float dq[D / 2], s[kBc / 2], dp[kBc / 2];
      uint32_t da[kSteps][4];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

      // S_j = q k_j^T into s and dP_j = dout v_j^T into dp (zeroed first)
      const uint64_t q_desc = kmajor(qs, kWsTile, 64 * wg, 0), o_desc = kmajor(os, kWsTile, 64 * wg, 0);
      auto issue_s = [&](uint32_t ks) {
#pragma unroll
        for (int i = 0; i < kBc / 2; ++i) s[i] = 0.f;
        const uint64_t k_desc = kmajor(ks, kBc, 0, 0);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss<kBc>(s, kmajor_step(q_desc, kWsTile, kk), kmajor_step(k_desc, kBc, kk));
        wgmma_commit();
      };
      auto issue_dp = [&](uint32_t ks) {
#pragma unroll
        for (int i = 0; i < kBc / 2; ++i) dp[i] = 0.f;
        const uint64_t v_desc = kmajor(ks + C::kKvBytes, kBc, 0, 0);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss<kBc>(dp, kmajor_step(o_desc, kWsTile, kk), kmajor_step(v_desc, kBc, kk));
        wgmma_commit();
      };
      // dq += dS k_j: dS the packed A fragments, k_j MN-major
      auto issue_dq = [&](uint32_t ks) {
        const uint64_t k_desc = mnmajor(ks, kBc, 0);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) mma_rs<D>(dq, da[kk], mnmajor_step(k_desc, kk));
        wgmma_commit();
      };
      auto kv_stage = [&](uint32_t i) { return base + C::kK + 2 * (i % S) * C::kKvBytes; };
      // p = exp(s - lse) = 2^(s log2 e - lse log2 e) into s, 0 past the
      // diagonal of tile j (its last, where the keys reach past the
      // warpgroup's first row; without branches); then dS = p (dp - di)
      // into s.  Rows and keys past T are zeros: their dS adds nothing
      // that is stored.
      auto probs = [&](int j) {
        const bool diag = j * kBc + kBc - 1 > row0;
        float lse2[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) lse2[rr] = sl[64 * wg + r + 8 * rr] * kLog2e;
#pragma unroll
        for (int jj = 0; jj < kBc / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1;
            const bool keep = !diag | (j * kBc + 8 * jj + cq + (e & 1) <= row0 + r + 8 * rr);
            s[4 * jj + e] = ex2(keep ? fmaf(s[4 * jj + e], kLog2e, -lse2[rr]) : -INFINITY);
          }
      };
      auto grads = [&]() {
#pragma unroll
        for (int jj = 0; jj < kBc / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * jj + e] *= dp[4 * jj + e] - sl[kWsTile + 64 * wg + r + 8 * (e >> 1)];
      };

      // the warpgroup's kv tiles: those up to its rows' diagonal (tile
      // row0 / kBc, the one tile that reaches past its first row); the
      // item's tiles after them it only releases
      const int last_j = row0 / kBc < nkv - 1 ? row0 / kBc : nkv - 1;
      wait_or_trap(q_full + 8 * (n % 2), (n / 2) & 1);
      wait_or_trap(kv_full + 8 * (it % S), (it / S) & 1);
      issue_s(kv_stage(it));
      if (n > 0 && t == 0) {  // the last item's dq staging is read: hand its buffer back
        tma_store_wait_read();
        mbar_arrive(q_empty + 8 * ((n - 1) % 2));
      }
      wgmma_wait<0>();
      fence_acc(s);
      // Tile j: S_j (tile 0's issued above) and dS_{j-1} k_{j-1}; the
      // exponentials of S_j while dS_{j-1} k_{j-1} runs; then dP_j, dS_j and
      // its A fragments.  (The loop that took the first tile apart, S_0 and
      // dP_0 issued together, ran 10% slower at the 1.1B micro-batch.)
      for (int j = 0; j <= last_j; ++j) {
        const uint32_t cur = it + j, prev = cur - 1;
        if (j > 0) {
          wait_or_trap(kv_full + 8 * (cur % S), (cur / S) & 1);
          issue_s(kv_stage(cur));
          issue_dq(kv_stage(prev));
          wgmma_wait<1>();  // S_j is done; dS_{j-1} k_{j-1} may run on
          fence_acc(s);
        }
        probs(j);
        wgmma_wait<0>();
        if (j > 0) {
          fence_acc(dq);
          fence_regs(da);
          if (t == 0) mbar_arrive(kv_empty + 8 * (prev % S));
        }
        issue_dp(kv_stage(cur));
        wgmma_wait<0>();
        fence_acc(dp);
        grads();
        pack_a<kSteps>(da, s);
      }
      {
        const uint32_t last = it + last_j;
        issue_dq(kv_stage(last));
        wgmma_wait<0>();
        fence_acc(dq);
        fence_regs(da);
        if (t == 0) mbar_arrive(kv_empty + 8 * (last % S));
      }
      for (int j = last_j + 1; j < nkv; ++j) {  // tiles wholly after this warpgroup's rows
        const uint32_t cur = it + j;
        wait_or_trap(kv_full + 8 * (cur % S), (cur / S) & 1);
        if (t == 0) mbar_arrive(kv_empty + 8 * (cur % S));
      }
      it += nkv;

      // The epilogue: dq through the warpgroup's rows of the dout tile by TMA.
      const float one[2] = {1.f, 1.f};
      const uint32_t stage = os + 64 * wg * 128;
      stage_rows<D, kWsTile * 128>(smem_raw + (stage - raw), dq, t, one);
      fence_proxy_async();
      warpgroup_sync(wg);
      if (t == 0) {
        if (row0 < a.T) {
          const int b = bh / a.H, h = bh - b * a.H;
#pragma unroll
          for (int x = 0; x < kBoxes; ++x)
            tma_store_4d(&map_dq, stage + x * kWsTile * 128, 64 * x, h, row0, b);
        }
        tma_store_commit();
      }
    }
  }
  if (t == 0) tma_store_wait_read();  // the staging is read before the CTA leaves
}

// K19's shared memory: kKvBufs pairs of k and v tiles (128 rows each,
// resident for the item; item n in pair n % kKvBufs, so that at D = 64 the
// next item's tiles load while this one runs), kStages stages of (q, dout:
// BQ rows each; lse, di: BQ fp32 each), the epilogue's staging of dk and dv
// (128 rows each), then the barriers kv_full[B], kv_empty[B], full[S],
// empty[S].
template <int D>
struct DkvWs {
  static constexpr int kBq = kDkvRows, kPasses = dkv_passes(D);
  static constexpr int kKvBufs = D == 64 ? 2 : 1;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kKvBytes = kWsTile * D * 2;
  static constexpr int kStepBytes = kBq * D * 2;
  static constexpr int kStage = round_up(2 * kStepBytes + 2 * kBq * 4, kAtomBytes);
  static constexpr int kK = 0;  // pair kb: k at kK + 2 kb kKvBytes, v after it
  static constexpr int kRing = 2 * kKvBufs * kKvBytes;
  static constexpr int kOut = kRing + kStages * kStage;  // dk, then dv
  static constexpr int kBars = kOut + 2 * kKvBytes;
  static constexpr int kSmem = kBars + 8 * (2 * kKvBufs + 2 * kStages) + kAtomBytes;
  static_assert(kSmem <= kSmemLimit, "K19's tiles must fit in 227 KB");
};

// What a pass of K19 sums: both (D = 64), dv (D = 128's first) or dk.
template <int kWhat>
struct DkvPass {
  static constexpr bool kDv = kWhat != 2, kDk = kWhat != 1;
};

// K19, bf16: persistent, items longest first (ws_item).  The producer loads
// an item's k and v tiles once, then q and dout (TMA) and lse and di (its
// lanes' plain loads, issued before the stage frees) a step through the
// ring, once a pass, and runs on into the next item.  (lse and di came by
// 1-D TMA first: a box whose start lay off 16 bytes, a head's rows at T %
// 4 != 0, was an illegal instruction on the card.)  A consumer warpgroup
// owns 64 kv rows: per step S^T = k q^T and dP^T = v dout^T (wgmma from
// shared memory), P^T and dS^T in registers (masked only at the diagonal
// steps and the ragged last one), then dV += P^T dout and dK += dS^T q
// (wgmma, P^T and dS^T rounded to bf16 as A fragments, dout and q
// MN-major); it skips the steps whose q rows all come before its kv rows.
// dk and dv leave by TMA stores; no atomics.  Measured and dropped
// (PERF.md §6): K17's turns here (scripts/probe_attention.py's "dkv
// turns": slower), and 32-row steps with the next step's S^T and dP^T
// issued before this step's P^T (it spilled at 168 registers and ran
// slower).
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_dk,
                     const __grid_constant__ CUtensorMap map_dv, const WsArgs a) {
  using C = DkvWs<D>;
  constexpr int S = C::kStages, kBoxes = D / 64, BQ = C::kBq;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtomBytes - 1) & ~static_cast<uint32_t>(kAtomBytes - 1);
  constexpr int B2 = C::kKvBufs;
  const uint32_t kv_full = base + C::kBars, kv_empty = kv_full + 8 * B2;
  const uint32_t full = kv_empty + 8 * B2, empty = full + 8 * S;
  if (threadIdx.x == 0) {
    for (int kb = 0; kb < B2; ++kb) {
      mbar_init(kv_full + 8 * kb, 1);
      mbar_init(kv_empty + 8 * kb, kWsConsumers);
    }
    for (int st = 0; st < S; ++st) {
      mbar_init(full + 8 * st, 2);  // the producer's TMA bytes, then its lse and di
      mbar_init(empty + 8 * st, kWsConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kWsConsumers) {
    // The producer warp: lane 0 issues the TMA loads; every lane copies its
    // share of the step's lse and di rows (zeros past T), and lane 0 then
    // arrives on the stage's barrier (its second arrival).
    const int lane = threadIdx.x % 32;
    uint32_t it = 0, n = 0;
    for (int w = blockIdx.x; w < a.s.items; w += gridDim.x, ++n) {
      int bh, kt;
      ws_item(a.s, false, w, bh, kt);
      const int b = bh / a.H, h = bh - b * a.H;
      if (lane == 0) {
        const int kb = n % B2;
        const uint32_t kf = kv_full + 8 * kb, ks = base + C::kK + 2 * kb * C::kKvBytes;
        if (n >= B2) wait_or_trap(kv_empty + 8 * kb, ((n / B2) - 1) & 1);
        mbar_expect_tx(kf, 2 * C::kKvBytes);
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) {
          tma_load_4d(ks + x * kWsTile * 128, &map_k, kf, 64 * x, h, kt * kWsTile, b);
          tma_load_4d(ks + C::kKvBytes + x * kWsTile * 128, &map_v, kf, 64 * x, h, kt * kWsTile, b);
        }
      }
      const float* lse = a.lse + static_cast<int64_t>(bh) * a.T;
      const float* di = a.di + static_cast<int64_t>(bh) * a.T;
      for (int pass = 0; pass < C::kPasses; ++pass) {
        for (int i = kt * kWsTile / BQ; i < a.s.steps; ++i, ++it) {
          const int st = it % S;
          const uint32_t qs = base + C::kRing + st * C::kStage, os = qs + C::kStepBytes;
          const uint32_t f = full + 8 * st;
          // the step's lse and di rows, loaded before the stage frees
          float lv[BQ / 32], dv[BQ / 32];
#pragma unroll
          for (int c = 0; c < BQ / 32; ++c) {
            const int row = i * BQ + 32 * c + lane;
            lv[c] = row < a.T ? lse[row] : 0.f;
            dv[c] = row < a.T ? di[row] : 0.f;
          }
          if (lane == 0) {
            if (it >= S) wait_or_trap(empty + 8 * st, ((it / S) - 1) & 1);
            mbar_expect_tx(f, 2 * C::kStepBytes);
#pragma unroll
            for (int x = 0; x < kBoxes; ++x) {
              tma_load_4d(qs + x * BQ * 128, &map_q, f, 64 * x, h, i * BQ, b);
              tma_load_4d(os + x * BQ * 128, &map_do, f, 64 * x, h, i * BQ, b);
            }
          }
          __syncwarp();  // the stage is free
          float* sl = reinterpret_cast<float*>(smem_raw + (os + C::kStepBytes - raw));
#pragma unroll
          for (int c = 0; c < BQ / 32; ++c) {
            sl[32 * c + lane] = lv[c];
            sl[BQ + 32 * c + lane] = dv[c];
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(f);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: kv rows 64 wg .. + 63 of the tile; thread t holds
  // kv rows r and r + 8 of them and, in each 8-column group of S^T, the q
  // columns 2 (t % 4) and + 1.
  const int t = threadIdx.x % 128;
  const int r = (t / 32) * 16 + (t % 32) / 4, cq = 2 * (t % 4);
  const uint32_t dk_stage = base + C::kOut + wg * (C::kKvBytes / 2);
  const uint32_t dv_stage = dk_stage + C::kKvBytes;
  uint32_t it = 0, n = 0;
  for (int w = blockIdx.x; w < a.s.items; w += gridDim.x, ++n) {
    int bh, kt;
    ws_item(a.s, false, w, bh, kt);
    const int b = bh / a.H, h = bh - b * a.H;
    const int k0 = kt * kWsTile + 64 * wg;  // this warpgroup's first kv row
    const uint32_t kb_k = base + C::kK + 2 * (n % B2) * C::kKvBytes, kb_v = kb_k + C::kKvBytes;
    wait_or_trap(kv_full + 8 * (n % B2), (n / B2) & 1);

    // One pass over the item's q steps, summing what `tag` says; then its
    // outputs leave through the staging by TMA.
    auto run_pass = [&](auto tag, bool last_pass) {
      using P = decltype(tag);
      float dk[P::kDk ? D / 2 : 1], dv[P::kDv ? D / 2 : 1];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        if constexpr (P::kDk) dk[i] = 0.f;
        if constexpr (P::kDv) dv[i] = 0.f;
      }
      for (int i = kt * kWsTile / BQ; i < a.s.steps; ++i, ++it) {
        const int st = it % S;
        wait_or_trap(full + 8 * st, (it / S) & 1);
        const uint32_t qs = base + C::kRing + st * C::kStage, os = qs + C::kStepBytes;
        const float* sl = reinterpret_cast<const float*>(smem_raw + (os + C::kStepBytes - raw));
        const float* sd = sl + BQ;
        const int q0 = i * BQ;
        if (q0 + BQ <= k0) {  // every q row of the step before this warpgroup's kv rows
          if (last_pass && i == a.s.steps - 1 && t == 0) mbar_arrive(kv_empty + 8 * (n % B2));
          if (t == 0) mbar_arrive(empty + 8 * st);
          continue;
        }
        float s[BQ / 2], dp[P::kDk ? BQ / 2 : 1];
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          s[e] = 0.f;
          if constexpr (P::kDk) dp[e] = 0.f;
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          mma_ss<BQ>(s, kmajor(kb_k, kWsTile, 64 * wg, kk), kmajor(qs, BQ, 0, kk));
          if constexpr (P::kDk)
            mma_ss<BQ>(dp, kmajor(kb_v, kWsTile, 64 * wg, kk), kmajor(os, BQ, 0, kk));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(s);
        if constexpr (P::kDk) fence_acc(dp);
        if (last_pass && i == a.s.steps - 1 && t == 0)
          mbar_arrive(kv_empty + 8 * (n % B2));  // the item's last read of k and v
        // P^T = exp(S^T - lse), dS^T = P^T (dP^T - di): masked (exp(-inf) =
        // 0) where a q row comes before the kv row or lies past T, without
        // branches (a branch an element cost more than the exponentials)
        const bool edge = q0 < k0 + 64 || q0 + BQ > a.T;
#pragma unroll
        for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * jj + cq + (e & 1), col = q0 + c;
            const bool keep = !edge | ((col >= k0 + r + 8 * (e >> 1)) & (col < a.T));
            const float pv = __expf(keep ? s[4 * jj + e] - sl[c] : -INFINITY);
            s[4 * jj + e] = pv;
            if constexpr (P::kDk) dp[4 * jj + e] = pv * (dp[4 * jj + e] - sd[c]);
          }
        uint32_t pa[P::kDv ? BQ / 16 : 1][4], da[P::kDk ? BQ / 16 : 1][4];
        if constexpr (P::kDv) pack_a<BQ / 16>(pa, s);
        if constexpr (P::kDk) pack_a<BQ / 16>(da, dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          if constexpr (P::kDv) mma_rs<D>(dv, pa[kk], mnmajor(os, BQ, kk));
          if constexpr (P::kDk) mma_rs<D>(dk, da[kk], mnmajor(qs, BQ, kk));
        }
        wgmma_commit();
        wgmma_wait<0>();
        if constexpr (P::kDk) {
          fence_acc(dk);
          fence_regs(da);
        }
        if constexpr (P::kDv) {
          fence_acc(dv);
          fence_regs(pa);
        }
        if (t == 0) mbar_arrive(empty + 8 * st);
      }
      const float one[2] = {1.f, 1.f};
      if (t == 0) tma_store_wait_read();  // the staging's last stores have read it
      warpgroup_sync(wg);
      if constexpr (P::kDk) stage_rows<D>(smem_raw + (dk_stage - raw), dk, t, one);
      if constexpr (P::kDv) stage_rows<D>(smem_raw + (dv_stage - raw), dv, t, one);
      fence_proxy_async();
      warpgroup_sync(wg);
      if (t == 0 && k0 < a.T) {
#pragma unroll
        for (int x = 0; x < kBoxes; ++x) {
          if constexpr (P::kDk) tma_store_4d(&map_dk, dk_stage + x * 8192, 64 * x, h, k0, b);
          if constexpr (P::kDv) tma_store_4d(&map_dv, dv_stage + x * 8192, 64 * x, h, k0, b);
        }
        tma_store_commit();
      }
    };
    if constexpr (C::kPasses == 1) {
      run_pass(DkvPass<0>{}, true);
    } else {
      run_pass(DkvPass<1>{}, false);
      run_pass(DkvPass<2>{}, true);
    }
  }
  if (t == 0) tma_store_wait_read();  // the staging is read before the CTA leaves
}

// -- host -----------------------------------------------------------------------

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

constexpr size_t f32_smem(int which, int D) {
  const size_t lr = D + 4, lc = D + 1, t = kF32Tile, ps = kPS;
  if (which == kFwd) return (t * lr + t * lc + t * D + t * ps) * sizeof(float);
  if (which == kDq) return (2 * t * lr + 2 * t * lc + t * ps) * sizeof(float);
  return (2 * t * lr + 2 * t * lc + 2 * t * ps + 2 * t) * sizeof(float);
}

// The one-CTA-a-tile kernels: K17-K19 in f32.
template <int D>
const void* f32_kernel_of(int which) {
  if (which == kFwd) return reinterpret_cast<const void*>(fwd_f32_kernel<D>);
  if (which == kDq) return reinterpret_cast<const void*>(dq_f32_kernel<D>);
  return reinterpret_cast<const void*>(dkv_f32_kernel<D>);
}

cudaError_t run_f32(int which, const Params& prm, int64_t B, int64_t T, int64_t H, int64_t D,
                    cudaStream_t stream) {
  const int64_t tiles = (T + kF32Tile - 1) / kF32Tile;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const void* fn = D == 64 ? f32_kernel_of<64>(which) : f32_kernel_of<128>(which);
  const size_t smem = f32_smem(which, static_cast<int>(D));
  // The dynamic shared memory limit is each function's own.
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>(tiles), 1);
  void* args[] = {const_cast<Params*>(&prm)};
  return cudaLaunchKernel(fn, grid, dim3(kF32Threads), args, smem, stream);
}

// -- the persistent kernels' plans and launches --

// The plan of a K17 (which 0), K18 (1) or K19 (2) call in bf16, the fields
// of attention_cuda.PLAN_KEYS: SMs, CTAs an SM, the grid's CTAs, items,
// 128-row tiles, steps (K17, K18: kv tiles; K19: q steps), step rows, passes
// over q, ring stages, threads and shared memory a CTA.
constexpr int kPlanFields = 11;

template <int D>
struct WsKernel {
  static const void* fn(int which) {
    if (which == kFwd) return reinterpret_cast<const void*>(fwd_wgmma_kernel<D>);
    if (which == kDq) return reinterpret_cast<const void*>(dq_wgmma_kernel<D>);
    return reinterpret_cast<const void*>(dkv_wgmma_kernel<D>);
  }
  static int smem(int which) {
    return which == kFwd ? FwdWs<D>::kSmem : which == kDq ? DqWs<D>::kSmem : DkvWs<D>::kSmem;
  }
  static int stages(int which) {
    return which == kFwd ? FwdWs<D>::kStages
                         : which == kDq ? DqWs<D>::kStages : DkvWs<D>::kStages;
  }
  static int step_rows(int which) {
    return which == kFwd ? fwd_kv_rows(D) : which == kDq ? kDqRows : kDkvRows;
  }
  static int passes(int which) { return which == kDkv ? dkv_passes(D) : 1; }
};

// SMs and CTAs of a kernel an SM on `device`, found once a kernel and device.
template <int D>
cudaError_t ws_resident(int which, int device, int* sms, int* per_sm) {
  static int known[3][64][2] = {};
  const int k = which;
  if (device >= 0 && device < 64 && known[k][device][0] > 0) {
    *sms = known[k][device][0];
    *per_sm = known[k][device][1];
    return cudaSuccess;
  }
  const void* fn = WsKernel<D>::fn(which);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         WsKernel<D>::smem(which));
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kWsThreads,
                                                      WsKernel<D>::smem(which));
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  if (device >= 0 && device < 64) {
    known[k][device][0] = *sms;
    known[k][device][1] = *per_sm;
  }
  return cudaSuccess;
}

template <int D>
WsSched ws_sched(int which, int64_t B, int64_t T, int64_t H) {
  WsSched s{};
  s.bh = static_cast<int>(B * H);
  s.tiles = static_cast<int>((T + kWsTile - 1) / kWsTile);
  s.items = s.bh * (which == kDq ? dq_units(s.tiles) : s.tiles);
  const int step = WsKernel<D>::step_rows(which);
  s.steps = static_cast<int>((T + step - 1) / step);
  return s;
}

template <int D>
cudaError_t ws_plan(int which, int device, int64_t B, int64_t T, int64_t H, int64_t* out) {
  int sms = 0, per_sm = 0;
  const cudaError_t err = ws_resident<D>(which, device, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  const WsSched s = ws_sched<D>(which, B, T, H);
  const int ctas = s.items < sms * per_sm ? s.items : sms * per_sm;
  const int64_t v[kPlanFields] = {sms, per_sm, ctas, s.items, s.tiles, s.steps,
                                  WsKernel<D>::step_rows(which), WsKernel<D>::passes(which),
                                  WsKernel<D>::stages(which),
                                  kWsThreads, WsKernel<D>::smem(which)};
  for (int i = 0; i < kPlanFields; ++i) out[i] = v[i];
  return cudaSuccess;
}

// The 4-D map (D, H, T, B) of a (B, T, H, D) bf16 tensor read or written in
// boxes of 64 columns by `rows` rows of one (batch, head), 128-byte swizzled:
// rows past T load as zeros and are not stored.
bool bthd_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int64_t B, int64_t T,
              int64_t H, int64_t D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D * 2), static_cast<cuuint64_t>(H * D * 2),
                                 static_cast<cuuint64_t>(T * H * D * 2)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int D>
cudaError_t run_ws(int which, int device, const Params& prm, int64_t B, int64_t T, int64_t H,
                   cudaStream_t stream) {
  EncodeTiled encode = nullptr;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  int64_t plan[kPlanFields];
  if ((err = ws_plan<D>(which, device, B, T, H, plan)) != cudaSuccess) return err;
  WsArgs a{};
  a.s = ws_sched<D>(which, B, T, H);
  a.T = static_cast<int>(T), a.H = static_cast<int>(H), a.lse = prm.lse, a.di = prm.di;
  const dim3 grid(static_cast<unsigned>(plan[2])), block(kWsThreads);
  const int smem = WsKernel<D>::smem(which), step = WsKernel<D>::step_rows(which);
  CUtensorMap mq, mk, mv, mo;
  if (which == kFwd) {
    if (!bthd_map(encode, &mq, prm.q, B, T, H, D, kWsTile) ||
        !bthd_map(encode, &mk, prm.k, B, T, H, D, step) ||
        !bthd_map(encode, &mv, prm.v, B, T, H, D, step) ||
        !bthd_map(encode, &mo, prm.o, B, T, H, D, 64))
      return cudaErrorInvalidValue;
    fwd_wgmma_kernel<D><<<grid, block, smem, stream>>>(mq, mk, mv, mo, a);
  } else if (which == kDq) {
    CUtensorMap mdo;
    if (!bthd_map(encode, &mq, prm.q, B, T, H, D, kWsTile) ||
        !bthd_map(encode, &mk, prm.k, B, T, H, D, step) ||
        !bthd_map(encode, &mv, prm.v, B, T, H, D, step) ||
        !bthd_map(encode, &mdo, prm.dout, B, T, H, D, kWsTile) ||
        !bthd_map(encode, &mo, prm.o, B, T, H, D, 64))
      return cudaErrorInvalidValue;
    dq_wgmma_kernel<D><<<grid, block, smem, stream>>>(mq, mk, mv, mdo, mo, a);
  } else {
    CUtensorMap mdo, mdk, mdv;
    if (!bthd_map(encode, &mq, prm.q, B, T, H, D, step) ||
        !bthd_map(encode, &mk, prm.k, B, T, H, D, kWsTile) ||
        !bthd_map(encode, &mv, prm.v, B, T, H, D, kWsTile) ||
        !bthd_map(encode, &mdo, prm.dout, B, T, H, D, step) ||
        !bthd_map(encode, &mdk, prm.o, B, T, H, D, 64) ||
        !bthd_map(encode, &mdv, prm.o2, B, T, H, D, 64))
      return cudaErrorInvalidValue;
    dkv_wgmma_kernel<D><<<grid, block, smem, stream>>>(mq, mk, mv, mdo, mdk, mdv, a);
  }
  return cudaGetLastError();
}

cudaError_t run(int which, int dtype, int device, const Params& prm, int64_t B, int64_t T,
                int64_t H, int64_t D, cudaStream_t stream) {
  // This library carries its own (static) CUDA runtime, whose current
  // device is not PyTorch's: set it to the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((dtype != 0 && dtype != 1) || (D != 64 && D != 128) || B < 0 || T < 0 || H <= 0)
    return cudaErrorInvalidValue;
  if (B * H * T > 0x7fffffff || T * H * D > (int64_t{1} << 40)) return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return cudaSuccess;
  if (dtype == 1) {
    err = D == 64 ? run_ws<64>(which, device, prm, B, T, H, stream)
                  : run_ws<128>(which, device, prm, B, T, H, stream);
  } else {
    err = run_f32(which, prm, B, T, H, D, stream);
  }
  if (err != cudaSuccess) cudaGetLastError();  // clear it: the caller gets it here
  return err;
}

Params params(const void* q, const void* k, const void* v, const void* dout, void* o, void* o2,
              float* lse, const float* di, int64_t T, int64_t H) {
  Params prm;
  prm.q = q, prm.k = k, prm.v = v, prm.dout = dout, prm.o = o, prm.o2 = o2;
  prm.lse = lse, prm.di = di;
  prm.T = static_cast<int>(T), prm.H = static_cast<int>(H);
  return prm;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, dout, o, dq, dk, dv: contiguous
// (B, T, H, D) on `device`, 16-byte aligned, D 64 or 128; lse, di: fp32
// (B, H, T).  Each returns the cudaError_t of its launch
// (cudaErrorInvalidValue for a shape the kernels do not take).

// K17: o and lse from q (already scaled), k, v.
extern "C" int smft_flash_attn_fwd(int dtype, int device, const void* q, const void* k,
                                   const void* v, void* o, float* lse, int64_t B, int64_t T,
                                   int64_t H, int64_t D, void* stream) {
  return run(kFwd, dtype, device, params(q, k, v, nullptr, o, nullptr, lse, nullptr, T, H), B,
             T, H, D, static_cast<cudaStream_t>(stream));
}

// K18: dq from q, k, v, dout, lse and di.
extern "C" int smft_flash_attn_dq(int dtype, int device, const void* q, const void* k,
                                  const void* v, const void* dout, const float* lse,
                                  const float* di, void* dq, int64_t B, int64_t T, int64_t H,
                                  int64_t D, void* stream) {
  return run(kDq, dtype, device,
             params(q, k, v, dout, dq, nullptr, const_cast<float*>(lse), di, T, H), B, T, H, D,
             static_cast<cudaStream_t>(stream));
}

// K19: dk and dv from q, k, v, dout, lse and di.
extern "C" int smft_flash_attn_dkv(int dtype, int device, const void* q, const void* k,
                                   const void* v, const void* dout, const float* lse,
                                   const float* di, void* dk, void* dv, int64_t B, int64_t T,
                                   int64_t H, int64_t D, void* stream) {
  return run(kDkv, dtype, device,
             params(q, k, v, dout, dk, dv, const_cast<float*>(lse), di, T, H), B, T, H, D,
             static_cast<cudaStream_t>(stream));
}

// The plan of a bf16 K17 (which 0), K18 (1) or K19 (2) call at (B, T, H, D)
// on `device`: the 11 fields of attention_cuda.PLAN_KEYS into `out`.
// Returns a cudaError_t (cudaErrorInvalidValue for a shape the kernels do
// not take).
extern "C" int smft_flash_attn_plan(int which, int device, int64_t B, int64_t T, int64_t H,
                                    int64_t D, int64_t* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((which != kFwd && which != kDq && which != kDkv) || (D != 64 && D != 128) || B <= 0 || T <= 0 || H <= 0 ||
      B * H * T > 0x7fffffff)
    return cudaErrorInvalidValue;
  return D == 64 ? ws_plan<64>(which, device, B, T, H, out)
                 : ws_plan<128>(which, device, B, T, H, out);
}
