// Monarch backward (K3) and the one-read factor-gradient pass (K4) for
// Hopper, sm_90a.
//
// K3 replaces the Pallas TPU kernel `_bwd_kernel` of
// sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py (:173-210, launcher
// :250-281); K4 replaces `_dw_only_kernel` (:364-397, launcher
// `monarch_dw_fused` :421-466).  K4 is K3 without dx: merged training's
// backward, whose dx goes through the merged dense operand instead.
//
//   x (M, n), n = K*P;  dout (M, m), m = S*L;  w1 (K, Q, P);  w2 (L, S, R);
//   J = K*Q = L*R.  Per row b, with j = k*Q + q read as (r, l), l fastest:
//   out1[b, j]  = round_T( sum_p x[b, k*P + p] * w1[k, q, p] )    (recomputed)
//   dout1[b, j] = round_T( sum_s dout[b, s*L + l] * w2[l, s, r] )
//   dw2[l, s, r] += out1[b, r*L + l] * dout[b, s*L + l]
//   dw1[k, q, p] += dout1[b, k*Q + q] * x[b, k*P + p]
//   dx[b, k*P + p] = round_T( sum_q dout1[b, k*Q + q] * w1[k, q, p] )  (K3)
// T is the dtype of x and dout (float or bf16); every sum is fp32 and dw1,
// dw2 come out in fp32.  Nothing is expanded into the TPU kernel's
// permuted-dense W1bd/W2hat: the interleave is indexed directly.
//
// What bounds it: device memory.  Per element of x and dout the kernel does
// 2-3 multiply-adds per unit of blk_r, far under the card's ~295 operations
// per byte, so the design reads x and dout from device memory once each
// and keeps the two J-wide row summaries (out1, dout1) out of it.
//
// The reduction over rows.  The TPU summed dW in VMEM across a grid that
// runs in order; Hopper's CTAs run in parallel and in no order.  Here each
// CTA owns a contiguous group of rows and sums its rows' contributions in
// shared memory (each thread owns its columns, so no atomics), then writes
// one fp32 partial per group; a second pass sums the partials in group
// order.  The result is the same bit for bit from run to run (fp32 atomics
// would not be).  The host picks the number of groups so that the partials'
// traffic stays under 1/4 of the main traffic, and splits the columns over
// up to 4 CTAs per group (each recomputing its rows' summaries, rereading
// them from L2) where the groups alone would leave SMs idle, and over more
// where the shared memory would not fit.
//
// Ragged rows: a tile's rows past M are never loaded; their x and dout
// values enter the sums as zeros.
//
// Layout of one CTA (group g, column chunk c), per tile of kTileRows rows:
//   A: out1 of the tile, one warp per (row, j) dot of length P (lanes along
//      p, coalesced), a shuffle reduction, rounded to T, kept in shared memory;
//   B: dout1 of the tile, one warp per (row, j) dot of length S, likewise;
//   C: one thread per input column of the chunk: the tile's x column in
//      registers; for each q, the dw1 contribution summed over the tile into
//      shared memory and (K3) dx accumulated in registers, then stored;
//   D: one thread per output column of the chunk: the tile's dout column in
//      registers; for each r, the dw2 contribution into shared memory.
//
// The C interface takes raw pointers and returns a cudaError_t, so this
// file needs no PyTorch header; ops.cpp binds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 16;
// Shared memory a CTA may take, below the 227 KB the card allows, so that
// the column split keeps a margin.
constexpr int64_t kSmemBudget = 200 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as JAX's astype
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Shape {
  int64_t M;
  int K, Q, P, L, S, R;
  int64_t rows_per_group;
  int64_t n_chunk, m_chunk;  // columns of x / dout per CTA of the split
};

template <typename T, bool kDx>
__global__ void __launch_bounds__(kThreads)
monarch_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                   const T* __restrict__ w1, const T* __restrict__ w2, T* __restrict__ dx,
                   float* __restrict__ part1, float* __restrict__ part2, Shape sh) {
  extern __shared__ float smem[];
  const int K = sh.K, Q = sh.Q, P = sh.P, L = sh.L, S = sh.S, R = sh.R;
  const int J = K * Q;
  const int64_t n = static_cast<int64_t>(K) * P;
  const int64_t m = static_cast<int64_t>(S) * L;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int64_t n0 = blockIdx.y * sh.n_chunk;
  const int64_t n1 = n0 + sh.n_chunk < n ? n0 + sh.n_chunk : n;
  const int64_t m0 = blockIdx.y * sh.m_chunk;
  const int64_t m1 = m0 + sh.m_chunk < m ? m0 + sh.m_chunk : m;

  float* acc1 = smem;                   // [Q][n_chunk]  dw1 of the chunk's columns
  float* acc2 = acc1 + Q * sh.n_chunk;  // [R][m_chunk]  dw2 of the chunk's columns
  float* o1 = acc2 + R * sh.m_chunk;    // [kTileRows][J] out1 of the tile
  float* d1 = o1 + kTileRows * J;       // [kTileRows][J] dout1 of the tile

  // Each thread zeroes, updates and writes out only its own columns' sums.
  for (int64_t c = n0 + threadIdx.x; c < n1; c += kThreads)
    for (int q = 0; q < Q; ++q) acc1[q * sh.n_chunk + (c - n0)] = 0.f;
  for (int64_t c = m0 + threadIdx.x; c < m1; c += kThreads)
    for (int r = 0; r < R; ++r) acc2[r * sh.m_chunk + (c - m0)] = 0.f;

  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * sh.rows_per_group;
  const int64_t g1 = g0 + sh.rows_per_group < sh.M ? g0 + sh.rows_per_group : sh.M;
  for (int64_t t0 = g0; t0 < g1; t0 += kTileRows) {
    const int rows = g1 - t0 < kTileRows ? static_cast<int>(g1 - t0) : kTileRows;

    // A: out1.  The loop bound is the same for every lane of a warp, so the
    // shuffles always have the full warp.
    for (int t = warp; t < rows * J; t += kWarps) {
      const int i = t / J, j = t % J, k = j / Q;
      const T* xr = x + (t0 + i) * n + static_cast<int64_t>(k) * P;
      const T* wr = w1 + static_cast<int64_t>(j) * P;  // w1[k, q, :]
      float acc = 0.f;
#pragma unroll 4
      for (int p = lane; p < P; p += 32) acc += to_f32(xr[p]) * to_f32(wr[p]);
      acc = warp_sum(acc);
      if (lane == 0) o1[i * J + j] = to_f32(from_f32<T>(acc));
    }
    // B: dout1, j = r*L + l.
    for (int t = warp; t < rows * J; t += kWarps) {
      const int i = t / J, j = t % J, r = j / L, l = j % L;
      const T* dr = dout + (t0 + i) * m + l;                        // dout[b, s*L + l]
      const T* wr = w2 + static_cast<int64_t>(l) * S * R + r;       // w2[l, s, r]
      float acc = 0.f;
#pragma unroll 4
      for (int s = lane; s < S; s += 32)
        acc += to_f32(dr[static_cast<int64_t>(s) * L]) * to_f32(wr[static_cast<int64_t>(s) * R]);
      acc = warp_sum(acc);
      if (lane == 0) d1[i * J + j] = to_f32(from_f32<T>(acc));
    }
    __syncthreads();

    // C: dw1 (and dx) over the chunk's input columns.
    for (int64_t c = n0 + threadIdx.x; c < n1; c += kThreads) {
      const int k = static_cast<int>(c / P);
      const int p = static_cast<int>(c % P);
      float xv[kTileRows], dxv[kTileRows];
#pragma unroll
      for (int i = 0; i < kTileRows; ++i) {
        xv[i] = i < rows ? to_f32(x[(t0 + i) * n + c]) : 0.f;
        dxv[i] = 0.f;
      }
      for (int q = 0; q < Q; ++q) {
        const int j = k * Q + q;
        const float w = kDx ? to_f32(w1[static_cast<int64_t>(j) * P + p]) : 0.f;
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < kTileRows; ++i) {
          const float d = i < rows ? d1[i * J + j] : 0.f;
          a += d * xv[i];
          if constexpr (kDx) dxv[i] += d * w;
        }
        acc1[q * sh.n_chunk + (c - n0)] += a;
      }
      if constexpr (kDx) {
#pragma unroll
        for (int i = 0; i < kTileRows; ++i)
          if (i < rows) dx[(t0 + i) * n + c] = from_f32<T>(dxv[i]);
      }
    }
    // D: dw2 over the chunk's output columns, c = s*L + l.
    for (int64_t c = m0 + threadIdx.x; c < m1; c += kThreads) {
      const int l = static_cast<int>(c % L);
      float dv[kTileRows];
#pragma unroll
      for (int i = 0; i < kTileRows; ++i) dv[i] = i < rows ? to_f32(dout[(t0 + i) * m + c]) : 0.f;
      for (int r = 0; r < R; ++r) {
        const int j = r * L + l;
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < kTileRows; ++i) a += (i < rows ? o1[i * J + j] : 0.f) * dv[i];
        acc2[r * sh.m_chunk + (c - m0)] += a;
      }
    }
    __syncthreads();  // the next tile overwrites o1 and d1
  }

  // The group's partial sums, in the factors' layouts.
  float* p1 = part1 + static_cast<int64_t>(blockIdx.x) * J * P;
  for (int64_t c = n0 + threadIdx.x; c < n1; c += kThreads) {
    const int k = static_cast<int>(c / P), p = static_cast<int>(c % P);
    for (int q = 0; q < Q; ++q)
      p1[static_cast<int64_t>(k * Q + q) * P + p] = acc1[q * sh.n_chunk + (c - n0)];
  }
  float* p2 = part2 + static_cast<int64_t>(blockIdx.x) * J * S;
  for (int64_t c = m0 + threadIdx.x; c < m1; c += kThreads) {
    const int l = static_cast<int>(c % L), s = static_cast<int>(c / L);
    for (int r = 0; r < R; ++r)
      p2[(static_cast<int64_t>(l) * S + s) * R + r] = acc2[r * sh.m_chunk + (c - m0)];
  }
}

// ---------------------------------------------------------------------------
// Fast path: K = Q = L = R = 4 (nblocks 4, blk_r 4, every configuration of
// the repository), P % 8 == 0, S even, 16-byte aligned rows.  Three
// launches, each reading its rows with 16-byte loads:
//   summaries: one warp per row computes out1 (from x) or dout1 (from dout)
//     into fp32 scratch, rounded to T; fixed-order warp reductions.
//   columns:   one thread per 8 columns of x (dx and dw1) or of dout (dw2),
//     its factor entries and its fp32 sums in registers, looping over the
//     rows of its row group 4 at a time; it rereads x and dout (from L2
//     where they are still there) but needs no block-wide reduction.
//   sum:       the groups' partial dw1 and dw2 summed in group order.
// Bytes: x and dout are read twice where the generic kernel reads them
// once, but every read is a coalesced 16-byte load and no CTA waits on a
// long dependent chain.

constexpr int kFast = 4;           // K = Q = L = R
constexpr int kSumWarps = 8;       // summaries: rows per CTA
constexpr int kColThreads = 128;   // columns: threads per CTA, 8 columns each
constexpr int kUnroll = 4;         // columns: rows loaded before they are used

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// s1[b, j] = out1[b, j], s2[b, j] = dout1[b, j] (16 per row, rounded to T).
// grid (ceil(M / kSumWarps), 2): y = 0 reads x, y = 1 reads dout.
template <typename T>
__global__ void __launch_bounds__(kSumWarps * 32)
summaries_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                 const T* __restrict__ w1, const T* __restrict__ w2, float* __restrict__ s1,
                 float* __restrict__ s2, int64_t M, int P, int S) {
  const int lane = threadIdx.x % 32;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kSumWarps + threadIdx.x / 32;
  if (b >= M) return;  // a whole warp at once; no block barrier below
  if (blockIdx.y == 0) {
    const T* xr = x + b * kFast * P;
    const int vecs = P / 8;  // per block k
#pragma unroll
    for (int k = 0; k < kFast; ++k) {
      float a[kFast] = {0.f, 0.f, 0.f, 0.f};
      for (int v = lane; v < vecs; v += 32) {
        float xv[8];
        load8(xr + static_cast<int64_t>(k) * P + 8 * v, xv);
#pragma unroll
        for (int q = 0; q < kFast; ++q) {
          float wv[8];
          load8(w1 + static_cast<int64_t>(k * kFast + q) * P + 8 * v, wv);
#pragma unroll
          for (int e = 0; e < 8; ++e) a[q] += xv[e] * wv[e];
        }
      }
#pragma unroll
      for (int q = 0; q < kFast; ++q) {
        const float total = warp_sum(a[q]);
        if (lane == 0) s1[b * 16 + k * kFast + q] = to_f32(from_f32<T>(total));
      }
    }
  } else {
    const T* dr = dout + b * kFast * S;
    float a[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) a[j] = 0.f;
    for (int v = lane; v < S / 2; v += 32) {  // 8 columns: s = 2v, 2v+1; l = 0..3
      float dv[8];
      load8(dr + 8 * static_cast<int64_t>(v), dv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int l = e & 3, s = 2 * v + (e >> 2);
        float w[kFast];
        load4(w2 + (static_cast<int64_t>(l) * S + s) * kFast, w);  // w2[l, s, :]
#pragma unroll
        for (int r = 0; r < kFast; ++r) a[r * kFast + l] += dv[e] * w[r];
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float total = warp_sum(a[j]);
      if (lane == 0) s2[b * 16 + j] = to_f32(from_f32<T>(total));
    }
  }
}

// grid (x_ctas + d_ctas, groups): CTAs below x_ctas own 8 columns of x per
// thread (dx, dw1), the others 8 columns of dout (dw2); blockIdx.y is the
// row group.  part1/part2 receive the group's sums in the factors' layouts.
template <typename T, bool kDx>
__global__ void __launch_bounds__(kColThreads)
columns_kernel(const T* __restrict__ x, const T* __restrict__ dout, const T* __restrict__ w1,
               const T* __restrict__ w2, const float* __restrict__ s1,
               const float* __restrict__ s2, T* __restrict__ dx, float* __restrict__ part1,
               float* __restrict__ part2, int64_t M, int P, int S, int64_t rows_per_group,
               int x_ctas) {
  const int64_t g0 = static_cast<int64_t>(blockIdx.y) * rows_per_group;
  const int64_t g1 = g0 + rows_per_group < M ? g0 + rows_per_group : M;
  if (static_cast<int>(blockIdx.x) < x_ctas) {
    const int64_t n = static_cast<int64_t>(kFast) * P;
    const int v = blockIdx.x * kColThreads + threadIdx.x;
    if (v >= n / 8) return;
    const int c0 = 8 * v, k = c0 / P, p0 = c0 % P;  // P % 8 == 0: one block k
    float w[kFast][8], acc[kFast][8];
#pragma unroll
    for (int q = 0; q < kFast; ++q) {
      load8(w1 + static_cast<int64_t>(k * kFast + q) * P + p0, w[q]);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[q][e] = 0.f;
    }
    for (int64_t b0 = g0; b0 < g1; b0 += kUnroll) {
      float xv[kUnroll][8];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (b0 + u < g1) {
          load8(x + (b0 + u) * n + c0, xv[u]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) xv[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (b0 + u >= g1) break;
        float d[kFast];
        load4(s2 + (b0 + u) * 16 + k * kFast, d);  // dout1[b, k*Q + q]
        if constexpr (kDx) {
          float o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[e] = d[0] * w[0][e] + d[1] * w[1][e] + d[2] * w[2][e] + d[3] * w[3][e];
          store8(dx + (b0 + u) * n + c0, o);
        }
#pragma unroll
        for (int q = 0; q < kFast; ++q)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[q][e] += d[q] * xv[u][e];
      }
    }
    float* out = part1 + static_cast<int64_t>(blockIdx.y) * 16 * P;
#pragma unroll
    for (int q = 0; q < kFast; ++q) store8(out + static_cast<int64_t>(k * kFast + q) * P + p0, acc[q]);
  } else {
    const int64_t m = static_cast<int64_t>(kFast) * S;
    const int v = (blockIdx.x - x_ctas) * kColThreads + threadIdx.x;
    if (v >= m / 8) return;
    float acc[8][kFast];
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int r = 0; r < kFast; ++r) acc[e][r] = 0.f;
    for (int64_t b0 = g0; b0 < g1; b0 += kUnroll) {
      float dv[kUnroll][8];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (b0 + u < g1) {
          load8(dout + (b0 + u) * m + 8 * static_cast<int64_t>(v), dv[u]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) dv[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (b0 + u >= g1) break;
        float o1[16];  // out1[b, r*L + l]
#pragma unroll
        for (int i = 0; i < 4; ++i) load4(s1 + (b0 + u) * 16 + 4 * i, o1 + 4 * i);
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int r = 0; r < kFast; ++r) acc[e][r] += o1[r * kFast + (e & 3)] * dv[u][e];
      }
    }
    float* out = part2 + static_cast<int64_t>(blockIdx.y) * 16 * S;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int l = e & 3, s = 2 * v + (e >> 2);
      *reinterpret_cast<float4*>(out + (static_cast<int64_t>(l) * S + s) * kFast) =
          make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
    }
  }
}

// dw1[i] = sum_g part1[g * count1 + i], then dw2 likewise, in group order.
__global__ void sum_groups_kernel(const float* __restrict__ part1,
                                  const float* __restrict__ part2, float* __restrict__ dw1,
                                  float* __restrict__ dw2, int64_t count1, int64_t count2,
                                  int groups) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < count1 + count2; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const bool first = i < count1;
    const float* part = first ? part1 + i : part2 + (i - count1);
    const int64_t stride = first ? count1 : count2;
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += part[g * stride];
    if (first) {
      dw1[i] = acc;
    } else {
      dw2[i - count1] = acc;
    }
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

cudaError_t sum_groups(const float* part1, const float* part2, float* dw1, float* dw2,
                       int64_t count1, int64_t count2, int groups, cudaStream_t stream) {
  const int64_t need = ceil_div(count1 + count2, 256);
  const unsigned blocks = static_cast<unsigned>(need < 4096 ? need : 4096);
  sum_groups_kernel<<<blocks, 256, 0, stream>>>(part1, part2, dw1, dw2, count1, count2, groups);
  return cudaGetLastError();
}

int64_t smem_bytes(const Shape& sh) {
  const int64_t J = static_cast<int64_t>(sh.K) * sh.Q;
  return static_cast<int64_t>(sizeof(float)) *
         (sh.Q * sh.n_chunk + sh.R * sh.m_chunk + 2 * kTileRows * J);
}

// The plan of a generic launch: row groups, column chunks and their sizes.
Shape plan(int64_t M, int K, int Q, int P, int L, int S, int R, int itemsize, bool with_dx,
           int num_sms, int* groups, int* chunks) {
  Shape sh{M, K, Q, P, L, S, R, 0, 0, 0};
  const int64_t n = static_cast<int64_t>(K) * P, m = static_cast<int64_t>(S) * L;
  const int64_t J = static_cast<int64_t>(K) * Q;
  // Row groups: a group's partial (dw1 + dw2 in fp32, written once and read
  // once) should cost no more than 1/4 of its rows' own traffic.
  const int64_t row_bytes = (n * (with_dx ? 2 : 1) + m) * itemsize;
  const int64_t part_bytes = 2 * 4 * J * (P + S);
  int64_t g = (M * row_bytes) / (4 * part_bytes);
  const int64_t max_g = ceil_div(M, kTileRows);
  if (g > max_g) g = max_g;
  if (g > 2 * static_cast<int64_t>(num_sms)) g = 2 * static_cast<int64_t>(num_sms);
  if (g < 1) g = 1;
  sh.rows_per_group = ceil_div(ceil_div(M, g), kTileRows) * kTileRows;
  g = ceil_div(M, sh.rows_per_group);
  // Column chunks: enough CTAs to reach every SM (at most 4 chunks, since
  // each chunk recomputes its rows' summaries), and more where the
  // shared memory would not fit.
  int64_t c = ceil_div(num_sms, g);
  if (c > 4) c = 4;
  if (c < 1) c = 1;
  for (;; ++c) {
    sh.n_chunk = ceil_div(n, c);
    sh.m_chunk = ceil_div(m, c);
    if (smem_bytes(sh) <= kSmemBudget || (sh.n_chunk <= 1 && sh.m_chunk <= 1)) break;
  }
  *groups = static_cast<int>(g);
  *chunks = static_cast<int>(c);
  return sh;
}

struct FastPlan {
  int groups;
  int64_t rows_per_group;
  int x_ctas, d_ctas;
};

// Row groups so that the columns launch has about two CTAs per SM.
FastPlan fast_plan(int64_t M, int P, int S, int num_sms) {
  FastPlan fp;
  fp.x_ctas = static_cast<int>(ceil_div(static_cast<int64_t>(kFast) * P / 8, kColThreads));
  fp.d_ctas = static_cast<int>(ceil_div(static_cast<int64_t>(kFast) * S / 8, kColThreads));
  int64_t g = ceil_div(2 * static_cast<int64_t>(num_sms), fp.x_ctas + fp.d_ctas);
  const int64_t max_g = ceil_div(M, 4 * kUnroll);
  if (g > max_g) g = max_g;
  if (g < 1) g = 1;
  fp.rows_per_group = ceil_div(ceil_div(M, g), kUnroll) * kUnroll;
  fp.groups = static_cast<int>(ceil_div(M, fp.rows_per_group));
  return fp;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool fast_path(const void* x, const void* dout, const void* w1, const void* w2, const void* dx,
               int K, int Q, int P, int L, int S, int R) {
  return K == kFast && Q == kFast && L == kFast && R == kFast && P % 8 == 0 && S % 2 == 0 &&
         aligned16(x) && aligned16(dout) && aligned16(w1) && aligned16(w2) &&
         (dx == nullptr || aligned16(dx));
}

int device_sms(int device) {
  int num_sms = 0;
  if (cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  return num_sms;
}

// fp32 scratch a launch needs: the fast path's row summaries and the
// groups' partial sums (none with one group).
int64_t workspace_floats(bool fast, int64_t M, int K, int Q, int P, int L, int S, int R,
                         int itemsize, bool with_dx, int num_sms) {
  const int64_t J = static_cast<int64_t>(K) * Q;
  if (fast) {
    const FastPlan fp = fast_plan(M, P, S, num_sms);
    return 2 * M * J + (fp.groups > 1 ? fp.groups * J * (P + S) : 0);
  }
  int groups = 0, chunks = 0;
  plan(M, K, Q, P, L, S, R, itemsize, with_dx, num_sms, &groups, &chunks);
  return groups > 1 ? groups * J * (P + S) : 0;
}

template <typename T, bool kDx>
cudaError_t launch_fast(const void* x, const void* dout, const void* w1, const void* w2,
                        void* dx, float* work, float* dw1, float* dw2, int64_t M, int P, int S,
                        int num_sms, cudaStream_t stream) {
  const FastPlan fp = fast_plan(M, P, S, num_sms);
  float* s1 = work;
  float* s2 = work + M * 16;
  // With one group the columns launch writes the outputs directly.
  float* part1 = fp.groups > 1 ? work + 2 * M * 16 : dw1;
  float* part2 = fp.groups > 1 ? part1 + static_cast<int64_t>(fp.groups) * 16 * P : dw2;
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(dout);
  const T* w1t = static_cast<const T*>(w1);
  const T* w2t = static_cast<const T*>(w2);
  const dim3 sgrid(static_cast<unsigned>(ceil_div(M, kSumWarps)), 2);
  summaries_kernel<T><<<sgrid, kSumWarps * 32, 0, stream>>>(xt, dt, w1t, w2t, s1, s2, M, P, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 cgrid(static_cast<unsigned>(fp.x_ctas + fp.d_ctas), static_cast<unsigned>(fp.groups));
  columns_kernel<T, kDx><<<cgrid, kColThreads, 0, stream>>>(
      xt, dt, w1t, w2t, s1, s2, static_cast<T*>(dx), part1, part2, M, P, S, fp.rows_per_group,
      fp.x_ctas);
  err = cudaGetLastError();
  if (err != cudaSuccess || fp.groups == 1) return err;
  return sum_groups(part1, part2, dw1, dw2, 16LL * P, 16LL * S, fp.groups, stream);
}

template <typename T, bool kDx>
cudaError_t launch(const void* x, const void* dout, const void* w1, const void* w2, void* dx,
                   float* part1, float* part2, float* dw1, float* dw2, const Shape& sh,
                   int groups, int chunks, cudaStream_t stream) {
  const int64_t smem = smem_bytes(sh);
  if (smem > kSmemBudget) return cudaErrorInvalidValue;
  auto kernel = monarch_bwd_kernel<T, kDx>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // With one group the kernel writes the outputs directly.
  float* out1 = groups > 1 ? part1 : dw1;
  float* out2 = groups > 1 ? part2 : dw2;
  const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(chunks));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dout), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<T*>(dx), out1, out2, sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return err;
  const int64_t J = static_cast<int64_t>(sh.K) * sh.Q;
  return sum_groups(part1, part2, dw1, dw2, J * sh.P, J * sh.S, groups, stream);
}

template <typename T, bool kDx>
cudaError_t dispatch(bool fast, const void* x, const void* dout, const void* w1, const void* w2,
                     void* dx, float* work, float* dw1, float* dw2, int64_t M, int K, int Q,
                     int P, int L, int S, int R, int num_sms, cudaStream_t stream) {
  if (fast) return launch_fast<T, kDx>(x, dout, w1, w2, dx, work, dw1, dw2, M, P, S, num_sms,
                                       stream);
  int groups = 0, chunks = 0;
  const Shape sh = plan(M, K, Q, P, L, S, R, sizeof(T), kDx, num_sms, &groups, &chunks);
  const int64_t J = static_cast<int64_t>(K) * Q;
  float* part1 = work;
  float* part2 = groups > 1 ? work + static_cast<int64_t>(groups) * J * P : nullptr;
  return launch<T, kDx>(x, dout, w1, w2, dx, part1, part2, dw1, dw2, sh, groups, chunks,
                        stream);
}

}  // namespace

// fp32 elements of scratch a launch with these arguments needs (the binding
// allocates them and passes them as `work`); -1 on a CUDA error.
extern "C" int64_t smft_monarch_bwd_workspace(int dtype, int device, const void* x,
                                              const void* dout, const void* w1, const void* w2,
                                              const void* dx, int64_t M, int K, int Q, int P,
                                              int L, int S, int R) {
  const int num_sms = device_sms(device);
  if (num_sms == 0) return -1;
  const bool fast = fast_path(x, dout, w1, w2, dx, K, Q, P, L, S, R);
  return workspace_floats(fast, M, K, Q, P, L, S, R, dtype == 0 ? 4 : 2, dx != nullptr,
                          num_sms);
}

// dtype: 0 = float32, 1 = bfloat16.  `dx` null means K4 (no dx).  `work`
// holds smft_monarch_bwd_workspace(...) fp32 elements (null when that is 0).
// dw1 (K, Q, P) and dw2 (L, S, R) are fp32.  All tensors are contiguous on
// `device`; the binding checks that.  M > 0.  Returns the cudaError_t.
extern "C" int smft_monarch_bwd(int dtype, int device, const void* x, const void* dout,
                                const void* w1, const void* w2, void* dx, float* work,
                                float* dw1, float* dw2, int64_t M, int K, int Q, int P, int L,
                                int S, int R, void* stream) {
  // This library carries its own (static) CUDA runtime, whose current
  // device is not PyTorch's: set it to the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int num_sms = device_sms(device);
  if (num_sms == 0) return cudaErrorInvalidDevice;
  if (M <= 0) return cudaErrorInvalidValue;
  const bool fast = fast_path(x, dout, w1, w2, dx, K, Q, P, L, S, R);
  const int itemsize = dtype == 0 ? 4 : 2;
  if (workspace_floats(fast, M, K, Q, P, L, S, R, itemsize, dx != nullptr, num_sms) > 0 &&
      work == nullptr)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dx ? dispatch<float, true>(fast, x, dout, w1, w2, dx, work, dw1, dw2, M, K, Q, P, L,
                                      S, R, num_sms, s)
              : dispatch<float, false>(fast, x, dout, w1, w2, dx, work, dw1, dw2, M, K, Q, P,
                                       L, S, R, num_sms, s);
  }
  if (dtype == 1) {
    return dx ? dispatch<__nv_bfloat16, true>(fast, x, dout, w1, w2, dx, work, dw1, dw2, M, K,
                                              Q, P, L, S, R, num_sms, s)
              : dispatch<__nv_bfloat16, false>(fast, x, dout, w1, w2, dx, work, dw1, dw2, M,
                                               K, Q, P, L, S, R, num_sms, s);
  }
  return cudaErrorInvalidValue;
}
