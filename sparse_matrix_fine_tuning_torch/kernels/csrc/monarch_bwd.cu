// Monarch backward (K3) and the one-read factor-gradient pass (K4) for
// Hopper, sm_90a.
//
// K3 replaces the Pallas TPU kernel `_bwd_kernel` of
// sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py (:173-210, launcher
// :250-281); K4 replaces `_dw_only_kernel` (:364-397, launcher
// `monarch_dw_fused` :421-466).  K4 is K3 without dx: merged training's
// backward, whose dx goes through the merged dense operand instead.  K4's
// kernel with its row group set by the caller is K13 (`dw_kernel_v2` of
// scripts/exp_dw_kernel.py:24, whose sequence tile ts it takes) and, at
// 256 rows, K14 (`dw_call_v2` of scripts/exp_merged_v3.py:23).  Unlike those
// two TPU kernels it masks the rows past M (their last tile reads padding).
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
// per byte, so a design reads x and dout from device memory once each and
// keeps the two J-wide row summaries (out1, dout1) out of it.
//
// Two designs, chosen by shape alone (fast_shape):
//
// The cluster kernel (bwd_cluster_kernel), K = L = 4 (nblocks 4, every
// configuration of the repository), Q = R in {4, 8, 16}, P % 8 == 0, S
// even, 16-byte aligned tensors, and a plan that fits in shared memory.  A
// thread block cluster of kC = 4 CTAs owns a row group; CTA c keeps x's
// block k = c (P columns) and a slice of dout's columns (all l for Sc
// values of s).  A persistent grid (as many clusters as can be resident,
// cudaOccupancyMaxActiveClusters) walks the row groups; each cluster walks
// its groups' row tiles.  Per tile of `tile` rows:
//   copy:      warp 0 stages the tile's rows of x's block and of dout's
//              slice into shared memory with one cp.async.bulk a row each,
//              in a ring of `stages` stages on mbarriers, `stages` tiles
//              ahead: x and dout are read from device memory once.
//   summaries: CTA c computes out1 of block c (Q values a row, complete)
//              and its slice's partial sums of dout1 (all J values a row);
//              in bf16 on the tensor cores (mma.sync m16n8k16: out1 with
//              the rows as M, q as N (padded to 8) and p as K, the A
//              operand by ldmatrix; dout1 per l with s as K, the A operand
//              taken out of the interleave by byte permutes), the warps
//              splitting K and their partials added in warp order.
//   exchange:  each CTA stores its out1 into every CTA of the cluster and
//              each partial of dout1 into the CTA of its block, through
//              distributed shared memory; one cluster barrier; each CTA then
//              holds the cluster's out1 (all J values) and the four
//              partials of its block's dout1, which it adds in rank order
//              and rounds to T.  The receive buffers are double-buffered,
//              so one cluster barrier a tile is enough.
//   products:  from the staged tile, no second read of memory: dw1 of
//              block c (dw1^T = x^T dout1, p as M, the rows as K, ldmatrix
//              .trans), dw2 of the slice (per l, s as M, the rows as K),
//              each sum kept in shared memory in the mma fragments' own
//              order across the cluster's tiles; then dx of block c (K3:
//              m16n8k8, q as K) into the x tile's rows, and out in 16-byte
//              stores.  float32 takes the FMA pipe for every product, over
//              the same staged tiles and buffers.
// Each cluster writes one fp32 partial (its CTAs' blocks and slices); a
// second launch sums the clusters' partials in cluster order (with one
// cluster the kernel writes dw1 and dw2 itself).  Every sum's order depends
// on the shapes and the plan alone, so every run gives the same bits.
//
// The generic kernel (monarch_bwd_kernel), every other shape: each CTA owns
// a contiguous group of rows and sums its rows' contributions in shared
// memory (each thread owns its columns, so no atomics), then writes one
// fp32 partial per group; the same second pass sums the partials in group
// order.  The host picks the number of groups so that the partials'
// traffic stays under 1/4 of the main traffic, and splits the columns over
// up to 4 CTAs per group (each recomputing its rows' summaries, rereading
// them from L2) where the groups alone would leave SMs idle, and over more
// where the shared memory would not fit.  Its layout of one CTA (group g,
// column chunk c), per tile of kTileRows rows:
//   A: out1 of the tile, one warp per (row, j) dot of length P (lanes along
//      p, coalesced), a shuffle reduction, rounded to T, kept in shared memory;
//   B: dout1 of the tile, one warp per (row, j) dot of length S, likewise;
//   C: one thread per input column of the chunk: the tile's x column in
//      registers; for each q, the dw1 contribution summed over the tile into
//      shared memory and (K3) dx accumulated in registers, then stored;
//   D: one thread per output column of the chunk: the tile's dout column in
//      registers; for each r, the dw2 contribution into shared memory.
//
// Ragged rows: a tile's rows past M (or past its row group) are never
// loaded; their x and dout values enter the sums as zeros.
//
// The C interface takes raw pointers and returns a cudaError_t, so this
// file needs no PyTorch header; ops.cpp binds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

namespace {

// The generic kernel's block, row tile and shared-memory budget.
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
// The cluster kernel (see the head of the file).

constexpr int kC = 4;                 // CTAs a cluster: one a block of x (K = L = 4)
// Threads a CTA at blk_r q: 12 warps (ptxas fits them in the 168 registers
// that leaves, no spill), 8 at blk_r 16, whose dw sums and partials fill
// the shared memory at the 7B widths.
__host__ __device__ constexpr int fast_threads(int q) { return q == 16 ? 256 : 384; }
constexpr int kMaxTile = 32;          // rows a tile at most: one a lane of the copying warp
constexpr int kMaxStages = 3;
constexpr int64_t kSmemMax = 232448;  // 227 KB, the most a CTA may take on the H100

using bf16 = __nv_bfloat16;

// -- the device's primitives: shared-memory addresses, mbarriers, bulk
// copies, the cluster's barrier and shared memory, ldmatrix and mma.sync

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool bar_test(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// One contiguous copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Orders this thread's earlier shared-memory accesses before the bulk
// copies it issues next.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address of `p` (this CTA's shared memory) in CTA `rank` of the
// cluster, a generic pointer that plain stores write (before the cluster
// barrier, whose "memory" clobber keeps them ahead of it).
template <typename E>
__device__ __forceinline__ E* peer(E* p, uint32_t rank) {
  uint64_t out = 0;
  asm("mapa.u64 %0, %1, %2;" : "=l"(out) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<E*>(out);
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b: m16n8k16, bf16 in, fp32 sums.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: m16n8k8, bf16 in, fp32 sums.
__device__ __forceinline__ void mma1688(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// Wait for the phase of parity `parity`; a pipeline fault traps instead of
// hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0; !bar_test(bar, parity); ++polls)
    if (polls == (1u << 22)) __trap();
}

__device__ __forceinline__ uint32_t pack_bf16(unsigned short lo, unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__bfloat16_as_ushort(__float2bfloat16(lo)),
                   __bfloat16_as_ushort(__float2bfloat16(hi)));
}

// The bf16 pair of value l (0..3) of two interleaved rows: u and v each hold
// one s's four l values (l0 l1 | l2 l3); the result holds u's value of l
// low and v's high.
__device__ __forceinline__ uint32_t pick_l(uint2 u, uint2 v, int l) {
  const uint32_t a = l < 2 ? u.x : u.y, b = l < 2 ? v.x : v.y;
  return __byte_perm(a, b, (l & 1) ? 0x7632 : 0x5410);
}

// Where the sums of a (rows x cols) product live in shared memory: in the
// mma fragments' own order, tile by tile (16 rows x 8 columns), lane by
// lane, four values a lane (rows g, g + 8 and columns 2t, 2t + 1 of the
// tile, lane = 4g + t).  At Q = 4 the columns 4-7 of a tile are padding, so
// only the lanes with t < 2 keep theirs (kLanes = 16).
template <int Q>
struct Frag {
  static constexpr int kQp = Q < 8 ? 8 : Q;  // columns, padded to an mma tile
  static constexpr int kNt = kQp / 8;        // column tiles
  static constexpr int kLanes = Q == 4 ? 16 : 32;
  __host__ __device__ static int lane_slot(int g, int t) { return kLanes == 16 ? 2 * g + t : 4 * g + t; }
  // The slot of the four values of lane (g, t) in row tile mt, column tile nt.
  __device__ static int slot(int mt, int nt, int g, int t) {
    return ((mt * kNt + nt) * kLanes + lane_slot(g, t)) * 4;
  }
  // The element (row, col) of the sums.
  __device__ static int index(int row, int col) {
    const int rr = row & 15, cc = col & 7;
    return slot(row >> 4, col >> 3, rr & 7, cc >> 1) + ((rr >> 3) << 1) + (cc & 1);
  }
  // Floats of a product of `rows` rows (a multiple of 16).
  __host__ __device__ static int64_t floats(int64_t rows) { return rows / 16 * kNt * kLanes * 4; }
  __device__ static bool keeps(int t) { return kLanes == 32 || t < 2; }
};

struct FastParams {
  const void* x;
  const void* dout;
  const void* w1;
  const void* w2;
  void* dx;
  float* part1;  // (clusters, K, Q, P): each cluster's dw1 (dw1 itself with one cluster)
  float* part2;  // (clusters, L, S, R): likewise dw2
  int64_t M, rows_per_group;
  int P, S;
  int Sc;        // values of s a CTA's slice holds (the last slice may hold fewer)
  int tile, stages, groups, clusters;
  int xs, ds;    // bytes a staged row of x's block and of dout's slice takes
  int stage_bytes;
  int off_acc1, off_acc2, off_recv, off_work;  // byte offsets in shared memory
  int dw2_global;  // 1: dw2's sums live in part2 itself (too wide for shared memory)
};

// The row tiles cluster `cl` walks: its groups cl, cl + clusters, ... in
// order, each in tiles of `tile` rows; at(i) gives tile i's first row and
// rows (the last tile of a group, or of M, holds fewer).
struct TileWalk {
  int64_t M, rows_per_group;
  int tile, clusters, per_group;
  int cl;
  __device__ void at(int i, int64_t& t0, int& rows) const {
    const int64_t g = cl + static_cast<int64_t>(i / per_group) * clusters;
    const int64_t g0 = g * rows_per_group;
    const int64_t g1 = g0 + rows_per_group < M ? g0 + rows_per_group : M;
    t0 = g0 + static_cast<int64_t>(i % per_group) * tile;
    rows = g1 - t0 < tile ? static_cast<int>(g1 - t0) : tile;
  }
};

template <typename T, int Q, bool kDx>
__global__ void __launch_bounds__(fast_threads(Q), 1) bwd_cluster_kernel(const FastParams prm) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  constexpr int kFastThreads = fast_threads(Q), kFastWarps = kFastThreads / 32;
  constexpr int J = 4 * Q;
  using F = Frag<Q>;
  constexpr int kQp = F::kQp, kNt = F::kNt;
  constexpr int kKs = kFastWarps / kNt;  // chunks the summaries split K into
  extern __shared__ __align__(128) unsigned char cluster_smem[];
  unsigned char* smem = cluster_smem;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int c = blockIdx.x % kC;   // the CTA's rank: block c of x, slice c of dout
  const int cl = blockIdx.x / kC;  // the cluster
  const int P = prm.P, S = prm.S, TR = prm.tile;
  const int64_t n = 4 * static_cast<int64_t>(P), m = 4 * static_cast<int64_t>(S);
  const int s0 = c * prm.Sc < S ? c * prm.Sc : S;
  const int sl = (s0 + prm.Sc < S ? s0 + prm.Sc : S) - s0;  // s in [s0, s0 + sl)
  const T* x = static_cast<const T*>(prm.x);
  const T* dout = static_cast<const T*>(prm.dout);
  const T* w1c = static_cast<const T*>(prm.w1) + static_cast<int64_t>(c) * Q * P;  // w1[c]
  const T* w2 = static_cast<const T*>(prm.w2);
  T* dx = static_cast<T*>(prm.dx);

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* acc1 = reinterpret_cast<float*>(smem + prm.off_acc1);  // dw1^T of block c (P x Q)
  float* acc2 = reinterpret_cast<float*>(smem + prm.off_acc2);  // dw2 of the slice, per l (s x r)
  const int acc2_l = static_cast<int>(F::floats((prm.Sc + 15) / 16 * 16));  // floats an l
  // The cluster's dw2 (L, S, R); with dw2_global its slice holds the sums
  // across the tiles in place of acc2, each entry read and written by one
  // thread only.
  float* p2 = prm.part2 + static_cast<int64_t>(cl) * 4 * S * Q;
  const bool dw2_global = prm.dw2_global != 0;
  // What the cluster sends this CTA a tile, double-buffered: each rank's
  // partial dout1 of block c, [2][kC][tile][Q] in fp32, and out1 of every
  // block, [2][tile][J], already rounded to T.
  float* recv_d = reinterpret_cast<float*>(smem + prm.off_recv);
  T* recv_o = reinterpret_cast<T*>(recv_d + 2 * kC * TR * Q);
  unsigned char* work = smem + prm.off_work;
  // After the exchange: out1 (l, r, row), dout1 of block c (q, row) and (row, q).
  T* o1 = reinterpret_cast<T*>(work);
  T* d1c = o1 + 4 * kQp * TR;
  T* d1r = d1c + kQp * TR;
  // Before it (bf16): the warps' partial summaries, in fragment order.
  float* part_o = reinterpret_cast<float*>(work);
  float* part_d = part_o + TR / 16 * kFastWarps * 32 * 4;

  TileWalk walk{prm.M, prm.rows_per_group, TR, prm.clusters,
                static_cast<int>((prm.rows_per_group + TR - 1) / TR), cl};
  const int my_groups = (prm.groups - cl + prm.clusters - 1) / prm.clusters;
  int ntiles = 0;
  {
    const int64_t last = (cl + static_cast<int64_t>(my_groups - 1) * prm.clusters) *
                         prm.rows_per_group;
    const int64_t last_rows = prm.M - last < prm.rows_per_group ? prm.M - last
                                                                : prm.rows_per_group;
    ntiles = (my_groups - 1) * walk.per_group + static_cast<int>((last_rows + TR - 1) / TR);
  }

  const uint32_t xbytes = static_cast<uint32_t>(P) * sizeof(T);
  const uint32_t dbytes = static_cast<uint32_t>(sl) * 4 * sizeof(T);
  // Zero the sums, and the columns of the staged rows that the products
  // read past the copies' data (P up to a multiple of 16, the slice up to
  // Sc rounded to 16): they stay zero, as the copies write the data only.
  {
    float4* z = reinterpret_cast<float4*>(smem + prm.off_acc1);
    for (int i = tid; i < (prm.off_recv - prm.off_acc1) / 16; i += kFastThreads)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (dw2_global)
      for (int k = tid; k < 4 * sl * Q; k += kFastThreads)
        p2[(static_cast<int64_t>(k / (sl * Q)) * S + s0 + k / Q % sl) * Q + k % Q] = 0.f;
    const int xpad = (prm.xs / 16) - static_cast<int>(xbytes / 16);
    const int dpad = (prm.ds / 16) - static_cast<int>(dbytes / 16);
    for (int i = tid; i < prm.stages * TR * (xpad + dpad); i += kFastThreads) {
      const int row = i / (xpad + dpad), w = i % (xpad + dpad);
      unsigned char* xt = smem + 128 + (row / TR) * prm.stage_bytes + (row % TR) * prm.xs;
      float4* at = w < xpad ? reinterpret_cast<float4*>(xt + xbytes) + w
                            : reinterpret_cast<float4*>(xt + (TR - row % TR) * prm.xs +
                                                        (row % TR) * prm.ds + dbytes) +
                                  (w - xpad);
      *at = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (tid == 0) {
    for (int s = 0; s < prm.stages; ++s) bar_init(smem_addr(bars + s), 1);
    bar_fence_init();
  }
  fence_async_smem();  // the zeros before the copies into the same stages
  // Every CTA of the cluster runs before any writes into another's buffers.
  cluster_arrive();
  cluster_wait();

  // Warp 0 stages tile i: lane i copies row i of x's block and of the slice.
  auto issue = [&](int i) {
    int64_t t0;
    int rows;
    walk.at(i, t0, rows);
    const int st = i % prm.stages;
    const uint32_t bar = smem_addr(bars + st);
    unsigned char* xt = smem + 128 + st * prm.stage_bytes;
    unsigned char* dt = xt + TR * prm.xs;
    if (lane == 0) bar_expect(bar, static_cast<uint32_t>(rows) * (xbytes + dbytes));
    __syncwarp();
    if (lane < rows) {
      const int64_t b = t0 + lane;
      bulk_copy(smem_addr(xt + lane * prm.xs), x + b * n + static_cast<int64_t>(c) * P, xbytes,
                bar);
      if (dbytes)
        bulk_copy(smem_addr(dt + lane * prm.ds), dout + b * m + 4 * static_cast<int64_t>(s0),
                  dbytes, bar);
    }
  };
  if (warp == 0)
    for (int i = 0; i < prm.stages && i < ntiles; ++i) issue(i);

  for (int i = 0; i < ntiles; ++i) {
    int64_t t0;
    int rows;
    walk.at(i, t0, rows);
    const int st = i % prm.stages;
    unsigned char* xt = smem + 128 + st * prm.stage_bytes;
    unsigned char* dt = xt + TR * prm.xs;
    T* to_o = recv_o + (i & 1) * TR * J;  // this tile's buffers, here and in the peers
    float* to_d = recv_d + (i & 1) * kC * TR * Q;
    bar_wait(smem_addr(bars + st), (i / prm.stages) & 1);
    if (rows < TR) {  // rows past the group enter as zeros
      const int xw = prm.xs / 16, dw = prm.ds / 16;
      for (int k = tid; k < (TR - rows) * (xw + dw); k += kFastThreads) {
        const int r = rows + k / (xw + dw), w = k % (xw + dw);
        float4* row = w < xw ? reinterpret_cast<float4*>(xt + r * prm.xs) + w
                             : reinterpret_cast<float4*>(dt + r * prm.ds) + (w - xw);
        *row = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
    }

    // -- summaries: out1 of block c, to every CTA of the cluster, and the
    // slice's partials of dout1, each to the CTA of its block
    auto send_out1 = [&](int b, int q, float v) {
      const T vt = from_f32<T>(v);
#pragma unroll
      for (int rank = 0; rank < kC; ++rank) peer(to_o, rank)[b * J + c * Q + q] = vt;
    };
    auto send_dout1 = [&](int b, int j, float v) {  // j = r*4 + l = k*Q + q
      peer(to_d, j / Q)[(c * TR + b) * Q + j % Q] = v;
    };
    if constexpr (kMma) {
      // Warp w takes column tile w / kKs and chunk w % kKs of K (kKs chunks
      // of the K steps, the same at every row tile), for each 16-row tile
      // of the tile; the chunks' partials are added in chunk order, so the
      // sums do not depend on the tile's rows.
      const int nt = warp / kKs, ch = warp % kKs, mts = TR / 16;
      {  // out1 = x w1[c]^T: rows as M, q as N, p as K
        const int nks = (P + 15) / 16, k0 = ch * nks / kKs, k1 = (ch + 1) * nks / kKs;
        const int q = nt * 8 + g;
        const uint32_t* wq = reinterpret_cast<const uint32_t*>(w1c + static_cast<int64_t>(q) * P);
        const uint32_t a_row = smem_addr(xt + ((lane & 7) + 8 * ((lane >> 3) & 1)) * prm.xs) +
                               16 * (lane >> 4);
        float d[kMaxTile / 16][4] = {};
        for (int ks = k0; ks < k1; ++ks) {
          const int p = ks * 16 + 2 * t;
          const uint32_t b0 = q < Q && p < P ? __ldg(wq + p / 2) : 0u;
          const uint32_t b1 = q < Q && p + 8 < P ? __ldg(wq + p / 2 + 4) : 0u;
#pragma unroll
          for (int mt = 0; mt < kMaxTile / 16; ++mt) {
            if (mt < mts) {
              uint32_t a[4];
              ldsm4(a, a_row + 16 * mt * prm.xs + 32 * ks);
              mma16816(d[mt], a, b0, b1);
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < kMaxTile / 16; ++mt)
          if (mt < mts)
            *reinterpret_cast<float4*>(part_o + ((mt * kFastWarps + warp) * 32 + lane) * 4) =
                make_float4(d[mt][0], d[mt][1], d[mt][2], d[mt][3]);
      }
      {  // the slice's dout1 per l: rows as M, r as N, s as K
        const int nks = (sl + 15) / 16, k0 = ch * nks / kKs, k1 = (ch + 1) * nks / kKs;
        const int r = nt * 8 + g;
        const unsigned short* w2s = reinterpret_cast<const unsigned short*>(w2);
        float d[kMaxTile / 16][4][4] = {};
        for (int ks = k0; ks < k1; ++ks) {
          const int sr = ks * 16 + 2 * t;  // s (in the slice) of the pair a[0] holds
          uint32_t b[4][2] = {};
          if (r < Q) {
#pragma unroll
            for (int l = 0; l < 4; ++l) {
              const int64_t w = (static_cast<int64_t>(l) * S + s0 + sr) * Q + r;
              if (sr < sl) b[l][0] = pack_bf16(__ldg(w2s + w), __ldg(w2s + w + Q));
              if (sr + 8 < sl) b[l][1] = pack_bf16(__ldg(w2s + w + 8 * Q), __ldg(w2s + w + 9 * Q));
            }
          }
#pragma unroll
          for (int mt = 0; mt < kMaxTile / 16; ++mt) {
            if (mt < mts) {
              const unsigned char* row0 = dt + (mt * 16 + g) * prm.ds + 8 * sr;
              const unsigned char* row8 = row0 + 8 * prm.ds;
              const uint4 v0 = *reinterpret_cast<const uint4*>(row0);
              const uint4 v8 = *reinterpret_cast<const uint4*>(row8);
              const uint4 h0 = *reinterpret_cast<const uint4*>(row0 + 64);
              const uint4 h8 = *reinterpret_cast<const uint4*>(row8 + 64);
#pragma unroll
              for (int l = 0; l < 4; ++l) {
                const uint32_t a[4] = {
                    pick_l(make_uint2(v0.x, v0.y), make_uint2(v0.z, v0.w), l),
                    pick_l(make_uint2(v8.x, v8.y), make_uint2(v8.z, v8.w), l),
                    pick_l(make_uint2(h0.x, h0.y), make_uint2(h0.z, h0.w), l),
                    pick_l(make_uint2(h8.x, h8.y), make_uint2(h8.z, h8.w), l)};
                mma16816(d[mt][l], a, b[l][0], b[l][1]);
              }
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < kMaxTile / 16; ++mt)
          if (mt < mts)
#pragma unroll
            for (int l = 0; l < 4; ++l)
              *reinterpret_cast<float4*>(
                  part_d + (((mt * kFastWarps + warp) * 4 + l) * 32 + lane) * 4) =
                  make_float4(d[mt][l][0], d[mt][l][1], d[mt][l][2], d[mt][l][3]);
      }
      __syncthreads();
      // The chunks' partials in chunk order: out1 rounded to T, dout1's
      // partials as they are.
      const int units = mts * kNt;
      for (int k = tid; k < units * 128; k += kFastThreads) {
        const int mt = k / 128 / kNt, nu = k / 128 % kNt, ln = (k / 4) % 32, e = k % 4;
        float v = 0.f;
        for (int s = 0; s < kKs; ++s)
          v += part_o[((mt * kFastWarps + nu * kKs + s) * 32 + ln) * 4 + e];
        const int b = mt * 16 + ln / 4 + 8 * (e >> 1);
        const int q = nu * 8 + 2 * (ln % 4) + (e & 1);
        if (q < Q) send_out1(b, q, v);
      }
      for (int k = tid; k < units * 4 * 128; k += kFastThreads) {
        const int mt = k / 512 / kNt, nu = k / 512 % kNt, l = (k / 128) % 4;
        const int ln = (k / 4) % 32, e = k % 4;
        float v = 0.f;
        for (int s = 0; s < kKs; ++s)
          v += part_d[(((mt * kFastWarps + nu * kKs + s) * 4 + l) * 32 + ln) * 4 + e];
        const int b = mt * 16 + ln / 4 + 8 * (e >> 1);
        const int r = nu * 8 + 2 * (ln % 4) + (e & 1);
        if (r < Q) send_dout1(b, r * 4 + l, v);
      }
    } else {
      for (int k = tid; k < TR * Q; k += kFastThreads) {
        const int b = k / Q, q = k % Q;
        const T* xr = reinterpret_cast<const T*>(xt + b * prm.xs);
        const T* wr = w1c + static_cast<int64_t>(q) * P;
        float a = 0.f;
        for (int p = 0; p < P; ++p) a += to_f32(xr[p]) * to_f32(wr[p]);
        send_out1(b, q, a);
      }
      for (int k = tid; k < TR * J; k += kFastThreads) {
        const int b = k / J, j = k % J, r = j / 4, l = j % 4;
        const T* dr = reinterpret_cast<const T*>(dt + b * prm.ds);
        const T* wr = w2 + (static_cast<int64_t>(l) * S + s0) * Q + r;
        float a = 0.f;
        for (int s = 0; s < sl; ++s) a += to_f32(dr[4 * s + l]) * to_f32(wr[static_cast<int64_t>(s) * Q]);
        send_dout1(b, j, a);
      }
    }

    // -- the exchange: after the barrier this CTA holds the cluster's out1
    // and the four partials of block c's dout1, added in rank order and
    // rounded to T, into o1, d1c and d1r
    cluster_arrive();
    cluster_wait();
    for (int k = tid; k < 4 * kQp * TR; k += kFastThreads) {  // o1[l][r][b] = out1[b, r*4 + l]
      const int l = k / (kQp * TR), r = k / TR % kQp, b = k % TR;
      o1[k] = r < Q ? to_o[b * J + r * 4 + l] : from_f32<T>(0.f);
    }
    for (int k = tid; k < kQp * TR; k += kFastThreads) {  // d1c[q][b], d1r[b][q]
      const int q = k / TR, b = k % TR;
      float v = 0.f;
      if (q < Q) {
#pragma unroll
        for (int rank = 0; rank < kC; ++rank) v += to_d[(rank * TR + b) * Q + q];
      }
      const T vt = from_f32<T>(v);
      d1c[k] = vt;
      d1r[b * kQp + q] = vt;
    }
    __syncthreads();

    // -- the products from the staged tile
    if constexpr (kMma) {
      const int mts = TR / 16;
      // dw1^T[p][q] += sum_b x[b][p] dout1[b][q]: p as M, q as N, rows as K
      for (int mt = warp; mt < (P + 15) / 16; mt += kFastWarps) {
        float d[kNt][4];
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const float4 v = F::keeps(t) ? *reinterpret_cast<const float4*>(acc1 + F::slot(mt, nt, g, t))
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
          d[nt][0] = v.x; d[nt][1] = v.y; d[nt][2] = v.z; d[nt][3] = v.w;
        }
        const uint32_t a_col = smem_addr(xt + (lane & 7) * prm.xs + 8 * (lane >> 4) * prm.xs) +
                               2 * (mt * 16 + 8 * ((lane >> 3) & 1));
        for (int ks = 0; ks < mts; ++ks) {
          uint32_t a[4];
          ldsm4_t(a, a_col + 16 * ks * prm.xs);
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) {
            const T* bq = d1c + (nt * 8 + g) * TR + ks * 16 + 2 * t;
            mma16816(d[nt], a, *reinterpret_cast<const uint32_t*>(bq),
                     *reinterpret_cast<const uint32_t*>(bq + 8));
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
          if (F::keeps(t))
            *reinterpret_cast<float4*>(acc1 + F::slot(mt, nt, g, t)) =
                make_float4(d[nt][0], d[nt][1], d[nt][2], d[nt][3]);
      }
      // dw2[l][s][r] += sum_b dout[b][s*4 + l] out1[b][r*4 + l], per l: s as
      // M, r as N, rows as K
      for (int mt = warp; mt < (sl + 15) / 16; mt += kFastWarps) {
        float d[4][kNt][4];
        const int s = mt * 16 + g;  // the lane's rows s and s + 8 of the row tile
#pragma unroll
        for (int l = 0; l < 4; ++l)
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (F::keeps(t) && !dw2_global) {
              v = *reinterpret_cast<const float4*>(acc2 + l * acc2_l + F::slot(mt, nt, g, t));
            } else if (F::keeps(t)) {  // columns r, r + 1 of rows s, s + 8 of dw2[l]
              const float* at = p2 + (static_cast<int64_t>(l) * S + s0 + s) * Q + nt * 8 + 2 * t;
              if (s < sl) {
                const float2 a = *reinterpret_cast<const float2*>(at);
                v.x = a.x;
                v.y = a.y;
              }
              if (s + 8 < sl) {
                const float2 a = *reinterpret_cast<const float2*>(at + 8 * Q);
                v.z = a.x;
                v.w = a.y;
              }
            }
            d[l][nt][0] = v.x; d[l][nt][1] = v.y; d[l][nt][2] = v.z; d[l][nt][3] = v.w;
          }
        for (int ks = 0; ks < mts; ++ks) {
          // rows 2t, 2t + 1 (and + 8) of the tile, s = g (and g + 8) of the row tile
          const unsigned char* r0 = dt + (ks * 16 + 2 * t) * prm.ds + 8 * (mt * 16 + g);
          const unsigned char* r8 = r0 + 8 * prm.ds;
          const uint2 u00 = *reinterpret_cast<const uint2*>(r0);
          const uint2 u10 = *reinterpret_cast<const uint2*>(r0 + prm.ds);
          const uint2 u01 = *reinterpret_cast<const uint2*>(r0 + 64);
          const uint2 u11 = *reinterpret_cast<const uint2*>(r0 + prm.ds + 64);
          const uint2 v00 = *reinterpret_cast<const uint2*>(r8);
          const uint2 v10 = *reinterpret_cast<const uint2*>(r8 + prm.ds);
          const uint2 v01 = *reinterpret_cast<const uint2*>(r8 + 64);
          const uint2 v11 = *reinterpret_cast<const uint2*>(r8 + prm.ds + 64);
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const uint32_t a[4] = {pick_l(u00, u10, l), pick_l(u01, u11, l), pick_l(v00, v10, l),
                                   pick_l(v01, v11, l)};
#pragma unroll
            for (int nt = 0; nt < kNt; ++nt) {
              const T* bq = o1 + (l * kQp + nt * 8 + g) * TR + ks * 16 + 2 * t;
              mma16816(d[l][nt], a, *reinterpret_cast<const uint32_t*>(bq),
                       *reinterpret_cast<const uint32_t*>(bq + 8));
            }
          }
        }
#pragma unroll
        for (int l = 0; l < 4; ++l)
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) {
            if (F::keeps(t) && !dw2_global) {
              *reinterpret_cast<float4*>(acc2 + l * acc2_l + F::slot(mt, nt, g, t)) =
                  make_float4(d[l][nt][0], d[l][nt][1], d[l][nt][2], d[l][nt][3]);
            } else if (F::keeps(t)) {
              float* at = p2 + (static_cast<int64_t>(l) * S + s0 + s) * Q + nt * 8 + 2 * t;
              if (s < sl) *reinterpret_cast<float2*>(at) = make_float2(d[l][nt][0], d[l][nt][1]);
              if (s + 8 < sl)
                *reinterpret_cast<float2*>(at + 8 * Q) = make_float2(d[l][nt][2], d[l][nt][3]);
            }
          }
      }
      if constexpr (kDx) {
        // dx[b][p] = sum_q dout1[b][q] w1[c][q][p]: rows as M, p as N, q as
        // K, into the x tile's rows (dw1 has read them), then out in
        // coalesced 16-byte stores
        __syncthreads();
        const unsigned short* w1s = reinterpret_cast<const unsigned short*>(w1c);
        for (int nb = warp; nb < P / 8; nb += kFastWarps) {
          const int p = nb * 8 + g;
          uint32_t bq[kQp / 8];
#pragma unroll
          for (int kk = 0; kk < kQp / 8; ++kk) {
            const int q = kk * 8 + 2 * t;
            bq[kk] = q < Q ? pack_bf16(__ldg(w1s + static_cast<int64_t>(q) * P + p),
                                       __ldg(w1s + static_cast<int64_t>(q + 1) * P + p))
                           : 0u;
          }
          for (int mt = 0; mt < mts; ++mt) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kk = 0; kk < kQp / 8; ++kk) {
              const T* ar = d1r + (mt * 16 + g) * kQp + kk * 8 + 2 * t;
              mma1688(d, *reinterpret_cast<const uint32_t*>(ar),
                      *reinterpret_cast<const uint32_t*>(ar + 8 * kQp), bq[kk]);
            }
            unsigned char* row = xt + (mt * 16 + g) * prm.xs + 2 * (nb * 8 + 2 * t);
            *reinterpret_cast<uint32_t*>(row) = pack_f32(d[0], d[1]);
            *reinterpret_cast<uint32_t*>(row + 8 * prm.xs) = pack_f32(d[2], d[3]);
          }
        }
        __syncthreads();
        const int chunks = P / 8;  // 16-byte chunks a row
        for (int k = tid; k < rows * chunks; k += kFastThreads) {
          const int b = k / chunks, w = k % chunks;
          *reinterpret_cast<uint4*>(dx + (t0 + b) * n + static_cast<int64_t>(c) * P + 8 * w) =
              *reinterpret_cast<const uint4*>(xt + b * prm.xs + 16 * w);
        }
      }
    } else {
      for (int k = tid; k < Q * P; k += kFastThreads) {  // dw1
        const int q = k / P, p = k % P;
        float& a = acc1[F::index(p, q)];
        for (int b = 0; b < TR; ++b)
          a += to_f32(reinterpret_cast<const T*>(xt + b * prm.xs)[p]) * to_f32(d1c[q * TR + b]);
      }
      if constexpr (kDx) {
        for (int k = tid; k < rows * P; k += kFastThreads) {
          const int b = k / P, p = k % P;
          float a = 0.f;
          for (int q = 0; q < Q; ++q)
            a += to_f32(d1r[b * kQp + q]) * to_f32(w1c[static_cast<int64_t>(q) * P + p]);
          dx[(t0 + b) * n + static_cast<int64_t>(c) * P + p] = from_f32<T>(a);
        }
      }
      for (int k = tid; k < 4 * sl * Q; k += kFastThreads) {  // dw2
        const int l = k / (sl * Q), s = k / Q % sl, r = k % Q;
        float& a = dw2_global ? p2[(static_cast<int64_t>(l) * S + s0 + s) * Q + r]
                              : acc2[l * acc2_l + F::index(s, r)];
        for (int b = 0; b < TR; ++b)
          a += to_f32(reinterpret_cast<const T*>(dt + b * prm.ds)[4 * s + l]) *
               to_f32(o1[(l * kQp + r) * TR + b]);
      }
    }
    fence_async_smem();  // this tile's reads of stage st before the copy into it
    __syncthreads();     // stage st, o1, d1c and d1r are free
    if (warp == 0 && i + prm.stages < ntiles) issue(i + prm.stages);
  }

  // The cluster's sums: block c of dw1, the slice of dw2.
  float* p1 = prm.part1 + (static_cast<int64_t>(cl) * 4 + c) * Q * P;
  for (int k = tid; k < Q * P; k += kFastThreads) p1[k] = acc1[F::index(k % P, k / P)];
  for (int k = tid; k < 4 * sl * Q && !dw2_global; k += kFastThreads) {
    const int l = k / (sl * Q), s = k / Q % sl, r = k % Q;
    p2[(static_cast<int64_t>(l) * S + s0 + s) * Q + r] = acc2[l * acc2_l + F::index(s, r)];
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
    int g = 0;
    for (; g + 8 <= groups; g += 8) {  // eight loads in flight, added in order
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = part[(g + u) * stride];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += v[u];
    }
    for (; g < groups; ++g) acc += part[g * stride];
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
// rows > 0 sets the rows of a group; 0 lets the plan choose.
Shape plan(int64_t M, int K, int Q, int P, int L, int S, int R, int itemsize, bool with_dx,
           int64_t rows, int num_sms, int* groups, int* chunks) {
  Shape sh{M, K, Q, P, L, S, R, 0, 0, 0};
  const int64_t n = static_cast<int64_t>(K) * P, m = static_cast<int64_t>(S) * L;
  const int64_t J = static_cast<int64_t>(K) * Q;
  if (rows > 0) {
    sh.rows_per_group = rows;
  } else {
    // Row groups: a group's partial (dw1 + dw2 in fp32, written once and
    // read once) should cost no more than 1/4 of its rows' own traffic.
    const int64_t row_bytes = (n * (with_dx ? 2 : 1) + m) * itemsize;
    const int64_t part_bytes = 2 * 4 * J * (P + S);
    int64_t g = (M * row_bytes) / (4 * part_bytes);
    const int64_t max_g = ceil_div(M, kTileRows);
    if (g > max_g) g = max_g;
    if (g > 2 * static_cast<int64_t>(num_sms)) g = 2 * static_cast<int64_t>(num_sms);
    if (g < 1) g = 1;
    sh.rows_per_group = ceil_div(ceil_div(M, g), kTileRows) * kTileRows;
  }
  const int64_t g = ceil_div(M, sh.rows_per_group);
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

// -- the cluster kernel's plan and launch

// The plan of a launch on the cluster kernel: the row tile and stages, the
// row groups and the clusters that walk them, and the layout of a CTA's
// shared memory.
struct ClusterPlan {
  int tile = 0, stages = 0, groups = 0, clusters = 0;
  int64_t rows_per_group = 0;
  int Sc = 0, xs = 0, ds = 0, stage_bytes = 0;
  int off_acc1 = 0, off_acc2 = 0, off_recv = 0, off_work = 0;
  bool dw2_global = false;  // dw2's sums in the cluster's partial, not in shared memory
  int64_t smem = 0;
};

int64_t round_up(int64_t a, int64_t b) { return (a + b - 1) / b * b; }

// A staged row's bytes, rounded so that 8 rows at the same column fall in
// distinct 16-byte bank groups (an odd number of 16-byte units).
int odd16(int64_t bytes) {
  const int64_t s = round_up(bytes, 16);
  return static_cast<int>((s / 16) % 2 ? s : s + 16);
}

// Fill the layout of `fp` (tile and stages set); returns its bytes.
int64_t fast_layout(ClusterPlan& fp, int Q, int P, int S, int item) {
  const int qp = Q < 8 ? 8 : Q, J = 4 * Q;
  const int64_t lanes = Q == 4 ? 16 : 32, nt = qp / 8;
  fp.Sc = static_cast<int>(round_up(ceil_div(S, kC), 2));
  const int64_t p16 = round_up(P, 16), sc16 = round_up(fp.Sc, 16);
  fp.xs = odd16(p16 * item);
  fp.ds = odd16(sc16 * 4 * item);
  fp.stage_bytes = static_cast<int>(round_up(static_cast<int64_t>(fp.tile) * (fp.xs + fp.ds), 128));
  int64_t off = 128 + static_cast<int64_t>(fp.stages) * fp.stage_bytes;  // mbarriers, stages
  fp.off_acc1 = static_cast<int>(off);
  off += round_up(p16 / 16 * nt * lanes * 16, 128);
  fp.off_acc2 = static_cast<int>(off);
  if (!fp.dw2_global) off += round_up(4 * sc16 / 16 * nt * lanes * 16, 128);
  fp.off_recv = static_cast<int>(off);
  off += round_up(2 * static_cast<int64_t>(fp.tile) * (kC * Q * 4 + J * item), 128);  // recv
  fp.off_work = static_cast<int>(off);
  const int64_t sums = static_cast<int64_t>(6) * qp * fp.tile * item;  // o1, d1c, d1r
  const int64_t parts =
      item == 2 ? static_cast<int64_t>(fp.tile / 16) * fast_threads(Q) / 32 * 5 * 128 * 4 : 0;
  off += round_up(sums > parts ? sums : parts, 128);
  fp.smem = off;
  return off;
}

using FastKernel = void (*)(FastParams);

FastKernel fast_kernel(int itemsize, int Q, bool dx) {
  if (itemsize == 2) {
    switch (Q) {
      case 4: return dx ? bwd_cluster_kernel<bf16, 4, true> : bwd_cluster_kernel<bf16, 4, false>;
      case 8: return dx ? bwd_cluster_kernel<bf16, 8, true> : bwd_cluster_kernel<bf16, 8, false>;
      case 16: return dx ? bwd_cluster_kernel<bf16, 16, true> : bwd_cluster_kernel<bf16, 16, false>;
    }
  } else {
    switch (Q) {
      case 4: return dx ? bwd_cluster_kernel<float, 4, true> : bwd_cluster_kernel<float, 4, false>;
      case 8: return dx ? bwd_cluster_kernel<float, 8, true> : bwd_cluster_kernel<float, 8, false>;
      case 16: return dx ? bwd_cluster_kernel<float, 16, true> : bwd_cluster_kernel<float, 16, false>;
    }
  }
  return nullptr;
}

cudaLaunchConfig_t cluster_config(unsigned clusters, int threads, int64_t smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kC, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kC;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of `kernel` at `smem` bytes a CTA that the device holds at once
// (0 where none fits); remembered per device, kernel and size.
int max_clusters(int device, FastKernel kernel, int threads, int64_t smem) {
  struct Entry {
    int device;
    FastKernel kernel;
    int64_t smem;
    int clusters;
  };
  static Entry seen[64];
  static int count = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < count; ++i)
    if (seen[i].device == device && seen[i].kernel == kernel && seen[i].smem == smem)
      return seen[i].clusters;
  int clusters = 0;
  if (cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(64, threads, smem, nullptr, &attr);
    if (cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &cfg) !=
        cudaSuccess)
      clusters = 0;
  }
  cudaGetLastError();  // a refusal above is an answer, not a fault of the next launch
  if (count < 64) seen[count++] = {device, kernel, smem, clusters};
  return clusters;
}

// The (tile, stages) the plan tries, in order: the first that fits in
// shared memory is taken.  A larger tile first: a tile's fixed costs (its
// barriers, the summaries' partial sums, the exchange) weigh more than the
// depth of the ring, which the H100 hardly notices (PERF.md §6, the
// `--sweep` of scripts/compare_monarch_bwd.py).  Rows of 8 only for float32
// (the tensor cores' products take 16 rows at a time).
constexpr int kTiles[][2] = {{32, 3}, {32, 2}, {32, 1}, {16, 3}, {16, 2}, {16, 1}, {8, 2}, {8, 1}};

// The plan of a cluster launch; false where none fits (the shape takes the
// generic kernel).  rows > 0 sets the rows of a group (K13); tile and
// stages > 0 force those (the comparison script's sweep).
bool cluster_plan(int device, int itemsize, bool with_dx, int64_t M, int Q, int P, int S,
               int64_t rows, int tile, int stages, ClusterPlan* out) {
  const FastKernel kernel = fast_kernel(itemsize, Q, with_dx);
  if (kernel == nullptr) return false;
  auto fits = [&](int ts, int st, ClusterPlan& fp) {
    fp.tile = ts;
    fp.stages = st;
    return fast_layout(fp, Q, P, S, itemsize) <= kSmemMax &&
           (fp.clusters = max_clusters(device, kernel, fast_threads(Q), fp.smem)) > 0;
  };
  auto pick = [&](int64_t cap, ClusterPlan& fp) {
    for (const auto& ts : kTiles)
      if (ts[0] <= cap && (ts[0] >= 16 || itemsize == 4) && fits(ts[0], ts[1], fp)) return true;
    return false;
  };
  // The plan's own tile and stages set the row groups; a forced tile and
  // stages keep them, so that they change no sum's order.  Where no tile
  // fits with dw2's sums in shared memory, they go to the cluster's
  // partial in device memory (the same adds in the same order).
  ClusterPlan fp;
  if (!pick(rows > 0 ? rows : kMaxTile, fp)) {
    fp.dw2_global = true;
    if (!pick(rows > 0 ? rows : kMaxTile, fp)) return false;
  }
  if (rows > 0) {
    fp.rows_per_group = rows;
  } else {
    // One row group a cluster of the grid, at least 16 rows each.
    int64_t g = ceil_div(M, 16);
    if (g > fp.clusters) g = fp.clusters;
    fp.rows_per_group = round_up(ceil_div(M, g), 16);
    if (fp.rows_per_group < fp.tile && !pick(fp.rows_per_group, fp)) return false;
  }
  if ((tile > 0 || stages > 0) &&
      !((tile == 32 || tile == 16 || (tile == 8 && itemsize == 4)) && stages >= 1 &&
        stages <= kMaxStages && fits(tile, stages, fp)))
    return false;
  const int64_t groups = ceil_div(M, fp.rows_per_group);
  if (groups > INT32_MAX) return false;
  fp.groups = static_cast<int>(groups);
  fp.clusters = static_cast<int>(groups < fp.clusters ? groups : fp.clusters);
  *out = fp;
  return true;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool fast_shape(int K, int Q, int P, int L, int S, int R) {
  return K == kC && L == kC && Q == R && (Q == 4 || Q == 8 || Q == 16) && P % 8 == 0 &&
         S % 2 == 0;
}

bool fast_pointers(const void* x, const void* dout, const void* w1, const void* w2,
                   const void* dx) {
  return aligned16(x) && aligned16(dout) && aligned16(w1) && aligned16(w2) &&
         (dx == nullptr || aligned16(dx));
}

cudaError_t launch_cluster(const void* x, const void* dout, const void* w1, const void* w2,
                           void* dx, float* work, float* dw1, float* dw2, int64_t M, int Q, int P,
                           int S, int itemsize, const ClusterPlan& fp, cudaStream_t stream) {
  const FastKernel kernel = fast_kernel(itemsize, Q, dx != nullptr);
  const int64_t J = 4 * static_cast<int64_t>(Q);
  float* part1 = fp.clusters > 1 ? work : dw1;
  float* part2 = fp.clusters > 1 ? work + fp.clusters * J * P : dw2;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(fp.smem));
  if (err != cudaSuccess) return err;
  FastParams prm{x, dout, w1, w2, dx, part1, part2, M, fp.rows_per_group, P, S, fp.Sc,
                 fp.tile, fp.stages, fp.groups, fp.clusters, fp.xs, fp.ds, fp.stage_bytes,
                 fp.off_acc1, fp.off_acc2, fp.off_recv, fp.off_work, fp.dw2_global ? 1 : 0};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(static_cast<unsigned>(fp.clusters),
                                                fast_threads(Q), fp.smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, prm);
  if (err != cudaSuccess || fp.clusters == 1) return err;
  return sum_groups(part1, part2, dw1, dw2, J * P, J * S, fp.clusters, stream);
}

int device_sms(int device) {
  int num_sms = 0;
  if (cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  return num_sms;
}

// A launch's design and plan: the cluster kernel where the shape, the
// pointers and shared memory allow, else the generic kernel.
struct Launch {
  bool fast = false;
  ClusterPlan fp;
  Shape sh{};
  int groups = 0, chunks = 0;
};

Launch plan_launch(int device, int itemsize, bool with_dx, bool aligned, int64_t M, int K, int Q,
                   int P, int L, int S, int R, int64_t rows, int tile, int stages) {
  Launch ln;
  ln.fast = aligned && fast_shape(K, Q, P, L, S, R) &&
            cluster_plan(device, itemsize, with_dx, M, Q, P, S, rows, tile, stages, &ln.fp);
  if (ln.fast) {
    ln.groups = ln.fp.groups;
  } else {
    ln.sh = plan(M, K, Q, P, L, S, R, itemsize, with_dx, rows, device_sms(device), &ln.groups,
                 &ln.chunks);
  }
  return ln;
}

// fp32 scratch of a launch: the partial sums of the clusters or groups
// (none with one).
int64_t workspace_floats(const Launch& ln, int K, int Q, int P, int S) {
  const int64_t J = static_cast<int64_t>(K) * Q;
  const int64_t parts = ln.fast ? ln.fp.clusters : ln.groups;
  return parts > 1 ? parts * J * (P + S) : 0;
}

// Dispatch by design: the generic kernel at T.
template <typename T, bool kDx>
cudaError_t dispatch_generic(const Launch& ln, const void* x, const void* dout, const void* w1,
                             const void* w2, void* dx, float* work, float* dw1, float* dw2,
                             cudaStream_t stream) {
  const int64_t J = static_cast<int64_t>(ln.sh.K) * ln.sh.Q;
  float* part1 = work;
  float* part2 = ln.groups > 1 ? work + static_cast<int64_t>(ln.groups) * J * ln.sh.P : nullptr;
  return launch<T, kDx>(x, dout, w1, w2, dx, part1, part2, dw1, dw2, ln.sh, ln.groups, ln.chunks,
                        stream);
}

int run(int dtype, int device, const void* x, const void* dout, const void* w1, const void* w2,
        void* dx, float* work, float* dw1, float* dw2, int64_t M, int K, int Q, int P, int L, int S,
        int R, int64_t rows, int tile, int stages, void* stream) {
  // This library carries its own (static) CUDA runtime, whose current
  // device is not PyTorch's: set it to the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0 || rows < 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const int itemsize = dtype == 0 ? 4 : 2;
  const Launch ln = plan_launch(device, itemsize, dx != nullptr,
                                fast_pointers(x, dout, w1, w2, dx), M, K, Q, P, L, S, R, rows,
                                tile, stages);
  if ((tile > 0 || stages > 0) && !ln.fast) return cudaErrorInvalidValue;
  if (workspace_floats(ln, K, Q, P, S) > 0 && work == nullptr) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (ln.fast)
    return launch_cluster(x, dout, w1, w2, dx, work, dw1, dw2, M, Q, P, S, itemsize, ln.fp, s);
  if (ln.groups > 65535) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dx ? dispatch_generic<float, true>(ln, x, dout, w1, w2, dx, work, dw1, dw2, s)
              : dispatch_generic<float, false>(ln, x, dout, w1, w2, dx, work, dw1, dw2, s);
  return dx ? dispatch_generic<bf16, true>(ln, x, dout, w1, w2, dx, work, dw1, dw2, s)
            : dispatch_generic<bf16, false>(ln, x, dout, w1, w2, dx, work, dw1, dw2, s);
}

}  // namespace

// The plan of a launch with these shapes on 16-byte aligned tensors:
// *fast = 1 where it takes the cluster kernel, *groups its row groups.
// itemsize is 4 (float32) or 2 (bfloat16); rows_per_group 0 is the plan's
// own choice.  Returns the cudaError_t.
extern "C" int smft_monarch_bwd_plan(int itemsize, int device, int64_t M, int K, int Q, int P,
                                     int L, int S, int R, int64_t rows_per_group, int with_dx,
                                     int* fast, int* groups) {
  if (M <= 0 || rows_per_group < 0 || (itemsize != 2 && itemsize != 4))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Launch ln = plan_launch(device, itemsize, with_dx != 0, true, M, K, Q, P, L, S, R,
                                rows_per_group, 0, 0);
  *fast = ln.fast ? 1 : 0;
  *groups = ln.groups;
  return cudaSuccess;
}

// The cluster kernel's plan as 9 values (0 where the shape takes the
// generic kernel, whose groups still fill `groups`): fast, groups,
// clusters, rows a group, tile rows, stages, shared memory bytes a CTA,
// values of s a slice, and 1 where dw2's sums live in device memory.
// tile and stages > 0 force those.
extern "C" int smft_monarch_bwd_plan_fields(int itemsize, int device, int64_t M, int K, int Q,
                                            int P, int L, int S, int R, int64_t rows_per_group,
                                            int with_dx, int tile, int stages, int64_t* out) {
  if (M <= 0 || rows_per_group < 0 || (itemsize != 2 && itemsize != 4))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Launch ln = plan_launch(device, itemsize, with_dx != 0, true, M, K, Q, P, L, S, R,
                                rows_per_group, tile, stages);
  const ClusterPlan& fp = ln.fp;
  const int64_t fields[] = {ln.fast ? 1 : 0, ln.groups,         fp.clusters,
                            fp.rows_per_group, fp.tile,  fp.stages,
                            fp.smem,           fp.Sc,    fp.dw2_global ? 1 : 0};
  for (int i = 0; i < 9; ++i) out[i] = ln.fast ? fields[i] : (i == 1 ? ln.groups : 0);
  return cudaSuccess;
}

// fp32 elements of scratch a launch with these arguments needs (the binding
// allocates them and passes them as `work`); -1 on a CUDA error.
extern "C" int64_t smft_monarch_bwd_workspace(int dtype, int device, const void* x,
                                              const void* dout, const void* w1, const void* w2,
                                              const void* dx, int64_t M, int K, int Q, int P,
                                              int L, int S, int R, int64_t rows_per_group) {
  if (cudaSetDevice(device) != cudaSuccess || device_sms(device) == 0) return -1;
  if (M <= 0 || rows_per_group < 0) return 0;
  const Launch ln = plan_launch(device, dtype == 0 ? 4 : 2, dx != nullptr,
                                fast_pointers(x, dout, w1, w2, dx), M, K, Q, P, L, S, R,
                                rows_per_group, 0, 0);
  return workspace_floats(ln, K, Q, P, S);
}

// dtype: 0 = float32, 1 = bfloat16.  `dx` null means K4 (no dx).  `work`
// holds smft_monarch_bwd_workspace(...) fp32 elements (null when that is 0).
// dw1 (K, Q, P) and dw2 (L, S, R) are fp32.  rows_per_group: the rows of a
// row group (K13), or 0 for the plan's own (K3, K4).  All tensors are
// contiguous on `device`; the binding checks that.  M > 0.  Returns the
// cudaError_t.
extern "C" int smft_monarch_bwd(int dtype, int device, const void* x, const void* dout,
                                const void* w1, const void* w2, void* dx, float* work,
                                float* dw1, float* dw2, int64_t M, int K, int Q, int P, int L,
                                int S, int R, int64_t rows_per_group, void* stream) {
  return run(dtype, device, x, dout, w1, w2, dx, work, dw1, dw2, M, K, Q, P, L, S, R,
             rows_per_group, 0, 0, stream);
}

// smft_monarch_bwd on the cluster kernel at a forced row tile and stage
// depth (smft_monarch_bwd_plan_fields reports the plan and its scratch is
// the plan's clusters x J x (P + S) floats); cudaErrorInvalidValue where
// the shape does not take the cluster kernel or the forced plan does not
// fit.
extern "C" int smft_monarch_bwd_planned(int dtype, int device, const void* x, const void* dout,
                                        const void* w1, const void* w2, void* dx, float* work,
                                        float* dw1, float* dw2, int64_t M, int K, int Q, int P,
                                        int L, int S, int R, int64_t rows_per_group, int tile,
                                        int stages, void* stream) {
  if (tile <= 0 || stages <= 0) return cudaErrorInvalidValue;
  return run(dtype, device, x, dout, w1, w2, dx, work, dw1, dw2, M, K, Q, P, L, S, R,
             rows_per_group, tile, stages, stream);
}
