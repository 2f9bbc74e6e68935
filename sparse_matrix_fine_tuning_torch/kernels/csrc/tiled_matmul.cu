// Tiled bf16 matrix product (K15) for Hopper, sm_90a:
//
//   y[i, j] = round_bf16( sum_k x[i, k] * w[k, j] ),   sum in fp32
//
// x (M, K) and w (K, N) bf16, row-major, as the JAX script's `x @ w`; y
// (M, N) bf16, rounded once to nearest even (as JAX's astype).
//
// Replaces the Pallas TPU kernel of scripts/exp_matmul_tiles.py:20 `make_mm`
// (pallas_call at :40), a tiled matmul with an fp32 VMEM accumulator whose
// tile (bm, bn, bk) is swept against XLA.  Here the tile is (BM, BN, S):
// BM x BN outputs, a k step of 64 and S stages of shared memory.  The TPU's
// tiles were sized for VMEM and are not carried over.
//
// What bounds it: operations.  At the bench shape, 2664 x 4096 -> 4096,
// 2*M*K*N = 89.4 GFLOP take 0.0904 ms at 989 TFLOP/s, the 77.2 MB 0.023 ms
// at 3.35 TB/s.  Only the warpgroup MMA (wgmma) reaches the tensor cores'
// full rate.  The kernel is persistent, so that a CTA's ring fill and
// epilogue are paid once and not once a tile:
//
//   * A cluster of kCluster CTAs takes a unit: kCluster neighbouring row
//     tiles by one column tile, one tile a CTA.  As many clusters as the
//     device holds at once (the occupancy API) walk the units c, c +
//     clusters, ... in groups of kGroupRows row tiles taken column after
//     column, so that the clusters at work share w's columns in L2.  (A
//     unit's row tile past the last, where the row tiles are odd, reads
//     zeros and stores nothing.)
//   * One ring of S stages in shared memory, each an x tile (BM x 64) and a
//     w tile (64 x BN), loaded by TMA in the 128-byte swizzle wgmma reads
//     without bank conflicts.  w's tile is the cluster's: each CTA loads
//     its share of the boxes and multicasts them to both, so w is read
//     from L2 once a unit; a stage is free again once the consumers of
//     every CTA in the cluster have released it.  One producer warp (one
//     thread) runs on into the next unit's k steps while the consumers
//     finish the current one: the ring fills once a CTA.
//   * BM / 64 consumer warpgroups: each waits for a full stage, issues four
//     wgmma m64nBNk16 (one per 16 of k) on its 64 rows, commits them, waits
//     for the previous stage's group and releases that stage, so one group
//     of MMAs stays in flight.
//   * The epilogue rounds the fp32 sums to bf16 into a staging buffer of its
//     own (64 x 64 boxes, 128-byte swizzled: a warp's 4-byte stores fall in
//     distinct banks) and stores it by TMA, which clips rows past M and
//     columns past N; the stores run while the next unit's MMAs start.
//     The staging holds the whole tile where it fits beside the ring, else
//     half its columns at a time (128 x 256 at 4 stages: 192 KB of ring and
//     32 KB of staging).
// Every output's k steps are summed in order by one CTA: a repeat gives the
// same bits.
// Measured and dropped (PERF.md §6): splitting the last partial
// wave's units along k over the idle SMs, as stream-K ranges and as
// chunks a wave in step, with fp32 partials summed by an owner: the
// partials' exchange cost more than the balance won.
// The producer is one warp, not a warpgroup, so that at BM = 128 (288
// threads) the BN = 256 consumers keep 128 fp32 accumulators without
// `setmaxnreg` (ptxas gives every thread 168 registers).
//
// Layouts.  x's tile is K-major: its descriptor steps 32 bytes a k16 inside
// the swizzled 128-byte rows, 8-row groups 1024 bytes apart (SBO).  w's
// tile lies N-major (w's N axis is contiguous, and it is not transposed:
// that would copy 33.6 MB a call), so the MMA takes B MN-major
// (imm-trans-b = 1): TMA lays it as 64-column boxes of 64 k-rows x 128
// bytes, 8 k-rows a swizzle atom (SBO 1024 bytes) and boxes 8192 bytes
// apart (LBO); a k16 step is 2048 bytes.  Rows past M, and k past K, come
// in as zeros from TMA.  The wrapper takes K and N multiples of 8 (TMA
// needs 16-byte row strides).
//
// The tensor maps are encoded on the host (hopper.cuh's make_map) and
// passed by value as __grid_constant__ kernel parameters; the mbarrier, TMA
// and wgmma helpers are hopper.cuh's too.  The C interface takes raw
// pointers and returns a cudaError_t; ops.cpp binds it.

#include <cuda.h>  // CUtensorMap and its enums: types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace smft_hopper;

constexpr int kBK = 64;          // k a stage: 64 bf16, one 128-byte swizzle row
constexpr int kAtomBytes = 1024;  // 8 rows of 128 bytes: the swizzle's period
constexpr int kBoxBytes = kBK * 64 * 2;  // a 64-column box of w's tile, or 64 x 64 of y's
constexpr int kSmemLimit = 232448;       // shared memory a CTA may take (227 KB)
constexpr int kGroupRows = 16;  // the rasterisation's group: row tiles, then the next column
constexpr int kCluster = 2;     // CTAs a cluster: neighbouring row tiles sharing w's tile

template <int BM, int BN, int S>
struct Tile {
  static_assert(BM % 64 == 0 && BN % 64 == 0 && (BN == 128 || BN == 256), "tile");
  static constexpr int kBM = BM, kBN = BN, kS = S;
  static constexpr int kConsumers = BM / 64;  // warpgroups, 64 rows each
  static constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
  static constexpr int kABytes = BM * kBK * 2;  // one stage of x
  static constexpr int kBBytes = kBK * BN * 2;  // one stage of w
  static constexpr int kRing = S * (kABytes + kBBytes);
  static constexpr int kBars = 2 * S * 8;  // a full and an empty barrier a stage
  // the epilogue's staged columns: the whole tile where it fits beside the
  // ring, else half of it at a time
  static constexpr int kOutCols =
      kRing + BM * BN * 2 + kBars + kAtomBytes <= kSmemLimit ? BN : BN / 2;
  static constexpr int kOutBytes = BM * kOutCols * 2;
  // the ring, the staging, the barriers, and slack to align the tiles on the
  // swizzle's period
  static constexpr int kSmem = kRing + kOutBytes + kBars + kAtomBytes;
  static_assert(kSmem <= kSmemLimit, "a tile must fit in 227 KB of shared memory");
};

// -- the schedule (host and device) --------------------------------------------

// A launch's static schedule, in units of kCluster row tiles by one column
// tile (one tile a CTA of the cluster): the tile counts and k steps, the
// units and the clusters that walk them (cluster c: units c, c + clusters,
// ...).
struct Sched {
  int m_tiles, n_tiles, k_steps, m_units, units, clusters;
};

__host__ __device__ inline int64_t cdiv64(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The schedule on at most `resident` clusters: one a unit up to that.
inline Sched make_sched(int64_t M, int64_t N, int64_t K, int BM, int BN, int resident) {
  Sched s{};
  s.m_tiles = static_cast<int>(cdiv64(M, BM));
  s.n_tiles = static_cast<int>(cdiv64(N, BN));
  s.k_steps = static_cast<int>(cdiv64(K, kBK));
  s.m_units = static_cast<int>(cdiv64(s.m_tiles, kCluster));
  s.units = s.m_units * s.n_tiles;
  s.clusters = s.units < resident ? s.units : resident;
  return s;
}

// (unit row, column tile) of unit u: groups of kGroupRows row tiles, column
// after column within a group.  CTA `rank` of the cluster takes row tile
// unit row * kCluster + rank.
__host__ __device__ inline void unit_coords(const Sched& s, int u, int& um, int& nt) {
  constexpr int kGroupUnits = kGroupRows / kCluster;
  const int per_group = kGroupUnits * s.n_tiles;
  const int g = u / per_group;
  const int first = g * kGroupUnits;
  const int rows = s.m_units - first < kGroupUnits ? s.m_units - first : kGroupUnits;
  const int within = u - g * per_group;
  um = first + within % rows;
  nt = within / rows;
}

// -- the kernel ----------------------------------------------------------------

template <int BN>
struct Wgmma;

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b) {
    wgmma_m64n128k16<1>(d, desc_a, desc_b);
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t desc_a,
                                             uint64_t desc_b) {
    wgmma_m64n256k16<1>(d, desc_a, desc_b);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A consumer warpgroup's named barrier (1 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// -- the cluster: its rank, a barrier of all its threads, an arrive on a
// peer's mbarrier, and a TMA load into every CTA's shared memory at once.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n barrier.cluster.wait.acquire.aligned;" :::
                   "memory");
}

// Arrives on the mbarrier at this CTA's shared address `bar` in CTA `rank`.
__device__ __forceinline__ void mbar_arrive_rank(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// tma_load_2d into `dst` of every CTA in `mask`, completing on each one's
// mbarrier at `bar`.
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

template <int BM, int BN, int S>
__global__ void __launch_bounds__(Tile<BM, BN, S>::kThreads, 1)
    tiled_mm_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_y, const Sched s, int M, int N) {
  using T = Tile<BM, BN, S>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtomBytes - 1) & ~static_cast<uint32_t>(kAtomBytes - 1);
  const uint32_t a_smem = base;                     // S stages of x's (BM x 64) tile
  const uint32_t b_smem = base + S * T::kABytes;    // S stages of w's (64 x BN) tile
  const uint32_t out_smem = base + T::kRing;        // the epilogue's staging
  const uint32_t bars = out_smem + T::kOutBytes;    // full[S], then empty[S]
  const int wg = threadIdx.x / 128;
  const int cl = blockIdx.x / kCluster;
  const int rank = kCluster > 1 ? static_cast<int>(cluster_rank()) : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(bars + 8 * st, 1);  // the producer's arrive + bytes
      // one arrive a consumer warpgroup of each CTA: a stage is free once
      // every CTA the w tile is multicast to has read it
      mbar_init(bars + 8 * (S + st), T::kConsumers * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers are set before a peer's load or arrive reaches them

  uint32_t it = 0;  // k steps through the ring so far
  if (wg == T::kConsumers) {
    // The producer warp; one thread issues every load, unit after unit:
    // x's tile for this CTA's rows, and its share of w's tile for the
    // whole cluster.
    if (threadIdx.x == 128 * T::kConsumers) {
      constexpr int kBoxes = BN / 64 / kCluster;  // w's boxes this CTA loads
      for (int u = cl; u < s.units; u += s.clusters) {
        int um, nt;
        unit_coords(s, u, um, nt);
        const int m0 = (um * kCluster + rank) * BM;
        for (int kt = 0; kt < s.k_steps; ++kt, ++it) {
          const int st = it % S;
          // the stage's previous k step must have been released by every CTA
          if (it >= S) wait_or_trap(bars + 8 * (S + st), ((it / S) - 1) & 1);
          const uint32_t full = bars + 8 * st;
          mbar_expect_tx(full, T::kABytes + T::kBBytes);
          const int k0 = kt * kBK;
          tma_load_2d(a_smem + st * T::kABytes, &map_x, full, k0, m0);
#pragma unroll
          for (int j = rank * kBoxes; j < (rank + 1) * kBoxes; ++j) {
            const uint32_t dst = b_smem + st * T::kBBytes + j * kBoxBytes;
            if constexpr (kCluster > 1) {
              tma_load_2d_multicast(dst, &map_w, full, nt * BN + 64 * j, k0,
                                    static_cast<uint16_t>((1u << kCluster) - 1));
            } else {
              tma_load_2d(dst, &map_w, full, nt * BN + 64 * j, k0);
            }
          }
        }
      }
    }
  } else {
    // A consumer warpgroup: rows 64 * wg .. + 63 of each tile.  The
    // fragment: warp w of the warpgroup holds rows 16w + lane/4 and +8;
    // acc[4j .. 4j+3] are columns 8j + 2*(lane%4) and +1 of those two rows.
    const int t = threadIdx.x % 128;
    const int r = (t / 32) * 16 + (t % 32) / 4;  // and r + 8: the same swizzle
    const uint32_t a_rows = a_smem + wg * 64 * 128;
    const uint32_t stage = out_smem + wg * 64 * T::kOutCols * 2;  // this warpgroup's rows
    uint8_t* const stagep = smem_raw + (stage - raw);
    float acc[BN / 2];
    for (int u = cl; u < s.units; u += s.clusters) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      fence_acc(acc);
      for (int kt = 0; kt < s.k_steps; ++kt, ++it) {
        const int st = it % S;
        wait_or_trap(bars + 8 * st, (it / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da = sw128_desc(a_rows + st * T::kABytes + kk * 32, 16, kAtomBytes);
          const uint64_t db =
              sw128_desc(b_smem + st * T::kBBytes + kk * 2048, kBoxBytes, kAtomBytes);
          Wgmma<BN>::run(acc, da, db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous k step's MMAs are done: release its stage
        if (kt > 0 && t < kCluster) mbar_arrive_rank(bars + 8 * (S + (it - 1) % S), t);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (t < kCluster) mbar_arrive_rank(bars + 8 * (S + (it - 1) % S), t);  // the last stage

      // The epilogue: kOutCols columns at a time through the staging, by TMA.
      int um, nt;
      unit_coords(s, u, um, nt);
      const int rows = (um * kCluster + rank) * BM + wg * 64;
#pragma unroll
      for (int h = 0; h < BN / T::kOutCols; ++h) {
        if (t == 0) tma_store_wait_read();  // the staging's last stores have read it
        warpgroup_sync(wg);
#pragma unroll
        for (int jj = 0; jj < T::kOutCols / 8; ++jj) {
          const int j = h * (T::kOutCols / 8) + jj;
          uint8_t* const at = stagep + (jj / 8) * kBoxBytes + r * 128 +
                              ((((jj % 8) ^ (r & 7)) << 4) | ((t % 4) << 2));
          *reinterpret_cast<uint32_t*>(at) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(at + 8 * 128) =
              pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
        }
        fence_proxy_async();
        warpgroup_sync(wg);
        if (t == 0 && rows < M) {
          for (int b = 0; b < T::kOutCols / 64; ++b) {
            const int col = nt * BN + h * T::kOutCols + 64 * b;
            if (col < N) tma_store_2d(&map_y, stage + b * kBoxBytes, col, rows);
          }
          tma_store_commit();
        }
      }
    }
    if (t == 0) tma_store_wait_read();  // the staging is read before the CTA leaves
  }
  // No CTA leaves while a peer may still multicast into it or arrive on its
  // barriers.
  cluster_sync();
}

// -- host side ------------------------------------------------------------------

// A launch of `clusters` clusters of kCluster CTAs.
template <int BM, int BN, int S>
cudaLaunchConfig_t cluster_config(int clusters, cudaStream_t stream, cudaLaunchAttribute* attr) {
  using T = Tile<BM, BN, S>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kCluster), 1, 1);
  cfg.blockDim = dim3(T::kThreads, 1, 1);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of the kernel the device holds at once, found once a device.
template <int BM, int BN, int S>
cudaError_t resident_clusters(int device, int* resident) {
  using T = Tile<BM, BN, S>;
  static int known[64] = {};
  if (device >= 0 && device < 64 && known[device] > 0) {
    *resident = known[device];
    return cudaSuccess;
  }
  auto kernel = tiled_mm_kernel<BM, BN, S>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<BM, BN, S>(1, nullptr, &attr);
  int clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  *resident = clusters;
  if (device >= 0 && device < 64) known[device] = clusters;
  return cudaSuccess;
}

// The plan of a call (tiled_matmul.PLAN_KEYS): resident CTAs, the grid's
// CTAs, CTAs a cluster, row, column and k tiles, units, staged output
// columns, shared memory a CTA.
constexpr int kPlanFields = 9;

template <int BM, int BN, int S>
cudaError_t plan(int device, int64_t M, int64_t N, int64_t K, int64_t* out) {
  using T = Tile<BM, BN, S>;
  int resident = 0;
  const cudaError_t err = resident_clusters<BM, BN, S>(device, &resident);
  if (err != cudaSuccess) return err;
  const Sched s = make_sched(M, N, K, BM, BN, resident);
  const int64_t v[kPlanFields] = {resident * kCluster, s.clusters * kCluster, kCluster,
                                  s.m_tiles, s.n_tiles, s.k_steps, s.units, T::kOutCols,
                                  T::kSmem};
  for (int i = 0; i < kPlanFields; ++i) out[i] = v[i];
  return cudaSuccess;
}

template <int BM, int BN, int S>
cudaError_t launch(int device, EncodeTiled encode, const void* x, const void* w, void* y,
                   int64_t M, int64_t N, int64_t K, cudaStream_t stream) {
  CUtensorMap map_x, map_w, map_y;
  if (!make_map(encode, &map_x, x, M, K, BM, kBK) || !make_map(encode, &map_w, w, K, N, kBK, 64) ||
      !make_map(encode, &map_y, y, M, N, 64, 64)) {
    return cudaErrorInvalidValue;
  }
  int resident = 0;
  cudaError_t err = resident_clusters<BM, BN, S>(device, &resident);
  if (err != cudaSuccess) return err;
  const Sched s = make_sched(M, N, K, BM, BN, resident);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<BM, BN, S>(s.clusters, stream, &attr);
  return cudaLaunchKernelEx(&cfg, tiled_mm_kernel<BM, BN, S>, map_x, map_w, map_y, s,
                            static_cast<int>(M), static_cast<int>(N));
}

// The tiles this library instantiates, by (bm, bn, stages): the Python
// wrapper's TILES.
template <typename F>
cudaError_t dispatch(int bm, int bn, int stages, F&& f) {
  switch (bm * 1000000 + bn * 1000 + stages) {
    case 64128004: return f(Tile<64, 128, 4>{});
    case 64256004: return f(Tile<64, 256, 4>{});
    case 128128004: return f(Tile<128, 128, 4>{});
    case 128128005: return f(Tile<128, 128, 5>{});
    case 128256003: return f(Tile<128, 256, 3>{});
    case 128256004: return f(Tile<128, 256, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y (M, N) = x (M, K) @ w (K, N), bf16, contiguous on `device`, at the tile
// (bm, bn, stages), one of the instantiations above (the Python wrapper's
// TILES).  The binding checks shapes, dtypes and alignment; M, N, K > 0,
// K % 8 == N % 8 == 0.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a tile that is not instantiated).
extern "C" int smft_tiled_matmul(int device, const void* x, const void* w, void* y, int64_t M,
                                 int64_t N, int64_t K, int bm, int bn, int stages,
                                 void* stream) {
  // This library carries its own (static) CUDA runtime, whose current
  // device is not PyTorch's: set it to the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  EncodeTiled encode = nullptr;
  err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(bm, bn, stages, [&](auto tile) {
    using T = decltype(tile);
    return launch<T::kBM, T::kBN, T::kS>(device, encode, x, w, y, M, N, K, s);
  });
}

// The plan of a call at (M, N, K) and the tile on `device`: the 9 fields of
// tiled_matmul.PLAN_KEYS into `out`.  Returns a cudaError_t
// (cudaErrorInvalidValue for a tile that is not instantiated).
extern "C" int smft_tiled_matmul_plan(int device, int64_t M, int64_t N, int64_t K, int bm, int bn,
                                      int stages, int64_t* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  return dispatch(bm, bn, stages, [&](auto tile) {
    using T = decltype(tile);
    return plan<T::kBM, T::kBN, T::kS>(device, M, N, K, out);
  });
}
