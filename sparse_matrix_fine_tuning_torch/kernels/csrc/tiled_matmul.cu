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
// BM x BN outputs a CTA, a k step of 64 and S stages of shared memory.  The
// TPU's tiles were sized for VMEM and are not carried over.
//
// What bounds it: operations.  At the bench shape, 2664 x 4096 -> 4096,
// 2*M*K*N = 89.4 GFLOP take 0.0904 ms at 989 TFLOP/s, the 77.2 MB 0.023 ms
// at 3.35 TB/s.  Only the warpgroup MMA (wgmma) reaches the tensor cores'
// full rate, so the design is Hopper's:
//   * a ring of S stages in shared memory, each an x tile (BM x 64) and a w
//     tile (64 x BN), loaded by TMA in the 128-byte swizzle that wgmma
//     reads without bank conflicts;
//   * one producer warp: one thread waits for a stage to be empty, arms the
//     stage's full barrier with its byte count and issues the TMA loads;
//   * BM / 64 consumer warpgroups: each waits for a full stage, issues four
//     wgmma m64nBNk16 (one per 16 of k) on its 64 rows, commits them, waits
//     for the previous stage's group and releases that stage to the
//     producer, so one group of MMAs stays in flight;
//   * the epilogue rounds the fp32 accumulators (registers) to bf16 and
//     stores them straight from the wgmma fragment, rows past M and columns
//     past N masked.
// The producer is one warp, not a warpgroup, so that at BM = 128 (288
// threads) every thread may hold 224 registers: the BN = 256 consumers keep
// 128 fp32 accumulators without `setmaxnreg`.
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
// Waves: at BM = 128, BN = 256 the bench shape has 21 x 16 = 336 tiles on
// 132 SMs, about 2.5 waves; a persistent kernel would win the last partial
// wave back, and is left for later.
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
constexpr int kBoxBytes = kBK * 64 * 2;  // one 64-column box of w's tile

template <int BM, int BN, int S>
struct Tile {
  static_assert(BM % 64 == 0 && BN % 64 == 0 && (BN == 128 || BN == 256), "tile");
  static constexpr int kConsumers = BM / 64;  // warpgroups, 64 rows each
  static constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
  static constexpr int kABytes = BM * kBK * 2;  // one stage of x
  static constexpr int kBBytes = kBK * BN * 2;  // one stage of w
  // the stages, the full and empty barriers, and slack to align the tiles
  // on the swizzle's period
  static constexpr int kSmem = S * (kABytes + kBBytes) + 2 * S * 8 + kAtomBytes;
  static_assert(kSmem <= 232448, "a tile must fit in 227 KB of shared memory");
};

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

template <int BM, int BN, int S>
__global__ void __launch_bounds__(Tile<BM, BN, S>::kThreads, 1)
    tiled_mm_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w, __nv_bfloat16* __restrict__ y,
                    int M, int N, int K) {
  using T = Tile<BM, BN, S>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base =
      (smem_u32(smem_raw) + kAtomBytes - 1) & ~static_cast<uint32_t>(kAtomBytes - 1);
  const uint32_t a_smem = base;                   // S stages of x's (BM x 64) tile
  const uint32_t b_smem = base + S * T::kABytes;  // S stages of w's (64 x BN) tile
  const uint32_t bars = b_smem + S * T::kBBytes;  // full[S], then empty[S]
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int num_k = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);                   // the producer's arrive + bytes
      mbar_init(bars + 8 * (S + s), T::kConsumers);  // one arrive a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == T::kConsumers) {
    // The producer warp; one thread issues every load.
    if (threadIdx.x == 128 * T::kConsumers) {
      for (int kt = 0; kt < num_k; ++kt) {
        const int s = kt % S;
        // the stage's previous k tile must have been released
        if (kt >= S) mbar_wait(bars + 8 * (S + s), ((kt / S) - 1) & 1);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, T::kABytes + T::kBBytes);
        const int k0 = kt * kBK;
        tma_load_2d(a_smem + s * T::kABytes, &map_x, full, k0, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          tma_load_2d(b_smem + s * T::kBBytes + j * kBoxBytes, &map_w, full, n0 + 64 * j, k0);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows m0 + 64 * wg .. + 63 of the tile.
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);
  const uint32_t a_rows = a_smem + wg * 64 * 128;
  for (int kt = 0; kt < num_k; ++kt) {
    const int s = kt % S;
    mbar_wait(bars + 8 * s, (kt / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = sw128_desc(a_rows + s * T::kABytes + kk * 32, 16, kAtomBytes);
      const uint64_t db = sw128_desc(b_smem + s * T::kBBytes + kk * 2048, kBoxBytes, kAtomBytes);
      Wgmma<BN>::run(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous k tile's MMAs are done: release its stage
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(bars + 8 * (S + (kt - 1) % S));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // The fragment: warp w of the warpgroup holds rows 16w + lane/4 and +8;
  // acc[4j .. 4j+3] are columns 8j + 2*(lane%4) and +1 of those two rows.
  const int t = threadIdx.x % 128;
  const int row = m0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int col0 = n0 + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j;
    if (col < N) {
      // __floats2bfloat162_rn rounds each to nearest even, as __float2bfloat16
      if (row < M) {
        *reinterpret_cast<__nv_bfloat162*>(y + static_cast<int64_t>(row) * N + col) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      }
      if (row + 8 < M) {
        *reinterpret_cast<__nv_bfloat162*>(y + static_cast<int64_t>(row + 8) * N + col) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

template <int BM, int BN, int S>
cudaError_t launch(EncodeTiled encode, const void* x, const void* w, void* y, int64_t M,
                   int64_t N, int64_t K, cudaStream_t stream) {
  using T = Tile<BM, BN, S>;
  CUtensorMap map_x, map_w;
  if (!make_map(encode, &map_x, x, M, K, BM, kBK) || !make_map(encode, &map_w, w, K, N, kBK, 64)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = tiled_mm_kernel<BM, BN, S>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((N + BN - 1) / BN));
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(map_x, map_w, static_cast<__nv_bfloat16*>(y),
                                                  static_cast<int>(M), static_cast<int>(N),
                                                  static_cast<int>(K));
  return cudaGetLastError();
}

}  // namespace

// y (M, N) = x (M, K) @ w (K, N), bf16, contiguous on `device`, at the tile
// (bm, bn, stages), one of the instantiations below (the Python wrapper's
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
  const int tile = bm * 1000000 + bn * 1000 + stages;
  switch (tile) {
    case 64128004: return launch<64, 128, 4>(encode, x, w, y, M, N, K, s);
    case 64256004: return launch<64, 256, 4>(encode, x, w, y, M, N, K, s);
    case 128128004: return launch<128, 128, 4>(encode, x, w, y, M, N, K, s);
    case 128128005: return launch<128, 128, 5>(encode, x, w, y, M, N, K, s);
    case 128256003: return launch<128, 256, 3>(encode, x, w, y, M, N, K, s);
    case 128256004: return launch<128, 256, 4>(encode, x, w, y, M, N, K, s);
    default: return cudaErrorInvalidValue;
  }
}
