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
// The tensor maps are encoded on the host with libcuda's
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (this
// library carries its own static runtime and is not linked with -lcuda), and
// passed by value as __grid_constant__ kernel parameters.  The C interface
// takes raw pointers and returns a cudaError_t; ops.cpp binds it.

#include <cuda.h>  // CUtensorMap and its enums: types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2-D TMA load of the box at (c0 inner, c1 outer) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (all in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous MMAs' fences and waits.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int BN>
struct Wgmma;

template <>
struct Wgmma<128> {
  // m64n128k16, A K-major and B MN-major (imm-trans-b = 1), both from
  // shared memory through their descriptors; d += A B.
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  // m64n256k16, A K-major and B MN-major (imm-trans-b = 1), both from
  // shared memory through their descriptors; d += A B.
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127},"
        " %128, %129, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(desc_a), "l"(desc_b), "r"(1));
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The tensor map of a row-major bf16 (outer, inner) matrix read in boxes of
// (box_outer, box_inner), 128-byte swizzled; out-of-range elements read 0.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int64_t outer,
              int64_t inner, int box_outer, int box_inner) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
