// Monarch forward (K1), Monarch forward with the residual add fused in
// (K2), and K1 at a chosen row tile (K12) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` and `_fwd_add_kernel` of
// sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py (:157-170), and
// `fwd_call` of scripts/exp_fwd_tile.py:21 (pallas_call at :31), K1's
// function with its row tile ts as a parameter, which took the expanded
// W1bd/W2hat.  It is written from the math, not carried over block by block:
//
//   x (B, n), n = K*P;  w1 (K, Q, P);  w2 (L, S, R), L*R = K*Q = J
//   out1[b, j]      = round_T( sum_p x[b, k*P + p] * w1[k, q, p] ),  j = k*Q + q
//   out[b, s*L + l] = sum_r out1[b, r*L + l] * w2[l, s, r]           (fp32)
//   K1: out = round_T(out)
//   K2: out = round_T(float(base[b, s*L + l]) + out)                 (add in fp32)
//
// T is the dtype of x (float or bf16); all sums are fp32.  The flat index
// j is read as (r, l) with l fastest: that is the butterfly interleave.
//
// What bounds it: device memory.  Per element of x the kernel does Q
// multiply-adds and per output element R, a few per byte read, far under
// the card's line of ~295 operations per byte.  So the design reads each
// row of x from device memory once per CTA, keeps the J-wide intermediate
// in shared memory (it never reaches device memory), and writes `out` with
// coalesced stores.  The TPU kernel's expanded permuted-dense weights
// (W1bd, W2hat) are not used: they cost K times the multiply-adds and only
// worked around Mosaic's lane relayout.
//
// Layout of the work:
//   grid.x: tiles of kRows rows of x; grid.y: chunks of output columns.
//   kRows is a template parameter: K1 and K2 launch at kDefaultRows = 8;
//   K12 (`smft_monarch_fwd_tile`) at 8, 16, 32 or 64, for the row-tile
//   sweep of exp_fwd_tile.  At 8 it is K1's instantiation, bit for bit.
//   Stage 1: one warp per (row, j) dot product of length P, lanes along p
//            (coalesced reads of x and w1), a warp-shuffle reduction, the
//            result rounded to T and kept as fp32 in shared memory.
//   Stage 2: one thread per output column, kRows fp32 accumulators in
//            registers; w2[l, s, :] is read once per column; each row's
//            store is coalesced across the warp.
// When there are few rows (decode), the columns are split over more CTAs
// so that the card has work; each such CTA recomputes stage 1 for its rows,
// which costs a reread of x from L2.
//
// The C interface below takes raw pointers and returns a cudaError_t, so
// this file needs no PyTorch header; ops.cpp binds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDefaultRows = 8;

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

template <typename T, bool kHasBase, int kRows>
__global__ void __launch_bounds__(kThreads)
monarch_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const T* __restrict__ w2, const T* __restrict__ base,
                   T* __restrict__ out, int64_t B, int K, int Q, int P, int L,
                   int S, int R, int64_t cols_per_cta) {
  extern __shared__ float out1[];  // [kRows][J], rounded to T, held as fp32
  const int J = K * Q;
  const int64_t n = static_cast<int64_t>(K) * P;
  const int64_t m = static_cast<int64_t>(S) * L;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int64_t rows_left = B - row0;
  const int rows = rows_left < kRows ? static_cast<int>(rows_left) : kRows;

  // Stage 1, over the tile's real rows only (the rows of out1 past them
  // are never read into a stored output).  The loop bound is the same for
  // every lane of a warp, so the shuffle below always has the full warp.
  for (int t = warp; t < rows * J; t += kWarps) {
    const int i = t / J;
    const int j = t % J;
    const int k = j / Q;
    const T* xr = x + (row0 + i) * n + static_cast<int64_t>(k) * P;
    const T* wr = w1 + static_cast<int64_t>(j) * P;  // w1[k, q, :]
    float acc = 0.f;
#pragma unroll 4
    for (int p = lane; p < P; p += 32) acc += to_f32(xr[p]) * to_f32(wr[p]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out1[i * J + j] = to_f32(from_f32<T>(acc));
  }
  __syncthreads();

  // Stage 2.
  const int64_t c_begin = static_cast<int64_t>(blockIdx.y) * cols_per_cta;
  const int64_t c_end = c_begin + cols_per_cta < m ? c_begin + cols_per_cta : m;
  for (int64_t c = c_begin + threadIdx.x; c < c_end; c += kThreads) {
    const int l = static_cast<int>(c % L);
    const int s = static_cast<int>(c / L);
    const T* w2r = w2 + (static_cast<int64_t>(l) * S + s) * R;  // w2[l, s, :]
    // K2: the base values are loaded first, so that their loads are in
    // flight during the multiply-adds instead of one after another.
    float acc[kRows], add[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      acc[i] = 0.f;
      add[i] = 0.f;
      if constexpr (kHasBase) {
        if (i < rows) add[i] = to_f32(base[(row0 + i) * m + c]);
      }
    }
    for (int r = 0; r < R; ++r) {
      const float w = to_f32(w2r[r]);
      const float* o1 = out1 + r * L + l;  // out1[:, r*L + l]
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] += o1[i * J] * w;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i < rows) out[(row0 + i) * m + c] = from_f32<T>(acc[i] + add[i]);
    }
  }
}

template <typename T, bool kHasBase, int kRows = kDefaultRows>
cudaError_t launch(const void* x, const void* w1, const void* w2, const void* base,
                   void* out, int64_t B, int K, int Q, int P, int L, int S, int R,
                   int num_sms, cudaStream_t stream) {
  const int64_t m = static_cast<int64_t>(S) * L;
  const int64_t row_tiles = (B + kRows - 1) / kRows;
  // Split the columns only as far as needed for about two CTAs per SM.
  const int64_t max_chunks = (m + kThreads - 1) / kThreads;
  int64_t chunks = (2 * static_cast<int64_t>(num_sms) + row_tiles - 1) / row_tiles;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks > 65535) chunks = 65535;
  if (chunks < 1) chunks = 1;
  const int64_t cols_per_cta = (m + chunks - 1) / chunks;
  if (row_tiles > 0x7fffffff) return cudaErrorInvalidValue;

  const size_t smem = sizeof(float) * kRows * K * Q;
  auto kernel = monarch_fwd_kernel<T, kHasBase, kRows>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(row_tiles), static_cast<unsigned>(chunks));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(base), static_cast<T*>(out), B, K, Q, P, L, S, R,
      cols_per_cta);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(int rows, const void* x, const void* w1, const void* w2, void* out,
                        int64_t B, int K, int Q, int P, int L, int S, int R, int num_sms,
                        cudaStream_t stream) {
  switch (rows) {
    case 8:
      return launch<T, false, 8>(x, w1, w2, nullptr, out, B, K, Q, P, L, S, R, num_sms, stream);
    case 16:
      return launch<T, false, 16>(x, w1, w2, nullptr, out, B, K, Q, P, L, S, R, num_sms, stream);
    case 32:
      return launch<T, false, 32>(x, w1, w2, nullptr, out, B, K, Q, P, L, S, R, num_sms, stream);
    case 64:
      return launch<T, false, 64>(x, w1, w2, nullptr, out, B, K, Q, P, L, S, R, num_sms, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `base` may be null (K1).  All tensors
// are contiguous on `device`; the binding checks that.  Returns the
// cudaError_t of the launch.
extern "C" int smft_monarch_fwd(int dtype, int device, const void* x, const void* w1,
                                const void* w2, const void* base, void* out, int64_t B,
                                int K, int Q, int P, int L, int S, int R, void* stream) {
  // This library carries its own (static) CUDA runtime, whose current
  // device is not PyTorch's: set it to the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int num_sms = 0;
  err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return base ? launch<float, true>(x, w1, w2, base, out, B, K, Q, P, L, S, R, num_sms, s)
                : launch<float, false>(x, w1, w2, base, out, B, K, Q, P, L, S, R, num_sms, s);
  }
  if (dtype == 1) {
    return base ? launch<__nv_bfloat16, true>(x, w1, w2, base, out, B, K, Q, P, L, S, R,
                                              num_sms, s)
                : launch<__nv_bfloat16, false>(x, w1, w2, base, out, B, K, Q, P, L, S, R,
                                               num_sms, s);
  }
  return cudaErrorInvalidValue;
}

// K12: K1 (no base) at the row tile `rows`, one of 8, 16, 32 and 64; the
// other arguments as smft_monarch_fwd's.  Returns cudaErrorInvalidValue for
// another row tile.
extern "C" int smft_monarch_fwd_tile(int dtype, int device, const void* x, const void* w1,
                                     const void* w2, void* out, int64_t B, int K, int Q, int P,
                                     int L, int S, int R, int rows, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int num_sms = 0;
  err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaSuccess;
  if (dtype == 0) {
    return launch_tile<float>(rows, x, w1, w2, out, B, K, Q, P, L, S, R, num_sms,
                              static_cast<cudaStream_t>(stream));
  }
  if (dtype == 1) {
    return launch_tile<__nv_bfloat16>(rows, x, w1, w2, out, B, K, Q, P, L, S, R, num_sms,
                                      static_cast<cudaStream_t>(stream));
  }
  return cudaErrorInvalidValue;
}
