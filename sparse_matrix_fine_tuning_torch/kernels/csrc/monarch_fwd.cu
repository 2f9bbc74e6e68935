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
//   K2: out = round_T(out + float(base[b, s*L + l]))                 (add in fp32)
//
// T is the dtype of x (float or bf16); all sums are fp32.  The flat index
// j is read as (r, l) with l fastest: that is the butterfly interleave.
//
// What bounds it: device memory.  Per element of x the kernel does Q
// multiply-adds and per output element R, a few per byte moved, far under
// the card's line of ~295 operations per byte.  So every byte of x, base
// and out moves once, 16 bytes a thread at a time, and the J-wide
// intermediate stays in shared memory.  The TPU kernel's expanded
// permuted-dense weights (W1bd, W2hat) are not used: they cost K times the
// multiply-adds and only worked around Mosaic's lane relayout.
//
// One kernel, 256 threads a CTA.  A CTA owns a row tile of x (`rows`) and
// a range of output columns (`chunks` chunks of 16 bytes); the grid is row
// tiles x column ranges, and the plan (make_plan) picks both from M:
//   * decode (M <= 16): one row tile, the columns split so that the call is
//     one wave of small CTAs; each CTA's stage 1 is a few 16-byte loads a
//     thread from L2;
//   * prefill and training rows: row tiles of 4 or 8 rows, the columns split
//     less as M grows (none at a training micro-batch).
// Stage 1, out1 = x w1^T a block.  Block k's P elements are chunks of 16
// bytes; a segment is 32 lanes x `cpl` chunks of one block (cpl = 1 up to
// 64 chunks a block, so a block has at most 2 segments).  A warp takes a
// segment: each lane reads its chunks of x once (4 rows at a time) and of
// w1[k, q, :] for 4 q's at a time, 16 bytes a load with no branch between a
// step's loads and the next step's loads issued before this step's
// multiply-adds, and sums the 4 x 4 products in fp32 registers (FMA on the
// CUDA cores: at blk_r 4 that is about 13 TFLOP/s at the memory's rate);
// one reduce-scatter across the warp (16 shuffles) leaves each (row, q)
// sum in one lane pair, which writes it to shared memory.  The
// segments of a block are added in order, the sum rounded to T and kept as
// fp32, transposed to (l, r) so that stage 2 reads a column's R values
// with one 16-byte load.
// Stage 2: a thread owns 16 bytes of output columns (8 bf16 or 4 f32),
// keeps their w2 values in registers (L = 4 and R = 4, loaded before stage
// 1 so that the loads overlap it, or R = 16), and walks the tile's rows: R
// fused multiply-adds a column from out1 (shared memory, broadcast), base
// loaded 4 rows ahead and out stored 16 bytes at a time.
//
// The order of every sum depends on the shapes alone (the lanes' chunks,
// the warp's butterfly, the segments in order), never on the row tile or
// the column split: K12 at any row tile, and K1 at any plan, give the same
// bits.
//
// Edges, in the one kernel: rows past M, columns past m, P and m not
// multiples of 16 bytes, and x, w1, w2, base or out not on 16 bytes (a
// sliced view) take scalar loads and stores where a 16-byte access would
// not fit; the launch says which (vec_in, vec_out, vec_w2).  Any L, R other
// than L = 4 with R = 4 or 16 reads w2 through the cache at each use.
//
// The C interface below takes raw pointers and returns a cudaError_t, so
// this file needs no PyTorch header; ops.cpp binds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRB = 4;            // rows a stage-1 batch
constexpr int kQG = 4;            // q's a stage-1 group: kRB x kQG sums a lane
constexpr int kSegChunks = 64;    // chunks of a block before a lane takes more than one
constexpr int kDecodeRows = 16;   // M up to this: one row tile
constexpr int kDecodeChunks = 32; // output chunks a CTA at decode
constexpr int kSmemMax = 232448;  // 227 KB
// K12's row tiles (monarch_cuda.FWD_TILE_ROWS)
constexpr int kFwdTileRows[] = {8, 16, 32, 64};

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

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

__device__ __forceinline__ void unpack(const uint4 u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // each rounded as from_f32
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]), bf16x2(v[4], v[5]),
                    bf16x2(v[6], v[7]));
}

// Vec<T>::n elements at p as fp32, the first `valid` of them (the rest 0):
// one 16-byte load where `vec` (p on 16 bytes) and the chunk is whole.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, int valid, bool vec,
                                           float (&v)[Vec<T>::n]) {
  constexpr int N = Vec<T>::n;
  if (vec && valid >= N) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = e < valid ? to_f32(p[e]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* p, int valid, bool vec,
                                            const float (&v)[Vec<T>::n]) {
  constexpr int N = Vec<T>::n;
  if (vec && valid >= N) {
    *reinterpret_cast<uint4*>(p) = pack(v);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if (e < valid) p[e] = from_f32<T>(v[e]);
    }
  }
}

// One step of reduce16: lanes H apart swap half of their Nv values.
template <int H, int Nv>
__device__ __forceinline__ void reduce_step(float (&v)[16], int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < Nv; ++i) {
    const float send = up ? v[i] : v[i + Nv];
    const float keep = up ? v[i + Nv] : v[i];
    v[i] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, H);
  }
}

// The warp's sums of 16 values: lane pair (2i, 2i + 1) returns the sum over
// the 32 lanes of v[i].  A reduce-scatter (each step halves the values a
// lane keeps), 16 shuffles.  Every value is summed in the same butterfly
// (lanes 16 apart first, then 8, 4, 2, 1), whichever index it has.
__device__ __forceinline__ float reduce16(float (&v)[16], int lane) {
  reduce_step<16, 8>(v, lane);
  reduce_step<8, 4>(v, lane);
  reduce_step<4, 2>(v, lane);
  reduce_step<2, 1>(v, lane);
  return v[0] + __shfl_xor_sync(0xFFFFFFFFu, v[0], 1);
}

struct Params {
  const void* x;
  const void* w1;
  const void* w2;
  const void* base;  // K2; null for K1
  void* out;
  int64_t B, n, m;
  int K, Q, P, L, S, R, J;
  int rows;        // the row tile
  int cpl;         // chunks a lane of a segment
  int ns;          // segments a block
  int64_t chunks;  // output chunks (16 bytes) a CTA
  int vec_in;      // x and w1 on 16 bytes, P a whole number of chunks
  int vec_out;     // out (and base) on 16 bytes, m a whole number of chunks
  int vec_w2;      // w2 on 16 bytes
};

// Stage 1's unit of work, a task: a warp's segment sg, rows r0 .. r0 + 3
// of the tile and q's q0 .. q0 + 3, over the lane's cpl chunks.  A step is
// one chunk of a task.
struct Step {
  int sg, r0, q0, i;
};

// The raw 16-byte chunks of one step: x at kRB rows, w1 at kQG q's, and
// which of them are real (bit rr, bit kRB + qq); the others are loaded from
// a valid address and read as zeros.
struct Raw {
  uint4 x[kRB], w[kQG];
  uint32_t ok;
};

template <typename T>
__device__ __forceinline__ void load_step(const Params& p, const Step& st, int lane, int rows,
                                          int64_t row0, Raw& raw) {
  constexpr int N = Vec<T>::n;
  const T* x = static_cast<const T*>(p.x);
  const T* w1 = static_cast<const T*>(p.w1);
  const int k = st.sg / p.ns;
  const int pp = ((st.sg - k * p.ns) * 32 * p.cpl + lane + 32 * st.i) * N;
  const bool in = pp < p.P;
  raw.ok = 0;
#pragma unroll
  for (int rr = 0; rr < kRB; ++rr) {
    const bool ok = in && st.r0 + rr < rows;
    const T* src = ok ? x + (row0 + st.r0 + rr) * p.n + static_cast<int64_t>(k) * p.P + pp : x;
    raw.x[rr] = __ldg(reinterpret_cast<const uint4*>(src));
    raw.ok |= static_cast<uint32_t>(ok) << rr;
  }
#pragma unroll
  for (int qq = 0; qq < kQG; ++qq) {
    const bool ok = in && st.q0 + qq < p.Q;
    const T* src = ok ? w1 + (static_cast<int64_t>(k) * p.Q + st.q0 + qq) * p.P + pp : w1;
    raw.w[qq] = __ldg(reinterpret_cast<const uint4*>(src));
    raw.ok |= static_cast<uint32_t>(ok) << (kRB + qq);
  }
}

// acc[rr * kQG + qq] += x[rr] . w[qq] over the chunk's elements, in order.
template <typename T>
__device__ __forceinline__ void fma_step(const Raw& raw, float (&acc)[kRB * kQG]) {
  constexpr int N = Vec<T>::n;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  float xv[kRB][N], wv[kQG][N];
#pragma unroll
  for (int rr = 0; rr < kRB; ++rr) unpack((raw.ok >> rr) & 1 ? raw.x[rr] : zero, xv[rr]);
#pragma unroll
  for (int qq = 0; qq < kQG; ++qq) unpack((raw.ok >> (kRB + qq)) & 1 ? raw.w[qq] : zero, wv[qq]);
#pragma unroll
  for (int e = 0; e < N; ++e) {
#pragma unroll
    for (int rr = 0; rr < kRB; ++rr) {
#pragma unroll
      for (int qq = 0; qq < kQG; ++qq)
        acc[rr * kQG + qq] = fmaf(xv[rr][e], wv[qq][e], acc[rr * kQG + qq]);
    }
  }
}

// The task's sums, reduced across the warp, into part[sg][row][q].
__device__ __forceinline__ void store_task(const Params& p, const Step& st, int lane, int rows,
                                           float (&acc)[kRB * kQG], float* part) {
  const float s = reduce16(acc, lane);
  const int v = lane >> 1, rr = v / kQG, qq = v % kQG;
  if ((lane & 1) == 0 && st.r0 + rr < rows && st.q0 + qq < p.Q)
    part[(st.sg * p.rows + st.r0 + rr) * p.Q + st.q0 + qq] = s;
#pragma unroll
  for (int i = 0; i < kRB * kQG; ++i) acc[i] = 0.f;
}

// The step after `st`: the next chunk, else the task's next q group, row
// batch, or this warp's next segment (stride `seg_stride`).
__device__ __forceinline__ Step next_step(const Params& p, Step st, int rows, int seg_stride) {
  if (++st.i < p.cpl) return st;
  st.i = 0;
  if ((st.q0 += kQG) < p.Q) return st;
  st.q0 = 0;
  if ((st.r0 += kRB) < rows) return st;
  st.r0 = 0;
  st.sg += seg_stride;
  return st;
}

// Stage 1 with 16-byte loads (vec_in): the warp's steps in order, the next
// step's loads issued before the current step's multiply-adds, so that two
// steps' loads are in flight and no branch stands between a step's loads.
template <typename T>
__device__ __forceinline__ void stage1_vec(const Params& p, int sg0, int seg_stride, int lane,
                                           int rows, int64_t row0, float* part) {
  const int segs = p.K * p.ns;
  Step st{sg0, 0, 0, 0};
  if (st.sg >= segs || rows <= 0) return;
  float acc[kRB * kQG];
#pragma unroll
  for (int i = 0; i < kRB * kQG; ++i) acc[i] = 0.f;
  Raw cur, nxt;
  load_step<T>(p, st, lane, rows, row0, cur);
  while (true) {
    const Step ns = next_step(p, st, rows, seg_stride);
    const bool more = ns.sg < segs;
    if (more) load_step<T>(p, ns, lane, rows, row0, nxt);
    fma_step<T>(cur, acc);
    if (ns.i == 0) store_task(p, st, lane, rows, acc, part);
    if (!more) break;
    st = ns;
    cur = nxt;
  }
}

// Stage 1 with loads of any alignment (scalar where a chunk is not whole
// or not on 16 bytes): the same sums in the same order.
template <typename T>
__device__ __forceinline__ void stage1_any(const Params& p, int sg0, int seg_stride, int lane,
                                           int rows, int64_t row0, float* part) {
  constexpr int N = Vec<T>::n;
  const T* x = static_cast<const T*>(p.x);
  const T* w1 = static_cast<const T*>(p.w1);
  const int segs = p.K * p.ns;
  for (int sg = sg0; sg < segs; sg += seg_stride) {
    const int k = sg / p.ns;
    const int ch0 = (sg % p.ns) * 32 * p.cpl + lane;  // the lane's first chunk in block k
    const T* xk = x + (row0 * p.n + static_cast<int64_t>(k) * p.P);
    for (int r0 = 0; r0 < rows; r0 += kRB) {
      for (int q0 = 0; q0 < p.Q; q0 += kQG) {
        float acc[kRB * kQG];
#pragma unroll
        for (int i = 0; i < kRB * kQG; ++i) acc[i] = 0.f;
        for (int i = 0; i < p.cpl; ++i) {
          const int pp = (ch0 + 32 * i) * N;  // the chunk's first element in block k
          if (pp >= p.P) break;
          const int valid = p.P - pp < N ? p.P - pp : N;
          float xv[kRB][N];
#pragma unroll
          for (int rr = 0; rr < kRB; ++rr) {
            if (r0 + rr < rows) {
              load_chunk<T>(xk + static_cast<int64_t>(r0 + rr) * p.n + pp, valid, false, xv[rr]);
            } else {
#pragma unroll
              for (int e = 0; e < N; ++e) xv[rr][e] = 0.f;
            }
          }
#pragma unroll
          for (int qq = 0; qq < kQG; ++qq) {
            float wv[N];
            if (q0 + qq < p.Q) {
              load_chunk<T>(w1 + (static_cast<int64_t>(k) * p.Q + q0 + qq) * p.P + pp, valid,
                            false, wv);
            } else {
#pragma unroll
              for (int e = 0; e < N; ++e) wv[e] = 0.f;
            }
#pragma unroll
            for (int e = 0; e < N; ++e) {
#pragma unroll
              for (int rr = 0; rr < kRB; ++rr)
                acc[rr * kQG + qq] = fmaf(xv[rr][e], wv[e], acc[rr * kQG + qq]);
            }
          }
        }
        store_task(p, Step{sg, r0, q0, 0}, lane, rows, acc, part);
      }
    }
  }
}

// w2 of output chunk c when L = 4 and R = kR (4 or 16): column col = c N +
// e is (l, s) = (e % 4, col / 4), its kR values w2[l, s, :] contiguous,
// kept as raw words, 8 or 16 bytes at a time; columns past m, and every
// column where w2 is not on 16 bytes, are read element by element (zeros
// past m).
template <typename T, int kR>
struct W2Raw {
  static constexpr int kWords = kR * static_cast<int>(sizeof(T)) / 4;  // a column's
  uint32_t u[Vec<T>::n * kWords];
};

template <typename T, int kR>
__device__ __forceinline__ void load_w2(const Params& p, int64_t c, W2Raw<T, kR>& raw) {
  constexpr int N = Vec<T>::n, W = W2Raw<T, kR>::kWords;
  const T* w2 = static_cast<const T*>(p.w2);
  const bool whole = p.vec_w2 && (c + 1) * N <= p.m;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int64_t col = c * N + e;
    const T* src = w2 + (static_cast<int64_t>(e % 4) * p.S + col / 4) * kR;
    uint32_t* dst = raw.u + e * W;
    if (whole) {
      if constexpr (W == 2) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
        dst[0] = v.x, dst[1] = v.y;
      } else {
#pragma unroll
        for (int i = 0; i < W / 4; ++i) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + i);
          dst[4 * i] = v.x, dst[4 * i + 1] = v.y, dst[4 * i + 2] = v.z, dst[4 * i + 3] = v.w;
        }
      }
    } else {
      const bool in = col < p.m;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if constexpr (sizeof(T) == 2) {
          dst[i] = bf16x2(in ? to_f32(src[2 * i]) : 0.f, in ? to_f32(src[2 * i + 1]) : 0.f);
        } else {
          dst[i] = __float_as_uint(in ? to_f32(src[i]) : 0.f);
        }
      }
    }
  }
}

// Value r of column e of a chunk's raw w2.
template <typename T, int kR>
__device__ __forceinline__ float w2_at(const W2Raw<T, kR>& raw, int e, int r) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t w = raw.u[(e * kR + r) / 2];
    return __uint_as_float(r % 2 ? w & 0xFFFF0000u : w << 16);
  } else {
    return __uint_as_float(raw.u[e * kR + r]);
  }
}

// A chunk's w2 for stage 2's rows: fp32 registers at R = 4 (32 values),
// the raw words themselves at R = 16 (converted at each use: 128 fp32
// values would not fit beside the rest).
template <typename T, int kR, bool kF32 = (kR == 4)>
struct W2Regs;
template <typename T, int kR>
struct W2Regs<T, kR, true> {
  float w[Vec<T>::n][kR];
  __device__ __forceinline__ explicit W2Regs(const W2Raw<T, kR>& raw) {
#pragma unroll
    for (int e = 0; e < Vec<T>::n; ++e) {
#pragma unroll
      for (int r = 0; r < kR; ++r) w[e][r] = w2_at<T, kR>(raw, e, r);
    }
  }
  __device__ __forceinline__ float operator()(int e, int r) const { return w[e][r]; }
};
template <typename T, int kR>
struct W2Regs<T, kR, false> {
  W2Raw<T, kR> raw;
  __device__ __forceinline__ explicit W2Regs(const W2Raw<T, kR>& r) : raw(r) {}
  __device__ __forceinline__ float operator()(int e, int r) const {
    return w2_at<T, kR>(raw, e, r);
  }
};

// kR = 4 or 16: L = 4 and R = kR (nblocks 4 and blk_r 4, the adapters of the
// repository's configurations; and K12's rank-16 sweep), w2 in registers;
// kR = 0: any L and R, w2 read through the cache at each use.
template <typename T, bool kHasBase, int kR>
__global__ void __launch_bounds__(kThreads, 2) monarch_fwd_kernel(const Params p) {
  constexpr int N = Vec<T>::n;
  constexpr int kRr = kR > 0 ? kR : 4;  // the raw w2's R (unused where kR = 0)
  extern __shared__ float smem[];
  const T* __restrict__ w2 = static_cast<const T*>(p.w2);
  const T* __restrict__ base = static_cast<const T*>(p.base);
  T* __restrict__ out = static_cast<T*>(p.out);
  const int J = p.J;
  float* const o1t = smem;                  // [rows][J]: out1 at (l, r), as l * R + r
  float* const part = smem + p.rows * J;    // [K * ns][rows][Q]: each segment's sums
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * p.rows;
  const int rows = static_cast<int>(p.B - row0 < p.rows ? p.B - row0 : p.rows);

  // Stage 2's layout: `tcols` threads along the CTA's chunks, the rest of
  // the CTA along its rows.  At R = 4 a thread's first chunk's w2, and for
  // K2 the base chunk of its first row (all of a decode call's base), are
  // loaded now, so that stage 2 waits for no load.
  const int64_t total = (p.m + N - 1) / N;
  const int64_t c_lo = static_cast<int64_t>(blockIdx.y) * p.chunks;
  const int64_t c_hi = c_lo + p.chunks < total ? c_lo + p.chunks : total;
  int tcols = 32;
  while (tcols < kThreads && tcols < c_hi - c_lo) tcols *= 2;
  const int groups = kThreads / tcols;
  int64_t c = c_lo + tid % tcols;
  const int rg = tid / tcols;
  W2Raw<T, kRr> w2raw;
  const bool pre = kHasBase && kR == 4 && p.vec_out && c < c_hi && rg < rows &&
                   (c + 1) * N <= p.m;
  uint4 b0;
  if constexpr (kR == 4) {
    if (c < c_hi) load_w2<T, kR>(p, c, w2raw);
    if (pre) {
      b0 = __ldg(reinterpret_cast<const uint4*>(static_cast<const T*>(p.base) +
                                                (row0 + rg) * p.m + c * N));
    }
  }

  // Stage 1: the segments, a warp each.
  if (p.vec_in) {
    stage1_vec<T>(p, warp, kWarps, lane, rows, row0, part);
  } else {
    stage1_any<T>(p, warp, kWarps, lane, rows, row0, part);
  }
  __syncthreads();
  // The segments of each block in order; out1 rounded to T, transposed.
  const int Jc = kR > 0 ? 4 * kR : J, Lc = kR > 0 ? 4 : p.L;
  for (int idx = tid; idx < rows * Jc; idx += kThreads) {
    const int row = idx / Jc, j = idx % Jc, k = j / p.Q, q = j - k * p.Q;
    const float* src = part + (k * p.ns * p.rows + row) * p.Q + q;
    float t = src[0];
    for (int s = 1; s < p.ns; ++s) t += src[s * p.rows * p.Q];
    o1t[row * Jc + (j % Lc) * p.R + j / Lc] = to_f32(from_f32<T>(t));
  }
  __syncthreads();

  // Stage 2.
  bool first = true;
  for (; c < c_hi; c += tcols, first = false) {
    const int64_t col0 = c * N;
    const int valid = static_cast<int>(p.m - col0 < N ? p.m - col0 : N);
    if constexpr (kR > 0) {
      if constexpr (kR != 4) load_w2<T, kR>(p, c, w2raw);
      const W2Regs<T, kR> wr(w2raw);
      if constexpr (kR == 4) {
        if (c + tcols < c_hi) load_w2<T, kR>(p, c + tcols, w2raw);  // the next chunk's
      }
      // Rows in groups of kPre: their base chunks loaded first, then each
      // row's products, add and store (one row at a time at R = 16, whose
      // raw w2 takes 64 registers).
      constexpr int kPre = kR == 4 ? 4 : 1;
      for (int rb = rg; rb < rows; rb += kPre * groups) {
        uint4 braw[kPre];
        if constexpr (kHasBase) {
          if (p.vec_out && valid == N) {
#pragma unroll
            for (int t = 0; t < kPre; ++t) {
              const int row = rb + t * groups;
              if (t == 0 && first && rb == rg && pre) {
                braw[t] = b0;
              } else if (row < rows) {
                braw[t] = __ldg(reinterpret_cast<const uint4*>(base + (row0 + row) * p.m + col0));
              }
            }
          }
        }
#pragma unroll
        for (int t = 0; t < kPre; ++t) {
          const int row = rb + t * groups;
          if (row >= rows) break;
          float acc[N];
#pragma unroll
          for (int e = 0; e < N; ++e) acc[e] = 0.f;
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const float4* o = reinterpret_cast<const float4*>(o1t + row * Jc + l * kR);
            float ov[kR];
#pragma unroll
            for (int i = 0; i < kR / 4; ++i) {
              const float4 f = o[i];
              ov[4 * i] = f.x, ov[4 * i + 1] = f.y, ov[4 * i + 2] = f.z, ov[4 * i + 3] = f.w;
            }
#pragma unroll
            for (int e = l; e < N; e += 4) {
#pragma unroll
              for (int r = 0; r < kR; ++r) acc[e] = fmaf(ov[r], wr(e, r), acc[e]);
            }
          }
          const int64_t at = (row0 + row) * p.m + col0;
          if constexpr (kHasBase) {
            float bv[N];
            if (p.vec_out && valid == N) {
              unpack(braw[t], bv);
            } else {
              load_chunk<T>(base + at, valid, false, bv);
            }
#pragma unroll
            for (int e = 0; e < N; ++e) acc[e] += bv[e];
          }
          store_chunk<T>(out + at, valid, p.vec_out, acc);
        }
      }
    } else {
      int o_at[N];
      int64_t w_at[N];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int64_t col = col0 + e < p.m ? col0 + e : p.m - 1;
        o_at[e] = static_cast<int>(col % p.L) * p.R;
        w_at[e] = ((col % p.L) * p.S + col / p.L) * p.R;
      }
      for (int row = rg; row < rows; row += groups) {
        const float* o = o1t + row * J;
        float acc[N];
#pragma unroll
        for (int e = 0; e < N; ++e) {
          acc[e] = 0.f;
          if (e < valid) {
            for (int r = 0; r < p.R; ++r)
              acc[e] = fmaf(o[o_at[e] + r], to_f32(w2[w_at[e] + r]), acc[e]);
          }
        }
        const int64_t at = (row0 + row) * p.m + col0;
        if constexpr (kHasBase) {
          float bv[N];
          load_chunk<T>(base + at, valid, p.vec_out, bv);
#pragma unroll
          for (int e = 0; e < N; ++e) acc[e] += bv[e];
        }
        store_chunk<T>(out + at, valid, p.vec_out, acc);
      }
    }
  }
}

// The launch floor: no work, at the kernel's grid, threads and shared
// memory (scripts/compare_monarch_fwd.py times it).
__global__ void monarch_fwd_empty_kernel(const Params) {}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// A launch's plan.  `rows` and `chunks` are forced where > 0 (K12 forces
// the row tile; scripts/compare_monarch_fwd.py --sweep either), else picked
// from M (scripts/compare_monarch_fwd.py --sweep, PERF.md §6):
//   M <= 16:    one row tile of M rows, kDecodeChunks output chunks a CTA;
//   M < 128:    tiles of 4 rows, 64 chunks a CTA;
//   M < 1024:   tiles of 4 rows, 256 chunks a CTA (a chunk a thread);
//   M >= 1024:  tiles of 8 rows, all the columns a CTA.
// A CTA reads all of w1 and its range's w2 from L2 whatever its rows, and
// each column range repeats stage 1: the tiles grow and the ranges shrink
// with M as far as the row tiles alone fill the card.  A picked row tile
// whose shared memory would not fit is halved until it does (a wide J);
// a forced one is refused.  cpl and ns depend on P alone (they set the
// order of stage 1's sums).
struct Plan {
  int rows, cpl, ns;
  int64_t row_tiles, ranges, chunks;
  size_t smem;
};

cudaError_t make_plan(int itemsize, int64_t B, int K, int Q, int P, int L, int S, int R,
                      int rows, int64_t chunks, Plan* out) {
  if ((itemsize != 2 && itemsize != 4) || B < 0 || rows < 0 || chunks < 0)
    return cudaErrorInvalidValue;
  const int N = 16 / itemsize;
  const int64_t m = static_cast<int64_t>(S) * L;
  const int64_t total = cdiv(m, N) > 0 ? cdiv(m, N) : 1;
  Plan pl{};
  const int64_t ck = cdiv(P, N);
  pl.cpl = static_cast<int>(ck > kSegChunks ? cdiv(ck, kSegChunks) : 1);
  pl.ns = static_cast<int>(ck > 0 ? cdiv(ck, 32 * static_cast<int64_t>(pl.cpl)) : 1);
  const bool decode = B <= kDecodeRows;
  pl.rows = rows > 0      ? rows
            : decode      ? static_cast<int>(B > 0 ? B : 1)
            : B < 1024    ? 4
                          : 8;
  // a row's shared memory: out1 (J) and the segments' sums (K ns Q)
  const int64_t J = static_cast<int64_t>(K) * Q;
  const size_t per_row =
      sizeof(float) * static_cast<size_t>(J + static_cast<int64_t>(K) * pl.ns * Q);
  while (rows == 0 && pl.rows > 1 && pl.rows * per_row > static_cast<size_t>(kSmemMax))
    pl.rows = (pl.rows + 1) / 2;
  pl.row_tiles = cdiv(B, pl.rows);
  if (chunks == 0) chunks = decode ? kDecodeChunks : B < 128 ? 64 : B < 1024 ? 256 : total;
  pl.chunks = chunks < total ? chunks : total;
  pl.ranges = cdiv(total, pl.chunks);
  pl.smem = pl.rows * per_row;
  if (pl.smem > static_cast<size_t>(kSmemMax) || pl.ranges > 65535 ||
      pl.row_tiles > 0x7fffffff || J > 0x7fffffff / pl.rows)
    return cudaErrorInvalidValue;
  *out = pl;
  return cudaSuccess;
}

cudaError_t launch_fn(const void* fn, const Params& prm, const Plan& pl, cudaStream_t stream) {
  // The dynamic shared memory limit is each function's own: raise it for
  // every launch that needs more than the default 48 KB.
  if (pl.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(pl.smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(pl.row_tiles), static_cast<unsigned>(pl.ranges), 1);
  void* args[] = {const_cast<Params*>(&prm)};
  const cudaError_t err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, pl.smem, stream);
  if (err != cudaSuccess) cudaGetLastError();  // clear it: the caller gets it here
  return err;
}

template <typename T, bool kHasBase, int kR>
cudaError_t launch_as(const Params& prm, const Plan& pl, cudaStream_t stream) {
  return launch_fn(reinterpret_cast<const void*>(monarch_fwd_kernel<T, kHasBase, kR>), prm, pl,
                   stream);
}

template <typename T, bool kHasBase>
cudaError_t launch_base(const Params& prm, const Plan& pl, cudaStream_t stream) {
  if (prm.L == 4 && prm.R == 4) return launch_as<T, kHasBase, 4>(prm, pl, stream);
  if (prm.L == 4 && prm.R == 16) return launch_as<T, kHasBase, 16>(prm, pl, stream);
  return launch_as<T, kHasBase, 0>(prm, pl, stream);
}

template <typename T>
cudaError_t launch_dtype(const Params& prm, const Plan& pl, cudaStream_t stream) {
  return prm.base != nullptr ? launch_base<T, true>(prm, pl, stream)
                             : launch_base<T, false>(prm, pl, stream);
}

bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

cudaError_t run(int dtype, int device, const void* x, const void* w1, const void* w2,
                const void* base, void* out, int64_t B, int K, int Q, int P, int L, int S,
                int R, int rows, int64_t chunks, cudaStream_t stream, bool empty = false) {
  // This library carries its own (static) CUDA runtime, whose current
  // device is not PyTorch's: set it to the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  Plan pl;
  const int itemsize = dtype == 0 ? 4 : 2;
  err = make_plan(itemsize, B, K, Q, P, L, S, R, rows, chunks, &pl);
  if (err != cudaSuccess) return err;
  const int64_t m = static_cast<int64_t>(S) * L;
  if (B == 0 || m == 0) return cudaSuccess;
  const int N = 16 / itemsize;
  Params prm;
  prm.x = x, prm.w1 = w1, prm.w2 = w2, prm.base = base, prm.out = out;
  prm.B = B, prm.n = static_cast<int64_t>(K) * P, prm.m = m;
  prm.K = K, prm.Q = Q, prm.P = P, prm.L = L, prm.S = S, prm.R = R, prm.J = K * Q;
  prm.rows = pl.rows, prm.cpl = pl.cpl, prm.ns = pl.ns, prm.chunks = pl.chunks;
  prm.vec_in = on16(x) && on16(w1) && P % N == 0;
  prm.vec_out = on16(out) && (base == nullptr || on16(base)) && m % N == 0;
  prm.vec_w2 = on16(w2);
  if (empty) {
    return launch_fn(reinterpret_cast<const void*>(monarch_fwd_empty_kernel), prm, pl, stream);
  }
  return dtype == 0 ? launch_dtype<float>(prm, pl, stream)
                    : launch_dtype<__nv_bfloat16>(prm, pl, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `base` may be null (K1).  All tensors
// are contiguous on `device` (any alignment); the binding checks that.
// Returns the cudaError_t of the launch.
extern "C" int smft_monarch_fwd(int dtype, int device, const void* x, const void* w1,
                                const void* w2, const void* base, void* out, int64_t B,
                                int K, int Q, int P, int L, int S, int R, void* stream) {
  return run(dtype, device, x, w1, w2, base, out, B, K, Q, P, L, S, R, 0, 0,
             static_cast<cudaStream_t>(stream));
}

// K12: K1 (no base) at the row tile `rows`, one of kFwdTileRows; the other
// arguments as smft_monarch_fwd's.  Returns cudaErrorInvalidValue for
// another row tile.
extern "C" int smft_monarch_fwd_tile(int dtype, int device, const void* x, const void* w1,
                                     const void* w2, void* out, int64_t B, int K, int Q, int P,
                                     int L, int S, int R, int rows, void* stream) {
  bool offered = false;
  for (int t : kFwdTileRows) offered = offered || t == rows;
  if (!offered) return cudaErrorInvalidValue;
  return run(dtype, device, x, w1, w2, nullptr, out, B, K, Q, P, L, S, R, rows, 0,
             static_cast<cudaStream_t>(stream));
}

// K1 or K2 at a plan with rows (the row tile) and chunks (output chunks of
// 16 bytes a CTA) forced where > 0; 0 takes the plan's own.  Every plan
// gives the same bits.  For scripts/compare_monarch_fwd.py --sweep.
extern "C" int smft_monarch_fwd_planned(int dtype, int device, const void* x, const void* w1,
                                        const void* w2, const void* base, void* out, int64_t B,
                                        int K, int Q, int P, int L, int S, int R, int rows,
                                        int64_t chunks, void* stream) {
  return run(dtype, device, x, w1, w2, base, out, B, K, Q, P, L, S, R, rows, chunks,
             static_cast<cudaStream_t>(stream));
}

// The launch floor of smft_monarch_fwd's call on the same arguments: an
// empty kernel at its plan's grid, threads and shared memory.
extern "C" int smft_monarch_fwd_empty(int dtype, int device, const void* x, const void* w1,
                                      const void* w2, const void* base, void* out, int64_t B,
                                      int K, int Q, int P, int L, int S, int R, void* stream) {
  return run(dtype, device, x, w1, w2, base, out, B, K, Q, P, L, S, R, 0, 0,
             static_cast<cudaStream_t>(stream), true);
}

// The plan of a call on B rows of `itemsize`-byte elements (rows and chunks
// forced where > 0) into plan[7]: row tile, row tiles, column ranges,
// output chunks a CTA, chunks a lane (cpl), segments a block (ns), shared
// memory bytes.  The plan depends on the shapes alone.  Returns a
// cudaError_t.
extern "C" int smft_monarch_fwd_plan(int itemsize, int64_t B, int K, int Q, int P, int L, int S,
                                     int R, int rows, int64_t chunks, int64_t* plan) {
  Plan pl;
  const cudaError_t err = make_plan(itemsize, B, K, Q, P, L, S, R, rows, chunks, &pl);
  if (err != cudaSuccess) return err;
  const int64_t v[7] = {pl.rows, pl.row_tiles, pl.ranges, pl.chunks, pl.cpl, pl.ns,
                        static_cast<int64_t>(pl.smem)};
  for (int i = 0; i < 7; ++i) plan[i] = v[i];
  return cudaSuccess;
}
