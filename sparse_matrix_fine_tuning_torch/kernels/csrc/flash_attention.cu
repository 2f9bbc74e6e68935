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
// What bounds it: in bf16 the tensor cores.  A 64-row tile of q does
// 4 * 64 * D multiply-adds for every 64 x D tile of k and v it reads, far
// past the card's ~295 operations a byte, so each CTA keeps its q tile in
// shared memory and streams k and v (dout and q for K19) through a
// two-stage cp.async ring, and the T x T scores never leave the registers.
//
// Design (bf16, mma.sync m16n8k16 with fp32 sums, 4 warps a CTA, 16 rows a
// warp, operands from padded shared memory by ldmatrix; the row stride
// D + 8 makes every ldmatrix phase conflict-free):
//   K17: one CTA per (batch * head, 64-row q tile), walking the kv tiles at
//        or below the diagonal with the online softmax (m, l in fp32
//        registers); only the diagonal tile is masked.  The S accumulator is
//        reused as P.V's A fragment, rounded to bf16.  Writes o and lse.
//   K18: one CTA per q tile, walking the same kv tiles: S = q k^T and dP =
//        dout v^T, p recomputed from lse, ds = p (dp - di), dq += ds k.
//   K19: one CTA per 64-row kv tile, walking the q tiles at or above the
//        diagonal (32 rows a step at D = 128, 64 at D = 64, for registers):
//        S^T = k q^T, dP^T = v dout^T, dv += p^T dout, dk += ds^T q.
// K18 and K19 stay separate, as the splash kernels do: no atomics, so every
// gradient is deterministic.  The CTAs with the most tiles are dispatched
// first (grid y), so the causal triangle's short CTAs fill the last wave.
// f32 (the checks' path) runs on FMA: 32-row tiles, 8 threads a row.
//
// D must be 64 or 128; any T is taken, ragged against every tile: rows past
// T load as zeros (cp.async's zero fill), are masked out of every sum and
// are never stored.  The kernels need 16-byte aligned, contiguous (B, T, H,
// D) tensors and contiguous fp32 (B, H, T) lse and di (ops.cpp checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // bf16: 4 warps, 16 rows each
constexpr int kTile = 64;       // bf16: the rows a CTA owns (q for K17/K18, kv for K19)
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled where !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
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

// Two fp32 values rounded to a bf16x2 register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// -- bf16 tiles ---------------------------------------------------------------

// ROWS x D rows of a (B, T, H, D) tensor, from row `row0` of one (batch,
// head), into shared memory at row stride D + 8; rows past T are zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int T,
                                          int64_t stride) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  static_assert(ROWS * kChunks % kThreads == 0, "the tile must split evenly over the threads");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int c = threadIdx.x + it * kThreads;
    const int r = c / kChunks, cc = c % kChunks, row = row0 + r;
    const bool ok = row < T;
    cp_async16(dst + r * (D + 8) + cc * 8, src + (ok ? row * stride : 0) + cc * 8, ok);
  }
}

// s[n] += A B^T over D: A the warp's 16 rows at `a`, B the NT * 8 rows at
// `b`, both row-major (row stride D + 8) in shared memory.  s[n] is the
// m16n8 accumulator of B's rows 8n .. 8n + 7.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&s)[NT][4], const bf16* a, const bf16* b,
                                        int lane) {
  constexpr int LD = D + 8;
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm4(af, a + ((mi & 1) * 8 + r) * LD + kk * 16 + (mi >> 1) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm4(bf, b + (np * 16 + (mi >> 1) * 8 + r) * LD + kk * 16 + (mi & 1) * 8);
      mma16816(s[2 * np], af, bf[0], bf[1]);
      mma16816(s[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// o += round_bf16(P) V: P the warp's 16 x (NT * 8) fp32 accumulators (the
// layout mma_abt leaves), V NT * 8 rows of D at `v` (row stride D + 8).
template <int D, int NT>
__device__ __forceinline__ void mma_pv(float (&o)[D / 8][4], const float (&p)[NT][4],
                                       const bf16* v, int lane) {
  constexpr int LD = D + 8;
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks) {
    const uint32_t af[4] = {pack_bf16(p[2 * ks][0], p[2 * ks][1]),
                            pack_bf16(p[2 * ks][2], p[2 * ks][3]),
                            pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]),
                            pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];
      ldsm4_t(bf, v + (ks * 16 + (mi & 1) * 8 + r) * LD + dp * 16 + (mi >> 1) * 8);
      mma16816(o[2 * dp], af, bf[0], bf[1]);
      mma16816(o[2 * dp + 1], af, bf[2], bf[3]);
    }
  }
}

// Store the warp's 16 x D fp32 accumulators, scaled by scale[row half], as
// bf16 rows row0 and row0 + 8 (those below T) of a (B, T, H, D) tensor.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 8][4], int row0,
                                           int T, int64_t stride, const float (&scale)[2],
                                           int lane) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + rr * 8;
    if (row >= T) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + row * stride + 2 * (lane & 3));
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      dst[dn * 4] = pack_bf16(acc[dn][2 * rr] * scale[rr], acc[dn][2 * rr + 1] * scale[rr]);
  }
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

// K17, bf16.  grid (B * H, q tiles), the last q tile first.
template <int D>
__global__ void __launch_bounds__(kThreads) fwd_bf16_kernel(const Params p) {
  constexpr int LD = D + 8, NT = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kTile * LD;      // 2 stages
  bf16* sV = sK + 2 * kTile * LD;  // 2 stages
  const Head hd = head_of<D>(p);
  const bf16* q = static_cast<const bf16*>(p.q) + hd.base;
  const bf16* k = static_cast<const bf16*>(p.k) + hd.base;
  const bf16* v = static_cast<const bf16*>(p.v) + hd.base;
  const int T = p.T, qt = gridDim.y - 1 - blockIdx.y, q0 = qt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const int row0 = q0 + warp * 16 + (lane >> 2);

  load_tile<D, kTile>(sQ, q, q0, T, hd.stride);
  load_tile<D, kTile>(sK, k, 0, T, hd.stride);
  load_tile<D, kTile>(sV, v, 0, T, hd.stride);
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j <= qt; ++j) {
    const int st = j & 1;
    if (j < qt) {
      load_tile<D, kTile>(sK + (st ^ 1) * kTile * LD, k, (j + 1) * kTile, T, hd.stride);
      load_tile<D, kTile>(sV + (st ^ 1) * kTile * LD, v, (j + 1) * kTile, T, hd.stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_abt<D, NT>(s, sQ + warp * 16 * LD, sK + st * kTile * LD, lane);
    if (j == qt) {  // the diagonal tile: keys after the query are masked
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * kTile + n * 8 + 2 * tq + (e & 1) > row0 + (e >> 1) * 8) s[n][e] = -INFINITY;
    }
    // Online softmax.  Every row has a finite score in kv tile 0 (key 0),
    // so m is finite from the first tile on and alpha = exp(-inf) = 0 there.
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = m[rr];
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * rr], s[n][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = __expf(m[rr] - mx);
      m[rr] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][2 * rr] = __expf(s[n][2 * rr] - mx);
        s[n][2 * rr + 1] = __expf(s[n][2 * rr + 1] - mx);
        sum += s[n][2 * rr] + s[n][2 * rr + 1];
      }
      l[rr] = l[rr] * alpha + sum;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][2 * rr] *= alpha;
        o[dn][2 * rr + 1] *= alpha;
      }
    }
    mma_pv<D, NT>(o, s, sV + st * kTile * LD, lane);
    __syncthreads();  // the stage is free for the next tile's loads
  }

  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    inv[rr] = 1.f / l[rr];
    const int row = row0 + rr * 8;
    if (tq == 0 && row < T) p.lse[hd.lse + row] = logf(l[rr]) + m[rr];
  }
  store_rows<D>(static_cast<bf16*>(p.o) + hd.base, o, row0, T, hd.stride, inv, lane);
}

// K18, bf16.  grid (B * H, q tiles), the last q tile first.
template <int D>
__global__ void __launch_bounds__(kThreads) dq_bf16_kernel(const Params p) {
  constexpr int LD = D + 8, NT = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + kTile * LD;      // dout
  bf16* sK = sO + kTile * LD;      // 2 stages
  bf16* sV = sK + 2 * kTile * LD;  // 2 stages
  const Head hd = head_of<D>(p);
  const bf16* q = static_cast<const bf16*>(p.q) + hd.base;
  const bf16* k = static_cast<const bf16*>(p.k) + hd.base;
  const bf16* v = static_cast<const bf16*>(p.v) + hd.base;
  const bf16* dout = static_cast<const bf16*>(p.dout) + hd.base;
  const int T = p.T, qt = gridDim.y - 1 - blockIdx.y, q0 = qt * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const int row0 = q0 + warp * 16 + (lane >> 2);

  load_tile<D, kTile>(sQ, q, q0, T, hd.stride);
  load_tile<D, kTile>(sO, dout, q0, T, hd.stride);
  load_tile<D, kTile>(sK, k, 0, T, hd.stride);
  load_tile<D, kTile>(sV, v, 0, T, hd.stride);
  cp_async_commit();
  float lse[2], di[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + rr * 8;
    lse[rr] = row < T ? p.lse[hd.lse + row] : 0.f;
    di[rr] = row < T ? p.di[hd.lse + row] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;

  for (int j = 0; j <= qt; ++j) {
    const int st = j & 1;
    if (j < qt) {
      load_tile<D, kTile>(sK + (st ^ 1) * kTile * LD, k, (j + 1) * kTile, T, hd.stride);
      load_tile<D, kTile>(sV + (st ^ 1) * kTile * LD, v, (j + 1) * kTile, T, hd.stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = sK + st * kTile * LD;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<D, NT>(s, sQ + warp * 16 * LD, kt, lane);
    mma_abt<D, NT>(dp, sO + warp * 16 * LD, sV + st * kTile * LD, lane);
    const bool diag = j == qt;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const bool masked = diag && j * kTile + n * 8 + 2 * tq + (e & 1) > row0 + rr * 8;
        const float pv = masked ? 0.f : __expf(s[n][e] - lse[rr]);
        s[n][e] = pv * (dp[n][e] - di[rr]);  // ds
      }
    mma_pv<D, NT>(dq, s, kt, lane);
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(static_cast<bf16*>(p.o) + hd.base, dq, row0, T, hd.stride, one, lane);
}

// K19, bf16: BQ q rows a step.  grid (B * H, kv tiles), kv tile 0 (the
// most q tiles) first.
template <int D, int BQ>
__global__ void __launch_bounds__(kThreads) dkv_bf16_kernel(const Params p) {
  constexpr int LD = D + 8, NT = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kTile * LD;
  bf16* sQ = sV + kTile * LD;   // 2 stages
  bf16* sO = sQ + 2 * BQ * LD;  // dout, 2 stages
  float* sL = reinterpret_cast<float*>(sO + 2 * BQ * LD);  // lse of the step's q rows
  float* sDi = sL + BQ;
  const Head hd = head_of<D>(p);
  const bf16* q = static_cast<const bf16*>(p.q) + hd.base;
  const bf16* k = static_cast<const bf16*>(p.k) + hd.base;
  const bf16* v = static_cast<const bf16*>(p.v) + hd.base;
  const bf16* dout = static_cast<const bf16*>(p.dout) + hd.base;
  const int T = p.T, k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tq = lane & 3;
  const int row0 = k0 + warp * 16 + (lane >> 2);  // this thread's kv rows row0, row0 + 8
  const int i0 = k0 / BQ, nq = (T + BQ - 1) / BQ;

  load_tile<D, kTile>(sK, k, k0, T, hd.stride);
  load_tile<D, kTile>(sV, v, k0, T, hd.stride);
  load_tile<D, BQ>(sQ, q, i0 * BQ, T, hd.stride);
  load_tile<D, BQ>(sO, dout, i0 * BQ, T, hd.stride);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

  for (int i = i0; i < nq; ++i) {
    const int st = (i - i0) & 1;
    if (i + 1 < nq) {
      load_tile<D, BQ>(sQ + (st ^ 1) * BQ * LD, q, (i + 1) * BQ, T, hd.stride);
      load_tile<D, BQ>(sO + (st ^ 1) * BQ * LD, dout, (i + 1) * BQ, T, hd.stride);
      cp_async_commit();
    }
    if (threadIdx.x < BQ) {  // the last step's reads ended at its closing barrier
      const int row = i * BQ + threadIdx.x;
      sL[threadIdx.x] = row < T ? p.lse[hd.lse + row] : 0.f;
      sDi[threadIdx.x] = row < T ? p.di[hd.lse + row] : 0.f;
    }
    if (i + 1 < nq) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = sQ + st * BQ * LD;
    const bf16* os = sO + st * BQ * LD;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<D, NT>(s, sK + warp * 16 * LD, qs, lane);   // S^T: kv rows x q columns
    mma_abt<D, NT>(dp, sV + warp * 16 * LD, os, lane);  // dP^T
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * tq + (e & 1), col = i * BQ + c;
        const bool ok = col >= row0 + (e >> 1) * 8 && col < T;
        const float pv = ok ? __expf(s[n][e] - sL[c]) : 0.f;
        s[n][e] = pv;
        dp[n][e] = pv * (dp[n][e] - sDi[c]);  // ds^T
      }
    mma_pv<D, NT>(dv, s, os, lane);
    mma_pv<D, NT>(dk, dp, qs, lane);
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(static_cast<bf16*>(p.o) + hd.base, dk, row0, T, hd.stride, one, lane);
  store_rows<D>(static_cast<bf16*>(p.o2) + hd.base, dv, row0, T, hd.stride, one, lane);
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

// -- host -----------------------------------------------------------------------

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

constexpr int kBwdStep128 = 32;  // K19's q rows a step at D = 128 (64 at D = 64)

constexpr size_t bf16_smem(int which, int D) {
  const size_t ld = static_cast<size_t>(D + 8) * sizeof(bf16);
  if (which == kFwd) return 5 * kTile * ld;
  if (which == kDq) return 6 * kTile * ld;
  const size_t bq = D == 128 ? kBwdStep128 : kTile;
  return (2 * kTile + 4 * bq) * ld + 2 * bq * sizeof(float);
}

constexpr size_t f32_smem(int which, int D) {
  const size_t lr = D + 4, lc = D + 1, t = kF32Tile, ps = kPS;
  if (which == kFwd) return (t * lr + t * lc + t * D + t * ps) * sizeof(float);
  if (which == kDq) return (2 * t * lr + 2 * t * lc + t * ps) * sizeof(float);
  return (2 * t * lr + 2 * t * lc + 2 * t * ps + 2 * t) * sizeof(float);
}

template <int D>
const void* kernel_of(int dtype, int which) {
  if (dtype == 1) {
    if (which == kFwd) return reinterpret_cast<const void*>(fwd_bf16_kernel<D>);
    if (which == kDq) return reinterpret_cast<const void*>(dq_bf16_kernel<D>);
    return reinterpret_cast<const void*>(
        dkv_bf16_kernel<D, D == 128 ? kBwdStep128 : kTile>);
  }
  if (which == kFwd) return reinterpret_cast<const void*>(fwd_f32_kernel<D>);
  if (which == kDq) return reinterpret_cast<const void*>(dq_f32_kernel<D>);
  return reinterpret_cast<const void*>(dkv_f32_kernel<D>);
}

cudaError_t run(int which, int dtype, int device, const Params& prm, int64_t B, int64_t T,
                int64_t H, int64_t D, cudaStream_t stream) {
  // This library carries its own (static) CUDA runtime, whose current
  // device is not PyTorch's: set it to the tensors' device.
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((dtype != 0 && dtype != 1) || (D != 64 && D != 128) || B < 0 || T < 0 || H <= 0)
    return cudaErrorInvalidValue;
  const int64_t tile = dtype == 1 ? kTile : kF32Tile;
  const int64_t tiles = (T + tile - 1) / tile;
  if (B * H > 0x7fffffff || tiles > 65535 || T * H * D > (int64_t{1} << 40))
    return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return cudaSuccess;
  const void* fn = D == 64 ? kernel_of<64>(dtype, which) : kernel_of<128>(dtype, which);
  const size_t smem = dtype == 1 ? bf16_smem(which, static_cast<int>(D))
                                 : f32_smem(which, static_cast<int>(D));
  // The dynamic shared memory limit is each function's own.
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>(tiles), 1);
  void* args[] = {const_cast<Params*>(&prm)};
  err = cudaLaunchKernel(fn, grid, dim3(dtype == 1 ? kThreads : kF32Threads), args, smem, stream);
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
