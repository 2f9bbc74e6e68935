// PyTorch bindings of the kernels in monarch_fwd.cu, monarch_bwd.cu,
// quant_matmul.cu (with quant_wgmma.cu, the bf16 tile path of K5-K8, behind
// its smft_quant_mm), more_linear.cu and tiled_matmul.cu:
//   torch.ops.smft.monarch_fwd(x, w1, w2)            -> out              (K1)
//   torch.ops.smft.monarch_fwd_tile(x, w1, w2, rows) -> out              (K12)
//   torch.ops.smft.monarch_fwd_add(base, x, w1, w2)  -> base + out       (K2)
//   torch.ops.smft.monarch_fwd_plan(B, K, Q, P, L, S, R, itemsize, rows=0) -> int[]
//       the plan K1/K2 (rows 0) or K12 (its row tile) launch with: (row
//       tile, row tiles, column ranges, output chunks a CTA, chunks a lane,
//       segments a block, shared memory bytes)
//   torch.ops.smft.monarch_bwd(x, w1, w2, dout)      -> (dx, dw1, dw2)   (K3)
//   torch.ops.smft.monarch_dw_fused(x, dout, w1, w2) -> (dw1, dw2)       (K4)
//   torch.ops.smft.monarch_dw_tile(x, dout, w1, w2, rows) -> (dw1, dw2)  (K13, K14)
//   torch.ops.smft.monarch_bwd_plan(M, K, Q, P, L, S, R, rows, with_dx, itemsize)
//       -> (fast, groups): the plan K3, K4 and K13 launch with
//   torch.ops.smft.monarch_bwd_plan_fields(M, K, Q, P, L, S, R, rows, with_dx, itemsize,
//       tile=0, stages=0) -> int[]: the cluster kernel's plan (fast, groups,
//       clusters, rows a group, tile rows, stages, shared memory bytes, values
//       of s a slice, dw2's sums in device memory); tile and stages > 0 force
//       those
//   torch.ops.smft.int4_mm(x, packed, scales, group)     -> y            (K5)
//   torch.ops.smft.int4_mm_dx(dy, packed, scales, group) -> dx           (K6)
//   torch.ops.smft.int8_mm(x, q, scales)                 -> y            (K7)
//   torch.ops.smft.int8_mm_dx(dy, q, scales)             -> dx           (K8)
//   torch.ops.smft.int4_variant_mm(x, packed, scales, group, arith) -> y  (K16)
//   torch.ops.smft.quant_decode_plan(bits, bf16, M, in, out, group=64, arith=0) -> int[]
//       the decode kernel's plan of K5/K7 (arith 0) at M <= 16 rows or K16:
//       (col_tile, slices, ctas, stages, ctas_per_sm, row_blocks, rows,
//        slice_rows, chunk_rows, smem, mma)
//   torch.ops.smft.quant_decode_attrs() -> int[]: 8 values a decode-kernel
//       instantiation (bits, bf16, arith, rows, registers, local bytes,
//       CTAs an SM, threads)
//   torch.ops.smft.quant_decode_empty(bits, bf16, M, in, out, group): the
//       decode call's launch floor, an empty kernel at its grid
//   torch.ops.smft.more_linear_fwd(x, dense_w, w1, w2)   -> y            (K9)
//   torch.ops.smft.more_linear_dx(dout, dense_w, w1, w2) -> dx           (K10)
//   torch.ops.smft.more_linear_plan(M, n, m, J, dx) -> int[]: the plan of a
//       bf16 K9 (dx false) or K10 call (bm, bn, jk, stages, row tiles, column
//       tiles, threads, shared memory bytes)
//   torch.ops.smft.tiled_matmul(x, w, bm, bn, stages)    -> y            (K15)
// K11 is monarch_dw_fused (K4's kernel); K13 is K4's kernel at a row group
// of `rows`, and K14 K13 at 256 rows.  Only a CUDA implementation of the
// tensor ops is registered, so a tensor on another device is refused by the
// dispatcher; monarch_bwd_plan, more_linear_plan and monarch_fwd_plan take
// no tensor (the first two read the current device, the third depends on
// the shapes alone).
// The launch's error code is checked here and raised; the kernels run on
// PyTorch's current stream and allocate nothing: the outputs and the fp32
// scratch (the backward's per-cluster or per-group partial sums, the
// tile paths' split partial sums, the fused linear's f32 row summaries) are
// allocated here.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/zeros.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAFunctions.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <cstdint>
#include <tuple>
#include <vector>

extern "C" int smft_monarch_fwd(int dtype, int device, const void* x, const void* w1,
                                const void* w2, const void* base, void* out, int64_t B,
                                int K, int Q, int P, int L, int S, int R, void* stream);
extern "C" int smft_monarch_fwd_tile(int dtype, int device, const void* x, const void* w1,
                                     const void* w2, void* out, int64_t B, int K, int Q, int P,
                                     int L, int S, int R, int rows, void* stream);
extern "C" int smft_monarch_fwd_plan(int itemsize, int64_t B, int K, int Q, int P, int L, int S,
                                     int R, int rows, int64_t chunks, int64_t* plan);
extern "C" int smft_tiled_matmul(int device, const void* x, const void* w, void* y, int64_t M,
                                 int64_t N, int64_t K, int bm, int bn, int stages,
                                 void* stream);
extern "C" int64_t smft_monarch_bwd_workspace(int dtype, int device, const void* x,
                                              const void* dout, const void* w1, const void* w2,
                                              const void* dx, int64_t M, int K, int Q, int P,
                                              int L, int S, int R, int64_t rows_per_group);
extern "C" int smft_monarch_bwd(int dtype, int device, const void* x, const void* dout,
                                const void* w1, const void* w2, void* dx, float* work,
                                float* dw1, float* dw2, int64_t M, int K, int Q, int P, int L,
                                int S, int R, int64_t rows_per_group, void* stream);
extern "C" int smft_monarch_bwd_plan(int itemsize, int device, int64_t M, int K, int Q, int P,
                                     int L, int S, int R, int64_t rows_per_group, int with_dx,
                                     int* fast, int* groups);
extern "C" int smft_monarch_bwd_plan_fields(int itemsize, int device, int64_t M, int K, int Q,
                                            int P, int L, int S, int R, int64_t rows_per_group,
                                            int with_dx, int tile, int stages, int64_t* out);
extern "C" int64_t smft_quant_mm_workspace(int dtype, int device, int bits, int dx, int64_t M,
                                           int64_t in_f, int64_t out_f);
extern "C" int smft_quant_mm(int dtype, int device, int bits, int dx, const void* a,
                             const void* codes, const float* scales, void* out, float* work,
                             int64_t M, int64_t in_f, int64_t out_f, int group, void* stream);
extern "C" int smft_int4_variant_mm(int device, int arith, const void* x, const void* codes,
                                    const float* scales, void* y, int64_t M, int64_t in_f,
                                    int64_t out_f, int group, void* stream);
extern "C" int smft_quant_decode_plan(int device, int bits, int dtype, int arith, int64_t M,
                                      int64_t in_f, int64_t out_f, int group, int64_t* plan);
extern "C" int smft_quant_decode_attrs(int device, int64_t* out, int capacity, int* count);
extern "C" int smft_quant_decode_empty(int device, int bits, int dtype, int64_t M, int64_t in_f,
                                       int64_t out_f, int group, void* stream);
extern "C" int smft_more_linear(int dtype, int device, int dx, const void* a, const void* wd,
                                const void* w1, const void* w2, void* out, float* work,
                                int64_t M, int64_t n, int64_t m, int K, int Q, int P, int L,
                                int S, int R, void* stream);
extern "C" int smft_more_linear_plan(int device, int dx, int64_t M, int64_t n, int64_t m, int J,
                                     int64_t* plan);
extern "C" int smft_tiled_matmul_plan(int device, int64_t M, int64_t N, int64_t K, int bm, int bn,
                                      int stages, int64_t* out);

namespace {

void check_tensor(const at::Tensor& t, const char* name, const at::Tensor& x) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.device() == x.device(), name, " must be on the device of x");
  TORCH_CHECK(t.scalar_type() == x.scalar_type(), name, " must have the dtype of x (",
              x.scalar_type(), "), got ", t.scalar_type());
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

// K1 and K2 (rows == 0: the default row tile; `base` may be null) and K12
// (rows > 0: that row tile; no base).
at::Tensor run(const at::Tensor& x, const at::Tensor& w1, const at::Tensor& w2,
               const at::Tensor* base, int64_t rows = 0) {
  TORCH_CHECK(x.scalar_type() == at::kFloat || x.scalar_type() == at::kBFloat16,
              "monarch_fwd takes float32 or bfloat16, got ", x.scalar_type());
  TORCH_CHECK(x.dim() == 2, "x must be (B, n)");
  TORCH_CHECK(w1.dim() == 3 && w2.dim() == 3, "w1 must be (K, Q, P) and w2 (L, S, R)");
  check_tensor(x, "x", x);
  check_tensor(w1, "w1", x);
  check_tensor(w2, "w2", x);
  const int64_t B = x.size(0), n = x.size(1);
  const int64_t K = w1.size(0), Q = w1.size(1), P = w1.size(2);
  const int64_t L = w2.size(0), S = w2.size(1), R = w2.size(2);
  TORCH_CHECK(K * P == n, "w1 ", w1.sizes(), " does not fit input width ", n);
  TORCH_CHECK(L * R == K * Q, "w2 ", w2.sizes(), " does not fit w1 ", w1.sizes());
  const int64_t lim = INT32_MAX;
  TORCH_CHECK(K <= lim && Q <= lim && P <= lim && L <= lim && S <= lim && R <= lim,
              "factor dims must fit in 32 bits");
  if (base != nullptr) {
    check_tensor(*base, "base", x);
    TORCH_CHECK(base->dim() == 2 && base->size(0) == B && base->size(1) == S * L,
                "base must be (B, S*L) = (", B, ", ", S * L, "), got ", base->sizes());
  }
  at::Tensor out = at::empty({B, S * L}, x.options());
  const int dtype = x.scalar_type() == at::kFloat ? 0 : 1;
  const auto stream = c10::cuda::getCurrentCUDAStream(x.get_device());
  const int k = static_cast<int>(K), q = static_cast<int>(Q), p = static_cast<int>(P);
  const int l = static_cast<int>(L), s = static_cast<int>(S), r = static_cast<int>(R);
  const int err =
      rows > 0 ? smft_monarch_fwd_tile(dtype, x.get_device(), x.data_ptr(), w1.data_ptr(),
                                       w2.data_ptr(), out.data_ptr(), B, k, q, p, l, s, r,
                                       static_cast<int>(rows), static_cast<void*>(stream.stream()))
               : smft_monarch_fwd(dtype, x.get_device(), x.data_ptr(), w1.data_ptr(),
                                  w2.data_ptr(), base ? base->data_ptr() : nullptr,
                                  out.data_ptr(), B, k, q, p, l, s, r,
                                  static_cast<void*>(stream.stream()));
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
  return out;
}

at::Tensor monarch_fwd_tile(const at::Tensor& x, const at::Tensor& w1, const at::Tensor& w2,
                            int64_t rows) {
  TORCH_CHECK(rows == 8 || rows == 16 || rows == 32 || rows == 64,
              "monarch_fwd_tile takes a row tile of 8, 16, 32 or 64, got ", rows);
  return run(x, w1, w2, nullptr, rows);
}

at::Tensor monarch_fwd(const at::Tensor& x, const at::Tensor& w1, const at::Tensor& w2) {
  return run(x, w1, w2, nullptr);
}

std::vector<int64_t> monarch_fwd_plan(int64_t B, int64_t K, int64_t Q, int64_t P, int64_t L,
                                      int64_t S, int64_t R, int64_t itemsize, int64_t rows) {
  TORCH_CHECK(B >= 0 && (itemsize == 2 || itemsize == 4) && rows >= 0,
              "monarch_fwd_plan takes B >= 0, an itemsize of 2 or 4 and rows >= 0");
  const int64_t lim = INT32_MAX;
  TORCH_CHECK(K <= lim && Q <= lim && P <= lim && L <= lim && S <= lim && R <= lim &&
                  rows <= lim,
              "factor dims must fit in 32 bits");
  std::vector<int64_t> plan(7);
  const int err = smft_monarch_fwd_plan(
      static_cast<int>(itemsize), B, static_cast<int>(K), static_cast<int>(Q),
      static_cast<int>(P), static_cast<int>(L), static_cast<int>(S), static_cast<int>(R),
      static_cast<int>(rows), 0, plan.data());
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
  return plan;
}

// K13's row group: a positive multiple of the generic kernel's 16-row tile
// (which the fast path's 4-row unroll divides).
void check_rows(int64_t rows) {
  TORCH_CHECK(rows > 0 && rows % 16 == 0,
              "the row group must be a positive multiple of 16 rows, got ", rows);
}

// K3 (with_dx) and K4: returns (dx or an empty tensor, dw1, dw2), dw in fp32.
// rows: K13's rows a group, 0 for the plan's own.
std::tuple<at::Tensor, at::Tensor, at::Tensor> run_bwd(const at::Tensor& x,
                                                       const at::Tensor& dout,
                                                       const at::Tensor& w1,
                                                       const at::Tensor& w2, bool with_dx,
                                                       int64_t rows = 0) {
  TORCH_CHECK(x.scalar_type() == at::kFloat || x.scalar_type() == at::kBFloat16,
              "monarch_bwd takes float32 or bfloat16, got ", x.scalar_type());
  TORCH_CHECK(x.dim() == 2 && dout.dim() == 2, "x must be (M, n) and dout (M, m)");
  TORCH_CHECK(w1.dim() == 3 && w2.dim() == 3, "w1 must be (K, Q, P) and w2 (L, S, R)");
  check_tensor(x, "x", x);
  check_tensor(dout, "dout", x);
  check_tensor(w1, "w1", x);
  check_tensor(w2, "w2", x);
  const int64_t M = x.size(0), n = x.size(1);
  const int64_t K = w1.size(0), Q = w1.size(1), P = w1.size(2);
  const int64_t L = w2.size(0), S = w2.size(1), R = w2.size(2);
  TORCH_CHECK(K * P == n, "w1 ", w1.sizes(), " does not fit input width ", n);
  TORCH_CHECK(L * R == K * Q, "w2 ", w2.sizes(), " does not fit w1 ", w1.sizes());
  TORCH_CHECK(dout.size(0) == M && dout.size(1) == S * L, "dout must be (M, S*L) = (", M,
              ", ", S * L, "), got ", dout.sizes());
  const int64_t lim = INT32_MAX;
  TORCH_CHECK(K <= lim && Q <= lim && P <= lim && L <= lim && S <= lim && R <= lim,
              "factor dims must fit in 32 bits");
  const auto f32 = x.options().dtype(at::kFloat);
  at::Tensor dx = with_dx ? at::empty({M, n}, x.options()) : at::empty({0}, x.options());
  if (M == 0) {
    return {dx, at::zeros({K, Q, P}, f32), at::zeros({L, S, R}, f32)};
  }
  at::Tensor dw1 = at::empty({K, Q, P}, f32);
  at::Tensor dw2 = at::empty({L, S, R}, f32);
  const int device = x.get_device();
  const int dtype = x.scalar_type() == at::kFloat ? 0 : 1;
  void* dx_ptr = with_dx ? dx.data_ptr() : nullptr;
  const int k = static_cast<int>(K), q = static_cast<int>(Q), p = static_cast<int>(P);
  const int l = static_cast<int>(L), s = static_cast<int>(S), r = static_cast<int>(R);
  const int64_t work_floats = smft_monarch_bwd_workspace(
      dtype, device, x.data_ptr(), dout.data_ptr(), w1.data_ptr(), w2.data_ptr(), dx_ptr, M, k,
      q, p, l, s, r, rows);
  TORCH_CHECK(work_floats >= 0, "monarch_bwd: cannot read the device's SM count");
  at::Tensor work = at::empty({work_floats}, f32);
  const auto stream = c10::cuda::getCurrentCUDAStream(device);
  const int err = smft_monarch_bwd(
      dtype, device, x.data_ptr(), dout.data_ptr(), w1.data_ptr(), w2.data_ptr(), dx_ptr,
      work_floats > 0 ? work.data_ptr<float>() : nullptr, dw1.data_ptr<float>(),
      dw2.data_ptr<float>(), M, k, q, p, l, s, r, rows, static_cast<void*>(stream.stream()));
  TORCH_CHECK(rows == 0 || err != cudaErrorInvalidValue, "monarch_dw_tile: ",
              (M + rows - 1) / (rows ? rows : 1), " row groups of ", rows,
              " rows exceed the launch's grid of 65535");
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
  return {dx, dw1, dw2};
}

std::tuple<at::Tensor, at::Tensor, at::Tensor> monarch_bwd(const at::Tensor& x,
                                                           const at::Tensor& w1,
                                                           const at::Tensor& w2,
                                                           const at::Tensor& dout) {
  return run_bwd(x, dout, w1, w2, true);
}

std::tuple<at::Tensor, at::Tensor> monarch_dw_fused(const at::Tensor& x, const at::Tensor& dout,
                                                    const at::Tensor& w1, const at::Tensor& w2) {
  auto out = run_bwd(x, dout, w1, w2, false);
  return {std::get<1>(out), std::get<2>(out)};
}

std::tuple<at::Tensor, at::Tensor> monarch_dw_tile(const at::Tensor& x, const at::Tensor& dout,
                                                   const at::Tensor& w1, const at::Tensor& w2,
                                                   int64_t rows) {
  check_rows(rows);
  auto out = run_bwd(x, dout, w1, w2, false, rows);
  return {std::get<1>(out), std::get<2>(out)};
}

std::tuple<bool, int64_t> monarch_bwd_plan(int64_t M, int64_t K, int64_t Q, int64_t P, int64_t L,
                                           int64_t S, int64_t R, int64_t rows, bool with_dx,
                                           int64_t itemsize) {
  if (rows != 0) check_rows(rows);
  TORCH_CHECK(M > 0, "monarch_bwd_plan needs M > 0, got ", M);
  TORCH_CHECK(itemsize == 2 || itemsize == 4, "itemsize must be 2 (bfloat16) or 4 (float32)");
  const int64_t lim = INT32_MAX;
  TORCH_CHECK(K <= lim && Q <= lim && P <= lim && L <= lim && S <= lim && R <= lim,
              "factor dims must fit in 32 bits");
  int fast = 0, groups = 0;
  const int err = smft_monarch_bwd_plan(
      static_cast<int>(itemsize), c10::cuda::current_device(), M, static_cast<int>(K),
      static_cast<int>(Q), static_cast<int>(P), static_cast<int>(L), static_cast<int>(S),
      static_cast<int>(R), rows, with_dx ? 1 : 0, &fast, &groups);
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
  return {fast != 0, groups};
}

std::vector<int64_t> monarch_bwd_plan_fields(int64_t M, int64_t K, int64_t Q, int64_t P,
                                             int64_t L, int64_t S, int64_t R, int64_t rows,
                                             bool with_dx, int64_t itemsize, int64_t tile,
                                             int64_t stages) {
  if (rows != 0) check_rows(rows);
  TORCH_CHECK(M > 0, "monarch_bwd_plan_fields needs M > 0, got ", M);
  TORCH_CHECK(itemsize == 2 || itemsize == 4, "itemsize must be 2 (bfloat16) or 4 (float32)");
  const int64_t lim = INT32_MAX;
  TORCH_CHECK(K <= lim && Q <= lim && P <= lim && L <= lim && S <= lim && R <= lim &&
                  tile >= 0 && tile <= lim && stages >= 0 && stages <= lim,
              "factor dims, tile and stages must fit in 32 bits");
  std::vector<int64_t> out(9, 0);
  const int err = smft_monarch_bwd_plan_fields(
      static_cast<int>(itemsize), c10::cuda::current_device(), M, static_cast<int>(K),
      static_cast<int>(Q), static_cast<int>(P), static_cast<int>(L), static_cast<int>(S),
      static_cast<int>(R), rows, with_dx ? 1 : 0, static_cast<int>(tile),
      static_cast<int>(stages), out.data());
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
  return out;
}

at::Tensor monarch_fwd_add(const at::Tensor& base, const at::Tensor& x,
                           const at::Tensor& w1, const at::Tensor& w2) {
  return run(x, w1, w2, &base);
}

// K5-K8 and K16: a (M, in) for the forward or (M, out) for dx; codes int8
// (in, out) or packed uint8 (in/2, out); scales f32 (in/group, out).
// Returns (in, out, group).
std::tuple<int64_t, int64_t, int64_t> check_quant(const at::Tensor& a, const at::Tensor& codes,
                                                  const at::Tensor& scales, int bits, bool dx,
                                                  int64_t group) {
  TORCH_CHECK(a.dim() == 2 && codes.dim() == 2 && scales.dim() == 2,
              "activations, codes and scales must be 2-D");
  check_tensor(a, "activations", a);
  TORCH_CHECK(codes.is_cuda() && scales.is_cuda() && codes.device() == a.device() &&
                  scales.device() == a.device(),
              "codes and scales must be CUDA tensors on the activations' device");
  TORCH_CHECK(codes.scalar_type() == (bits == 8 ? at::kChar : at::kByte), "int", bits,
              " codes must be ", bits == 8 ? "int8" : "uint8", ", got ", codes.scalar_type());
  TORCH_CHECK(scales.scalar_type() == at::kFloat, "scales must be float32");
  TORCH_CHECK(codes.is_contiguous() && scales.is_contiguous(),
              "codes and scales must be contiguous");
  const int64_t rows = codes.size(0), out_f = codes.size(1);
  const int64_t in_f = bits == 8 ? rows : 2 * rows;
  if (bits == 8) {
    TORCH_CHECK(scales.size(0) == 1 && scales.size(1) == out_f, "int8 scales must be (1, ",
                out_f, "), got ", scales.sizes());
    group = in_f;
  } else {
    TORCH_CHECK(group >= 8 && rows % group == 0 && scales.size(0) == in_f / group &&
                    scales.size(1) == out_f,
                "int4 codes ", codes.sizes(), " with group ", group,
                " need a group of at least 8, (in/2) % group == 0 and scales (in/group, ",
                "out), got ", scales.sizes());
  }
  TORCH_CHECK(in_f % 8 == 0 && out_f % 16 == 0, "the kernels take in % 8 == 0 and ",
              "out % 16 == 0, got in ", in_f, ", out ", out_f);
  TORCH_CHECK(in_f < INT32_MAX && out_f < INT32_MAX, "in and out must fit in 32 bits");
  const int64_t width = dx ? out_f : in_f;
  TORCH_CHECK(a.size(1) == width, "activations must be (M, ", width, "), got ", a.sizes());
  for (const at::Tensor* t : {&a, &codes, &scales}) {
    TORCH_CHECK(reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                "the kernels load 16 bytes at a time: operands must start on 16 bytes");
  }
  return {in_f, out_f, group};
}

at::Tensor run_quant(const at::Tensor& a, const at::Tensor& codes, const at::Tensor& scales,
                     int bits, bool dx, int64_t group) {
  TORCH_CHECK(a.scalar_type() == at::kFloat || a.scalar_type() == at::kBFloat16,
              "the quantized matmuls take float32 or bfloat16 activations, got ",
              a.scalar_type());
  int64_t in_f, out_f;
  std::tie(in_f, out_f, group) = check_quant(a, codes, scales, bits, dx, group);
  const int64_t M = a.size(0);
  at::Tensor out = at::empty({M, dx ? in_f : out_f}, a.options());
  const int device = a.get_device();
  const int dtype = a.scalar_type() == at::kFloat ? 0 : 1;
  const int64_t work_floats =
      smft_quant_mm_workspace(dtype, device, bits, dx ? 1 : 0, M, in_f, out_f);
  TORCH_CHECK(work_floats >= 0, "quantized matmul: cannot read the device's SM count");
  // the decode rows need no scratch: allocate none (a decode step makes 154 calls)
  at::Tensor work;
  if (work_floats > 0) work = at::empty({work_floats}, a.options().dtype(at::kFloat));
  const auto stream = c10::cuda::getCurrentCUDAStream(device);
  const int err = smft_quant_mm(
      dtype, device, bits, dx ? 1 : 0, a.data_ptr(),
      codes.data_ptr(), scales.data_ptr<float>(), out.data_ptr(),
      work_floats > 0 ? work.data_ptr<float>() : nullptr, M, in_f, out_f,
      static_cast<int>(group), static_cast<void*>(stream.stream()));
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
  return out;
}

at::Tensor int8_mm(const at::Tensor& x, const at::Tensor& q, const at::Tensor& scales) {
  return run_quant(x, q, scales, 8, false, 0);
}

at::Tensor int8_mm_dx(const at::Tensor& dy, const at::Tensor& q, const at::Tensor& scales) {
  return run_quant(dy, q, scales, 8, true, 0);
}

at::Tensor int4_mm(const at::Tensor& x, const at::Tensor& packed, const at::Tensor& scales,
                   int64_t group) {
  return run_quant(x, packed, scales, 4, false, group);
}

at::Tensor int4_mm_dx(const at::Tensor& dy, const at::Tensor& packed, const at::Tensor& scales,
                      int64_t group) {
  return run_quant(dy, packed, scales, 4, true, group);
}

// K16: the six arithmetic variants of the int4 decode product (arith 0-5:
// f32mul, bf16mul, ucorr, ugdot, f32dot, u2dot), raw output; x bfloat16.
void check_arith(int64_t arith) {
  TORCH_CHECK(arith >= 0 && arith <= 5, "int4_variant_mm: arith must be 0-5 (f32mul, bf16mul, ",
              "ucorr, ugdot, f32dot, u2dot), got ", arith);
}

at::Tensor int4_variant_mm(const at::Tensor& x, const at::Tensor& packed, const at::Tensor& scales,
                           int64_t group, int64_t arith) {
  check_arith(arith);
  TORCH_CHECK(x.scalar_type() == at::kBFloat16, "int4_variant_mm takes bfloat16 x, got ",
              x.scalar_type());
  int64_t in_f, out_f;
  std::tie(in_f, out_f, group) = check_quant(x, packed, scales, 4, false, group);
  const int64_t M = x.size(0);
  at::Tensor y = at::empty({M, out_f}, x.options());
  const int device = x.get_device();
  const auto stream = c10::cuda::getCurrentCUDAStream(device);
  const int err = smft_int4_variant_mm(device, static_cast<int>(arith), x.data_ptr(),
                                       packed.data_ptr(), scales.data_ptr<float>(), y.data_ptr(),
                                       M, in_f, out_f, static_cast<int>(group),
                                       static_cast<void*>(stream.stream()));
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
  return y;
}

// The decode kernel's shapes: bits 8 or 4, in % 8 == 0, out % 16 == 0,
// int4's (in / 2) % group == 0 with group >= 8, as check_quant takes them.
void check_decode_shape(const char* what, int64_t bits, int64_t M, int64_t in_f, int64_t out_f,
                        int64_t group) {
  TORCH_CHECK(bits == 4 || bits == 8, what, ": bits must be 4 or 8, got ", bits);
  TORCH_CHECK(M > 0 && in_f > 0 && out_f > 0 && in_f % 8 == 0 && out_f % 16 == 0 &&
                  in_f < INT32_MAX && out_f < INT32_MAX,
              what, ": needs M > 0, in % 8 == 0 and out % 16 == 0, got M ", M, ", in ", in_f,
              ", out ", out_f);
  TORCH_CHECK(bits == 8 || (group >= 8 && (in_f / 2) % group == 0), what,
              ": int4 needs a group of at least 8 with (in/2) % group == 0, got ", group);
}

std::vector<int64_t> quant_decode_plan(int64_t bits, bool bf16, int64_t M, int64_t in_f,
                                       int64_t out_f, int64_t group, int64_t arith) {
  check_arith(arith);
  check_decode_shape("quant_decode_plan", bits, M, in_f, out_f, group);
  TORCH_CHECK(arith == 0 || (bits == 4 && bf16), "the int4 variants take int4 and bfloat16");
  std::vector<int64_t> plan(11);
  const int err = smft_quant_decode_plan(c10::cuda::current_device(), static_cast<int>(bits),
                                         bf16 ? 1 : 0, static_cast<int>(arith), M, in_f, out_f,
                                         static_cast<int>(group), plan.data());
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
  return plan;
}

std::vector<int64_t> quant_decode_attrs() {
  std::vector<int64_t> out(8 * 32);
  int count = 0;
  const int err = smft_quant_decode_attrs(c10::cuda::current_device(), out.data(), 32, &count);
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
  TORCH_CHECK(count <= 32, "quant_decode_attrs: more instantiations than room");
  out.resize(8 * count);
  return out;
}

void quant_decode_empty(int64_t bits, bool bf16, int64_t M, int64_t in_f, int64_t out_f,
                        int64_t group) {
  check_decode_shape("quant_decode_empty", bits, M, in_f, out_f, group);
  const int device = c10::cuda::current_device();
  const auto stream = c10::cuda::getCurrentCUDAStream(device);
  const int err = smft_quant_decode_empty(device, static_cast<int>(bits), bf16 ? 1 : 0, M, in_f,
                                          out_f, static_cast<int>(group),
                                          static_cast<void*>(stream.stream()));
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
}

// K9 (dx false: a = x (M, n) -> y (M, m)) and K10 (dx true: a = dout (M, m)
// -> dx (M, n)); dense_w (m, n), w1 (K, Q, P), w2 (L, S, R).
at::Tensor run_more_linear(const at::Tensor& a, const at::Tensor& wd, const at::Tensor& w1,
                           const at::Tensor& w2, bool dx) {
  TORCH_CHECK(a.scalar_type() == at::kFloat || a.scalar_type() == at::kBFloat16,
              "the fused dense+Monarch kernels take float32 or bfloat16, got ", a.scalar_type());
  TORCH_CHECK(a.dim() == 2 && wd.dim() == 2, "activations must be (M, width) and dense_w (m, n)");
  TORCH_CHECK(w1.dim() == 3 && w2.dim() == 3, "w1 must be (K, Q, P) and w2 (L, S, R)");
  check_tensor(a, "activations", a);
  check_tensor(wd, "dense_w", a);
  check_tensor(w1, "w1", a);
  check_tensor(w2, "w2", a);
  const int64_t m = wd.size(0), n = wd.size(1);
  const int64_t K = w1.size(0), Q = w1.size(1), P = w1.size(2);
  const int64_t L = w2.size(0), S = w2.size(1), R = w2.size(2);
  TORCH_CHECK(K * P == n && S * L == m && L * R == K * Q, "w1 ", w1.sizes(), " and w2 ",
              w2.sizes(), " do not fit dense_w ", wd.sizes(), ": need K*P == n, S*L == m and ",
              "L*R == K*Q");
  TORCH_CHECK(a.size(1) == (dx ? m : n), "activations must be (M, ", dx ? m : n, "), got ",
              a.sizes());
  TORCH_CHECK(K * Q <= 64, "the kernels take K*Q <= 64, got ", K * Q);
  TORCH_CHECK(n % 8 == 0 && m % 8 == 0, "the kernels take widths that are multiples of 8, ",
              "got n ", n, ", m ", m);
  TORCH_CHECK(n < INT32_MAX && m < INT32_MAX, "widths must fit in 32 bits");
  for (const at::Tensor* t : {&a, &wd}) {
    TORCH_CHECK(reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                "the kernels load 16 bytes at a time: activations and dense_w must start on 16 "
                "bytes");
  }
  const int64_t M = a.size(0);
  at::Tensor out = at::empty({M, dx ? n : m}, a.options());
  if (M == 0) return out;
  // the f32 path's row summaries; bf16 computes them inside its one launch
  const bool f32 = a.scalar_type() == at::kFloat;
  at::Tensor work = f32 ? at::empty({M * K * Q}, a.options().dtype(at::kFloat)) : at::Tensor();
  const int device = a.get_device();
  const auto stream = c10::cuda::getCurrentCUDAStream(device);
  const int err = smft_more_linear(
      f32 ? 0 : 1, device, dx ? 1 : 0, a.data_ptr(), wd.data_ptr(), w1.data_ptr(),
      w2.data_ptr(), out.data_ptr(), f32 ? work.data_ptr<float>() : nullptr, M, n, m,
      static_cast<int>(K), static_cast<int>(Q), static_cast<int>(P), static_cast<int>(L),
      static_cast<int>(S), static_cast<int>(R), static_cast<void*>(stream.stream()));
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
  return out;
}

// The plan of a bf16 K9 (dx false) or K10 call on M rows, x (M, n), y (M,
// m), J = K*Q: (bm, bn, jk, stages, row tiles, column tiles, threads, shared
// memory bytes), on the current device.
std::vector<int64_t> more_linear_plan(int64_t M, int64_t n, int64_t m, int64_t J, bool dx) {
  TORCH_CHECK(M > 0 && n > 0 && m > 0 && J > 0 && J <= 64,
              "more_linear_plan takes M, n, m > 0 and 0 < J <= 64");
  std::vector<int64_t> plan(8);
  const int err = smft_more_linear_plan(c10::cuda::current_device(), dx ? 1 : 0, M, n, m,
                                        static_cast<int>(J), plan.data());
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
  return plan;
}

at::Tensor more_linear_fwd(const at::Tensor& x, const at::Tensor& dense_w, const at::Tensor& w1,
                           const at::Tensor& w2) {
  return run_more_linear(x, dense_w, w1, w2, false);
}

at::Tensor more_linear_dx(const at::Tensor& dout, const at::Tensor& dense_w,
                          const at::Tensor& w1, const at::Tensor& w2) {
  return run_more_linear(dout, dense_w, w1, w2, true);
}

// K15: x (M, K) @ w (K, N) -> y (M, N), bf16, at the tile (bm, bn, stages).
at::Tensor tiled_matmul(const at::Tensor& x, const at::Tensor& w, int64_t bm, int64_t bn,
                        int64_t stages) {
  TORCH_CHECK(x.scalar_type() == at::kBFloat16, "tiled_matmul takes bfloat16, got ",
              x.scalar_type());
  TORCH_CHECK(x.dim() == 2 && w.dim() == 2, "x must be (M, K) and w (K, N)");
  check_tensor(x, "x", x);
  check_tensor(w, "w", x);
  const int64_t M = x.size(0), K = x.size(1), N = w.size(1);
  TORCH_CHECK(w.size(0) == K, "w ", w.sizes(), " does not fit x ", x.sizes());
  TORCH_CHECK(K % 8 == 0 && N % 8 == 0, "tiled_matmul takes K and N that are multiples of 8 ",
              "(TMA needs 16-byte row strides), got K ", K, ", N ", N);
  TORCH_CHECK(M < INT32_MAX && N < INT32_MAX && K < INT32_MAX, "M, N and K must fit in 32 bits");
  for (const at::Tensor* t : {&x, &w}) {
    TORCH_CHECK(reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                "TMA reads from 16-byte aligned addresses: x and w must start on 16 bytes");
  }
  if (M == 0 || N == 0 || K == 0) return at::zeros({M, N}, x.options());
  at::Tensor y = at::empty({M, N}, x.options());
  const auto stream = c10::cuda::getCurrentCUDAStream(x.get_device());
  const int err = smft_tiled_matmul(x.get_device(), x.data_ptr(), w.data_ptr(), y.data_ptr(), M,
                                    N, K, static_cast<int>(bm), static_cast<int>(bn),
                                    static_cast<int>(stages), static_cast<void*>(stream.stream()));
  TORCH_CHECK(err != cudaErrorInvalidValue, "tiled_matmul: the tile (", bm, ", ", bn, ", ",
              stages, ") is not instantiated, or a tensor map was refused");
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
  return y;
}

// The plan of a K15 call at (M, N, K) and the tile, on the current device:
// resident CTAs, the grid's CTAs, CTAs a cluster, row, column and k tiles,
// units, the staged output columns and the shared memory a CTA
// (tiled_matmul.PLAN_KEYS).
std::vector<int64_t> tiled_matmul_plan(int64_t M, int64_t N, int64_t K, int64_t bm, int64_t bn,
                                       int64_t stages) {
  TORCH_CHECK(M > 0 && N > 0 && K > 0, "tiled_matmul_plan takes M, N, K > 0");
  std::vector<int64_t> plan(9);
  const int err = smft_tiled_matmul_plan(c10::cuda::current_device(), M, N, K,
                                         static_cast<int>(bm), static_cast<int>(bn),
                                         static_cast<int>(stages), plan.data());
  TORCH_CHECK(err != cudaErrorInvalidValue, "tiled_matmul_plan: the tile (", bm, ", ", bn, ", ",
              stages, ") is not instantiated");
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
  return plan;
}

}  // namespace

TORCH_LIBRARY(smft, m) {
  m.def("monarch_fwd(Tensor x, Tensor w1, Tensor w2) -> Tensor");
  m.def("monarch_fwd_add(Tensor base, Tensor x, Tensor w1, Tensor w2) -> Tensor");
  m.def("monarch_fwd_tile(Tensor x, Tensor w1, Tensor w2, int rows) -> Tensor");
  m.def("monarch_fwd_plan(int B, int K, int Q, int P, int L, int S, int R, int itemsize=2, "
        "int rows=0) -> int[]",
        &monarch_fwd_plan);
  m.def("monarch_bwd(Tensor x, Tensor w1, Tensor w2, Tensor dout) -> (Tensor, Tensor, Tensor)");
  m.def("monarch_dw_fused(Tensor x, Tensor dout, Tensor w1, Tensor w2) -> (Tensor, Tensor)");
  m.def("monarch_dw_tile(Tensor x, Tensor dout, Tensor w1, Tensor w2, int rows) -> "
        "(Tensor, Tensor)");
  m.def("monarch_bwd_plan(int M, int K, int Q, int P, int L, int S, int R, int rows, "
        "bool with_dx, int itemsize=2) -> (bool, int)",
        &monarch_bwd_plan);
  m.def("monarch_bwd_plan_fields(int M, int K, int Q, int P, int L, int S, int R, int rows, "
        "bool with_dx, int itemsize=2, int tile=0, int stages=0) -> int[]",
        &monarch_bwd_plan_fields);
  m.def("int8_mm(Tensor x, Tensor q, Tensor scales) -> Tensor");
  m.def("int8_mm_dx(Tensor dy, Tensor q, Tensor scales) -> Tensor");
  m.def("int4_mm(Tensor x, Tensor packed, Tensor scales, int group) -> Tensor");
  m.def("int4_mm_dx(Tensor dy, Tensor packed, Tensor scales, int group) -> Tensor");
  m.def("int4_variant_mm(Tensor x, Tensor packed, Tensor scales, int group, int arith) -> Tensor");
  m.def("quant_decode_plan(int bits, bool bf16, int M, int in_f, int out_f, int group=64, "
        "int arith=0) -> int[]",
        &quant_decode_plan);
  m.def("quant_decode_attrs() -> int[]", &quant_decode_attrs);
  m.def("quant_decode_empty(int bits, bool bf16, int M, int in_f, int out_f, int group) -> ()",
        &quant_decode_empty);
  m.def("more_linear_fwd(Tensor x, Tensor dense_w, Tensor w1, Tensor w2) -> Tensor");
  m.def("more_linear_dx(Tensor dout, Tensor dense_w, Tensor w1, Tensor w2) -> Tensor");
  m.def("more_linear_plan(int M, int n, int m, int J, bool dx) -> int[]", &more_linear_plan);
  m.def("tiled_matmul(Tensor x, Tensor w, int bm, int bn, int stages) -> Tensor");
  m.def("tiled_matmul_plan(int M, int N, int K, int bm, int bn, int stages) -> int[]",
        &tiled_matmul_plan);
}

TORCH_LIBRARY_IMPL(smft, CUDA, m) {
  m.impl("monarch_fwd", &monarch_fwd);
  m.impl("monarch_fwd_add", &monarch_fwd_add);
  m.impl("monarch_fwd_tile", &monarch_fwd_tile);
  m.impl("monarch_bwd", &monarch_bwd);
  m.impl("monarch_dw_fused", &monarch_dw_fused);
  m.impl("monarch_dw_tile", &monarch_dw_tile);
  m.impl("int8_mm", &int8_mm);
  m.impl("int8_mm_dx", &int8_mm_dx);
  m.impl("int4_mm", &int4_mm);
  m.impl("int4_mm_dx", &int4_mm_dx);
  m.impl("int4_variant_mm", &int4_variant_mm);
  m.impl("more_linear_fwd", &more_linear_fwd);
  m.impl("more_linear_dx", &more_linear_dx);
  m.impl("tiled_matmul", &tiled_matmul);
}
