// PyTorch bindings of the kernels in monarch_fwd.cu, monarch_bwd.cu,
// quant_matmul.cu and more_linear.cu:
//   torch.ops.smft.monarch_fwd(x, w1, w2)            -> out              (K1)
//   torch.ops.smft.monarch_fwd_add(base, x, w1, w2)  -> base + out       (K2)
//   torch.ops.smft.monarch_bwd(x, w1, w2, dout)      -> (dx, dw1, dw2)   (K3)
//   torch.ops.smft.monarch_dw_fused(x, dout, w1, w2) -> (dw1, dw2)       (K4)
//   torch.ops.smft.int4_mm(x, packed, scales, group)     -> y            (K5)
//   torch.ops.smft.int4_mm_dx(dy, packed, scales, group) -> dx           (K6)
//   torch.ops.smft.int8_mm(x, q, scales)                 -> y            (K7)
//   torch.ops.smft.int8_mm_dx(dy, q, scales)             -> dx           (K8)
//   torch.ops.smft.more_linear_fwd(x, dense_w, w1, w2)   -> y            (K9)
//   torch.ops.smft.more_linear_dx(dout, dense_w, w1, w2) -> dx           (K10)
// K11 is monarch_dw_fused (K4's kernel).  Only a CUDA implementation is
// registered, so a tensor on another device is refused by the dispatcher.
// The launch's error code is checked here and raised; the kernels run on
// PyTorch's current stream and allocate nothing: the outputs and the fp32
// scratch (the backward's row summaries and per-group partial sums, the
// decode split's partial sums, the fused linear's row summaries) are
// allocated here.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/zeros.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <cstdint>
#include <tuple>

extern "C" int smft_monarch_fwd(int dtype, int device, const void* x, const void* w1,
                                const void* w2, const void* base, void* out, int64_t B,
                                int K, int Q, int P, int L, int S, int R, void* stream);
extern "C" int64_t smft_monarch_bwd_workspace(int dtype, int device, const void* x,
                                              const void* dout, const void* w1, const void* w2,
                                              const void* dx, int64_t M, int K, int Q, int P,
                                              int L, int S, int R);
extern "C" int smft_monarch_bwd(int dtype, int device, const void* x, const void* dout,
                                const void* w1, const void* w2, void* dx, float* work,
                                float* dw1, float* dw2, int64_t M, int K, int Q, int P, int L,
                                int S, int R, void* stream);
extern "C" int64_t smft_quant_mm_workspace(int dtype, int device, int bits, int dx, int64_t M,
                                           int64_t in_f, int64_t out_f);
extern "C" int smft_quant_mm(int dtype, int device, int bits, int dx, const void* a,
                             const void* codes, const float* scales, void* out, float* work,
                             int64_t M, int64_t in_f, int64_t out_f, int group, void* stream);
extern "C" int smft_more_linear(int dtype, int device, int dx, const void* a, const void* wd,
                                const void* w1, const void* w2, void* out, float* work,
                                int64_t M, int64_t n, int64_t m, int K, int Q, int P, int L,
                                int S, int R, void* stream);

namespace {

void check_tensor(const at::Tensor& t, const char* name, const at::Tensor& x) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.device() == x.device(), name, " must be on the device of x");
  TORCH_CHECK(t.scalar_type() == x.scalar_type(), name, " must have the dtype of x (",
              x.scalar_type(), "), got ", t.scalar_type());
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

at::Tensor run(const at::Tensor& x, const at::Tensor& w1, const at::Tensor& w2,
               const at::Tensor* base) {
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
  const int err = smft_monarch_fwd(
      dtype, x.get_device(), x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
      base ? base->data_ptr() : nullptr, out.data_ptr(), B, static_cast<int>(K),
      static_cast<int>(Q), static_cast<int>(P), static_cast<int>(L), static_cast<int>(S),
      static_cast<int>(R), static_cast<void*>(stream.stream()));
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
  return out;
}

at::Tensor monarch_fwd(const at::Tensor& x, const at::Tensor& w1, const at::Tensor& w2) {
  return run(x, w1, w2, nullptr);
}

// K3 (with_dx) and K4: returns (dx or an empty tensor, dw1, dw2), dw in fp32.
std::tuple<at::Tensor, at::Tensor, at::Tensor> run_bwd(const at::Tensor& x,
                                                       const at::Tensor& dout,
                                                       const at::Tensor& w1,
                                                       const at::Tensor& w2, bool with_dx) {
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
      q, p, l, s, r);
  TORCH_CHECK(work_floats >= 0, "monarch_bwd: cannot read the device's SM count");
  at::Tensor work = at::empty({work_floats}, f32);
  const auto stream = c10::cuda::getCurrentCUDAStream(device);
  const int err = smft_monarch_bwd(
      dtype, device, x.data_ptr(), dout.data_ptr(), w1.data_ptr(), w2.data_ptr(), dx_ptr,
      work_floats > 0 ? work.data_ptr<float>() : nullptr, dw1.data_ptr<float>(),
      dw2.data_ptr<float>(), M, k, q, p, l, s, r, static_cast<void*>(stream.stream()));
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

at::Tensor monarch_fwd_add(const at::Tensor& base, const at::Tensor& x,
                           const at::Tensor& w1, const at::Tensor& w2) {
  return run(x, w1, w2, &base);
}

// K5-K8: a (M, in) for the forward or (M, out) for dx; codes int8 (in, out)
// or packed uint8 (in/2, out); scales f32 (in/group, out).
at::Tensor run_quant(const at::Tensor& a, const at::Tensor& codes, const at::Tensor& scales,
                     int bits, bool dx, int64_t group) {
  TORCH_CHECK(a.scalar_type() == at::kFloat || a.scalar_type() == at::kBFloat16,
              "the quantized matmuls take float32 or bfloat16 activations, got ",
              a.scalar_type());
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
  const int64_t M = a.size(0);
  at::Tensor out = at::empty({M, dx ? in_f : out_f}, a.options());
  const int device = a.get_device();
  const int dtype = a.scalar_type() == at::kFloat ? 0 : 1;
  const int64_t work_floats =
      smft_quant_mm_workspace(dtype, device, bits, dx ? 1 : 0, M, in_f, out_f);
  TORCH_CHECK(work_floats >= 0, "quantized matmul: cannot read the device's SM count");
  at::Tensor work = at::empty({work_floats}, a.options().dtype(at::kFloat));
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
  at::Tensor work = at::empty({M * K * Q}, a.options().dtype(at::kFloat));
  const int device = a.get_device();
  const auto stream = c10::cuda::getCurrentCUDAStream(device);
  const int err = smft_more_linear(
      a.scalar_type() == at::kFloat ? 0 : 1, device, dx ? 1 : 0, a.data_ptr(), wd.data_ptr(),
      w1.data_ptr(), w2.data_ptr(), out.data_ptr(), work.data_ptr<float>(), M, n, m,
      static_cast<int>(K), static_cast<int>(Q), static_cast<int>(P), static_cast<int>(L),
      static_cast<int>(S), static_cast<int>(R), static_cast<void*>(stream.stream()));
  C10_CUDA_CHECK(static_cast<cudaError_t>(err));
  return out;
}

at::Tensor more_linear_fwd(const at::Tensor& x, const at::Tensor& dense_w, const at::Tensor& w1,
                           const at::Tensor& w2) {
  return run_more_linear(x, dense_w, w1, w2, false);
}

at::Tensor more_linear_dx(const at::Tensor& dout, const at::Tensor& dense_w,
                          const at::Tensor& w1, const at::Tensor& w2) {
  return run_more_linear(dout, dense_w, w1, w2, true);
}

}  // namespace

TORCH_LIBRARY(smft, m) {
  m.def("monarch_fwd(Tensor x, Tensor w1, Tensor w2) -> Tensor");
  m.def("monarch_fwd_add(Tensor base, Tensor x, Tensor w1, Tensor w2) -> Tensor");
  m.def("monarch_bwd(Tensor x, Tensor w1, Tensor w2, Tensor dout) -> (Tensor, Tensor, Tensor)");
  m.def("monarch_dw_fused(Tensor x, Tensor dout, Tensor w1, Tensor w2) -> (Tensor, Tensor)");
  m.def("int8_mm(Tensor x, Tensor q, Tensor scales) -> Tensor");
  m.def("int8_mm_dx(Tensor dy, Tensor q, Tensor scales) -> Tensor");
  m.def("int4_mm(Tensor x, Tensor packed, Tensor scales, int group) -> Tensor");
  m.def("int4_mm_dx(Tensor dy, Tensor packed, Tensor scales, int group) -> Tensor");
  m.def("more_linear_fwd(Tensor x, Tensor dense_w, Tensor w1, Tensor w2) -> Tensor");
  m.def("more_linear_dx(Tensor dout, Tensor dense_w, Tensor w1, Tensor w2) -> Tensor");
}

TORCH_LIBRARY_IMPL(smft, CUDA, m) {
  m.impl("monarch_fwd", &monarch_fwd);
  m.impl("monarch_fwd_add", &monarch_fwd_add);
  m.impl("monarch_bwd", &monarch_bwd);
  m.impl("monarch_dw_fused", &monarch_dw_fused);
  m.impl("int8_mm", &int8_mm);
  m.impl("int8_mm_dx", &int8_mm_dx);
  m.impl("int4_mm", &int4_mm);
  m.impl("int4_mm_dx", &int4_mm_dx);
  m.impl("more_linear_fwd", &more_linear_fwd);
  m.impl("more_linear_dx", &more_linear_dx);
}
