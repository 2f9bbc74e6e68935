// PyTorch bindings of the Monarch kernels in monarch_fwd.cu and monarch_bwd.cu:
//   torch.ops.smft.monarch_fwd(x, w1, w2)            -> out              (K1)
//   torch.ops.smft.monarch_fwd_add(base, x, w1, w2)  -> base + out       (K2)
//   torch.ops.smft.monarch_bwd(x, w1, w2, dout)      -> (dx, dw1, dw2)   (K3)
//   torch.ops.smft.monarch_dw_fused(x, dout, w1, w2) -> (dw1, dw2)       (K4)
// Only a CUDA implementation is registered, so a tensor on another device
// is refused by the dispatcher.  The launch's error code is checked here
// and raised; the kernels run on PyTorch's current stream and allocate
// nothing: the outputs and the backward's fp32 scratch (row summaries and
// per-group partial sums) are allocated here.

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

}  // namespace

TORCH_LIBRARY(smft, m) {
  m.def("monarch_fwd(Tensor x, Tensor w1, Tensor w2) -> Tensor");
  m.def("monarch_fwd_add(Tensor base, Tensor x, Tensor w1, Tensor w2) -> Tensor");
  m.def("monarch_bwd(Tensor x, Tensor w1, Tensor w2, Tensor dout) -> (Tensor, Tensor, Tensor)");
  m.def("monarch_dw_fused(Tensor x, Tensor dout, Tensor w1, Tensor w2) -> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(smft, CUDA, m) {
  m.impl("monarch_fwd", &monarch_fwd);
  m.impl("monarch_fwd_add", &monarch_fwd_add);
  m.impl("monarch_bwd", &monarch_bwd);
  m.impl("monarch_dw_fused", &monarch_dw_fused);
}
