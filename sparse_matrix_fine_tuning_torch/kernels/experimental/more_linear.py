"""The fused dense + Monarch linear on the card (K9, K10, K11), its autograd
Function, and its plain versions.

Counterpart of ``sparse_matrix_fine_tuning_tpu/kernels/experimental/more_linear.py``:

  more_linear(x, dense_w, w1, w2) = x @ dense_w^T + monarch(x, w1, w2)

with ``dense_w`` (m, n) frozen, w1 (K, Q, P) and w2 (L, S, R), n == K*P,
m == S*L and L*R == K*Q.  For x of dtype T (float32 or bfloat16), every sum
in fp32:

  forward  y  = round_T( x Wd^T   + round_T(out1)  W2hat   ),  out1  = x W1bd
  dx       dx = round_T( dout Wd  + round_T(dout1) W1bd^T  ),  dout1 = dout W2hat^T
  dw       (dw1, dw2) in fp32, as K4, out1 and dout1 rounded to T

where W1bd[k*P + p, k*Q + q] = w1[k, q, p] and W2hat[r*L + l, s*L + l] =
w2[l, s, r] are the TPU kernel's permuted-dense expansions.  Neither is ever
built here: the kernels and the plain versions index the factors.

``more_linear_fwd`` (K9) and ``more_linear_dx`` (K10) launch the hand-written
CUDA kernels of ``csrc/more_linear.cu`` (bf16: one warp-specialised wgmma +
TMA launch a call, whose tile plan ``more_linear_plan`` reads; f32: a
row-summary pass, then a CUDA-core tile kernel).  ``more_linear_dw`` (K11)
launches K4's kernel of ``csrc/monarch_bwd.cu``, since the TPU's ``_dw_kernel``
computes the same function as ``_dw_only_kernel``; it counts under its own
key and leaves ``monarch_cuda.LAUNCHES`` as it was.  The three take CUDA
tensors only and raise for anything else.  ``more_linear`` dispatches by
device alone: CUDA tensors go to the kernels, CPU tensors to the plain
versions (the CPU tests' mode).  The gradient of ``dense_w`` is None, where
the JAX package returns zeros.

``LAUNCHES`` counts the launches of each kernel: a wrapper adds one where it
launches its kernel, and nowhere else.
"""

from __future__ import annotations

import torch

from sparse_matrix_fine_tuning_torch.kernels.monarch_cuda import (
    load_ops,
    monarch_dw_fused_reference,
)
from sparse_matrix_fine_tuning_torch.ops.monarch import _forward_with_out1

LAUNCHES = {"more_linear_fwd": 0, "more_linear_dx": 0, "more_linear_dw": 0}
# the fields of ``more_linear_plan``
PLAN_KEYS = ("bm", "bn", "jk", "stages", "row_tiles", "col_tiles", "threads", "smem")


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def more_linear_supported(n: int, m: int, w1_shape, w2_shape) -> bool:
    """The JAX shape rules (n == K*P, m == S*L, L*R == K*Q), without its
    VMEM budget, a TPU measurement.  The kernels take further limits, which
    their binding checks: n and m multiples of 8, K*Q <= 64."""
    k, q, p = w1_shape
    l, s, r = w2_shape
    return k * p == n and s * l == m and l * r == k * q


# -- plain versions ----------------------------------------------------------

def more_linear_fwd_reference(x: torch.Tensor, dense_w: torch.Tensor, w1: torch.Tensor,
                              w2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K9: x (M, n) -> y (M, m) in x's dtype."""
    mon, _ = _forward_with_out1(x, w1, w2)
    return (x.float() @ dense_w.float().T + mon).to(x.dtype)


def more_linear_dx_reference(dout: torch.Tensor, dense_w: torch.Tensor, w1: torch.Tensor,
                             w2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K10: dout (M, m) -> dx (M, n) in dout's dtype."""
    k, q, p = w1.shape
    l, s, _ = w2.shape
    d3 = dout.reshape(-1, s, l).float()
    dout1 = torch.einsum("bsl,lsr->brl", d3, w2.float()).to(dout.dtype)  # flat r*L + l = k*Q + q
    mon = torch.einsum("bkq,kqp->bkp", dout1.reshape(-1, k, q).float(), w1.float())
    return (dout.float() @ dense_w.float() + mon.reshape(-1, k * p)).to(dout.dtype)


# Plain PyTorch version of K11: (dw1, dw2) in fp32, K4's function.
more_linear_dw_reference = monarch_dw_fused_reference


# -- kernels -----------------------------------------------------------------

def _check(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"the fused dense+Monarch CUDA kernels take CUDA tensors, got one "
                             f"on {t.device}")


def more_linear_plan(m_rows: int, n: int, m: int, j: int, dx: bool) -> dict:
    """The plan of a bf16 K9 (``dx`` False: x (m_rows, n) -> (m_rows, m)) or
    K10 call on the current card, as ``PLAN_KEYS``: the output tile (bm x
    bn), the row summaries' width jk (J = K*Q rounded up to 16), the ring's
    stages, the grid, the threads and the shared memory of a CTA.  The
    library is loaded (built) first."""
    plan = load_ops().more_linear_plan(m_rows, n, m, j, dx)
    return dict(zip(PLAN_KEYS, (int(v) for v in plan)))


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """Contiguous and starting on 16 bytes: the kernels load 16 bytes a thread."""
    a = a.contiguous()
    return a.clone() if a.data_ptr() % 16 else a


def more_linear_fwd(x: torch.Tensor, dense_w: torch.Tensor, w1: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    """K9: ``x @ dense_w^T + monarch(x)`` with one rounding, x (M, n)."""
    _check(x, dense_w, w1, w2)
    y = load_ops().more_linear_fwd(_aligned(x), _aligned(dense_w), w1.contiguous(),
                                   w2.contiguous())
    LAUNCHES["more_linear_fwd"] += 1
    return y


def more_linear_dx(dout: torch.Tensor, dense_w: torch.Tensor, w1: torch.Tensor,
                   w2: torch.Tensor) -> torch.Tensor:
    """K10: the input gradient ``dout @ dense_w + monarch^T(dout)``, dout (M, m)."""
    _check(dout, dense_w, w1, w2)
    dx = load_ops().more_linear_dx(_aligned(dout), _aligned(dense_w), w1.contiguous(),
                                   w2.contiguous())
    LAUNCHES["more_linear_dx"] += 1
    return dx


def more_linear_dw(x: torch.Tensor, dout: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """K11: ``(dw1, dw2)`` in fp32 from one read of x (M, n) and dout (M, m),
    through K4's kernel; dout is taken in x's dtype."""
    _check(x, dout, w1, w2)
    dw1, dw2 = load_ops().monarch_dw_fused(x.contiguous(), dout.to(x.dtype).contiguous(),
                                           w1.contiguous(), w2.contiguous())
    LAUNCHES["more_linear_dw"] += 1
    return dw1, dw2


class _MoreLinearFn(torch.autograd.Function):
    """K9 forward, K10 and K11 backward on the card; the plain versions on
    the CPU.  Saves (x, dense_w, w1, w2), as the JAX ``fwd`` does."""

    @staticmethod
    def forward(ctx, x2d, dense_w, w1, w2):
        ctx.save_for_backward(x2d, dense_w, w1, w2)
        if x2d.is_cuda:
            return more_linear_fwd(x2d, dense_w, w1, w2)
        return more_linear_fwd_reference(x2d, dense_w, w1, w2)

    @staticmethod
    def backward(ctx, dout):
        x2d, dense_w, w1, w2 = ctx.saved_tensors
        dout = dout.to(x2d.dtype)
        if x2d.is_cuda:
            dx = more_linear_dx(dout, dense_w, w1, w2)
            dw1, dw2 = more_linear_dw(x2d, dout, w1, w2)
        else:
            dx = more_linear_dx_reference(dout, dense_w, w1, w2)
            dw1, dw2 = more_linear_dw_reference(x2d, dout, w1, w2)
        return dx, None, dw1.to(w1.dtype), dw2.to(w2.dtype)


def more_linear(x: torch.Tensor, dense_w: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor) -> torch.Tensor:
    """Fused ``x @ dense_w^T + monarch(x, w1, w2)``, x (..., n) -> (..., m).

    dense_w (m, n) is frozen: it gets no gradient.  Differentiable in x, w1
    and w2: K10 and K11 on the card."""
    *batch, n = x.shape
    m = dense_w.shape[0]
    if tuple(dense_w.shape) != (m, n) or not more_linear_supported(n, m, w1.shape, w2.shape):
        raise ValueError(f"more_linear: x (..., {n}), dense_w {tuple(dense_w.shape)}, w1 "
                         f"{tuple(w1.shape)} and w2 {tuple(w2.shape)} need dense_w (m, n), "
                         "n == K*P, m == S*L and L*R == K*Q")
    y = _MoreLinearFn.apply(x.reshape(-1, n), dense_w, w1, w2)
    return y.reshape(*batch, m)
