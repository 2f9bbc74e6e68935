"""Monarch kernels on the card (K1-K4), their autograd Functions, and their
plain versions.

``monarch_kernel`` and ``monarch_add`` launch the hand-written CUDA forward
kernels of ``csrc/monarch_fwd.cu``; ``monarch_bwd`` and ``monarch_dw_fused``
the backward kernels of ``csrc/monarch_bwd.cu``.  They replace
``monarch_kernel``, ``monarch_add``, the backward ``_monarch_pallas_bwd_call``
and ``monarch_dw_fused`` of
``sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py``.  They take CUDA
tensors only and raise for anything else: nothing here moves work to the
plain path or to the CPU.  ``monarch_mm`` dispatches by device alone: a
CUDA tensor goes to the kernel, a CPU tensor to the plain version (the CPU
tests' mode).

Semantics, for x of dtype T (float32 or bfloat16):
  monarch_kernel(x, w1, w2)      = blockdiag_butterfly_multiply(x, w1, w2)
  monarch_add(base, x, w1, w2)   = round_T(float(base) + monarch_f32(x))
  monarch_bwd(x, w1, w2, dout)   = (dx in T, dw1 fp32, dw2 fp32)
  monarch_dw_fused(x, dout, w1, w2) = (dw1 fp32, dw2 fp32)
where the intermediates are rounded to T and every sum is fp32.  The fused
add rounds once; the unfused ``base + monarch_kernel(x)`` rounds twice, so
the two differ by up to one ulp of T at the output's scale.

Gradients: ``monarch_kernel`` and ``monarch_add`` are autograd Functions
that save (x, w1, w2) only; their backward launches K3, which recomputes
the intermediate from x as the TPU kernel does.  The gradient of
``monarch_add``'s base is dout itself.

``LAUNCHES`` counts the launches of each kernel: a wrapper adds one where it
launches its kernel, and nowhere else.
"""

from __future__ import annotations

import torch

from sparse_matrix_fine_tuning_torch.ops.monarch import (
    _monarch_dw_f32,
    blockdiag_butterfly_multiply,
    monarch_dx,
    monarch_forward_f32,
)

LAUNCHES = {"monarch_kernel": 0, "monarch_add": 0, "monarch_bwd": 0, "monarch_dw_fused": 0}

_ops = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load_ops():
    """Build (at first use) and load the kernel library; ``torch.ops.smft``."""
    global _ops
    if _ops is None:
        from sparse_matrix_fine_tuning_torch.kernels.build import build

        torch.ops.load_library(str(build()))
        _ops = torch.ops.smft
    return _ops


# -- plain versions ----------------------------------------------------------

def monarch_kernel_reference(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1 (differentiable, plain backward)."""
    return blockdiag_butterfly_multiply(x, w1, w2)


def monarch_add_reference(base: torch.Tensor, x: torch.Tensor, w1: torch.Tensor,
                          w2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: the add in fp32, one rounding."""
    return (base.float() + monarch_forward_f32(x, w1, w2)).to(x.dtype)


def monarch_bwd_reference(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                          dout: torch.Tensor):
    """Plain PyTorch version of K3: ``(dx, dw1, dw2)``, dw in fp32.
    x (M, n), dout (M, m)."""
    dw1, dw2, dout1_kq = _monarch_dw_f32(x, dout, w1, w2)
    return monarch_dx(dout1_kq, w1, x.shape, x.dtype), dw1, dw2


def monarch_dw_fused_reference(x: torch.Tensor, dout: torch.Tensor, w1: torch.Tensor,
                               w2: torch.Tensor):
    """Plain PyTorch version of K4: ``(dw1, dw2)`` in fp32."""
    dw1, dw2, _ = _monarch_dw_f32(x, dout, w1, w2)
    return dw1, dw2


# -- kernels -----------------------------------------------------------------

def _check(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"the Monarch CUDA kernels take CUDA tensors, got one on {t.device}")


def _launch_fwd(x2d, w1, w2, base2d=None):
    if base2d is None:
        out = load_ops().monarch_fwd(x2d, w1, w2)
        LAUNCHES["monarch_kernel"] += 1
    else:
        out = load_ops().monarch_fwd_add(base2d, x2d, w1, w2)
        LAUNCHES["monarch_add"] += 1
    return out


def monarch_bwd(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, dout: torch.Tensor):
    """K3: ``(dx, dw1, dw2)`` of the Monarch multiply in one CUDA kernel (and
    a pass that sums its per-group partials).  x (M, n), dout (M, m); dout
    is taken in x's dtype; dw1 and dw2 come out in fp32."""
    _check(x, w1, w2, dout)
    dx, dw1, dw2 = load_ops().monarch_bwd(x.contiguous(), w1.contiguous(), w2.contiguous(),
                                          dout.to(x.dtype).contiguous())
    LAUNCHES["monarch_bwd"] += 1
    return dx, dw1, dw2


def monarch_dw_fused(x: torch.Tensor, dout: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """K4: ``(dw1, dw2)`` in fp32 from one read of x (M, n) and dout (M, m)."""
    _check(x, dout, w1, w2)
    dw1, dw2 = load_ops().monarch_dw_fused(x.contiguous(), dout.to(x.dtype).contiguous(),
                                           w1.contiguous(), w2.contiguous())
    LAUNCHES["monarch_dw_fused"] += 1
    return dw1, dw2


class _MonarchKernelFn(torch.autograd.Function):
    """K1 forward, K3 backward; saves (x, w1, w2) only."""

    @staticmethod
    def forward(ctx, x2d, w1, w2):
        ctx.save_for_backward(x2d, w1, w2)
        return _launch_fwd(x2d, w1, w2)

    @staticmethod
    def backward(ctx, dout):
        x2d, w1, w2 = ctx.saved_tensors
        dx, dw1, dw2 = monarch_bwd(x2d, w1, w2, dout)
        return dx, dw1.to(w1.dtype), dw2.to(w2.dtype)


class _MonarchAddFn(torch.autograd.Function):
    """K2 forward, K3 backward; d_base = dout."""

    @staticmethod
    def forward(ctx, base2d, x2d, w1, w2):
        ctx.save_for_backward(x2d, w1, w2)
        ctx.base_dtype = base2d.dtype
        return _launch_fwd(x2d, w1, w2, base2d)

    @staticmethod
    def backward(ctx, dout):
        x2d, w1, w2 = ctx.saved_tensors
        dx, dw1, dw2 = monarch_bwd(x2d, w1, w2, dout)
        return dout.to(ctx.base_dtype), dx, dw1.to(w1.dtype), dw2.to(w2.dtype)


def monarch_kernel(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """K1: ``x @ Monarch(w1, w2)^T`` in one CUDA kernel.  x (..., n).
    Differentiable: the gradient is K3."""
    _check(x, w1, w2)
    *batch, n = x.shape
    out = _MonarchKernelFn.apply(x.reshape(-1, n).contiguous(), w1.contiguous(),
                                 w2.contiguous())
    return out.reshape(*batch, out.shape[-1])


def monarch_add(base: torch.Tensor, x: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor) -> torch.Tensor:
    """K2: ``base + monarch(x)`` with the add in the kernel's epilogue.
    Differentiable: the gradient of x, w1 and w2 is K3, that of base dout."""
    _check(x, w1, w2, base)
    *batch, n = x.shape
    out = _MonarchAddFn.apply(base.reshape(-1, base.shape[-1]).contiguous(),
                              x.reshape(-1, n).contiguous(), w1.contiguous(), w2.contiguous())
    return out.reshape(base.shape)


def monarch_mm(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Device dispatch of K1: the kernel on CUDA, the plain version on the CPU."""
    if x.is_cuda:
        return monarch_kernel(x, w1, w2)
    return monarch_kernel_reference(x, w1, w2)


def monarch_dw_any(x: torch.Tensor, dout: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """Device dispatch of K4: (dw1, dw2) in fp32, the kernel on CUDA, the
    plain version on the CPU."""
    if x.is_cuda:
        return monarch_dw_fused(x, dout, w1, w2)
    return monarch_dw_fused_reference(x, dout, w1, w2)
