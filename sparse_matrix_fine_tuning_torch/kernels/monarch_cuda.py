"""Monarch forward kernels on the card (K1, K2), and their plain versions.

``monarch_kernel`` and ``monarch_add`` launch the hand-written CUDA kernels
of ``csrc/monarch_fwd.cu``; they replace ``monarch_kernel`` and
``monarch_add`` of ``sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py``.
They take CUDA tensors only and raise for anything else: nothing here moves
work to the plain path or to the CPU.  ``monarch_mm`` dispatches by device
alone: a CUDA tensor goes to the kernel, a CPU tensor to the plain version
(the CPU tests' mode).

Semantics, for x of dtype T (float32 or bfloat16):
  monarch_kernel(x, w1, w2)      = blockdiag_butterfly_multiply(x, w1, w2)
  monarch_add(base, x, w1, w2)   = round_T(float(base) + monarch_f32(x))
where the intermediate is rounded to T and every sum is fp32.  The fused add
rounds once; the unfused ``base + monarch_kernel(x)`` rounds twice, so the
two differ by up to one ulp of T at the output's scale.

``LAUNCHES`` counts the launches of each kernel: a wrapper adds one where it
launches its kernel, and nowhere else.
"""

from __future__ import annotations

import torch

from sparse_matrix_fine_tuning_torch.ops.monarch import (
    blockdiag_butterfly_multiply,
    monarch_forward_f32,
)

LAUNCHES = {"monarch_kernel": 0, "monarch_add": 0}

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


def monarch_kernel_reference(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1."""
    return blockdiag_butterfly_multiply(x, w1, w2)


def monarch_add_reference(base: torch.Tensor, x: torch.Tensor, w1: torch.Tensor,
                          w2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: the add in fp32, one rounding."""
    return (base.float() + monarch_forward_f32(x, w1, w2)).to(x.dtype)


def _check(x: torch.Tensor, *others: torch.Tensor) -> None:
    for t in (x, *others):
        if not t.is_cuda:
            raise ValueError(f"the Monarch CUDA kernels take CUDA tensors, got one on {t.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *others)):
        raise NotImplementedError(
            "the Monarch CUDA kernels have no backward yet: the backward kernel is K3 in "
            "ROADMAP.md (queue B).  Call them under torch.no_grad() or inference_mode().")


def monarch_kernel(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """K1: ``x @ Monarch(w1, w2)^T`` in one CUDA kernel.  x (..., n)."""
    _check(x, w1, w2)
    *batch, n = x.shape
    out = load_ops().monarch_fwd(x.reshape(-1, n).contiguous(), w1.contiguous(),
                                 w2.contiguous())
    LAUNCHES["monarch_kernel"] += 1
    return out.reshape(*batch, out.shape[-1])


def monarch_add(base: torch.Tensor, x: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor) -> torch.Tensor:
    """K2: ``base + monarch(x)`` with the add in the kernel's epilogue."""
    _check(x, w1, w2, base)
    *batch, n = x.shape
    out = load_ops().monarch_fwd_add(
        base.reshape(-1, base.shape[-1]).contiguous(), x.reshape(-1, n).contiguous(),
        w1.contiguous(), w2.contiguous())
    LAUNCHES["monarch_add"] += 1
    return out.reshape(base.shape)


def monarch_mm(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Device dispatch of K1: the kernel on CUDA, the plain version on the CPU."""
    if x.is_cuda:
        return monarch_kernel(x, w1, w2)
    return monarch_kernel_reference(x, w1, w2)

