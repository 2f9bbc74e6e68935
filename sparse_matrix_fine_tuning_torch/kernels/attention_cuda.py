"""Causal flash attention on the card (K17-K19), its autograd Function and
its device dispatch.

``splash_fwd``, ``splash_dq`` and ``splash_dkv`` launch the hand-written
CUDA kernels of ``csrc/flash_attention.cu``, which replace the three Pallas
kernels that JAX's splash attention runs for ``_splash_attention`` of
``sparse_matrix_fine_tuning_tpu/models/llama.py:57``: the forward
(``flash_attention_kernel``, which also saves the logsumexp), dq
(``_flash_attention_dq_kernel``) and dk/dv (``_flash_attention_dkv_kernel``).
They take CUDA tensors only and raise for anything else.  Their plain
versions are in ``ops/attention.py``.

``splash_attention(q, k, v)`` dispatches by device alone: an autograd
Function whose forward is K17 and whose backward computes
``di = rowsum(o * dout)`` in fp32 in PyTorch, as the JAX backward does
outside its kernels, then launches K18 and K19, on a CUDA tensor; the same
Function on the plain versions for a CPU tensor (the CPU tests' mode).  It
saves q, k, v, o and lse.

Tensors are (b, t, heads, head_dim) with equal heads, q already scaled by
``1/sqrt(head_dim)``; the kernels take float32 or bfloat16 and a head_dim of
64 or 128, at any t.  In bfloat16 the forward rounds P to bf16 for the
tensor cores' P.V, where the TPU kernel keeps P in fp32.

``LAUNCHES`` counts the launches of each kernel: a wrapper adds one where it
launches its kernel, and nowhere else.
"""

from __future__ import annotations

import torch

from sparse_matrix_fine_tuning_torch.kernels.monarch_cuda import load_ops
from sparse_matrix_fine_tuning_torch.ops.attention import (
    attention_di,
    attention_dkv_reference,
    attention_dq_reference,
    causal_attention_reference,
)

LAUNCHES = {"splash_fwd": 0, "splash_dq": 0, "splash_dkv": 0}
HEAD_DIMS = (64, 128)  # the head widths csrc/flash_attention.cu instantiates


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"the attention CUDA kernels take CUDA tensors, got one on {t.device}")
    q = tensors[0]
    if q.dim() != 4 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the attention CUDA kernels take (b, t, heads, head_dim) with "
                         f"head_dim in {HEAD_DIMS}, got {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the attention CUDA kernels take float32 or bfloat16, got {q.dtype}")


def splash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K17: ``(o, lse)``, o in q's dtype, lse fp32 (b, heads, t)."""
    _check(q, k, v)
    o, lse = load_ops().flash_attn_fwd(q.contiguous(), k.contiguous(), v.contiguous())
    LAUNCHES["splash_fwd"] += 1
    return o, lse


def splash_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
              lse: torch.Tensor, di: torch.Tensor) -> torch.Tensor:
    """K18: dq in q's dtype; dout is taken in q's dtype."""
    _check(q, k, v, dout, lse, di)
    dq = load_ops().flash_attn_dq(q.contiguous(), k.contiguous(), v.contiguous(),
                                  dout.to(q.dtype).contiguous(), lse.contiguous(),
                                  di.contiguous())
    LAUNCHES["splash_dq"] += 1
    return dq


def splash_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
               lse: torch.Tensor, di: torch.Tensor):
    """K19: ``(dk, dv)`` in k's dtype; dout is taken in q's dtype."""
    _check(q, k, v, dout, lse, di)
    dk, dv = load_ops().flash_attn_dkv(q.contiguous(), k.contiguous(), v.contiguous(),
                                       dout.to(q.dtype).contiguous(), lse.contiguous(),
                                       di.contiguous())
    LAUNCHES["splash_dkv"] += 1
    return dk, dv


class _SplashFn(torch.autograd.Function):
    """K17 forward, K18 and K19 backward on the card; the plain versions on
    the CPU.  Saves (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = (splash_fwd if q.is_cuda else causal_attention_reference)(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dout = dout.to(q.dtype)
        di = attention_di(o, dout)
        if q.is_cuda:
            dq = splash_dq(q, k, v, dout, lse, di)
            dk, dv = splash_dkv(q, k, v, dout, lse, di)
        else:
            dq = attention_dq_reference(q, k, v, dout, lse, di)
            dk, dv = attention_dkv_reference(q, k, v, dout, lse, di)
        return dq, dk, dv


def splash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of pre-scaled q over k, v, all (b, t, heads,
    head_dim): the kernels on a CUDA tensor, the plain versions on a CPU
    tensor.  Differentiable."""
    if not (q.dtype == k.dtype == v.dtype and q.shape == k.shape == v.shape):
        raise ValueError(f"q, k and v must share shape and dtype, got {tuple(q.shape)} "
                         f"{q.dtype}, {tuple(k.shape)} {k.dtype}, {tuple(v.shape)} {v.dtype}")
    return _SplashFn.apply(q, k, v)
