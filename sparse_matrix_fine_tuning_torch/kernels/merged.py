"""Merge-during-training: the adapter folded into the frozen dense operand.

Counterpart of ``sparse_matrix_fine_tuning_tpu/kernels/merged.py``.  The
dense is frozen, so the adapted layer

    y = x @ (Wd + M(w1, w2))^T

is exact with one merged operand that changes only when (w1, w2) change:
once per optimizer step, not per micro-batch.  The forward and the input
gradient are then one dense product each, as in a layer with no adapter;
the factor gradients come straight from (x, dout) through the Monarch
structure: K4 (``monarch_dw_fused``) on the card, the plain ``monarch_dw``
on the CPU.

Numerics: the merged operand is summed in fp32 and rounded once to the
dense's dtype.  The factor gradients are exact in the sense of the JAX
package: they do not go through the merged operand.  Valid for the plain
additive adapter only (no output dropout, Scaler or multiplicative factor).

The dense equivalent comes from ``ops/monarch.monarch_dense_equivalent``,
not from the TPU kernel's expanded ``W1bd``/``W2hat``.  The merged matrix is
kept once, in the dense's (out, in) layout: ``wm`` (in, out) and ``wm_t``
(out, in) are two views of it, since a transposed operand costs cuBLAS no
copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sparse_matrix_fine_tuning_torch.kernels.monarch_cuda import monarch_dw_any
from sparse_matrix_fine_tuning_torch.ops.monarch import monarch_dense_equivalent


@torch.no_grad()
def build_merged_operands(dense: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """``(wm, wm_t)`` from the frozen dense (out, in) and the Monarch factors:
    ``wm`` (in, out) for the forward ``x @ wm``, ``wm_t`` (out, in) for the
    input gradient ``dout @ wm_t``, both views of one matrix in
    ``dense.dtype``."""
    m, n = dense.shape
    # The factors in the dense's dtype, their dense equivalent summed in fp32.
    d = monarch_dense_equivalent(w1.to(dense.dtype).float(), w2.to(dense.dtype).float())
    # Padded blocks fold away: zero-padded input columns never contribute and
    # truncated output rows are dropped.
    merged = (dense.float() + d[:m, :n]).to(dense.dtype)
    return merged.t(), merged


class _MergedApply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wm, wm_t, w1, w2):
        ctx.save_for_backward(x, wm_t, w1, w2)
        return F.linear(x, wm_t)

    @staticmethod
    def backward(ctx, dout):
        x, wm_t, w1, w2 = ctx.saved_tensors
        n = x.shape[-1]
        m = dout.shape[-1]
        d2 = dout.reshape(-1, m)
        dx = (d2 @ wm_t).to(x.dtype).reshape(x.shape)
        # The factor gradients at the extended (padded) Monarch shapes: zero-pad
        # the input features and the cotangent of the truncated output columns.
        k, _, p = w1.shape
        l, s, _ = w2.shape
        x2 = x.reshape(-1, n)
        if k * p > n:
            x2 = F.pad(x2, (0, k * p - n))
        if s * l > m:
            d2 = F.pad(d2, (0, s * l - m))
        dw1, dw2 = monarch_dw_any(x2, d2, w1, w2)
        return dx, None, None, dw1.to(w1.dtype), dw2.to(w2.dtype)


def merged_apply(x: torch.Tensor, wm: torch.Tensor, wm_t: torch.Tensor, w1: torch.Tensor,
                 w2: torch.Tensor) -> torch.Tensor:
    """``x @ wm`` with factor-structured gradients.

    ``(wm, wm_t)`` must be ``build_merged_operands(dense, w1, w2)`` for the
    same (w1, w2); the trainer refreshes them at the top of every optimizer
    step.  Gradients: dx through ``wm_t`` (one dense product); (dw1, dw2)
    from (x, dout) through K4 on the card, the plain ``monarch_dw`` on the
    CPU; ``wm`` and ``wm_t`` get none (the dense is frozen).
    """
    if wm.shape != wm_t.t().shape:
        raise ValueError(f"wm {tuple(wm.shape)} and wm_t {tuple(wm_t.shape)} do not match")
    return _MergedApply.apply(x, wm, wm_t, w1, w2)
