"""Single block-diagonal factor multiply, plain PyTorch; its gradient is
autograd's through these ops.

Counterpart of ``sparse_matrix_fine_tuning_tpu/ops/blockdiag.py``: k
independent (q, p) blocks applied to the k contiguous p-chunks of the input.
``MonarchLinear``'s multiplicative factor uses it.
"""

from __future__ import annotations

import torch


def blockdiag_multiply(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """out[..., (k q)] = x[..., (k p)] blockwise, x_k @ w_k^T, fp32 accumulation."""
    *batch, n = x.shape
    k, q, p = weight.shape
    if k * p != n:
        raise ValueError(f"weight {tuple(weight.shape)} incompatible with input dim {n}")
    xb = x.reshape(-1, k, p).transpose(0, 1).float()           # (k, b, p)
    out = torch.bmm(xb, weight.float().transpose(1, 2))        # (k, b, q)
    return out.to(x.dtype).transpose(0, 1).reshape(*batch, k * q)


def blockdiag_weight_to_dense_weight(weight: torch.Tensor) -> torch.Tensor:
    """Dense (k*q, k*p) equivalent of a block-diagonal weight."""
    return torch.block_diag(*weight.unbind(0))
