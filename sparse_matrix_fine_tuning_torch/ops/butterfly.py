"""Classic butterfly-factor utilities, plain PyTorch.

Counterpart of ``sparse_matrix_fine_tuning_tpu/ops/butterfly.py``: one
butterfly factor as a dense matrix (``layers/blocksparse``'s layouts are
built from its support), and the block-butterfly product of log2(n)
factors.  The products are ``torch.einsum``, as the JAX package's are
``jnp.einsum``; no kernel of the port runs here.
"""

from __future__ import annotations

import torch


def butterfly_factor_to_matrix(twiddle: torch.Tensor, factor_index: int) -> torch.Tensor:
    """One classic butterfly factor as a dense (n, n) matrix.

    twiddle: (n // 2, 2, 2) entries of the factor; stride 2**factor_index.
    Pair (i0, i1 = i0 + stride) of group g gets twiddle[g * stride + s]."""
    half_n = twiddle.shape[0]
    n = half_n * 2
    stride = 1 << factor_index
    groups = n // (2 * stride)
    t = twiddle.reshape(groups, stride, 4)
    i0 = (torch.arange(groups)[:, None] * 2 * stride + torch.arange(stride)[None, :]).to(
        twiddle.device)
    i1 = i0 + stride
    rows = torch.stack([i0, i0, i1, i1], -1).reshape(-1)
    cols = torch.stack([i0, i1, i0, i1], -1).reshape(-1)
    mat = torch.zeros(n, n, dtype=twiddle.dtype, device=twiddle.device)
    return mat.index_put((rows, cols), t.reshape(-1))


def block_butterfly_factor_multiply(twiddle: torch.Tensor, x: torch.Tensor,
                                    factor_index: int) -> torch.Tensor:
    """One block-butterfly factor: twiddle (nstacks, n // 2, 2, 2, bs, bs),
    x (batch, nstacks, n, bs) -> (batch, nstacks, n, bs); stride
    2**factor_index over n."""
    b, nstacks, n, bs = x.shape
    stride = 1 << factor_index
    xv = x.reshape(b, nstacks, n // (2 * stride), 2, stride, bs)
    tv = twiddle.reshape(nstacks, n // (2 * stride), stride, 2, 2, bs, bs)
    # out[..., i, ...] = sum_j tw[i, j] @ x[..., j, ...]
    out = torch.einsum("sgtijpq,bsgjtq->bsgitp", tv, xv)
    return out.reshape(b, nstacks, n, bs)


def block_butterfly_multiply(twiddle: torch.Tensor, x: torch.Tensor,
                             increasing_stride: bool = True) -> torch.Tensor:
    """The product of log2(n) block-butterfly factors: twiddle (nstacks,
    log_n, n // 2, 2, 2, bs, bs), x (batch, nstacks, n, bs)."""
    log_n = twiddle.shape[1]
    order = range(log_n) if increasing_stride else range(log_n - 1, -1, -1)
    for idx in order:
        x = block_butterfly_factor_multiply(twiddle[:, idx], x, idx)
    return x
