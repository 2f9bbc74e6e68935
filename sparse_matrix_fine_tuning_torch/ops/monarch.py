"""Monarch (block-diagonal butterfly) multiply, plain PyTorch.

Counterpart of ``sparse_matrix_fine_tuning_tpu/ops/monarch.py`` (forward
only; the backward comes with training, ROADMAP.md queue A):

  x:  (..., n)      with n = k * p
  w1: (k, q, p)     first block-diagonal factor, x_k @ w1_k^T per block
  w2: (l, s, r)     second factor, l * r == k * q
  out: (..., s * l)

  out1 = cat_k(x_k @ w1_k^T)                  # (..., k*q)
  shuffle: flat index (k*q) read as (r, l)    # the butterfly interleave
  out2_l = out1_shuffled_l @ w2_l^T           # (..., s) per block l
  out flat index = (s, l)

Both products accumulate in fp32.  ``out1`` is rounded to the input dtype
between them and ``out`` at the end, where the JAX ``_monarch_fwd_impl``
rounds (:118, :124).  These functions are the plain versions that the CUDA
kernels in ``kernels/monarch_cuda.py`` are held against.
"""

from __future__ import annotations

import torch


def _check_shapes(n: int, w1_shape, w2_shape) -> None:
    k, q, p = w1_shape
    l, s, r = w2_shape
    if k * p != n:
        raise ValueError(f"w1 {tuple(w1_shape)} incompatible with input dim {n}: k*p={k * p}")
    if l * r != k * q:
        raise ValueError(f"w2 {tuple(w2_shape)} incompatible with w1 {tuple(w1_shape)}: "
                         f"l*r={l * r} != k*q={k * q}")


def _check_real(x: torch.Tensor) -> None:
    if x.is_complex():
        raise NotImplementedError(
            "complex Monarch multiply: ROADMAP.md queue A, 'Backward of the ops'")


def monarch_dense_equivalent(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The dense M of shape (s*l, k*p) with monarch(x) == x @ M^T."""
    k, q, p = w1.shape
    l, s, r = w2.shape
    _check_shapes(k * p, w1.shape, w2.shape)
    kq = k * q
    dev = w2.device
    j_idx = torch.arange(kq, device=dev)
    r_idx = j_idx // l
    l_idx = j_idx % l
    s_idx = torch.arange(s, device=dev)
    rows = (s_idx[:, None] * l + l_idx[None, :]).reshape(-1)
    cols = j_idx.repeat(s)
    vals = w2[l_idx[None, :], s_idx[:, None], r_idx[None, :]].reshape(-1)
    w2_perm = torch.zeros(s * l, kq, dtype=w2.dtype, device=dev)
    w2_perm[rows, cols] = vals
    w1_bd = torch.block_diag(*w1.unbind(0))
    return w2_perm @ w1_bd


def blockdiag_butterfly_multiply_reference(x: torch.Tensor, w1: torch.Tensor,
                                           w2: torch.Tensor) -> torch.Tensor:
    """Slow but obviously correct einsum oracle."""
    *batch, n = x.shape
    k, q, p = w1.shape
    l, s, r = w2.shape
    _check_shapes(n, w1.shape, w2.shape)
    xb = x.reshape(-1, k, p)
    out1 = torch.einsum("kqp,bkp->bkq", w1, xb)
    out1 = out1.reshape(-1, k * q).reshape(-1, r, l).transpose(1, 2)
    out2 = torch.einsum("lsr,blr->bsl", w2, out1)
    return out2.reshape(*batch, s * l)


def monarch_forward_f32(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The Monarch multiply before its last rounding: fp32 (..., s*l), with
    the intermediate rounded to x's dtype."""
    _check_real(x)
    *batch, n = x.shape
    k, q, p = w1.shape
    l, s, r = w2.shape
    _check_shapes(n, w1.shape, w2.shape)
    xb = x.reshape(-1, k, p).transpose(0, 1).float()                # (k, b, p)
    out1 = torch.bmm(xb, w1.float().transpose(1, 2))                # (k, b, q)
    out1 = out1.transpose(0, 1).reshape(-1, r, l).transpose(1, 2)   # (b, l, r)
    out1 = out1.to(x.dtype).float()
    out2 = torch.bmm(out1.transpose(0, 1), w2.float().transpose(1, 2))  # (l, b, s)
    return out2.permute(1, 2, 0).reshape(*batch, s * l)             # flat (s, l)


def blockdiag_butterfly_multiply(x: torch.Tensor, w1: torch.Tensor,
                                 w2: torch.Tensor) -> torch.Tensor:
    """Monarch multiply ``out = x @ Monarch(w1, w2)^T``: x (..., n) -> (..., s*l)."""
    return monarch_forward_f32(x, w1, w2).to(x.dtype)
