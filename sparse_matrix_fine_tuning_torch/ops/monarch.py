"""Monarch (block-diagonal butterfly) multiply, plain PyTorch, with its
backward.

Counterpart of ``sparse_matrix_fine_tuning_tpu/ops/monarch.py``:

  x:  (..., n)      with n = k * p
  w1: (k, q, p)     first block-diagonal factor, x_k @ w1_k^T per block
  w2: (l, s, r)     second factor, l * r == k * q
  out: (..., s * l)

  out1 = cat_k(x_k @ w1_k^T)                  # (..., k*q)
  shuffle: flat index (k*q) read as (r, l)    # the butterfly interleave
  out2_l = out1_shuffled_l @ w2_l^T           # (..., s) per block l
  out flat index = (s, l)

Both products accumulate in fp32 (complex64 for a complex input, as the
JAX ``_pet`` chooses).  ``out1`` is rounded to the input dtype between them
and ``out`` at the end, where the JAX ``_monarch_fwd_impl`` rounds (:118,
:124).  These functions are the plain versions that the CUDA kernels in
``kernels/monarch_cuda.py`` are held against; the kernels are real, and
only ``layers/structured.ButterflyFFT`` multiplies complex factors, here.

Backward (JAX ``_bbm_bwd`` and ``monarch_dw``, :144-216): the forward is a
``torch.autograd.Function`` that saves (x, w1, w2, out1); its backward is
three batched products,

  dw2[l, s, r]  = sum_b dout[b, s, l] * out1[b, l, r]        (fp32)
  dout1[b, j]   = round_T( sum_s dout[b, s, l] * w2[l, s, r] ),  j = r*L + l
  dw1[k, q, p]  = sum_b dout1[b, k, q] * x[b, k, p]          (fp32)
  dx[b, k, p]   = round_T( sum_q dout1[b, k, q] * w1[k, q, p] )

with dout cast to x's dtype first and dw cast to the factor's dtype last,
where the JAX package rounds.

Complex inputs: PyTorch's autograd hands a backward the conjugate of JAX's
cotangent (for a real loss, ``x.grad`` is the conjugate of ``jax.grad``), so
the complex backward conjugates the saved operands where JAX's
``monarch_dw`` takes a pure transpose: dw2 = dout . conj(out1), dout1 =
dout . conj(w2), dw1 = dout1 . conj(x), dx = dout1 . conj(w1).  For real
inputs the conjugations are the identity.
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


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The products' accumulation dtype: fp32, or complex64 for complex inputs."""
    return torch.complex64 if dtype.is_complex else torch.float32


def _conj(t: torch.Tensor) -> torch.Tensor:
    return t.conj() if t.is_complex() else t


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


def _forward_with_out1(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """(output (..., s*l) in the accumulation dtype, out1 (b, l, r) rounded to
    x's dtype)."""
    *batch, n = x.shape
    k, q, p = w1.shape
    l, s, r = w2.shape
    acc = _acc(x.dtype)
    xb = x.reshape(-1, k, p).transpose(0, 1).to(acc)                # (k, b, p)
    out1 = torch.bmm(xb, w1.to(acc).transpose(1, 2))                # (k, b, q)
    out1 = out1.transpose(0, 1).reshape(-1, r, l).transpose(1, 2)   # (b, l, r)
    out1 = out1.to(x.dtype)
    out2 = torch.bmm(out1.to(acc).transpose(0, 1), w2.to(acc).transpose(1, 2))  # (l, b, s)
    return out2.permute(1, 2, 0).reshape(*batch, s * l), out1       # flat (s, l)


def _monarch_dw_f32(x: torch.Tensor, dout: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                    out1: torch.Tensor | None = None):
    """(dw1, dw2) in the accumulation dtype and dout1_kq (b, k, q) in x's dtype."""
    k, q, p = w1.shape
    l, s, r = w2.shape
    acc = _acc(x.dtype)
    xb = x.reshape(-1, k, p)
    if out1 is None:
        out1 = _forward_with_out1(x, w1, w2)[1]                     # (b, l, r)
    d3 = dout.reshape(-1, s, l).to(x.dtype).to(acc)                 # (b, s, l)
    dw2 = torch.einsum("bsl,blr->lsr", d3, _conj(out1).to(acc))
    dout1 = torch.einsum("bsl,lsr->blr", d3, _conj(w2).to(acc)).to(x.dtype)  # (b, l, r)
    dout1_kq = dout1.transpose(1, 2).reshape(-1, k, q)              # flat (r, l) = (k, q)
    dw1 = torch.einsum("bkq,bkp->kqp", dout1_kq.to(acc), _conj(xb).to(acc))
    return dw1, dw2, dout1_kq


def monarch_dw(x: torch.Tensor, dout: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
               out1: torch.Tensor | None = None):
    """Factor gradients of the Monarch multiply from its input and output
    cotangent: ``(dw1, dw2, dout1_kq)``, dw summed in fp32 and cast to the
    factors' dtype, dout1_kq (b, k, q) in x's dtype.  ``out1``: the saved
    post-shuffle intermediate (b, l, r), recomputed from x when None.  For
    complex inputs, PyTorch's gradients: the conjugates of JAX's for the
    conjugate cotangent."""
    _check_shapes(x.shape[-1], w1.shape, w2.shape)
    dw1, dw2, dout1_kq = _monarch_dw_f32(x, dout, w1, w2, out1)
    return dw1.to(w1.dtype), dw2.to(w2.dtype), dout1_kq


def monarch_dx(dout1_kq: torch.Tensor, w1: torch.Tensor, x_shape, dtype: torch.dtype
               ) -> torch.Tensor:
    """dx[b, k, p] = sum_q dout1[b, k, q] * conj(w1[k, q, p]), fp32 (complex64)
    sums, in ``dtype``."""
    acc = _acc(dtype)
    dx = torch.einsum("bkq,kqp->bkp", dout1_kq.to(acc), _conj(w1).to(acc))
    return dx.to(dtype).reshape(x_shape)


class _MonarchF32(torch.autograd.Function):
    """The Monarch multiply before its last rounding, with the plain
    backward of the JAX ``_bbm_bwd``."""

    @staticmethod
    def forward(ctx, x, w1, w2):
        out, out1 = _forward_with_out1(x, w1, w2)
        ctx.save_for_backward(x, w1, w2, out1)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w1, w2, out1 = ctx.saved_tensors
        dw1, dw2, dout1_kq = _monarch_dw_f32(x, dout, w1, w2, out1)
        dx = monarch_dx(dout1_kq, w1, x.shape, x.dtype)
        return dx, dw1.to(w1.dtype), dw2.to(w2.dtype)


def monarch_forward_f32(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The Monarch multiply before its last rounding: fp32 (complex64 for a
    complex x) (..., s*l), with the intermediate rounded to x's dtype.
    Differentiable (plain backward)."""
    _check_shapes(x.shape[-1], w1.shape, w2.shape)
    return _MonarchF32.apply(x, w1, w2)


def blockdiag_butterfly_multiply(x: torch.Tensor, w1: torch.Tensor,
                                 w2: torch.Tensor) -> torch.Tensor:
    """Monarch multiply ``out = x @ Monarch(w1, w2)^T``: x (..., n) -> (..., s*l)."""
    return monarch_forward_f32(x, w1, w2).to(x.dtype)
