"""Helpers for holding the port against the JAX package in tests.

Arrays cross between the frameworks as numpy arrays, and every crossing
copies: a zero-copy view (``jnp.asarray(t.numpy())``) aliased torch storage
once and silently broke a parity experiment (ROADMAP.md, commit 52fcba2).

``TOLERANCES`` is the table the port's tests use:
  * f32 ops: the two frameworks sum in another order, 1e-5;
  * f32 model logits: a few layers of such sums, 1e-4;
  * bf16 ops: two bf16 ulps of the output's scale, ``bf16_atol``; the
    intermediate may round one ulp apart and the output rounds once more.

``attention_block_error`` and ``ATTN_BLOCK_RTOL`` hold K17-K19's outputs
row block by row block, where the scale-wide bound is loose: an attention
output's largest value sits in its first rows (o[0] = v[0]), while a late
row averages hundreds of values and is many times smaller.
"""

from __future__ import annotations

import numpy as np
import torch

TOLERANCES = {
    "f32_op": dict(rtol=1e-5, atol=1e-5),
    "f32_logits": dict(rtol=1e-4, atol=1e-4),
}


def bf16_atol(ref) -> float:
    """Two bf16 ulps at the scale of ``ref``: 2 * 2**-7 * max|ref|."""
    return float(np.abs(np.asarray(ref, np.float32)).max()) * 2.0 ** -6


# K17-K19 against their plain versions: ``attention_block_error`` at most
# this.  bf16: the outputs round once and the kernels round P (or dS) to
# bf16 where the plain versions round it too or keep fp32; f32: the sums in
# another order.  Readings (H100, PERF.md §6): bf16 up to 0.0026 (K17) and
# 0.0009 (K18, K19), f32 up to 5.1e-7; planted faults 0.034 and more.
ATTN_BLOCK_ROWS = 64
ATTN_BLOCK_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


def attention_block_error(got: torch.Tensor, ref: torch.Tensor,
                          rows: int = ATTN_BLOCK_ROWS) -> float:
    """The largest ||got - ref|| / ||ref|| (Frobenius) over the blocks of
    ``rows`` rows of t in each (batch, head) of two (b, t, heads, head_dim)
    tensors (the last block ragged).  A block where ref is 0 gives 0 if got
    is 0 there too, else infinity."""
    b, t, h, d = ref.shape
    pad = -t % rows

    def block_sq(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        return x.view(b, (t + pad) // rows, rows, h, d).square().sum((2, 4))

    err, scale = block_sq(got.float() - ref.float()), block_sq(ref.float())
    ratio = torch.where(scale > 0, err / scale.clamp_min(torch.finfo(torch.float32).tiny),
                        torch.where(err > 0, float("inf"), 0.0))
    return float(ratio.max().sqrt())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of a tensor; bfloat16 becomes float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def to_torch(a, dtype: torch.dtype | None = None, device=None) -> torch.Tensor:
    """A torch copy of a numpy array, in ``dtype`` where given."""
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(dtype=dtype or t.dtype, device=device)
