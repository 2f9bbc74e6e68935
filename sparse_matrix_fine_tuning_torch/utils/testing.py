"""Helpers for holding the port against the JAX package in tests.

Arrays cross between the frameworks as numpy arrays, and every crossing
copies: a zero-copy view (``jnp.asarray(t.numpy())``) aliased torch storage
once and silently broke a parity experiment (ROADMAP.md, commit 52fcba2).

``TOLERANCES`` is the table the port's tests use:
  * f32 ops: the two frameworks sum in another order, 1e-5;
  * f32 model logits: a few layers of such sums, 1e-4;
  * bf16 ops: two bf16 ulps of the output's scale, ``bf16_atol``; the
    intermediate may round one ulp apart and the output rounds once more.
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
