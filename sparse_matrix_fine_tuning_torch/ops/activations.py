"""Gated activations: SwiGLU (SiLU(a) * b) and GeGLU (tanh-GELU(a) * b).

Counterpart of ``sparse_matrix_fine_tuning_tpu/ops/activations.py``, with
the same formulas in the same order.  The gradient is autograd's through
these plain ops; it equals the JAX package's hand-written VJP, which
recomputes the activation in the backward to save memory (a fused kernel
that does the same is ROADMAP.md queue B's optional Triton pass).
"""

from __future__ import annotations

import torch

_SQRT_2_OVER_PI = 0.7978845608028654  # sqrt(2/pi)


def swiglu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SiLU(a) * b."""
    return a * torch.sigmoid(a) * b


def geglu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """tanh-GELU(a) * b."""
    a3 = a * a * a
    return 0.5 * a * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (a + 0.044715 * a3))) * b
