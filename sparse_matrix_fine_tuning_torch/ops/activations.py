"""Gated activations, forward only: SwiGLU (SiLU(a) * b) and GeGLU
(tanh-GELU(a) * b).

Counterpart of ``sparse_matrix_fine_tuning_tpu/ops/activations.py``, with
the same formulas in the same order; the recompute-in-backward comes with
training.
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
