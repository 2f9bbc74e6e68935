"""BlockdiagLinear, ButterflyFFT and ButterflyFFT2, PyTorch.

Counterpart of ``sparse_matrix_fine_tuning_tpu/layers/structured.py``, with
its attribute names (``weight``, ``bias``; ``perm``, ``w1``, ``w2``; ``fft1``,
``fft2``), so ``utils/jax_bridge.load_jax_state`` carries a JAX module's
state across as it is.

  * ``BlockdiagLinear``: ``nblocks`` (out/nblocks, in/nblocks) blocks, an
    optional ShuffleNet channel shuffle of the input, a zero bias; the
    weight uniform in +-1/sqrt(in_features), the dense layer's bound.  Its
    product is the plain ``ops/blockdiag.blockdiag_multiply`` (a batched
    matmul), as the JAX layer's is XLA's.
  * ``ButterflyFFT``: the length-n (i)DFT as the input permutation ``perm``
    (an int32 buffer, as the JAX ``nnx.Variable``) and the rank-1 Monarch
    factors of ``ops/projection.butterfly_fft_factors``, stored as real
    parameters (..., 2) (real, imaginary) and multiplied by the complex
    ``ops/monarch.blockdiag_butterfly_multiply``.  Exact at init.
  * ``ButterflyFFT2``: the 2-D transform as two ButterflyFFTs, the first
    over the second-to-last axis.

Built on ``device``, the card when None (``utils/device.py``); random
weights are drawn from a CPU generator and moved, so the card and the CPU
start alike.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from sparse_matrix_fine_tuning_torch.ops.blockdiag import blockdiag_multiply
from sparse_matrix_fine_tuning_torch.ops.monarch import blockdiag_butterfly_multiply
from sparse_matrix_fine_tuning_torch.ops.projection import butterfly_fft_factors
from sparse_matrix_fine_tuning_torch.utils.device import resolve_device, seeded_generator

CPU = torch.device("cpu")


def uniform(shape, bound: float, dtype, device, generator: torch.Generator) -> torch.Tensor:
    """Uniform(-bound, bound), drawn on the generator's device, then moved."""
    t = torch.empty(shape, dtype=dtype, device=generator.device)
    return t.uniform_(-bound, bound, generator=generator).to(device)


def as_complex(p: torch.Tensor) -> torch.Tensor:
    """A (..., 2) real tensor as the complex tensor (...,) it stores."""
    return torch.complex(p[..., 0], p[..., 1])


def stacked(z: torch.Tensor) -> torch.Tensor:
    """A complex tensor as its (..., 2) real storage."""
    return torch.stack([z.real, z.imag], -1)


class BlockdiagLinear(nn.Module):
    """Block-diagonal linear with an optional channel shuffle."""

    def __init__(self, in_features: int, out_features: int, *, nblocks: int = 4,
                 shuffle: bool = False, use_bias: bool = True,
                 param_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if in_features % nblocks or out_features % nblocks:
            raise ValueError(f"{in_features} -> {out_features} does not split into "
                             f"{nblocks} blocks")
        device = resolve_device(device)
        generator = seeded_generator(CPU, generator)
        self.in_features, self.out_features = in_features, out_features
        self.nblocks, self.shuffle = nblocks, shuffle
        shape = (nblocks, out_features // nblocks, in_features // nblocks)
        self.weight = nn.Parameter(uniform(shape, 1.0 / math.sqrt(in_features), param_dtype,
                                           device, generator))
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=param_dtype, device=device)) \
            if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shuffle:  # (k, c) view transposed -> (c, k)
            b = x.shape[:-1]
            x = x.reshape(*b, self.nblocks, -1).transpose(-1, -2).reshape(*b, -1)
        out = blockdiag_multiply(x, self.weight.to(x.dtype))
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


class ButterflyFFT(nn.Module):
    """Length-n (i)DFT as an input permutation and a trainable Monarch
    product; complex64 (or complex) in and out."""

    def __init__(self, n: int, direction: str = "fft", norm: str = "ortho", *, device=None):
        super().__init__()
        device = resolve_device(device)
        perm, w1, w2 = butterfly_fft_factors(n, direction=direction, norm=norm)
        self.n = n
        self.register_buffer("perm", perm.to(device))
        self.w1 = nn.Parameter(stacked(w1).to(device))
        self.w2 = nn.Parameter(stacked(w2).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x if x.is_complex() else x.to(torch.complex64)
        shaped = xc[..., self.perm].reshape(-1, self.n)
        out = blockdiag_butterfly_multiply(shaped, as_complex(self.w1), as_complex(self.w2))
        return out.reshape(xc.shape)


class ButterflyFFT2(nn.Module):
    """2-D (i)DFT over the last two axes (n1, n2) as two ButterflyFFTs."""

    def __init__(self, n1: int, n2: int, direction: str = "fft", norm: str = "ortho", *,
                 device=None):
        super().__init__()
        self.fft1 = ButterflyFFT(n1, direction, norm, device=device)
        self.fft2 = ButterflyFFT(n2, direction, norm, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.fft1(x.transpose(-1, -2)).transpose(-1, -2)
        return self.fft2(out)
