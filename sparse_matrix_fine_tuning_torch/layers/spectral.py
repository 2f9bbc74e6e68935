"""FNO spectral convolutions, PyTorch: FFT, a per-mode linear mix, inverse FFT.

Counterpart of ``sparse_matrix_fine_tuning_tpu/layers/spectral.py``:
ortho-normalised real transforms, complex weights stored as real
parameters (..., 2) (``weights1``, ``weights2``, as the JAX names), the
lowest ``modes1`` frequencies mixed (1-D) or the (low, low) and (high, low)
corners (2-D), the rest zero, and the inverse back to the input length.
The input is taken in float32 and the output cast back to its dtype.

The transforms are ``torch.fft`` (cuFFT on the card), as the JAX layer's
are ``jnp.fft``; the mode mix is an einsum.  The mixed spectrum is not
Hermitian, so an inverse real transform depends on how it treats the parts
that a Hermitian spectrum would not have:

  * 1-D: a real inverse reads only the real part of the zero-frequency bin
    (and of the Nyquist bin at even n).  Their imaginary parts are zeroed
    before ``irfft``: the same output, with nothing left to the transform.
  * 2-D: ``jnp.fft.irfft2`` equals a complex inverse over the first axis,
    then a real inverse over the last (to 7e-7 at 85 x 85); the other order
    differs by 3.18, and a multi-dimensional C2R makes no promise for such
    input.  So the 2-D inverse is those two 1-D steps, written out.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sparse_matrix_fine_tuning_torch.layers.structured import CPU, as_complex
from sparse_matrix_fine_tuning_torch.utils.device import resolve_device, seeded_generator


def _normal(shape, scale: float, device, generator: torch.Generator) -> torch.Tensor:
    t = torch.randn(shape, generator=generator, device=generator.device)
    return (scale * t).to(device)


def real_inverse(spectrum: torch.Tensor, n: int) -> torch.Tensor:
    """``irfft`` over the last axis to length ``n`` (ortho), the imaginary
    parts of the zero-frequency and (even n) Nyquist bins set to zero first."""
    keep = torch.ones(spectrum.shape[-1], dtype=torch.float32, device=spectrum.device)
    keep[0] = 0.0
    if n % 2 == 0 and spectrum.shape[-1] == n // 2 + 1:
        keep[-1] = 0.0
    spectrum = torch.complex(spectrum.real, spectrum.imag * keep)
    return torch.fft.irfft(spectrum, n=n, norm="ortho")


class SpectralConv1d(nn.Module):
    """1-D Fourier layer: x (batch, in_channels, length) -> (batch,
    out_channels, length)."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = seeded_generator(CPU, generator)
        self.in_channels, self.out_channels, self.modes1 = in_channels, out_channels, modes1
        scale = 1.0 / (in_channels * out_channels)
        self.weights1 = nn.Parameter(_normal((in_channels, out_channels, modes1, 2), scale,
                                             device, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-1]
        x_ft = torch.fft.rfft(x.float(), norm="ortho")
        out_lo = torch.einsum("bix,iox->box", x_ft[:, :, :self.modes1],
                              as_complex(self.weights1))
        rest = out_lo.new_zeros(*out_lo.shape[:-1], x_ft.shape[-1] - self.modes1)
        return real_inverse(torch.cat([out_lo, rest], -1), n).to(x.dtype)


class SpectralConv2d(nn.Module):
    """2-D Fourier layer: x (batch, in_channels, h, w) -> (batch,
    out_channels, h, w); ``weights1`` mixes the (low, low) corner of the
    rfft2 spectrum, ``weights2`` the (high, low) one."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int, modes2: int, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = seeded_generator(CPU, generator)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.modes1, self.modes2 = modes1, modes2
        scale = 1.0 / (in_channels * out_channels)
        shape = (in_channels, out_channels, modes1, modes2, 2)
        self.weights1 = nn.Parameter(_normal(shape, scale, device, generator))
        self.weights2 = nn.Parameter(_normal(shape, scale, device, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w_len = x.shape[-2], x.shape[-1]
        x_ft = torch.fft.rfft2(x.float(), norm="ortho")
        m1, m2 = self.modes1, self.modes2
        lo = torch.einsum("bixy,ioxy->boxy", x_ft[:, :, :m1, :m2], as_complex(self.weights1))
        hi = torch.einsum("bixy,ioxy->boxy", x_ft[:, :, -m1:, :m2], as_complex(self.weights2))
        out_ft = x_ft.new_zeros(x.shape[0], self.out_channels, *x_ft.shape[-2:])
        out_ft[:, :, :m1, :m2] = lo
        out_ft[:, :, -m1:, :m2] = hi
        return real_inverse(torch.fft.ifft(out_ft, dim=-2, norm="ortho"), w_len).to(x.dtype)
