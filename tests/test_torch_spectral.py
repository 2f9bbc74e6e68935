"""The port's SpectralConv1d and SpectralConv2d (``layers/spectral.py``)
against the JAX package's on the CPU.

The JAX layers' weights are carried across by ``load_jax_state``; outputs
and the gradients of both weights and of the input are compared for seeded
numpy inputs, at odd and even lengths (the Nyquist bin), at modes that
overlap in 2-D, at the FNO Darcy grid 85 x 85 (where a 2-D inverse taken in
the other order would be 3.18 off), and with bf16 inputs (the layer
computes in float32 and casts back).

Tolerances (``utils/testing.TOLERANCES``): float32 outputs 1e-5
(``f32_op``); gradients, which sum FFTs over the batch and the grid, 1e-4
(``f32_logits``); bf16 outputs two ulps of their scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from test_torch_structured import check_parity, jax_state

from sparse_matrix_fine_tuning_torch.layers import spectral as ts
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, bf16_atol, to_numpy
from sparse_matrix_fine_tuning_tpu.layers import spectral as js

F32 = TOLERANCES["f32_op"]
SUMS = TOLERANCES["f32_logits"]


@pytest.mark.parametrize("case", [(3, 4, 5, 32), (3, 4, 5, 33), (2, 2, 17, 32), (4, 3, 1, 8)])
def test_torch_spectral_conv1d_matches_jax(case):
    c_in, c_out, modes, n = case
    rng = np.random.default_rng(n + modes)
    jl = js.SpectralConv1d(c_in, c_out, modes, rngs=nnx.Rngs(n))
    tl = ts.SpectralConv1d(c_in, c_out, modes, device="cpu")
    x = rng.standard_normal((2, c_in, n)).astype(np.float32)
    cot = rng.standard_normal((2, c_out, n)).astype(np.float32)
    check_parity(jl, tl, x, cot, F32, SUMS)


@pytest.mark.parametrize("case", [(3, 4, 5, 4, 16, 12), (3, 4, 5, 4, 17, 13), (2, 3, 6, 3, 10, 9),
                                  (2, 2, 12, 12, 85, 85)])
def test_torch_spectral_conv2d_matches_jax(case):
    c_in, c_out, m1, m2, h, w = case
    rng = np.random.default_rng(h * w)
    jl = js.SpectralConv2d(c_in, c_out, m1, m2, rngs=nnx.Rngs(h))
    tl = ts.SpectralConv2d(c_in, c_out, m1, m2, device="cpu")
    x = rng.standard_normal((2, c_in, h, w)).astype(np.float32)
    cot = rng.standard_normal((2, c_out, h, w)).astype(np.float32)
    check_parity(jl, tl, x, cot, F32, SUMS)


def test_torch_spectral_bf16_inputs_match_jax():
    rng = np.random.default_rng(9)
    for jl, tl, shape in [
        (js.SpectralConv1d(3, 4, 6, rngs=nnx.Rngs(1)), ts.SpectralConv1d(3, 4, 6, device="cpu"),
         (2, 3, 40)),
        (js.SpectralConv2d(3, 4, 4, 3, rngs=nnx.Rngs(2)),
         ts.SpectralConv2d(3, 4, 4, 3, device="cpu"), (2, 3, 12, 10))]:
        load_jax_state(tl, jax_state(jl))
        x = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(jl(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
        got = tl(torch.from_numpy(x).bfloat16())
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=bf16_atol(want))


def test_torch_spectral_inverse_order_matters():
    """The 2-D inverse is a complex inverse over rows, then a real one over
    columns: the other order, or zeroing the DC column's imaginary part,
    gives another answer on a mode-mixed spectrum."""
    rng = np.random.default_rng(4)
    spec = torch.from_numpy((rng.standard_normal((1, 1, 85, 43))
                             + 1j * rng.standard_normal((1, 1, 85, 43))).astype(np.complex64))
    want = np.fft.irfft2(spec.numpy().astype(np.complex128), s=(85, 85), norm="ortho")
    got = ts.real_inverse(torch.fft.ifft(spec, dim=-2, norm="ortho"), 85)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    other = torch.fft.ifft(torch.fft.irfft(spec, n=85, dim=-1, norm="ortho"), dim=-2,
                           norm="ortho").real
    assert np.abs(other.numpy() - want).max() > 0.1


def test_torch_spectral_init_and_states():
    """The weights' scale 1/(in*out), drawn on a CPU generator (the same
    numbers each build); JAX's state loads as it is."""
    a = ts.SpectralConv2d(8, 8, 4, 4, device="cpu")
    b = ts.SpectralConv2d(8, 8, 4, 4, device="cpu")
    assert torch.equal(a.weights1, b.weights1) and not torch.equal(a.weights1, a.weights2)
    assert abs(float(a.weights1.std()) * 64 - 1) < 0.1
    jl = js.SpectralConv2d(8, 8, 4, 4, rngs=nnx.Rngs(0))
    load_jax_state(a, jax_state(jl))
    np.testing.assert_array_equal(a.weights2.detach().numpy(), np.asarray(jl.weights2[...]))
