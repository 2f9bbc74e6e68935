"""The port's BlockdiagLinear, ButterflyFFT and ButterflyFFT2
(``layers/structured.py``) against the JAX package's on the CPU.

The JAX layer's whole ``nnx.state`` (ButterflyFFT's int32 ``perm`` too) is
carried into the port's by ``utils/jax_bridge.load_jax_state``; inputs and
cotangents come from seeded numpy generators.  Outputs and the gradients of
every parameter and of the input are compared.  ButterflyFFT takes complex
inputs: for a real loss PyTorch's gradient of a complex tensor is the
conjugate of ``jax.grad``'s, while real leaves (the stacked factors) agree
as they are.

Tolerances (``utils/testing.TOLERANCES``): float32 outputs 1e-5
(``f32_op``), gradients that sum over the batch 1e-4 (``f32_logits``);
bfloat16 two ulps of the output's scale (``bf16_atol``); the transforms
against ``torch.fft`` within 1e-3, as the JAX tests hold them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.layers import structured as ts
from sparse_matrix_fine_tuning_torch.ops.monarch import monarch_dense_equivalent
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, bf16_atol, to_numpy
from sparse_matrix_fine_tuning_tpu.layers import structured as js
from sparse_matrix_fine_tuning_tpu.ops import monarch as jm

F32 = TOLERANCES["f32_op"]
SUMS = TOLERANCES["f32_logits"]
FFT_TOL = dict(rtol=1e-3, atol=1e-3)


def jax_state(module) -> dict:
    """{path: numpy copy} of an NNX module's whole state (Variables and the
    plain arrays NNX keeps as state)."""
    return {tuple(getattr(p, "key", p) for p in path): np.array(getattr(v, "value", v))
            for path, v in nnx.to_flat_state(nnx.state(module))}


def jax_grads(module, x, cot):
    """(output, {param path: grad}, grad of x) of sum(Re(module(x) * conj(cot)))."""
    graphdef, params, rest = nnx.split(module, nnx.Param, ...)

    def loss(params, x):
        out = nnx.merge(graphdef, params, rest)(x)
        return jnp.sum(jnp.real(out * jnp.conj(cot))), out

    (_, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
    grads = {tuple(getattr(p, "key", p) for p in path): np.array(getattr(v, "value", v))
             for path, v in nnx.to_flat_state(gp)}
    return np.asarray(out), grads, np.asarray(gx)


def torch_grads(module, x, cot):
    x = x.clone().requires_grad_()
    out = module(x)
    loss = (out * cot.conj()).real.sum() if out.is_complex() else (out * cot).sum()
    loss.backward()
    return out.detach(), {n: p.grad for n, p in module.named_parameters()}, x.grad


def check_parity(jmod, tmod, x, cot, out_tol, grad_tol, conj_x: bool = False) -> None:
    load_jax_state(tmod, jax_state(jmod))
    want, wgrads, wgx = jax_grads(jmod, jnp.asarray(x), jnp.asarray(cot))
    got, tgrads, tgx = torch_grads(tmod, torch.from_numpy(x), torch.from_numpy(cot))
    if out_tol == "bf16":
        np.testing.assert_allclose(to_numpy(got), want.astype(np.float32), rtol=0,
                                   atol=bf16_atol(want))
    else:
        np.testing.assert_allclose(got.numpy(), want, **out_tol)
    assert sorted(tgrads) == sorted(".".join(map(str, k)) for k in wgrads)
    for path, w in wgrads.items():
        g = to_numpy(tgrads[".".join(map(str, path))])
        np.testing.assert_allclose(g, w.astype(g.dtype), **grad_tol)
    np.testing.assert_allclose(tgx.numpy(), np.conj(wgx) if conj_x else wgx, **grad_tol)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("shape", [(32, 48, 4), (64, 16, 2), (24, 24, 3)])
def test_torch_blockdiag_linear_matches_jax(shape, shuffle):
    n_in, n_out, nblocks = shape
    rng = np.random.default_rng(n_in + n_out + shuffle)
    jl = js.BlockdiagLinear(n_in, n_out, nblocks=nblocks, shuffle=shuffle, rngs=nnx.Rngs(1))
    jl.bias[...] = jnp.asarray(rng.standard_normal(n_out), jnp.float32)  # init is zero
    tl = ts.BlockdiagLinear(n_in, n_out, nblocks=nblocks, shuffle=shuffle, device="cpu")
    x = rng.standard_normal((2, 5, n_in)).astype(np.float32)
    cot = rng.standard_normal((2, 5, n_out)).astype(np.float32)
    check_parity(jl, tl, x, cot, F32, SUMS)


def test_torch_blockdiag_linear_bf16_matches_jax():
    """bf16 activations over float32 parameters, cast to bf16 in the layer."""
    rng = np.random.default_rng(3)
    jl = js.BlockdiagLinear(64, 32, nblocks=4, shuffle=True, rngs=nnx.Rngs(2))
    tl = ts.BlockdiagLinear(64, 32, nblocks=4, shuffle=True, device="cpu")
    load_jax_state(tl, jax_state(jl))
    x = rng.standard_normal((7, 64)).astype(np.float32)
    want = np.asarray(jl(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = tl(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=bf16_atol(want))


def test_torch_blockdiag_linear_shapes_and_init():
    """JAX tests/layers/test_structured.py's shapes and sparsity, and the
    dense layer's uniform bound 1/sqrt(in) at init, drawn on the CPU."""
    layer = ts.BlockdiagLinear(32, 48, nblocks=4, device="cpu")
    assert layer(torch.randn(5, 32)).shape == (5, 48)
    assert layer.weight.numel() == 4 * 12 * 8
    assert ts.BlockdiagLinear(32, 32, nblocks=4, shuffle=True, device="cpu")(
        torch.randn(3, 32)).shape == (3, 32)
    big = ts.BlockdiagLinear(256, 256, nblocks=4, device="cpu")
    bound = 1 / 16
    assert big.weight.abs().max() <= bound and big.weight.abs().max() > 0.95 * bound
    assert torch.equal(big.bias, torch.zeros(256))
    again = ts.BlockdiagLinear(256, 256, nblocks=4, device="cpu")
    assert torch.equal(big.weight, again.weight)  # seeded CPU generator
    with pytest.raises(ValueError, match="blocks"):
        ts.BlockdiagLinear(30, 32, nblocks=4, device="cpu")


def _complex_inputs(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("direction", ["fft", "ifft"])
@pytest.mark.parametrize("n", [16, 36, 64])
def test_torch_butterfly_fft_matches_jax(n, direction):
    rng = np.random.default_rng(n)
    jf = js.ButterflyFFT(n, direction=direction)
    tf = ts.ButterflyFFT(n, direction=direction, device="cpu")
    # train-like factors: the init is exact, so perturb it
    for name in ("w1", "w2"):
        p = getattr(jf, name)
        p[...] = p[...] + 0.1 * jnp.asarray(rng.standard_normal(p[...].shape), jnp.float32)
    x = _complex_inputs(rng, (3, n))
    cot = _complex_inputs(rng, (3, n))
    check_parity(jf, tf, x, cot, F32, SUMS, conj_x=True)
    assert tf.perm.dtype == torch.int32


@pytest.mark.parametrize("direction", ["fft", "ifft"])
@pytest.mark.parametrize("n", [16, 36, 64])
def test_torch_butterfly_fft_exact_at_init(n, direction):
    """The port's own factors: the transform within 1e-3 of ``torch.fft``
    (complex and real inputs), and their dense equivalent within 1e-5 of
    the JAX factors' (the factors themselves differ by a phase a block)."""
    rng = np.random.default_rng(n + 1)
    tf = ts.ButterflyFFT(n, direction=direction, device="cpu")
    fn = torch.fft.fft if direction == "fft" else torch.fft.ifft
    x = torch.from_numpy(_complex_inputs(rng, (4, n)))
    np.testing.assert_allclose(tf(x).detach().numpy(), fn(x, norm="ortho").resolve_conj().numpy(), **FFT_TOL)
    xr = torch.from_numpy(rng.standard_normal((2, 3, n)).astype(np.float32))
    got = tf(xr)
    assert got.dtype == torch.complex64 and got.shape == (2, 3, n)
    np.testing.assert_allclose(got.detach().numpy(), fn(xr, norm="ortho").resolve_conj().numpy(), **FFT_TOL)
    jf = js.ButterflyFFT(n, direction=direction)
    want = jm.monarch_dense_equivalent(jax.lax.complex(jf.w1[...][..., 0], jf.w1[...][..., 1]),
                                       jax.lax.complex(jf.w2[...][..., 0], jf.w2[...][..., 1]))
    dense = monarch_dense_equivalent(ts.as_complex(tf.w1), ts.as_complex(tf.w2))
    np.testing.assert_allclose(dense.detach().numpy(), np.asarray(want), **F32)
    assert np.array_equal(tf.perm.numpy(), np.asarray(jf.perm[...]))


@pytest.mark.parametrize("shape", [(16, 16), (36, 16)])
def test_torch_butterfly_fft2_matches_jax(shape):
    n1, n2 = shape
    rng = np.random.default_rng(n1 * n2)
    jf = js.ButterflyFFT2(n1, n2)
    tf = ts.ButterflyFFT2(n1, n2, device="cpu")
    x = _complex_inputs(rng, (2, n1, n2))
    cot = _complex_inputs(rng, (2, n1, n2))
    check_parity(jf, tf, x, cot, F32, SUMS, conj_x=True)
    got = tf(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.fft.fft2(x, norm="ortho"), **FFT_TOL)


def test_torch_structured_states_load_unchanged():
    """``load_jax_state`` carries each layer's whole JAX state, int32 perms
    included, and refuses a perm of another integer type."""
    jf2 = js.ButterflyFFT2(16, 36)
    state = jax_state(jf2)
    assert state[("fft1", "perm")].dtype == np.int32
    tf2 = ts.ButterflyFFT2(16, 36, device="cpu")
    load_jax_state(tf2, state)
    assert tf2.fft2.perm.dtype == torch.int32
    state[("fft1", "perm")] = state[("fft1", "perm")].astype(np.int64)
    with pytest.raises(ValueError, match="codes do not fit"):
        load_jax_state(tf2, state)
    jl = js.BlockdiagLinear(16, 8, nblocks=2, use_bias=False, rngs=nnx.Rngs(0))
    tl = ts.BlockdiagLinear(16, 8, nblocks=2, use_bias=False, device="cpu")
    load_jax_state(tl, jax_state(jl))
    assert tl.bias is None and np.array_equal(tl.weight.detach().numpy(), np.asarray(jl.weight[...]))
