"""The plain versions of K5-K8 (``kernels/quant_cuda``) against the JAX
package's Pallas kernels run in interpret mode, as its own tests run them
(``int8_matmul``/``int4_matmul(..., interpret=True)`` and ``jax.grad`` of
them), and the quantized ``MonarchLinear`` against the JAX layer.

Shapes: those of ``tests/kernels/test_quant_matmul.py:26-31``, a ragged row
count (65) and a 3-D input.  Tolerances:
  * float32: 1e-5 of the output's scale (sums in another order);
  * bfloat16, above 64 rows: two bf16 ulps of the output's scale (2**-6
    of it): the weight is rounded to bf16 once on both sides, the sums
    differ in order and the output rounds once more;
  * bfloat16, up to 64 rows: the JAX int4 kernel keeps the dequantized
    weight in f32 there (its ``f32dot`` branch, a TPU measurement the port
    does not carry over), the port rounds it to bf16 as at every other row
    count: each product then differs by up to 2**-9 relatively, so 2**-5
    of the output's scale;
  * dx, float32: 1e-4 of its scale (the gradient's sums over out in another
    order, as the JAX package's own test states).
The layer: float32, 1e-5 for the output, 1e-4 for the gradients of x and
both factors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch import quant as tq
from sparse_matrix_fine_tuning_torch.kernels import quant_cuda as qc
from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import quant as jq
from sparse_matrix_fine_tuning_tpu.kernels import quant_matmul as jqm
from sparse_matrix_fine_tuning_tpu.layers import monarch_linear as jml
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam

# (out, in, group, rows)
SHAPES = [(256, 256, 64, 4), (384, 512, 64, 16), (128, 768, 32, 8), (256, 256, 64, 96),
          (256, 512, 64, 65)]


def _tol(ref: np.ndarray, dtype: str, rows: int, dx: bool = False) -> float:
    scale = float(np.abs(ref).max())
    if dtype == "float32":
        return scale * (1e-4 if dx else 1e-5)
    return scale * (2.0 ** -5 if rows <= 64 and not dx else 2.0 ** -6)


def _operands(out_f, in_f, group, rows, bits, dtype, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((out_f, in_f)) * 0.1).astype(np.float32)
    codes, scales = jq.quantize_int4(w, group) if bits == 4 else jq.quantize_int8(w)
    x = rng.standard_normal((rows, in_f)).astype(np.float32)
    dy = rng.standard_normal((rows, out_f)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jdy = jnp.asarray(dy, getattr(jnp, dtype))
    t = getattr(torch, dtype)
    return (codes, scales, jx, jdy, to_torch(x).to(t), to_torch(dy).to(t))


def _jax_mm(bits, group):
    if bits == 4:
        return lambda x, c, s: jqm.int4_matmul(x, c, s, group, interpret=True)
    return lambda x, c, s: jqm.int8_matmul(x, c, s, interpret=True)


def _port_mm(bits, group):
    if bits == 4:
        return (lambda x, c, s: qc.int4_matmul_reference(x, c, s, group),
                lambda dy, c, s: qc.int4_matmul_dx_reference(dy, c, s, group))
    return qc.int8_matmul_reference, qc.int8_matmul_dx_reference


# every shape in float32; in bfloat16 the f32dot row count, a training-size
# one and the ragged one
CASES = [(s, "float32") for s in SHAPES] + [(SHAPES[i], "bfloat16") for i in (0, 3, 4)]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape,dtype", CASES,
                         ids=[f"{o}x{i}g{g}m{m}-{d}" for (o, i, g, m), d in CASES])
def test_torch_quant_matmul_plain_matches_jax_kernel(shape, dtype, bits):
    out_f, in_f, group, rows = shape
    codes, scales, jx, jdy, x, dy = _operands(out_f, in_f, group, rows, bits, dtype)
    jmm = _jax_mm(bits, group)
    jc, js = jnp.asarray(codes), jnp.asarray(scales)
    want = np.asarray(jmm(jx, jc, js), np.float32)
    fwd, dx_fn = _port_mm(bits, group)
    got = fwd(x, to_torch(codes), to_torch(scales))
    assert got.dtype == x.dtype and tuple(got.shape) == (rows, out_f)
    assert np.abs(to_numpy(got) - want).max() <= _tol(want, dtype, rows)

    # dx: jax.grad of <mm(x), dy> is dy @ W^T, through the JAX kernel's VJP
    want_dx = np.asarray(jax.grad(lambda v: jnp.sum(
        (jmm(v, jc, js) * jdy).astype(jnp.float32)))(jx), np.float32)
    got_dx = dx_fn(dy, to_torch(codes), to_torch(scales))
    assert got_dx.dtype == dy.dtype and tuple(got_dx.shape) == (rows, in_f)
    assert np.abs(to_numpy(got_dx) - want_dx).max() <= _tol(want_dx, dtype, rows, dx=True)
    # the plain forward's autograd gives the plain dx
    xr = x.clone().requires_grad_()
    (auto,) = torch.autograd.grad(fwd(xr, to_torch(codes), to_torch(scales)), xr, dy)
    torch.testing.assert_close(auto, got_dx, rtol=0, atol=_tol(to_numpy(got_dx), "float32", 0))


@pytest.mark.parametrize("bits", [4, 8])
def test_torch_quant_matmul_plain_takes_3d_input(bits):
    codes, scales, jx, _, x, _ = _operands(256, 256, 64, 6, bits, "float32", seed=1)
    jmm = _jax_mm(bits, 64)
    want = np.asarray(jmm(jx.reshape(2, 3, 256), jnp.asarray(codes), jnp.asarray(scales)))
    fwd, _ = _port_mm(bits, 64)
    got = fwd(x.reshape(2, 3, 256), to_torch(codes), to_torch(scales))
    assert tuple(got.shape) == (2, 3, 256)
    assert np.abs(to_numpy(got) - want).max() <= _tol(want, "float32", 6)


def _flat_state(module) -> dict:
    state = nnx.state(module, nnx.Any(nnx.Param, jq.QuantScales))
    return {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(state)}


@pytest.mark.parametrize("mode", ["int8", "int4", "w8a8"])
def test_torch_quantized_monarch_linear_matches_jax(mode):
    """Output and the gradients of x and both factors, float32; the codes
    and scales get no gradient."""
    bits = 4 if mode == "int4" else 8
    in_f, out_f = 128, 96
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((out_f, in_f)) * 0.1).astype(np.float32)
    jl = jml.MonarchLinear(in_f, out_f, weights=jnp.array(w), rngs=nnx.Rngs(0))
    for _, v in nnx.to_flat_state(nnx.state(jl, AdapterParam)):
        v.set_value(jnp.array(rng.normal(0.0, 0.05, v[...].shape).astype(np.float32)))
    jq.quantize_frozen_base(jl, bits=bits, group_size=32)
    tl = MonarchLinear(in_f, out_f, weights=torch.zeros(out_f, in_f), device="cpu")
    tq.quantize_frozen_base(tl, bits=bits, group_size=32)
    load_jax_state(tl, _flat_state(jl))
    if mode == "w8a8":
        jq.enable_w8a8_serving(jl)
        tq.enable_w8a8_serving(tl)
    x = rng.standard_normal((2, 5, in_f)).astype(np.float32)
    cot = rng.standard_normal((2, 5, out_f)).astype(np.float32)

    def jloss(layer, v):
        return jnp.sum(layer(v) * jnp.asarray(cot))

    want_out = np.asarray(jl(jnp.asarray(x)))
    jgrads, jdx = nnx.grad(jloss, argnums=(nnx.DiffState(0, AdapterParam), 1))(
        jl, jnp.asarray(x))
    xt = to_torch(x).requires_grad_()
    out = tl(xt)
    np.testing.assert_allclose(to_numpy(out), want_out, rtol=1e-5, atol=1e-5)
    out.backward(to_torch(cot))
    assert tl.dense.grad is None and tl.dense_scales.grad is None
    assert not tl.dense.requires_grad
    if mode != "w8a8":  # w8a8 rounds x to int8: no gradient of x through it in either
        np.testing.assert_allclose(to_numpy(xt.grad), np.asarray(jdx), rtol=1e-4, atol=1e-4)
    flat = {tuple(getattr(p, "key", p) for p in path): np.asarray(v[...])
            for path, v in nnx.to_flat_state(jgrads)}
    for name in ("blkdiag1", "blkdiag2"):
        np.testing.assert_allclose(to_numpy(getattr(tl, name).grad), flat[(name,)],
                                   rtol=1e-4, atol=1e-4)
