"""The fused dense + Monarch linear of the port
(``kernels/experimental/more_linear``) on the CPU, where it runs its plain
versions, against the JAX package's Pallas kernels in interpret mode, as
``tests/kernels/test_more_linear.py`` runs them.

Shapes: that file's ``CASES`` (:14-19), a 3-D batch and one bf16 case.
Tolerances:
  * float32: 1e-4, as ``tests/kernels/test_more_linear.py:40-59`` states for
    the forward and every gradient (sums in another order; the gradients of
    the factors sum over all rows);
  * bfloat16: the output and dx two bf16 ulps of their scale (2**-6 of it):
    the intermediate (out1 or dout1) may round one ulp apart and the output
    rounds once more; the factor gradients, summed in fp32 over the rows from
    intermediates one ulp apart and then rounded to bf16, also 2**-6 of their
    scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_matrix_fine_tuning_torch.kernels.experimental import more_linear as tml
from sparse_matrix_fine_tuning_torch.utils.testing import bf16_atol, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu.kernels.experimental import more_linear as jml
from sparse_matrix_fine_tuning_tpu.kernels.monarch_pallas import _extract_dw, expand_monarch_factors

# (batch, n, m, K, r): tests/kernels/test_more_linear.py:14-19
CASES = [(32, 64, 64, 4, 4), (200, 128, 96, 4, 8), (64, 96, 192, 4, 4)]
F32_TOL = 1e-4


def _arrays(b, n, m, K, r, seed=0):
    """x, dense_w, w1, w2 and a cotangent, scaled as the JAX test's ``_mk``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n))
    wd = rng.standard_normal((m, n)) * 0.1
    w1 = rng.standard_normal((K, r, n // K)) * 0.1
    w2 = rng.standard_normal((K, m // K, r)) * 0.1
    cot = rng.standard_normal((b, m))
    return [a.astype(np.float32) for a in (x, wd, w1, w2, cot)]


def _jax_value_and_grads(x, wd, w1, w2, cot, dtype=jnp.float32):
    """y and the gradients of <y, cot> with respect to x, w1 and w2, through
    the JAX kernels in interpret mode."""
    jx, jwd, jw1, jw2 = (jnp.asarray(a, dtype) for a in (x, wd, w1, w2))
    jcot = jnp.asarray(cot, dtype)

    def loss(v, a, b):
        return jnp.sum((jml.more_linear(v, jwd, a, b, interpret=True) * jcot).astype(jnp.float32))

    y = jml.more_linear(jx, jwd, jw1, jw2, interpret=True)
    grads = jax.grad(loss, argnums=(0, 1, 2))(jx, jw1, jw2)
    return [np.asarray(t, np.float32) for t in (y, *grads)]


def _port_value_and_grads(x, wd, w1, w2, cot, dtype=torch.float32):
    tx, tw1, tw2 = (to_torch(a, dtype).requires_grad_() for a in (x, w1, w2))
    y = tml.more_linear(tx, to_torch(wd, dtype), tw1, tw2)
    y.backward(to_torch(cot, dtype))
    for t in (y, tx.grad, tw1.grad, tw2.grad):
        assert t.dtype == dtype
    return [to_numpy(t) for t in (y, tx.grad, tw1.grad, tw2.grad)]


@pytest.mark.parametrize("b,n,m,K,r", CASES)
def test_torch_more_linear_forward_matches_jax(b, n, m, K, r):
    x, wd, w1, w2, _ = _arrays(b, n, m, K, r)
    assert tml.more_linear_supported(n, m, w1.shape, w2.shape)
    want = np.asarray(jml.more_linear(*(jnp.asarray(a) for a in (x, wd, w1, w2)), interpret=True))
    got = tml.more_linear(*(to_torch(a) for a in (x, wd, w1, w2)))
    assert tuple(got.shape) == (b, m)
    np.testing.assert_allclose(to_numpy(got), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("b,n,m,K,r", CASES)
def test_torch_more_linear_grads_match_jax(b, n, m, K, r):
    arrays = _arrays(b, n, m, K, r, seed=1)
    want = _jax_value_and_grads(*arrays)
    got = _port_value_and_grads(*arrays)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)


def test_torch_more_linear_bf16_matches_jax():
    arrays = _arrays(200, 128, 96, 4, 8, seed=2)
    want = _jax_value_and_grads(*arrays, dtype=jnp.bfloat16)
    got = _port_value_and_grads(*arrays, dtype=torch.bfloat16)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= bf16_atol(w)


def test_torch_more_linear_takes_3d_batch():
    x, wd, w1, w2, _ = _arrays(24, 64, 64, 4, 4, seed=3)
    want = np.asarray(jml.more_linear(jnp.asarray(x.reshape(2, 12, 64)), jnp.asarray(wd),
                                      jnp.asarray(w1), jnp.asarray(w2), interpret=True))
    got = tml.more_linear(to_torch(x.reshape(2, 12, 64)), to_torch(wd), to_torch(w1), to_torch(w2))
    assert tuple(got.shape) == (2, 12, 64)
    np.testing.assert_allclose(to_numpy(got), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("b,n,m,K,r", CASES)
def test_torch_more_linear_plain_dx_dw_match_jax_kernels(b, n, m, K, r):
    """The plain K10 and K11 directly against the JAX ``_more_dx_call`` and
    ``_more_dw_call`` + ``_extract_dw``; the expanded factors are built on
    the JAX side only."""
    x, wd, w1, w2, dout = _arrays(b, n, m, K, r, seed=4)
    w1bd, w2hat = expand_monarch_factors(jnp.asarray(w1), jnp.asarray(w2))
    want_dx = np.asarray(jml._more_dx_call(jnp.asarray(dout), jnp.asarray(wd), w1bd, w2hat, True))
    dw1bd, dw2hat = jml._more_dw_call(jnp.asarray(x), jnp.asarray(dout), w1bd, w2hat, True)
    want_dw = [np.asarray(t) for t in _extract_dw(dw1bd, dw2hat, w1.shape, w2.shape)]
    got_dx = tml.more_linear_dx_reference(to_torch(dout), to_torch(wd), to_torch(w1), to_torch(w2))
    np.testing.assert_allclose(to_numpy(got_dx), want_dx, rtol=F32_TOL, atol=F32_TOL)
    got_dw = tml.more_linear_dw_reference(to_torch(x), to_torch(dout), to_torch(w1), to_torch(w2))
    for g, w in zip(got_dw, want_dw):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(to_numpy(g), w, rtol=F32_TOL, atol=F32_TOL)


def test_torch_more_linear_supported_matches_jax_shape_rules():
    """Good shapes and each broken rule; the JAX rule's VMEM budget holds at
    these sizes, so the two agree everywhere."""
    shapes = [(64, 64, (4, 4, 16), (4, 16, 4)), (128, 96, (4, 8, 32), (4, 24, 8)),
              (64, 24, (4, 2, 16), (2, 12, 4)),
              (64, 64, (4, 4, 8), (4, 16, 4)),    # K*P != n
              (64, 64, (4, 4, 16), (4, 8, 4)),    # S*L != m
              (64, 64, (4, 4, 16), (4, 16, 2))]   # L*R != K*Q
    for n, m, s1, s2 in shapes:
        assert tml.more_linear_supported(n, m, s1, s2) == jml.more_linear_supported(n, m, s1, s2)
    assert [tml.more_linear_supported(n, m, s1, s2) for n, m, s1, s2 in shapes] == [True] * 3 + \
        [False] * 3
    n, m, s1, s2 = shapes[3]
    with pytest.raises(ValueError, match="K\\*P"):
        tml.more_linear(torch.zeros(2, n), torch.zeros(m, n), torch.zeros(s1), torch.zeros(s2))


def test_torch_more_linear_dense_w_gets_no_gradient():
    """The JAX backward returns zeros for the frozen weight; the port returns
    None, even when dense_w asks for a gradient."""
    x, wd, w1, w2, cot = _arrays(32, 64, 64, 4, 4, seed=5)
    twd = to_torch(wd).requires_grad_()
    tx, tw1, tw2 = (to_torch(a).requires_grad_() for a in (x, w1, w2))
    tml.more_linear(tx, twd, tw1, tw2).backward(to_torch(cot))
    assert twd.grad is None
    assert all(t.grad is not None for t in (tx, tw1, tw2))
    assert tml.LAUNCHES == dict.fromkeys(tml.LAUNCHES, 0)  # the CPU runs no kernel
