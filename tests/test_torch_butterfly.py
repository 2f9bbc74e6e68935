"""The port's classic butterfly utilities (``ops/butterfly.py``) against the
JAX package's on the CPU: the factor as a dense matrix (equal bit for bit:
it only places the twiddles), one block-butterfly factor and the product
of log2(n) of them in both stride orders, with the gradients of the
twiddles and the input.  Inputs from seeded numpy generators.

Tolerances (``utils/testing.TOLERANCES``): float32 1e-5 (``f32_op``) for
products, 1e-4 (``f32_logits``) for gradients summed over the batch and
the factors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_matrix_fine_tuning_torch.ops import butterfly as tbf
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES
from sparse_matrix_fine_tuning_tpu.ops import butterfly as jbf

F32 = TOLERANCES["f32_op"]
SUMS = TOLERANCES["f32_logits"]


@pytest.mark.parametrize("n", [2, 8, 16])
def test_torch_butterfly_factor_to_matrix_equals_jax(n):
    rng = np.random.default_rng(n)
    for idx in range(int(np.log2(n))):
        tw = rng.standard_normal((n // 2, 2, 2)).astype(np.float32)
        want = np.asarray(jbf.butterfly_factor_to_matrix(jnp.asarray(tw), idx))
        got = tbf.butterfly_factor_to_matrix(torch.from_numpy(tw), idx)
        np.testing.assert_array_equal(got.numpy(), want)
    ones = tbf.butterfly_factor_to_matrix(torch.ones(n // 2, 2, 2), 0)
    assert int(ones.sum()) == 2 * n  # two entries a row


def test_torch_butterfly_factor_to_matrix_gradient():
    rng = np.random.default_rng(3)
    tw = rng.standard_normal((8, 2, 2)).astype(np.float32)
    g = rng.standard_normal((16, 16)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jbf.butterfly_factor_to_matrix(t, 2) * g))(jnp.asarray(tw))
    t = torch.from_numpy(tw).requires_grad_()
    (tbf.butterfly_factor_to_matrix(t, 2) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


def _block_inputs(seed, batch, nstacks, n, bs):
    rng = np.random.default_rng(seed)
    log_n = int(np.log2(n))
    tw = (rng.standard_normal((nstacks, log_n, n // 2, 2, 2, bs, bs)) / np.sqrt(2 * bs))
    x = rng.standard_normal((batch, nstacks, n, bs))
    g = rng.standard_normal((batch, nstacks, n, bs))
    return tw.astype(np.float32), x.astype(np.float32), g.astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 1, 8, 4), (2, 2, 16, 3), (5, 1, 4, 8)])
def test_torch_block_butterfly_factor_multiply_matches_jax(shape):
    tw, x, g = _block_inputs(sum(shape), *shape)
    for idx in range(tw.shape[1]):
        def loss(t, xx):
            return jnp.sum(jbf.block_butterfly_factor_multiply(t, xx, idx) * g)
        want = jbf.block_butterfly_factor_multiply(jnp.asarray(tw[:, idx]), jnp.asarray(x), idx)
        wgrads = jax.grad(loss, argnums=(0, 1))(jnp.asarray(tw[:, idx]), jnp.asarray(x))
        tt = torch.from_numpy(tw[:, idx].copy()).requires_grad_()
        tx = torch.from_numpy(x).requires_grad_()
        got = tbf.block_butterfly_factor_multiply(tt, tx, idx)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
        (got * torch.from_numpy(g)).sum().backward()
        for a, b in zip((tt.grad, tx.grad), wgrads):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **SUMS)


@pytest.mark.parametrize("increasing_stride", [True, False])
@pytest.mark.parametrize("shape", [(3, 1, 8, 4), (2, 2, 16, 3)])
def test_torch_block_butterfly_multiply_matches_jax(shape, increasing_stride):
    tw, x, g = _block_inputs(sum(shape) + increasing_stride, *shape)

    def loss(t, xx):
        return jnp.sum(jbf.block_butterfly_multiply(t, xx, increasing_stride) * g)

    want = jbf.block_butterfly_multiply(jnp.asarray(tw), jnp.asarray(x), increasing_stride)
    wgrads = jax.grad(loss, argnums=(0, 1))(jnp.asarray(tw), jnp.asarray(x))
    tt = torch.from_numpy(tw).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    got = tbf.block_butterfly_multiply(tt, tx, increasing_stride)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    (got * torch.from_numpy(g)).sum().backward()
    for a, b in zip((tt.grad, tx.grad), wgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SUMS)


def test_torch_block_butterfly_identity_twiddles():
    """Identity twiddles (diagonal 2 x 2 of identity blocks) leave x as it is."""
    n, bs = 8, 4
    tw = torch.zeros(1, 3, n // 2, 2, 2, bs, bs)
    tw[..., 0, 0, :, :] = torch.eye(bs)
    tw[..., 1, 1, :, :] = torch.eye(bs)
    x = torch.randn(2, 1, n, bs)
    assert torch.equal(tbf.block_butterfly_multiply(tw, x), x)
