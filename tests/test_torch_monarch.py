"""The port's Monarch ops and the plain versions of its kernels K1 and K2,
held against the JAX package on the CPU.

The JAX side runs ``blockdiag_butterfly_multiply`` and the Pallas kernels
``monarch_kernel``/``monarch_add`` in interpret mode, as
tests/kernels/test_monarch_pallas.py runs them.  Inputs come from numpy.

Tolerances (utils/testing.TOLERANCES): float32 1e-5 relative and absolute,
the frameworks summing in another order; bfloat16 two ulps of the output's
scale (``bf16_atol``), since the intermediate may round one ulp apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda
from sparse_matrix_fine_tuning_torch.ops import blockdiag as tbd
from sparse_matrix_fine_tuning_torch.ops import monarch as tm
from sparse_matrix_fine_tuning_torch.utils.testing import (
    TOLERANCES,
    bf16_atol,
    to_numpy,
    to_torch,
)
from sparse_matrix_fine_tuning_tpu.kernels.monarch_pallas import monarch_add, monarch_kernel
from sparse_matrix_fine_tuning_tpu.ops import blockdiag as jbd
from sparse_matrix_fine_tuning_tpu.ops import monarch as jm

F32 = TOLERANCES["f32_op"]

# (batch, K, Q, P, L, S, R): the CASES of the JAX kernel test (L=K, R=Q),
# and one with L != K, where a swapped interleave index would show; then the
# ragged shapes the card holds K1/K2 to (tests/test_torch_kernels_cuda.py
# FWD_RAGGED_CASES, at fewer rows): P and S*L no multiple of 8, K != L and
# Q != R, L = 4 with R = 16.
CASES = [
    (16, 4, 4, 32, 4, 32, 4),
    (65, 4, 8, 16, 4, 24, 8),
    (8, 2, 16, 64, 2, 64, 16),
    (9, 4, 2, 16, 2, 12, 4),
    (1, 4, 4, 13, 4, 7, 4),
    (4, 2, 8, 36, 4, 9, 4),
    (17, 4, 6, 52, 8, 33, 3),
    (5, 2, 32, 20, 4, 13, 16),
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(case, seed):
    batch, K, Q, P, L, S, R = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, K * P)).astype(np.float32)
    w1 = (rng.standard_normal((K, Q, P)) / np.sqrt(P)).astype(np.float32)
    w2 = (rng.standard_normal((L, S, R)) / np.sqrt(R)).astype(np.float32)
    base = rng.standard_normal((batch, S * L)).astype(np.float32)
    return x, w1, w2, base


def _both(arrays, dtype):
    jd, td = DTYPES[dtype]
    return ([jnp.array(a, dtype=jd) for a in arrays], [to_torch(a, td) for a in arrays])


def _close(got: torch.Tensor, want, dtype):
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(to_numpy(got), want, **F32)
    else:
        np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=bf16_atol(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_torch_butterfly_multiply_matches_jax(case, dtype):
    (jx, jw1, jw2, _), (tx, tw1, tw2, _) = _both(_inputs(case, 0), dtype)
    want = jm.blockdiag_butterfly_multiply(jx, jw1, jw2)
    got = tm.blockdiag_butterfly_multiply(tx, tw1, tw2)
    assert got.dtype == tx.dtype and got.shape == tuple(want.shape)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_torch_monarch_kernel_reference_matches_pallas(case, dtype):
    """K1's plain version against the Pallas kernel in interpret mode."""
    (jx, jw1, jw2, _), (tx, tw1, tw2, _) = _both(_inputs(case, 1), dtype)
    want = monarch_kernel(jx, jw1, jw2, interpret=True)
    _close(monarch_cuda.monarch_kernel_reference(tx, tw1, tw2), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_torch_monarch_add_reference_matches_pallas(case, dtype):
    """K2's plain version (the add in fp32, one rounding) against the
    Pallas fused-add kernel in interpret mode."""
    (jx, jw1, jw2, jb), (tx, tw1, tw2, tb) = _both(_inputs(case, 2), dtype)
    want = monarch_add(jb, jx, jw1, jw2, interpret=True)
    got = monarch_cuda.monarch_add_reference(tb, tx, tw1, tw2)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


def test_torch_monarch_add_rounds_once():
    """bf16: the fused add rounds once, base + monarch(x) twice; they differ
    by at most one ulp of the output's scale."""
    x, w1, w2, base = (to_torch(a, torch.bfloat16) for a in _inputs(CASES[1], 3))
    fused = monarch_cuda.monarch_add_reference(base, x, w1, w2).float()
    unfused = (base + tm.blockdiag_butterfly_multiply(x, w1, w2)).float()
    assert float((fused - unfused).abs().max()) <= bf16_atol(to_numpy(fused)) / 2


@pytest.mark.parametrize("case", CASES)
def test_torch_einsum_oracle_and_dense_equivalent(case):
    x, w1, w2, _ = _inputs(case, 4)
    want = np.asarray(jm.blockdiag_butterfly_multiply_reference(*map(jnp.array, (x, w1, w2))))
    tx, tw1, tw2 = map(to_torch, (x, w1, w2))
    np.testing.assert_allclose(
        to_numpy(tm.blockdiag_butterfly_multiply_reference(tx, tw1, tw2)), want, **F32)
    dense_j = np.asarray(jm.monarch_dense_equivalent(jnp.array(w1), jnp.array(w2)))
    dense_t = to_numpy(tm.monarch_dense_equivalent(tw1, tw2))
    np.testing.assert_allclose(dense_t, dense_j, **F32)
    np.testing.assert_allclose(x @ dense_t.T, want, rtol=1e-4, atol=1e-4)


def test_torch_butterfly_multiply_batch_dims():
    x, w1, w2, _ = _inputs((12, 4, 4, 16, 4, 16, 4), 5)
    tx, tw1, tw2 = map(to_torch, (x, w1, w2))
    out = tm.blockdiag_butterfly_multiply(tx.reshape(3, 4, 64), tw1, tw2)
    assert out.shape == (3, 4, 64)
    np.testing.assert_allclose(to_numpy(out).reshape(12, 64),
                               to_numpy(tm.blockdiag_butterfly_multiply(tx, tw1, tw2)), **F32)


def test_torch_shape_checks():
    x, w1, w2, _ = _inputs(CASES[0], 6)
    with pytest.raises(ValueError):
        tm.blockdiag_butterfly_multiply(to_torch(x[:, :-1]), to_torch(w1), to_torch(w2))
    with pytest.raises(ValueError):
        tm.blockdiag_butterfly_multiply(to_torch(x), to_torch(w1), to_torch(w2[:, :, :-1]))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_torch_blockdiag_multiply_matches_jax(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((10, 48)).astype(np.float32)
    w = (rng.standard_normal((4, 6, 12)) / np.sqrt(12)).astype(np.float32)
    (jx, jw), (tx, tw) = _both((x, w), dtype)
    _close(tbd.blockdiag_multiply(tx, tw), jbd.blockdiag_multiply(jx, jw), dtype)
    np.testing.assert_allclose(to_numpy(tbd.blockdiag_weight_to_dense_weight(to_torch(w))),
                               np.asarray(jbd.blockdiag_weight_to_dense_weight(jnp.array(w))),
                               **F32)


def test_torch_monarch_mm_dispatches_cpu_to_plain():
    x, w1, w2, _ = map(to_torch, _inputs(CASES[0], 8))
    before = dict(monarch_cuda.LAUNCHES)
    out = monarch_cuda.monarch_mm(x, w1, w2)
    torch.testing.assert_close(out, monarch_cuda.monarch_kernel_reference(x, w1, w2))
    assert monarch_cuda.LAUNCHES == before

