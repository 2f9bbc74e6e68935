"""The port's FlatBlockButterflySparsityConfig and BlockSparseLinear
(``layers/blocksparse.py``) against the JAX package's on the CPU.

The layouts must equal JAX's bit for bit.  The layers' whole JAX state
(``weight``, ``bias``, ``layout``, ``_flat_idx``) is carried across by
``utils/jax_bridge.load_jax_state``; outputs and the gradients of the
weight, bias and input are compared for seeded numpy inputs.  The six
cases of JAX tests/layers/test_blocksparse.py are mirrored on the port.

Tolerances (``utils/testing.TOLERANCES``): float32 1e-5 (``f32_op``) for
outputs, 1e-4 (``f32_logits``) for gradients summed over the batch;
bfloat16 two ulps of the output's scale.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from test_torch_structured import check_parity, jax_state

from sparse_matrix_fine_tuning_torch.layers import blocksparse as tb
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, bf16_atol, to_numpy
from sparse_matrix_fine_tuning_tpu.layers import blocksparse as jb

F32 = TOLERANCES["f32_op"]
SUMS = TOLERANCES["f32_logits"]

# (butterfly_size, n_factors, block, global_size, shuffle, out, in)
LAYOUTS = [
    (4, 1, 2, 0, False, 8, 8),
    (4, 2, 2, 0, False, 8, 8),
    (8, 2, 2, 0, True, 16, 32),
    (8, 3, 4, 4, False, 32, 16),
    (16, 2, 4, 0, True, 64, 64),
    (32, 2, 32, 0, False, 4096, 1024),
    (32, 2, 32, 0, False, 4000 + 96, 1000 + 24),
    (8, 1, 8, 8, True, 24, 40),
]


@pytest.mark.parametrize("case", LAYOUTS)
def test_torch_layout_equals_jax(case):
    bs, nf, block, gs, shuffle, n_out, n_in = case
    want = jb.FlatBlockButterflySparsityConfig(bs, nf, block, gs, shuffle).make_layout(n_out, n_in)
    got = tb.FlatBlockButterflySparsityConfig(bs, nf, block, gs, shuffle).make_layout(n_out, n_in)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_torch_layout_refusals_match_jax():
    for args in [(6, 1), (1, 1), (8, 0), (8, 4)]:
        with pytest.raises(NotImplementedError):
            jb.FlatBlockButterflySparsityConfig(*args)
        with pytest.raises(NotImplementedError):
            tb.FlatBlockButterflySparsityConfig(*args)
    with pytest.raises(ValueError, match="block"):
        tb.FlatBlockButterflySparsityConfig(4, 1, block=4).make_layout(10, 8)


# (in, out, config args or None for a dense 2 x 2 layout of 4-blocks, bias)
LAYERS = [
    (16, 16, (4, 1, 4, 0, False), True),
    (32, 64, (8, 2, 4, 0, True), True),
    (5, 6, None, True),
    (40, 30, (4, 2, 8, 8, False), False),
    (100, 70, (4, 1, 16, 0, False), True),
]


def _pair(case, seed):
    n_in, n_out, cfg, bias = case
    if cfg is None:
        kw = dict(layout=np.ones((2, 2), np.int64), block_size=4)
        args = ()
        targs = ()
    else:
        args = (jb.FlatBlockButterflySparsityConfig(*cfg),)
        targs = (tb.FlatBlockButterflySparsityConfig(*cfg),)
        kw = {}
    jl = jb.BlockSparseLinear(n_in, n_out, *args, bias=bias, rngs=nnx.Rngs(seed), **kw)
    tl = tb.BlockSparseLinear(n_in, n_out, *targs, bias=bias, device="cpu", **kw)
    return jl, tl


@pytest.mark.parametrize("case", LAYERS)
def test_torch_block_sparse_linear_matches_jax(case):
    n_in, n_out = case[:2]
    rng = np.random.default_rng(n_in * n_out)
    jl, tl = _pair(case, seed=n_in)
    x = rng.standard_normal((2, 3, n_in)).astype(np.float32)
    cot = rng.standard_normal((2, 3, n_out)).astype(np.float32)
    check_parity(jl, tl, x, cot, F32, SUMS)
    assert tl.nnz_blocks == jl.nnz_blocks and tl.saving == jl.saving
    np.testing.assert_array_equal(tl.dense_weight().detach().numpy(),
                                  np.asarray(jl.dense_weight()))
    assert tl._flat_idx.dtype == torch.int32 and tl.layout.dtype == torch.int64


def test_torch_block_sparse_linear_bf16_matches_jax():
    jl, tl = _pair(LAYERS[1], seed=5)
    load_jax_state(tl, jax_state(jl))
    x = np.random.default_rng(6).standard_normal((9, 32)).astype(np.float32)
    want = np.asarray(jl(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = tl(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=bf16_atol(want))


# -- JAX tests/layers/test_blocksparse.py, on the port -----------------------

def test_torch_butterfly_layout_support():
    layout = tb.FlatBlockButterflySparsityConfig(butterfly_size=4, n_factors=1,
                                                 block=2).make_layout(8, 8)
    expect = np.zeros((4, 4), np.int64)
    expect[:2, :2] = 1
    expect[2:, 2:] = 1
    np.testing.assert_array_equal(layout, expect)
    full = tb.FlatBlockButterflySparsityConfig(4, 2, block=2).make_layout(8, 8)
    assert (full.sum(axis=1) == 3).all() and full.min() == 0


def test_torch_global_size_densifies_edges():
    layout = tb.FlatBlockButterflySparsityConfig(4, 1, block=2, global_size=2).make_layout(8, 8)
    assert layout[0].min() == 1 and layout[:, 0].min() == 1


def test_torch_forward_equals_masked_dense():
    cfg = tb.FlatBlockButterflySparsityConfig(butterfly_size=4, n_factors=1, block=4)
    layer = tb.BlockSparseLinear(16, 16, cfg, device="cpu")
    w = layer.dense_weight().detach().numpy()
    mask = np.kron(layer.layout.numpy(), np.ones((4, 4)))
    assert np.all(w[mask == 0] == 0)
    x = np.random.default_rng(0).normal(size=(3, 16)).astype(np.float32)
    out = layer(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, x @ w.T + layer.bias.detach().numpy(), **F32)
    assert layer.saving == layer.nnz_blocks * 16 / 256


def test_torch_pad_and_truncate_non_multiple_features():
    layer = tb.BlockSparseLinear(5, 6, layout=np.ones((2, 2), np.int64), block_size=4,
                                 device="cpu")
    x = np.random.default_rng(1).normal(size=(2, 5)).astype(np.float32)
    out = layer(torch.from_numpy(x))
    assert out.shape == (2, 6)
    w = layer.dense_weight().detach().numpy()[:6, :5]
    np.testing.assert_allclose(out.detach().numpy(), x @ w.T + layer.bias.detach().numpy(), **F32)
    with pytest.raises(ValueError, match="layout"):
        tb.BlockSparseLinear(5, 6, layout=np.ones((2, 3), np.int64), block_size=4, device="cpu")


def test_torch_grads_confined_to_active_blocks():
    cfg = tb.FlatBlockButterflySparsityConfig(butterfly_size=8, n_factors=2, block=2)
    layer = tb.BlockSparseLinear(16, 16, cfg, bias=False, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 16)).astype(np.float32))
    loss = (layer(x) ** 2).sum()
    loss.backward()
    g = layer.weight.grad
    assert g.shape == (layer.nnz_blocks, 2, 2)
    assert math.isfinite(float(loss)) and g.abs().sum() > 0
    # the dense weight's gradient lies on the layout: the blocks are all it has
    dense = layer.dense_weight()
    gd = torch.autograd.grad((torch.nn.functional.linear(x, dense) ** 2).sum(), dense)[0]
    mask = torch.kron(layer.layout.float(), torch.ones(2, 2))
    assert torch.count_nonzero(gd * (1 - mask)) > 0  # dense grads leak off the support
    assert torch.equal(layer.dense_weight().detach() * (1 - mask), torch.zeros(16, 16))


def test_torch_init_variance_correction():
    cfg = tb.FlatBlockButterflySparsityConfig(butterfly_size=8, n_factors=1, block=8)
    layer = tb.BlockSparseLinear(64, 64, cfg, device="cpu")
    w = layer.dense_weight().detach().numpy()
    nnz_var = w[w != 0].var()
    dense_var = (1 / math.sqrt(64)) ** 2 / 3
    assert abs(nnz_var / (4 * dense_var) - 1) < 0.15
    again = tb.BlockSparseLinear(64, 64, cfg, device="cpu")
    assert torch.equal(layer.weight, again.weight) and torch.equal(layer.bias, again.bias)
