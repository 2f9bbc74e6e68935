"""The port's SVD projection (``ops/projection.py``), the projecting modes of
``MonarchLinear`` (``svd_init``, projection mode, ``reference_orientation``)
and ``MonarchFactor``, held against the JAX package on the CPU in float32.

Inputs are drawn from seeded numpy generators.  Each singular pair comes
out of an SVD up to its sign, so the factors are compared after fixing it
(the largest-|.| entry of each row of Vt made positive, U's column with
it); the Monarch dense equivalents, the layers' outputs and the svd_init
residuals are sign-free and compared as they are.  Tolerances: the factors
and residuals ``TOLERANCES["f32_op"]`` (1e-5); products through an SVD in
another LAPACK's order ``TOLERANCES["f32_logits"]`` (1e-4).  The JAX
projection runs under its own float32 matmul precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchFactor, MonarchLinear
from sparse_matrix_fine_tuning_torch.models.config import RobertaConfig
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.ops import projection as tproj
from sparse_matrix_fine_tuning_torch.ops.monarch import (
    blockdiag_butterfly_multiply,
    monarch_dense_equivalent,
)
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu.layers import monarch_linear as jml
from sparse_matrix_fine_tuning_tpu.ops import projection as jproj

F32 = TOLERANCES["f32_op"]
LOGITS = TOLERANCES["f32_logits"]


def jnp_f32(a):
    return jnp.array(np.asarray(a, np.float32))


def blocks(w1, w2, nblocks2: int):
    """(U (k, j, l, r), Vt (k, j, r, i)) of projected factors, each pair's
    sign fixed: the largest-|.| entry of each row of Vt positive."""
    w1, w2 = np.asarray(w1, np.float64), np.asarray(w2, np.float64)
    k, rj, i = w1.shape
    j, l, kr = w2.shape
    r = rj // j
    vt = w1.reshape(k, r, j, i).transpose(0, 2, 1, 3)
    u = w2.reshape(j, l, k, r).transpose(2, 0, 1, 3)
    idx = np.abs(vt).argmax(-1)[..., None]
    sign = np.sign(np.take_along_axis(vt, idx, -1))
    return u * np.swapaxes(sign, -1, -2), vt * sign


def check_factors(got, want, nblocks2: int, tol=F32) -> None:
    gu, gv = blocks(to_numpy(got[0]), to_numpy(got[1]), nblocks2)
    wu, wv = blocks(want[0], want[1], nblocks2)
    np.testing.assert_allclose(gv, wv, **tol)
    np.testing.assert_allclose(gu, wu, **tol)


def jax_project(M, k, j, rank, reverse=False):
    with jax.default_matmul_precision("float32"):
        return jproj.blockdiag_butterfly_project_einsum_rank(jnp_f32(M), k, j, rank,
                                                            reverse=reverse)


@pytest.mark.parametrize("shape,k,j,rank", [((32, 32), 4, 4, 1), ((32, 32), 4, 4, 4),
                                            ((24, 36), 4, 3, 2), ((40, 30), 3, 5, 1)])
def test_torch_projection_matches_jax(shape, k, j, rank):
    M = np.random.default_rng(sum(shape) + rank).standard_normal(shape).astype(np.float32)
    got = tproj.blockdiag_butterfly_project_einsum_rank(to_torch(M), k, j, rank)
    want = jax_project(M, k, j, rank)
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert all(t.dtype == torch.float32 for t in got)
    check_factors(got, want, j)
    np.testing.assert_allclose(to_numpy(monarch_dense_equivalent(*got)),
                               np.asarray(jml.monarch_dense_equivalent(*want)), **LOGITS)
    if rank == 1:
        simple = tproj.blockdiag_butterfly_project_einsum_simple(to_torch(M), k, j)
        assert all(torch.equal(a, b) for a, b in zip(simple, got))


def test_torch_projection_reverse_matches_jax():
    """``reverse``: the trailing singular pairs, whose product with the
    leading ones' gives M back exactly."""
    M = np.random.default_rng(5).standard_normal((24, 36)).astype(np.float32)
    got = tproj.blockdiag_butterfly_project_einsum_rank(to_torch(M), 4, 3, 3, reverse=True)
    want = jax_project(M, 4, 3, 3, reverse=True)
    check_factors(got[:2], want[:2], 3)
    check_factors(got[2:], want[2:], 3)
    whole = monarch_dense_equivalent(*got[:2]) + monarch_dense_equivalent(*got[2:])
    np.testing.assert_allclose(to_numpy(whole), M, **LOGITS)


def test_torch_projection_full_rank_is_exact_and_oracle_matches():
    """At full rank the projection is M; the einsum oracle equals the
    port's Monarch multiply and the JAX oracle."""
    rng = np.random.default_rng(6)
    M = rng.standard_normal((24, 24)).astype(np.float32)
    w1, w2 = tproj.blockdiag_butterfly_project_einsum_rank(to_torch(M), 4, 4, 6)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    got = tproj.blockdiag_butterfly_multiply_einsum_rank(to_torch(x), w1, w2)
    np.testing.assert_allclose(to_numpy(got), x @ M.T, **LOGITS)
    np.testing.assert_allclose(to_numpy(got), to_numpy(blockdiag_butterfly_multiply(
        to_torch(x), w1, w2)), **F32)
    want = jproj.blockdiag_butterfly_multiply_einsum_rank(jnp_f32(x), jnp_f32(to_numpy(w1)),
                                                          jnp_f32(to_numpy(w2)))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **F32)
    with pytest.raises(ValueError):
        tproj.blockdiag_butterfly_project_einsum_rank(to_torch(M), 5, 4, 1)


def test_torch_low_rank_and_factors_match_jax():
    M = np.random.default_rng(7).standard_normal((3, 8, 6)).astype(np.float32)
    got = tproj.low_rank_project(to_torch(M), 2)
    with jax.default_matmul_precision("float32"):
        want = jproj.low_rank_project(jnp_f32(M), 2)
    np.testing.assert_allclose(to_numpy(got[0] @ got[1]), np.asarray(want[0] @ want[1]),
                               **F32)
    assert tproj.factors(36) == jproj.factors(36) and tproj.factors(97) == jproj.factors(97)


# name: (in, out, peft_config)
LAYERS = {
    "svd_init": (64, 48, {"svd_init": True}),
    "svd_init_padded": (50, 40, {"svd_init": True}),
    "projection": (64, 48, {"adapter": False, "nblocks": 8}),
    "projection_padded": (50, 40, {"adapter": False}),
    "reference_orientation": (48, 48, {"reference_orientation": True, "adapter": False}),
    "reference_orientation_svd_init": (48, 48, {"reference_orientation": True,
                                                "svd_init": True}),
}


def layer_pair(name: str, seed: int = 0):
    n_in, n_out, peft = LAYERS[name]
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_out, n_in)) / np.sqrt(n_in)).astype(np.float32)
    bias = rng.standard_normal(n_out).astype(np.float32)
    jl = jml.MonarchLinear(n_in, n_out, peft_config=peft, weights=jnp_f32(w),
                           bias=jnp_f32(bias), rngs=nnx.Rngs(0))
    tl = MonarchLinear(n_in, n_out, peft_config=peft, weights=to_torch(w), bias=to_torch(bias),
                       device="cpu")
    x = rng.standard_normal((3, 5, n_in)).astype(np.float32)
    return jl, tl, x


@pytest.mark.parametrize("name", list(LAYERS))
def test_torch_monarch_linear_projects_as_jax(name):
    """The factors (signs fixed), the residual that svd_init keeps as the
    frozen dense (none in projection mode) and the layer's output."""
    jl, tl, x = layer_pair(name)
    assert tl.as_adapter == jl.as_adapter
    check_factors((tl.blkdiag1, tl.blkdiag2), (jl.blkdiag1[...], jl.blkdiag2[...]), tl.nblocks)
    if jl.dense is None:
        assert tl.dense is None
    else:
        np.testing.assert_allclose(to_numpy(tl.dense), np.asarray(jl.dense[...]), **F32)
        assert not tl.dense.requires_grad
    with torch.no_grad():
        got = tl(to_torch(x))
    np.testing.assert_allclose(to_numpy(got), np.asarray(jl(jnp_f32(x))), **LOGITS)


@pytest.mark.parametrize("name", list(LAYERS))
def test_torch_projected_layer_trains_as_jax_on_bridged_weights(name):
    """With JAX's factors carried across: the output and the gradients of
    the factors, equal in float32."""
    jl, tl, x = layer_pair(name, seed=1)
    load_jax_state(tl, {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
                        for path, v in nnx.to_flat_state(nnx.state(jl, nnx.Param))})
    g = np.random.default_rng(2).standard_normal((3, 5, tl.out_features)).astype(np.float32)

    def loss(model):
        return jnp.sum(model(jnp_f32(x)) * jnp_f32(g))

    grads = nnx.grad(loss, argnums=nnx.DiffState(0, jml.AdapterParam))(jl)
    (tl(to_torch(x)) * to_torch(g)).sum().backward()
    for key in ("blkdiag1", "blkdiag2"):
        want = np.asarray(getattr(grads, key)[...])
        np.testing.assert_allclose(to_numpy(getattr(tl, key).grad), want, **LOGITS)


@pytest.mark.parametrize("n_in,n_out,peft,match", [
    (48, 32, {"reference_orientation": True, "adapter": False}, "square"),
    (50, 50, {"reference_orientation": True, "svd_init": True}, "divide"),
])
def test_torch_reference_orientation_refusals_match_jax(n_in, n_out, peft, match):
    w = np.random.default_rng(3).standard_normal((n_out, n_in)).astype(np.float32)
    with pytest.raises(ValueError, match=match):
        jml.MonarchLinear(n_in, n_out, peft_config=peft, weights=jnp_f32(w), rngs=nnx.Rngs(0))
    with pytest.raises(ValueError, match=match):
        MonarchLinear(n_in, n_out, peft_config=peft, weights=to_torch(w), device="cpu")


@pytest.mark.parametrize("peft", [{"adapter": False}, {"svd_init": True}])
def test_torch_init_monarch_projects_the_encoder_as_jax(peft):
    """``init_monarch`` on the tiny RoBERTa: projection mode takes
    sqrt-factor blocks (no dense), svd_init the config's (the residual as
    dense); the logits equal JAX's."""
    cfg = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    jm = jmodels.RobertaForSequenceClassification(jmodels.RobertaConfig.tiny(**cfg),
                                                  rngs=nnx.Rngs(0))
    tm = RobertaForSequenceClassification(RobertaConfig.tiny(**cfg), device="cpu")
    state = {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
             for path, v in nnx.to_flat_state(nnx.state(jm, nnx.Param))}
    load_jax_state(tm, state)
    full = dict(peft, monarch=True, nblocks=4, blk_r=4,
                target_modules=["query", "value", "key"])
    want = jpeft.init_monarch(jm, full, rngs=nnx.Rngs(1))
    got = surgery.init_monarch(tm, full)
    assert got == want
    assert (tm.roberta.layer[0].attention.self.query.dense is None) == ("adapter" in peft)
    ids = np.random.default_rng(4).integers(3, 128, (2, 7)).astype(np.int32)
    with torch.no_grad():
        logits = tm.eval()(to_torch(ids, torch.long), torch.ones(2, 7, dtype=torch.long))
    np.testing.assert_allclose(to_numpy(logits), np.asarray(jm(jnp.array(ids),
                                                               jnp.ones((2, 7), jnp.int32))),
                               **LOGITS)


@pytest.mark.parametrize("kw", [{}, {"use_bias": True}, {"ortho": True}])
def test_torch_monarch_factor_matches_jax_on_bridged_weights(kw):
    rng = np.random.default_rng(8)
    jf = jml.MonarchFactor(32, 16, nblocks=4, blk_r=4, rngs=nnx.Rngs(0), **kw)
    tf = MonarchFactor(32, 16, nblocks=4, blk_r=4, device="cpu", **kw)
    if kw.get("use_bias"):
        jf.bias.set_value(jnp_f32(rng.standard_normal(16)))
    load_jax_state(tf, {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
                        for path, v in nnx.to_flat_state(nnx.state(jf, nnx.Param))})
    x = rng.standard_normal((5, 32)).astype(np.float32)
    g = rng.standard_normal((5, 16)).astype(np.float32)
    out = tf(to_torch(x))
    np.testing.assert_allclose(to_numpy(out), np.asarray(jf(jnp_f32(x))), **F32)

    def loss(model):
        return jnp.sum(model(jnp_f32(x)) * jnp_f32(g))

    grads = nnx.grad(loss, argnums=nnx.DiffState(0, jml.AdapterParam))(jf)
    (out * to_torch(g)).sum().backward()
    np.testing.assert_allclose(to_numpy(tf.weight.grad), np.asarray(grads.weight[...]), **F32)
    if kw.get("use_bias"):
        np.testing.assert_allclose(to_numpy(tf.bias.grad), np.asarray(grads.bias[...]), **F32)
    model = torch.nn.Sequential(tf)
    assert surgery.trainable_filter(model, ()) == sorted(
        n for n, _ in model.named_parameters())


def test_torch_monarch_factor_init_laws():
    """Kaiming: U(+-1/sqrt(block in)); all zero; ortho: each block's rows
    orthonormal; a generator gives its draw again; in_features must divide."""
    kaiming = MonarchFactor(256, 64, nblocks=4, blk_r=16, device="cpu")
    w = to_numpy(kaiming.weight)
    assert w.shape == (4, 16, 64) and np.abs(w).max() <= 1 / 8 and np.abs(w).max() > 0.12
    assert abs(w.std() - (1 / 8) / np.sqrt(3)) < 0.005
    assert not to_numpy(MonarchFactor(16, 16, all_zero=True, device="cpu").weight).any()
    ortho = to_numpy(MonarchFactor(64, 16, nblocks=4, blk_r=4, ortho=True, device="cpu").weight)
    for block in ortho:
        np.testing.assert_allclose(block @ block.T, np.eye(4), atol=1e-5)
    a = MonarchFactor(32, 8, device="cpu", generator=torch.Generator().manual_seed(3))
    b = MonarchFactor(32, 8, device="cpu", generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.weight, b.weight) and a.bias is None
    with pytest.raises(ValueError):
        MonarchFactor(30, 8, nblocks=4, device="cpu")
