"""Merge-during-training in the port (``kernels/merged.py``, the training part
of ``MonarchLinear`` and of ``peft/surgery.py``) against the JAX package on
the CPU, in float32 unless stated.

``merged_apply``'s factor gradients are the plain ``monarch_dw`` here (K4 on
the card).  Cases with padding: in 50 -> 4 blocks of 13 (k*p = 52 > 50) and
out 40 -> 4 blocks of 11 (s*l = 44 > 40).

Tolerances (utils/testing.TOLERANCES): float32 1e-5 for one op, 1e-4 for a
layer's gradients, which sum over the rows; bfloat16 two ulps of the
output's scale (``bf16_atol``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.kernels import merged as tmerged
from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear
from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import (
    TOLERANCES,
    bf16_atol,
    to_numpy,
    to_torch,
)
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu.kernels import merged as jmerged
from sparse_matrix_fine_tuning_tpu.layers import monarch_linear as jml
from sparse_matrix_fine_tuning_tpu.peft.surgery import DEFAULT_TRAINABLE_PATHS
from sparse_matrix_fine_tuning_tpu.peft.surgery import trainable_filter as jax_trainable_filter

F32 = TOLERANCES["f32_op"]
F32_SUMS = TOLERANCES["f32_logits"]
SHAPES = {"square": (64, 64), "rect": (64, 48), "padded": (50, 40)}
PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj"]}


def _layer_pair(n_in, n_out, seed=0, peft=None):
    """A JAX MonarchLinear with random factors and its port copy."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_out, n_in)) / np.sqrt(n_in)).astype(np.float32)
    jl = jml.MonarchLinear(n_in, n_out, peft_config=peft or {}, weights=jnp.array(w),
                           rngs=nnx.Rngs(0))
    for _, v in nnx.to_flat_state(nnx.state(jl, jml.AdapterParam)):
        v.set_value(jnp.array(rng.normal(0.0, 0.3, v[...].shape).astype(np.float32)))
    tl = MonarchLinear(n_in, n_out, peft_config=peft or {}, weights=to_torch(w), device="cpu")
    load_jax_state(tl, {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
                        for path, v in nnx.to_flat_state(nnx.state(jl, nnx.Param))})
    x = rng.standard_normal((3, 7, n_in)).astype(np.float32)
    g = rng.standard_normal((3, 7, n_out)).astype(np.float32)
    return jl, tl, x, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_torch_build_merged_operands_match_jax(shape, dtype):
    jl, tl, _, _ = _layer_pair(*SHAPES[shape], seed=1)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    dense = jl.dense[...].astype(jd)
    jwm, jwm_t = jmerged.build_merged_operands(dense, jl.blkdiag1[...].astype(jd),
                                               jl.blkdiag2[...].astype(jd))
    wm, wm_t = tmerged.build_merged_operands(tl.dense.to(td), tl.blkdiag1.to(td),
                                             tl.blkdiag2.to(td))
    assert wm.dtype == wm_t.dtype == td and torch.equal(wm, wm_t.t())
    if dtype == "float32":
        np.testing.assert_allclose(to_numpy(wm), np.asarray(jwm), **F32)
    else:
        want = np.asarray(jwm.astype(jnp.float32))
        np.testing.assert_allclose(to_numpy(wm), want, rtol=0, atol=bf16_atol(want))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_torch_merged_apply_grads_match_jax(shape):
    """Forward and the gradients of x, w1 and w2 against jax.grad of the JAX
    merged_apply, with the padded factor shapes."""
    jl, tl, x, g = _layer_pair(*SHAPES[shape], seed=2)
    jw1, jw2 = jl.blkdiag1[...], jl.blkdiag2[...]
    jwm, jwm_t = jmerged.build_merged_operands(jl.dense[...], jw1, jw2)

    def loss(a, b, c):
        return jnp.sum(jmerged.merged_apply(a, jwm, jwm_t, b, c) * jnp.array(g))

    want_out = jmerged.merged_apply(jnp.array(x), jwm, jwm_t, jw1, jw2)
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.array(x), jw1, jw2)
    wm, wm_t = tmerged.build_merged_operands(tl.dense, tl.blkdiag1, tl.blkdiag2)
    tx = to_torch(x).requires_grad_()
    tw1 = tl.blkdiag1.detach().clone().requires_grad_()
    tw2 = tl.blkdiag2.detach().clone().requires_grad_()
    out = tmerged.merged_apply(tx, wm, wm_t, tw1, tw2)
    np.testing.assert_allclose(to_numpy(out), np.asarray(want_out), **F32)
    got = torch.autograd.grad(out, (tx, tw1, tw2), to_torch(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), **F32_SUMS)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_torch_monarch_linear_merged_training_matches_jax(shape):
    """A layer with merged training on: its output and factor gradients match
    the JAX layer's merged path and the port's own unmerged path."""
    jl, tl, x, g = _layer_pair(*SHAPES[shape], seed=3)
    jl.enable_merged_training()
    tl.enable_merged_training()
    assert tl.wm_cache is not None and "wm_cache" not in tl.state_dict()

    def jloss(m):
        m.refresh_merged()  # as the JAX trainer does inside its step
        return jnp.sum(m(jnp.array(x)) * jnp.array(g))

    grads = dict(nnx.to_flat_state(
        nnx.grad(jloss, argnums=nnx.DiffState(0, jml.AdapterParam))(jl)))
    want = [grads[(name,)][...] for name in ("blkdiag1", "blkdiag2")]
    out = tl(to_torch(x))
    np.testing.assert_allclose(to_numpy(out), np.asarray(jl(jnp.array(x))), **F32)
    got = torch.autograd.grad(out, (tl.blkdiag1, tl.blkdiag2), to_torch(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), **F32_SUMS)

    tl.disable_merged_training()
    assert tl.wm_cache is None
    plain = tl(to_torch(x))
    np.testing.assert_allclose(to_numpy(plain), to_numpy(out), **F32)
    unmerged = torch.autograd.grad(plain, (tl.blkdiag1, tl.blkdiag2), to_torch(g))
    for a, b in zip(got, unmerged):
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), **F32_SUMS)


def test_torch_merged_refresh_follows_the_factors():
    _, tl, x, _ = _layer_pair(64, 48, seed=4)
    tl.enable_merged_training()
    with torch.no_grad():
        tl.blkdiag2.mul_(2.0)
    with torch.no_grad():
        stale = tl(to_torch(x))
        tl.refresh_merged()
        fresh = tl(to_torch(x))
        tl.disable_merged_training()
        want = tl(to_torch(x))
    np.testing.assert_allclose(to_numpy(fresh), to_numpy(want), **F32)
    assert float((stale - fresh).abs().max()) > 1e-3


@pytest.mark.parametrize("peft", [{"dropout": 0.1}, {"scaler": True}])
def test_torch_merged_training_refuses_branch_transforms(peft):
    jl, tl, _, _ = _layer_pair(64, 64, seed=5, peft=peft)
    assert tl.can_merge_train() is jl.can_merge_train() is False
    with pytest.raises(ValueError, match="merged training"):
        tl.enable_merged_training()


def test_torch_surgery_training_helpers_match_jax():
    """trainable_filter and enable/refresh/disable of merged training on a
    tiny Llama, against the JAX package's filter and counts."""
    jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(), rngs=nnx.Rngs(0))
    jpeft.init_monarch(jm, PEFT, rngs=nnx.Rngs(1))
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    surgery.init_monarch(tm, PEFT)
    for extra in (DEFAULT_TRAINABLE_PATHS, (), ("__all__",)):
        want = sorted(".".join(str(getattr(p, "key", p)) for p in path)
                      for path, _ in nnx.to_flat_state(nnx.state(jm, jax_trainable_filter(extra))))
        want = [w.replace("lm_head.kernel", "lm_head.weight")
                .replace("embed_tokens.embedding", "embed_tokens.weight")
                .replace("layernorm.scale", "layernorm.weight")
                .replace("norm.scale", "norm.weight") for w in want]
        got = surgery.trainable_filter(tm, extra)
        assert got == sorted(want)
        assert got == sorted(n for n, p in tm.named_parameters() if p.requires_grad)
    surgery.trainable_filter(tm)
    for min_dim in (0, 128):
        assert (surgery.enable_merged_training(tm, min_dim=min_dim)
                == jpeft.enable_merged_training(jm, min_dim=min_dim))
        assert surgery.refresh_merged(tm) == jpeft.refresh_merged(jm)
        assert surgery.disable_merged_training(tm) == jpeft.disable_merged_training(jm)
    assert surgery.refresh_merged(tm) == 0
