"""The port's MonarchLinear against the JAX one, weights carried across by
``utils/jax_bridge.load_jax_state``, on the CPU in float32.

Every adapter parameter is set to random nonzero values first: the plain
adapter init zeroes blkdiag2, which would hide a broken Monarch branch.
Tolerance: float32, 1e-5 (utils/testing.TOLERANCES["f32_op"]).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu.layers import monarch_linear as jml

F32 = TOLERANCES["f32_op"]

# name: (in, out, peft_config, layer kwargs)
VARIANTS = {
    "plain": (64, 48, {}, {}),
    "scaler": (64, 64, {"scaler": True}, {}),
    "scaler_diag_affine": (64, 32, {"scaler": True, "scaler_type": "diag", "affine": True}, {}),
    "padded_in50": (50, 40, {}, {}),
    "bias": (64, 48, {}, {"use_bias": True}),
    "mult_factor": (64, 64, {"use_mult_factor": True}, {}),
    "dropout_eval": (64, 48, {"dropout": 0.1}, {}),
}


def flat_params(module) -> dict:
    """{path: numpy copy} of an NNX module's parameters."""
    return {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(nnx.state(module, nnx.Param))}


def randomize_adapters(module, rng) -> None:
    for _, v in nnx.to_flat_state(nnx.state(module, jml.AdapterParam)):
        v.set_value(jnp.array(rng.normal(0.0, 0.3, v[...].shape).astype(np.float32)))


def make_pair(name, seed=0):
    n_in, n_out, peft, kw = VARIANTS[name]
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_out, n_in)) / np.sqrt(n_in)).astype(np.float32)
    bias = rng.standard_normal(n_out).astype(np.float32) if kw.get("use_bias") else None
    jl = jml.MonarchLinear(n_in, n_out, peft_config=peft, weights=jnp.array(w),
                           bias=None if bias is None else jnp.array(bias), rngs=nnx.Rngs(0))
    randomize_adapters(jl, rng)
    tl = MonarchLinear(n_in, n_out, peft_config=peft, weights=to_torch(w),
                       bias=None if bias is None else to_torch(bias), device="cpu")
    load_jax_state(tl, flat_params(jl))
    tl.eval()
    x = rng.standard_normal((3, 5, n_in)).astype(np.float32)
    return jl, tl, x


@pytest.mark.parametrize("name", list(VARIANTS))
def test_torch_monarch_linear_forward_matches_jax(name):
    jl, tl, x = make_pair(name)
    assert float(tl.blkdiag2.detach().abs().max()) > 0
    with torch.no_grad():
        got = tl(to_torch(x))
    np.testing.assert_allclose(to_numpy(got), np.asarray(jl(jnp.array(x))), **F32)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_torch_monarch_linear_merge_unmerge_matches_jax(name):
    jl, tl, x = make_pair(name, seed=1)
    jl.merge_adapter()
    tl.merge_adapter()
    assert tl.merged and tl.blkdiag1.requires_grad and not tl.dense.requires_grad
    np.testing.assert_allclose(to_numpy(tl.dense), np.asarray(jl.dense[...]), **F32)
    with torch.no_grad():
        got = tl(to_torch(x))
    np.testing.assert_allclose(to_numpy(got), np.asarray(jl(jnp.array(x))), **F32)
    jl.unmerge_adapter()
    tl.unmerge_adapter()
    assert not tl.merged
    np.testing.assert_allclose(to_numpy(tl.dense), np.asarray(jl.dense[...]), **F32)
    with torch.no_grad():
        got = tl(to_torch(x))
    np.testing.assert_allclose(to_numpy(got), np.asarray(jl(jnp.array(x))), **F32)


def test_torch_monarch_linear_shapes_and_init():
    """Shape resolution and the init rules of the JAX layer."""
    w = torch.randn(40, 50, generator=torch.Generator().manual_seed(0))
    plain = MonarchLinear(50, 40, weights=w, device="cpu")
    jl = jml.MonarchLinear(50, 40, weights=jnp.array(to_numpy(w)), rngs=nnx.Rngs(0))
    assert plain.blkdiag1.shape == jl.blkdiag1[...].shape
    assert plain.blkdiag2.shape == jl.blkdiag2[...].shape
    assert float(plain.blkdiag2.detach().abs().max()) == 0  # the adapter starts at zero
    bound = 1 / np.sqrt(plain.in_blksz)
    assert 0 < float(plain.blkdiag1.detach().abs().max()) <= bound
    scaled = MonarchLinear(50, 40, weights=w, peft_config={"scaler": True}, device="cpu")
    assert float(scaled.blkdiag2.detach().abs().max()) > 0
    trainable = {n for n, p in scaled.named_parameters() if p.requires_grad}
    assert trainable == {"blkdiag1", "blkdiag2", "scaler.scaler"}


class _FakeCudaInput:
    is_cuda = True


@pytest.mark.parametrize("name,fuses", [("plain", True), ("bias", True), ("scaler", False),
                                        ("padded_in50", False), ("mult_factor", False),
                                        ("dropout_eval", False)])
def test_torch_monarch_linear_fused_add_dispatch(name, fuses):
    """On a CUDA input the layer takes the fused kernel K2 exactly when no
    branch transform and no padding is in the way; a CPU input never does."""
    _, tl, x = make_pair(name)
    assert tl._can_fuse_add(_FakeCudaInput()) is fuses
    assert tl._can_fuse_add(to_torch(x)) is False
