"""Gemma on the port's Llama, the rest of ``test_torch_gemma.py``: greedy
and beam-4 tokens through the cache and the hook sites against the JAX model
(float32, the machinery and tolerances of ``test_torch_gpt2.py``);
``UnitOffsetRMSNorm`` at a zero offset equals ``RMSNorm`` at unit scale bit
for bit, and the JAX norm at a random offset within
``TOLERANCES["f32_op"]``; splash attention at Gemma's head_dim 256 raises
on the CPU as on the card, naming its ROADMAP entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.kernels.attention_cuda import WIDE_HEAD_ITEM
from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.llama import (
    LlamaForCausalLM,
    RMSNorm,
    UnitOffsetRMSNorm,
)
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES
from sparse_matrix_fine_tuning_tpu.models.llama import UnitOffsetRMSNorm as JaxUnitOffset
from test_torch_gpt2 import check_decode, check_hooks, family_pair


def test_torch_gemma_decode_and_hooks_match_jax():
    jm, tm = family_pair("gemma")
    check_decode(jm, tm)
    check_hooks(jm, tm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_gemma_unit_offset_norm_at_zero_is_identity_scale(dtype):
    x = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(0)).to(dtype)
    offset = UnitOffsetRMSNorm(64, eps=1e-6, dtype=dtype, device="cpu")
    unit = RMSNorm(64, eps=1e-6, dtype=dtype, device="cpu")
    assert torch.equal(offset.weight, torch.zeros(64)) and torch.equal(unit.weight, torch.ones(64))
    with torch.no_grad():
        assert torch.equal(offset(x), unit(x))
        # and the JAX norm at the same stored offset, float32
        jn = JaxUnitOffset(64, epsilon=1e-6, rngs=nnx.Rngs(0))
        w = np.random.default_rng(1).normal(0, 0.1, 64).astype(np.float32)
        jn.scale.set_value(jnp.array(w))
        offset.weight.copy_(torch.from_numpy(w))
        offset.dtype = None
        xf = x.float()
        np.testing.assert_allclose(offset(xf).numpy(), np.asarray(jn(jnp.array(xf.numpy()))),
                                   **TOLERANCES["f32_op"])


def test_torch_gemma_splash_at_head_dim_256_is_refused():
    """The preset's head_dim with "splash": the forward raises before any
    attention runs (no einsum in its place)."""
    cfg = LlamaConfig.gemma_2b(vocab_size=256, hidden_size=64, num_hidden_layers=1,
                               intermediate_size=128, attention_impl="splash")
    assert cfg.head_width == 256
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="head_dim 256") as err:
        model(torch.ones(2, 8, dtype=torch.long))
    assert WIDE_HEAD_ITEM in str(err.value)
    # the einsum attention the harnesses run serves the same config
    LlamaForCausalLM(LlamaConfig.gemma_2b(vocab_size=256, hidden_size=64, num_hidden_layers=1,
                                          intermediate_size=128), device="cpu")(
        torch.ones(2, 8, dtype=torch.long))
