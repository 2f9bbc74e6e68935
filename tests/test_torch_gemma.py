"""Gemma on the port's Llama (``rmsnorm_unit_offset``, ``scale_embeddings``,
GeGLU, one kv head, a decoupled head_dim, a tied head) against the JAX model
on the CPU, with the machinery and tolerances of ``test_torch_gpt2.py``:
logits and the adapter gradients in float32 and bfloat16 (the embedding
scale rounded to bf16 first, as HF does).  Decoding, hooks, the norm and
the splash refusal: ``test_torch_gemma_decode.py``."""

import pytest

from sparse_matrix_fine_tuning_torch.models.llama import UnitOffsetRMSNorm
from test_torch_gpt2 import check_logits, check_loss_and_grads, family_pair


@pytest.fixture(scope="module", params=[None, "bfloat16"], ids=["f32", "bf16"])
def pairs(request):
    return request.param, family_pair("gemma", dtype=request.param)


def test_torch_gemma_logits_match_jax(pairs):
    dtype, (jm, tm) = pairs
    assert isinstance(tm.model.norm, UnitOffsetRMSNorm) and tm.lm_head is None
    check_logits(jm, tm, bf16=dtype is not None)


def test_torch_gemma_loss_and_adapter_grads_match_jax(pairs):
    dtype, (jm, tm) = pairs
    assert check_loss_and_grads(jm, tm, bf16=dtype is not None) == 2 * 7 * 2
