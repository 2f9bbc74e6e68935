"""The port's Backpack-GPT-2 against the JAX model on the CPU (the machinery
and tolerances of ``test_torch_gpt2.py``): logits and the adapter gradients
in float32 and bfloat16 (every linear adapted: the contextualization
GPT-2's, the sense network's and the weight network's), the
contextualization network's hook sites and the sense site.  The ReFT
sense site: ``test_torch_backpack_reft.py``."""

import pytest

from test_torch_gpt2 import (
    SITES,
    check_hooks,
    check_logits,
    check_loss_and_grads,
    family_pair,
)


@pytest.fixture(scope="module", params=[None, "bfloat16"], ids=["f32", "bf16"])
def pairs(request):
    return request.param, family_pair("backpack", dtype=request.param)


def test_torch_backpack_logits_match_jax(pairs):
    dtype, (jm, tm) = pairs
    check_logits(jm, tm, bf16=dtype is not None)


def test_torch_backpack_loss_and_adapter_grads_match_jax(pairs):
    dtype, (jm, tm) = pairs
    # GPT-2's four a layer; the sense network's block and final MLPs (c_fc,
    # c_proj each) and the weight network's c_attn; two factors each
    assert check_loss_and_grads(jm, tm, bf16=dtype is not None) == (2 * 4 + 5) * 2


def test_torch_backpack_hooks_match_jax(pairs):
    dtype, (jm, tm) = pairs
    if dtype is None:
        check_hooks(jm, tm, [*SITES, "sense_network_output"])
