"""The port's GPT-NeoX (Pythia) against the JAX model on the CPU (the
machinery and tolerances of ``test_torch_gpt2.py``): logits and the adapter
gradients in float32 and bfloat16 (``embed_out`` adapted too, as
``find_all_linear_names`` picks it), greedy and beam-4 tokens through the
cache, the hook sites; partial rotary at ``rotary_pct`` 0.25 (the preset,
4 of 16 head dims rotating) and 1.0 (all), and the sequential residual."""

import pytest

from sparse_matrix_fine_tuning_torch import models as tmodels
from test_torch_gpt2 import (
    check_decode,
    check_hooks,
    check_logits,
    check_loss_and_grads,
    family_pair,
)


@pytest.fixture(scope="module", params=[None, "bfloat16"], ids=["f32", "bf16"])
def pairs(request):
    return request.param, family_pair("gpt_neox", dtype=request.param)


def test_torch_gpt_neox_logits_match_jax(pairs):
    dtype, (jm, tm) = pairs
    check_logits(jm, tm, bf16=dtype is not None)


def test_torch_gpt_neox_loss_and_adapter_grads_match_jax(pairs):
    dtype, (jm, tm) = pairs
    # query_key_value, dense, dense_h_to_4h, dense_4h_to_h a layer and
    # embed_out, two factors each
    assert check_loss_and_grads(jm, tm, bf16=dtype is not None) == (2 * 4 + 1) * 2


def test_torch_gpt_neox_decode_and_hooks_match_jax(pairs):
    dtype, (jm, tm) = pairs
    if dtype is None:
        check_decode(jm, tm)
        check_hooks(jm, tm)


@pytest.mark.parametrize("cfg", [{"rotary_pct": 0.25}, {"rotary_pct": 1.0},
                                 {"use_parallel_residual": False, "hidden_act": "gelu_new"}],
                         ids=["rotary_quarter", "rotary_full", "sequential_gelu_new"])
def test_torch_gpt_neox_variants_match_jax(cfg):
    jm, tm = family_pair("gpt_neox", seed=5, **cfg)
    assert tm.config.rotary_ndims == int(16 * cfg.get("rotary_pct", 0.25))
    check_logits(jm, tm, bf16=False)
    check_hooks(jm, tm)


def test_torch_gpt_neox_pythia_1b_preset():
    cfg = tmodels.GPTNeoXConfig.pythia_1b()
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.head_width, cfg.intermediate_size,
            cfg.vocab_size, cfg.rotary_ndims) == (2048, 16, 256, 8192, 50432, 64)
