"""The port's GPT-Neo against the JAX model on the CPU (the machinery and
tolerances of ``test_torch_gpt2.py``): logits and the adapter gradients in
float32 and bfloat16, greedy and beam-4 tokens through the cache, the hook
sites.  The tiny preset's window is 5 tokens and its layers alternate
global and local, so every sequence here (10-14 tokens) is cut by the local
layer's window, in training and over the cache alike."""

import numpy as np
import pytest
import torch

from sparse_matrix_fine_tuning_torch import models as tmodels
from sparse_matrix_fine_tuning_torch.utils.testing import to_torch
from test_torch_gpt2 import (
    check_decode,
    check_hooks,
    check_logits,
    check_loss_and_grads,
    family_pair,
    left_padded,
)


@pytest.fixture(scope="module", params=[None, "bfloat16"], ids=["f32", "bf16"])
def pairs(request):
    return request.param, family_pair("gpt_neo", dtype=request.param)


def test_torch_gpt_neo_logits_match_jax(pairs):
    dtype, (jm, tm) = pairs
    check_logits(jm, tm, bf16=dtype is not None)


def test_torch_gpt_neo_loss_and_adapter_grads_match_jax(pairs):
    dtype, (jm, tm) = pairs
    # q, k, v, out_proj, c_fc, c_proj a layer, two factors each
    assert check_loss_and_grads(jm, tm, bf16=dtype is not None) == 2 * 6 * 2


def test_torch_gpt_neo_decode_and_hooks_match_jax(pairs):
    dtype, (jm, tm) = pairs
    if dtype is None:
        check_decode(jm, tm)
        check_hooks(jm, tm)


def test_torch_gpt_neo_local_window_cuts():
    """At t = 10 > window 5 the local layer's output depends on the window
    (a window of 10 gives other logits past position 4, the same before),
    and the JAX model agrees at both windows."""
    outs = []
    for window in (5, 10):
        jm, tm = family_pair("gpt_neo", seed=3, window_size=window)
        assert tm.config.layer_types == ("global", "local")
        check_logits(jm, tm, bf16=False, lens=(10, 10))
        ids, mask = left_padded(0, (10, 10))
        with torch.no_grad():
            outs.append(tm(to_torch(ids, torch.long)).numpy())
    np.testing.assert_allclose(outs[0][:, :5], outs[1][:, :5], rtol=1e-6, atol=1e-6)
    assert np.abs(outs[0][:, 5:] - outs[1][:, 5:]).min(axis=-1).max() > 0


def test_torch_gpt_neo_attention_layers_config():
    cfg = tmodels.GPTNeoConfig.tiny(num_hidden_layers=3, attention_layers=("local",) * 3)
    assert cfg.layer_types == ("local",) * 3
    assert tmodels.GPTNeoConfig.tiny(num_hidden_layers=3).layer_types == (
        "global", "local", "global")
