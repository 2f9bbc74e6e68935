"""A tiny Llama over a quantized frozen base, the port against the JAX
package on the CPU in float32.

The JAX model is ``LlamaConfig.tiny()`` (2 layers, hidden 64, GQA 4/2) with
Monarch adapters on all seven projections and random nonzero factors,
quantized by ``quantize_frozen_base`` (int8, or int4 with group 16) and,
where asked, with an ``Int8LMHead``; its whole state, codes and scales
included, is carried into the port by ``utils/jax_bridge.load_jax_state``.
Tolerances: logits 1e-4 (``TOLERANCES["f32_logits"]``); greedy tokens
identical.  Training over the quantized base is held in
``test_torch_quant_trainer.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch import quant as tq
from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.generate import GenerationConfig, generate
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu import quant as jq
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam
from sparse_matrix_fine_tuning_tpu.models import generate as jgen

LOGITS = TOLERANCES["f32_logits"]
PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj"]}
GROUP = 16
NEW = 6


def _flat_state(module) -> dict:
    state = nnx.state(module, nnx.Any(nnx.Param, jq.QuantScales))
    return {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(state)}


def quantized_pair(bits: int, head: str = "", seed: int = 0):
    """(JAX model, port model), both quantized with ``bits`` and, for a
    non-empty ``head``, an Int8LMHead of that impl; the port carries the JAX
    state bit for bit."""
    jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(), rngs=nnx.Rngs(seed))
    jpeft.init_monarch(jm, PEFT, rngs=nnx.Rngs(seed + 1))
    rng = np.random.default_rng(seed)
    for _, v in nnx.to_flat_state(nnx.state(jm, AdapterParam)):
        v.set_value(jnp.array(rng.normal(0.0, 0.1, v[...].shape).astype(np.float32)))
    assert jq.quantize_frozen_base(jm, bits=bits, group_size=GROUP) == 14
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    surgery.init_monarch(tm, PEFT)
    assert tq.quantize_frozen_base(tm, bits=bits, group_size=GROUP) == 14
    if head:
        assert jq.quantize_lm_head(jm, impl=head) and tq.quantize_lm_head(tm, impl=head)
    load_jax_state(tm, _flat_state(jm))
    return jm, tm.eval()


def _prompts(seed=1, lens=(9, 5, 2)):
    rng = np.random.default_rng(seed)
    t = max(lens)
    ids = rng.integers(3, 256, (len(lens), t)).astype(np.int32)
    mask = np.zeros_like(ids)
    for row, n in enumerate(lens):
        mask[row, t - n:] = 1
    return ids * mask, mask


@pytest.mark.parametrize("bits,head", [(8, ""), (4, ""), (8, "w8a8"), (4, "dequant")])
def test_torch_quantized_llama_logits_and_tokens_match_jax(bits, head):
    jm, tm = quantized_pair(bits, head)
    layer = tm.model.layers[1].mlp.down_proj
    jlayer = jm.model.layers[1].mlp.down_proj
    assert layer.dense.dtype == (torch.int8 if bits == 8 else torch.uint8)
    assert np.array_equal(layer.dense.numpy(), np.asarray(jlayer.dense[...]))
    assert np.array_equal(layer.dense_scales.numpy(), np.asarray(jlayer.dense_scales[...]))
    ids, mask = _prompts()
    want = np.asarray(jm(jnp.array(ids), attention_mask=jnp.array(mask)))
    with torch.no_grad():
        got = tm(to_torch(ids, torch.long), attention_mask=to_torch(mask, torch.long))
    valid = mask.astype(bool)
    np.testing.assert_allclose(to_numpy(got)[valid], want[valid], **LOGITS)
    if head == "w8a8" or not head:  # the decode loop compiles once per config in JAX
        want_toks = np.asarray(jgen.generate(jm, jnp.array(ids), jnp.array(mask),
                                             jgen.GenerationConfig(max_new_tokens=NEW)))
        got_toks = generate(tm, to_torch(ids, torch.long), to_torch(mask, torch.long),
                            GenerationConfig(max_new_tokens=NEW))
        np.testing.assert_array_equal(got_toks.numpy(), want_toks)
