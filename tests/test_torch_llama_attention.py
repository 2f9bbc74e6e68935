"""The port's Llama with ``attention_impl`` "splash" and "dpa" against the JAX
model on the CPU in float32: logits, ``training_loss`` and every adapter
gradient at t = 128 (splash's block), on a full batch and on a right-padded
one (splash ignores the padding, as JAX's does: pure-causal is exact for a
right-padded row's real positions, and both models compute the same
garbage at its pad positions, which the labels mask); greedy tokens from
``generate`` with a splash config (prefill and decode take the einsum
attention, as in JAX); and splash with a sliding window refused, as JAX
refuses it.

The JAX model is ``LlamaConfig.tiny(attention_impl=...)`` (2 layers, hidden
64, GQA 4/2, head_dim 16) with Monarch adapters on all seven projections,
random nonzero, carried into the port by ``utils/jax_bridge.load_jax_state``.
Its splash kernels run in interpret mode (``make_splash_mha`` patched with
``interpret=True``; the JAX package is unchanged).  Tolerances: 1e-4
(TOLERANCES["f32_logits"]): two layers of fp32 sums in another order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from jax.experimental.pallas.ops.tpu.splash_attention import splash_attention_kernel as sk

from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.generate import GenerationConfig, generate
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam
from sparse_matrix_fine_tuning_tpu.models import generate as jgen

MODEL = TOLERANCES["f32_logits"]
PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj"]}
T = 128


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(sk, "make_splash_mha",
                        functools.partial(sk.make_splash_mha, interpret=True))


def pair_for(impl: str, seed: int = 0):
    jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(attention_impl=impl),
                                  rngs=nnx.Rngs(seed))
    jpeft.init_monarch(jm, PEFT, rngs=nnx.Rngs(seed + 1))
    rng = np.random.default_rng(seed)
    for _, v in nnx.to_flat_state(nnx.state(jm, AdapterParam)):
        v.set_value(jnp.array(rng.normal(0.0, 0.1, v[...].shape).astype(np.float32)))
    tm = LlamaForCausalLM(LlamaConfig.tiny(attention_impl=impl), device="cpu")
    surgery.init_monarch(tm, PEFT)
    load_jax_state(tm, {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
                        for path, v in nnx.to_flat_state(nnx.state(jm, nnx.Param))})
    return jm, tm


def batch(padded: bool, seed: int = 1):
    """Two rows of T tokens; padded: row 1 right-padded after 90 tokens,
    its pad labels -100."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 256, (2, T)).astype(np.int32)
    mask = np.ones_like(ids)
    if padded:
        mask[1, 90:] = 0
        ids = ids * mask
    labels = np.where(mask > 0, ids, -100).astype(np.int32)
    return ids, mask, labels


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("impl", ["splash", "dpa"])
def test_torch_llama_attention_impl_matches_jax(interpret, impl, padded):
    jm, tm = pair_for(impl)
    ids, mask, labels = batch(padded)
    jids, jmask, jlabels = jnp.array(ids), jnp.array(mask), jnp.array(labels)
    want_logits = np.asarray(jm(jids, attention_mask=jmask))

    def jloss(m):
        return m.training_loss(jids, jlabels, attention_mask=jmask)

    want, jgrads = nnx.value_and_grad(jloss, argnums=nnx.DiffState(0, AdapterParam))(jm)
    jgrads = {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(v[...])
              for path, v in nnx.to_flat_state(jgrads)}
    tids, tmask = to_torch(ids, torch.long), to_torch(mask, torch.long)
    with torch.no_grad():
        got_logits = tm(tids, attention_mask=tmask)
    np.testing.assert_allclose(to_numpy(got_logits), want_logits, **MODEL)
    tm.zero_grad()
    got = tm.training_loss(tids, to_torch(labels, torch.long), attention_mask=tmask)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **MODEL)
    assert len(jgrads) == 28
    for name, g in jgrads.items():
        np.testing.assert_allclose(to_numpy(tm.get_parameter(name).grad), g, **MODEL)


def test_torch_llama_splash_ignores_padding_as_jax_does():
    """Splash attends by position alone: the attention mask changes no
    logit of a right-padded batch (the JAX model's padded logits are held
    to the port's in the test above)."""
    _, tm = pair_for("splash")
    ids, mask, _ = batch(padded=True)
    with torch.no_grad():
        masked = tm(to_torch(ids, torch.long), attention_mask=to_torch(mask, torch.long))
        unmasked = tm(to_torch(ids, torch.long))
    torch.testing.assert_close(masked, unmasked, rtol=0, atol=0)


def test_torch_llama_splash_generate_matches_jax():
    """Greedy decode with a splash config: the tokens equal JAX's (prefill
    and decode over the cache take the einsum attention in both)."""
    jm, tm = pair_for("splash", seed=2)
    jm.eval()
    tm.eval()
    rng = np.random.default_rng(3)
    lens = (9, 5, 2)
    ids = rng.integers(3, 256, (len(lens), max(lens))).astype(np.int32)
    mask = np.zeros_like(ids)
    for row, n in enumerate(lens):
        mask[row, max(lens) - n:] = 1
    ids = ids * mask
    want = np.asarray(jgen.generate(jm, jnp.array(ids), jnp.array(mask),
                                    jgen.GenerationConfig(max_new_tokens=8, eos_token_id=None)))
    got = generate(tm, to_torch(ids, torch.long), to_torch(mask, torch.long),
                   GenerationConfig(max_new_tokens=8, eos_token_id=None))
    np.testing.assert_array_equal(got.numpy(), want)


def test_torch_llama_splash_refuses_sliding_window():
    """As the JAX model (llama.py:266-271): splash ignores the bias, so a
    sliding window would be silently dropped.  Decode over a cache takes the
    einsum attention and keeps the window."""
    ids = np.random.default_rng(4).integers(3, 256, (1, 16)).astype(np.int32)
    jm = jmodels.LlamaForCausalLM(
        jmodels.LlamaConfig.tiny(attention_impl="splash", sliding_window=4), rngs=nnx.Rngs(0))
    with pytest.raises(ValueError, match="sliding_window"):
        jm(jnp.array(ids))
    tm = LlamaForCausalLM(LlamaConfig.tiny(attention_impl="splash", sliding_window=4),
                          device="cpu")
    with pytest.raises(ValueError, match="sliding_window"):
        tm(to_torch(ids, torch.long))
    with pytest.raises(ValueError, match="attention_impl"):
        LlamaForCausalLM(LlamaConfig.tiny(attention_impl="flash"), device="cpu")
