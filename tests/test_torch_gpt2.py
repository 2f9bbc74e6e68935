"""The port's GPT-2 against the JAX model on the CPU, and the parity
machinery the other families' tests share (``FAMILIES``, ``family_pair``,
``check_*``).

A family's JAX model is its ``tiny()`` preset (2 layers, hidden 64) with
Monarch adapters on every linear (``find_all_linear_names``), every
parameter (the adapters', the frozen bases', the biases, norms and
embeddings) moved off its init by seeded numpy noise; the port's model
takes it through ``utils/jax_bridge.load_jax_state``.  Held:

  * logits of a left-padded batch: float32 within
    ``TOLERANCES["f32_logits"]``, bfloat16 within ``bf16_atol`` of the
    logits (two bf16 ulps of their scale);
  * the masked loss and the gradient of every adapter parameter: float32
    within ``TOLERANCES["f32_logits"]``; in bfloat16 the loss within
    ``bf16_atol`` and each gradient within ``BF16_GRAD_RTOL`` of its norm,
    norm-wise (the activations round to bf16 in each package at other
    points of the same sums, and JAX's softmaxes over bf16 scores round at
    each step; the readings: 1.0-1.9% for the GPT families and Gemma, 3.5%
    for Backpack, whose weight network's softmax is bf16 in JAX);
  * greedy and beam-4 tokens through the KV cache (left-padded prompts,
    float32): equal;
  * each hook site's input (block input, attention and MLP outputs, block
    output), recorded in both: float32 within ``TOLERANCES["f32_logits"]``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch import models as tmodels
from sparse_matrix_fine_tuning_torch.models import generate as tgen
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
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam
from sparse_matrix_fine_tuning_tpu.models import generate as jgen

LOGITS = TOLERANCES["f32_logits"]
BF16_GRAD_RTOL = 2.0 ** -4  # norm-wise: eight bf16 ulps relative
PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True}
# family -> (JAX config, JAX model, port config, port model)
FAMILIES = {
    "gpt2": (jmodels.GPT2Config, jmodels.GPT2LMHeadModel, tmodels.GPT2Config,
             tmodels.GPT2LMHeadModel),
    "gpt_neo": (jmodels.GPTNeoConfig, jmodels.GPTNeoForCausalLM, tmodels.GPTNeoConfig,
                tmodels.GPTNeoForCausalLM),
    "gpt_neox": (jmodels.GPTNeoXConfig, jmodels.GPTNeoXForCausalLM, tmodels.GPTNeoXConfig,
                 tmodels.GPTNeoXForCausalLM),
    "backpack": (jmodels.BackpackGPT2Config, jmodels.BackpackGPT2LMHeadModel,
                 tmodels.BackpackGPT2Config, tmodels.BackpackGPT2LMHeadModel),
    "gemma": (lambda **kw: jmodels.LlamaConfig.tiny(**GEMMA, **kw), jmodels.LlamaForCausalLM,
              lambda **kw: tmodels.LlamaConfig.tiny(**GEMMA, **kw), tmodels.LlamaForCausalLM),
}
# the Gemma preset's knobs on the tiny Llama: one kv head, head_dim decoupled
GEMMA = dict(num_key_value_heads=1, head_dim=32, mlp_activation="gelu_tanh",
             rmsnorm_unit_offset=True, scale_embeddings=True, tie_word_embeddings=True)


def _tiny(cls):
    return cls.tiny if hasattr(cls, "tiny") else cls


def flat_params(model) -> dict:
    return {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def family_pair(family: str, seed: int = 0, **cfg):
    """(JAX model, port model) of ``family``'s tiny preset with ``cfg`` on
    top, Monarch-adapted on every linear, all parameters perturbed, the
    port's bridged from the JAX one."""
    jcfg, jcls, tcfg, tcls = FAMILIES[family]
    jm = jcls(_tiny(jcfg)(**cfg), rngs=nnx.Rngs(seed))
    jpeft.init_monarch(jm, dict(PEFT, target_modules=jpeft.find_all_linear_names(jm)),
                       rngs=nnx.Rngs(seed + 1))
    rng = np.random.default_rng(seed)
    for _, v in nnx.to_flat_state(nnx.state(jm, nnx.Param)):
        value = v[...]
        v.set_value(value + jnp.array(rng.normal(0.0, 0.05, value.shape), value.dtype))
    tm = tcls(_tiny(tcfg)(**cfg), device="cpu")
    surgery.init_monarch(tm, dict(PEFT, target_modules=surgery.find_all_linear_names(tm)))
    load_jax_state(tm, flat_params(jm))
    return jm, tm.eval()


def left_padded(seed=0, lens=(10, 6, 3), vocab=256):
    rng = np.random.default_rng(seed)
    t = max(lens)
    ids = rng.integers(3, vocab, (len(lens), t)).astype(np.int32)
    mask = np.zeros_like(ids)
    for row, n in enumerate(lens):
        mask[row, t - n:] = 1
    return ids * mask, mask


def check_logits(jm, tm, bf16: bool, seed=0, lens=(10, 6, 3)):
    ids, mask = left_padded(seed, lens)
    want = np.asarray(jm(jnp.array(ids), attention_mask=jnp.array(mask))).astype(np.float32)
    with torch.no_grad():
        got = to_numpy(tm(to_torch(ids, torch.long), attention_mask=to_torch(mask, torch.long)))
    assert got.shape == want.shape
    tol = dict(rtol=0, atol=bf16_atol(want)) if bf16 else LOGITS
    np.testing.assert_allclose(got, want, **tol)


def _grad_names(grads) -> dict:
    return {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(v[...], np.float32)
            for path, v in nnx.to_flat_state(grads)}


def check_loss_and_grads(jm, tm, bf16: bool, seed=1):
    ids, mask = left_padded(seed, (9, 7))
    labels = np.where(mask > 0, ids, -100).astype(np.int32)

    def jloss(m):
        return m.training_loss(jnp.array(ids), jnp.array(labels),
                               attention_mask=jnp.array(mask))

    want, jgrads = nnx.value_and_grad(jloss, argnums=nnx.DiffState(0, AdapterParam))(jm)
    jgrads = _grad_names(jgrads)
    surgery.trainable_filter(tm, extra_paths=())
    tm.zero_grad()
    got = tm.training_loss(to_torch(ids, torch.long), to_torch(labels, torch.long),
                           attention_mask=to_torch(mask, torch.long))
    got.backward()
    tgrads = {n: p.grad for n, p in tm.named_parameters() if p.requires_grad}
    assert sorted(tgrads) == sorted(jgrads) and len(jgrads) > 0
    if bf16:
        np.testing.assert_allclose(got.item(), float(want), rtol=0,
                                   atol=bf16_atol(float(want)))
    else:
        np.testing.assert_allclose(got.item(), float(want), **LOGITS)
    for name, g in jgrads.items():
        if bf16:
            err = np.linalg.norm(to_numpy(tgrads[name]) - g) / np.linalg.norm(g)
            assert err <= BF16_GRAD_RTOL, f"{name}: {err}"
        else:
            np.testing.assert_allclose(to_numpy(tgrads[name]), g, err_msg=name, **LOGITS)
    return len(jgrads)


def check_decode(jm, tm, vocab=256):
    """Greedy and beam-4 tokens through the cache from left-padded prompts."""
    ids, mask = left_padded(3, (8, 5, 2), vocab)
    for beams in (1, 4):
        kw = dict(max_new_tokens=6, num_beams=beams, eos_token_id=None, pad_token_id=0)
        want = np.asarray(jgen.generate(jm, jnp.array(ids), jnp.array(mask),
                                        jgen.GenerationConfig(**kw)))
        got = tgen.generate(tm, to_torch(ids, torch.long), to_torch(mask, torch.long),
                            tgen.GenerationConfig(**kw))
        np.testing.assert_array_equal(to_numpy(got), want, err_msg=f"{beams} beams")


SITES = [(0, "block_input"), (0, "attention_output"), (1, "mlp_output"), (1, "block_output")]


def check_hooks(jm, tm, sites=SITES):
    """Each site's tensor, recorded by an identity hook in both packages,
    and the logits with a hook that doubles every site's tensor."""
    ids, mask = left_padded(4)
    seen = {"jax": {}, "port": {}}

    def recorder(where, key, scale):
        def hook(x):
            seen[where][key] = x
            return x * scale
        return hook

    for scale in (1.0, 2.0):
        jh = {k: recorder("jax", k, scale) for k in sites}
        th = {k: recorder("port", k, scale) for k in sites}
        want = np.asarray(jm(jnp.array(ids), attention_mask=jnp.array(mask), layer_hooks=jh))
        with torch.no_grad():
            got = to_numpy(tm(to_torch(ids, torch.long),
                              attention_mask=to_torch(mask, torch.long), layer_hooks=th))
        np.testing.assert_allclose(got, want, err_msg=f"logits, hooks x{scale}", **LOGITS)
        for k in sites:
            np.testing.assert_allclose(to_numpy(seen["port"][k]), np.asarray(seen["jax"][k]),
                                       err_msg=f"{k} x{scale}", **LOGITS)


@pytest.fixture(scope="module", params=[None, "bfloat16"], ids=["f32", "bf16"])
def pairs(request):
    return request.param, family_pair("gpt2", dtype=request.param)


@pytest.fixture(scope="module")
def pair():
    return family_pair("gpt2")


def test_torch_gpt2_logits_match_jax(pairs):
    dtype, (jm, tm) = pairs
    check_logits(jm, tm, bf16=dtype is not None)


def test_torch_gpt2_loss_and_adapter_grads_match_jax(pairs):
    dtype, (jm, tm) = pairs
    # c_attn, attn.c_proj, c_fc, mlp.c_proj a layer, two factors each
    assert check_loss_and_grads(jm, tm, bf16=dtype is not None) == 2 * 4 * 2


def test_torch_gpt2_decode_matches_jax(pair):
    check_decode(*pair)


def test_torch_gpt2_hooks_match_jax(pair):
    check_hooks(*pair)


def test_torch_gpt2_inverse_layer_scale_matches_jax():
    """``scale_attn_by_inverse_layer_idx`` (Backpack's setting) divides
    layer i's scores by i + 1."""
    jm, tm = family_pair("gpt2", seed=2, scale_attn_by_inverse_layer_idx=True)
    assert [blk.attn.score_scale for blk in tm.transformer.h] == [0.25, 0.125]
    check_logits(jm, tm, bf16=False)


def test_torch_gpt2_config_and_exports_match_jax():
    for name in ("gpt2", "gpt_neo", "gpt_neox", "backpack"):
        jcfg, _, tcfg, _ = FAMILIES[name]
        j, t = jcfg.tiny(), tcfg.tiny()
        assert {f: getattr(j, f) for f in j.__dataclass_fields__} == {
            f: getattr(t, f) for f in t.__dataclass_fields__}, name
        assert (t.kv_heads, t.head_width) == (j.kv_heads, j.head_width)
    assert tmodels.GPT2Config.gpt2_medium() == tmodels.GPT2Config(
        **{f: getattr(jmodels.GPT2Config.gpt2_medium(), f)
           for f in jmodels.GPT2Config.__dataclass_fields__})
    assert set(tmodels.__all__) == set(jmodels.__all__) - {
        n for n in jmodels.__all__ if n.startswith("Blip")}


def test_torch_gpt2_refuses_positions_past_the_table():
    """128 learned positions: a 129-token sequence or cache raises (the JAX
    model's gather would clamp position 128 to 127)."""
    _, tm = family_pair("gpt2")
    with pytest.raises(ValueError, match="129 positions, past the model's"):
        tm(torch.ones(1, 129, dtype=torch.long))
    caches = tmodels.llama.init_caches(tm.config, 1, 129, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="129 positions"):
        tm(torch.ones(1, 4, dtype=torch.long), attention_mask=torch.ones(1, 129),
           caches=caches, cache_index=0)
