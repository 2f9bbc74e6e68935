"""The port's Llama with Monarch adapters on all seven projections, held
against the JAX model on the CPU in float32: prefill logits, one KV-cache
decode step, the surgery helpers and the gated activations.

The JAX model is ``LlamaConfig.tiny()`` (2 layers, hidden 64, GQA 4/2) with
``init_monarch``; its adapters get random nonzero values and every weight is
carried into the port by ``utils/jax_bridge.load_jax_state``.
Tolerances: model logits 1e-4 (TOLERANCES["f32_logits"]); ops 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM, init_caches
from sparse_matrix_fine_tuning_torch.ops import activations as tact
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam
from sparse_matrix_fine_tuning_tpu.models.llama import init_caches as jax_init_caches
from sparse_matrix_fine_tuning_tpu.ops import activations as jact

LOGITS = TOLERANCES["f32_logits"]
PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj"]}


def jax_llama(seed=0, **cfg):
    model = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(**cfg), rngs=nnx.Rngs(seed))
    jpeft.init_monarch(model, PEFT, rngs=nnx.Rngs(seed + 1))
    rng = np.random.default_rng(seed)
    for _, v in nnx.to_flat_state(nnx.state(model, AdapterParam)):
        v.set_value(jnp.array(rng.normal(0.0, 0.1, v[...].shape).astype(np.float32)))
    return model


def port_of(jax_model, **cfg):
    model = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    surgery.init_monarch(model, PEFT)
    flat = {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(nnx.state(jax_model, nnx.Param))}
    load_jax_state(model, flat)
    return model.eval()


@pytest.fixture(scope="module")
def pair():
    jm = jax_llama()
    return jm, port_of(jm)


def left_padded(seed=0, lens=(10, 6, 3)):
    rng = np.random.default_rng(seed)
    t = max(lens)
    ids = rng.integers(3, 256, (len(lens), t)).astype(np.int32)
    mask = np.zeros_like(ids)
    for row, n in enumerate(lens):
        mask[row, t - n:] = 1
    return ids * mask, mask


def test_torch_llama_prefill_logits_match_jax(pair):
    jm, tm = pair
    ids, mask = left_padded()
    want = np.asarray(jm(jnp.array(ids), attention_mask=jnp.array(mask)))
    with torch.no_grad():
        got = tm(to_torch(ids, torch.long), attention_mask=to_torch(mask, torch.long))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(got), want, **LOGITS)


def test_torch_llama_kv_cache_decode_step_matches_jax(pair):
    """Prefill into a preallocated cache, then one decode step."""
    jm, tm = pair
    ids, mask = left_padded(seed=1)
    b, t = ids.shape
    total = t + 4
    cfg = jm.config
    mask_full = np.concatenate([mask, np.zeros((b, total - t), mask.dtype)], -1)
    pos = np.maximum(np.cumsum(mask, -1) - 1, 0)
    step_ids = np.random.default_rng(2).integers(3, 256, (b, 1)).astype(np.int32)
    step_mask = mask_full.copy()
    step_mask[:, t] = 1
    step_pos = pos[:, -1:] + 1

    jc = jax_init_caches(cfg, b, total, jnp.float32)
    j1, jc = jm(jnp.array(ids), attention_mask=jnp.array(mask_full), positions=jnp.array(pos),
                caches=jc, cache_index=0)
    j2, jc = jm(jnp.array(step_ids), attention_mask=jnp.array(step_mask),
               positions=jnp.array(step_pos), caches=jc, cache_index=t)

    tc = init_caches(tm.config, b, total, torch.float32, device="cpu")
    with torch.no_grad():
        t1, tc = tm(to_torch(ids, torch.long), attention_mask=to_torch(mask_full, torch.long),
                    positions=to_torch(pos, torch.long), caches=tc, cache_index=0)
        t2, _ = tm(to_torch(step_ids, torch.long), attention_mask=to_torch(step_mask, torch.long),
                   positions=to_torch(step_pos, torch.long), caches=tc, cache_index=t)
    np.testing.assert_allclose(to_numpy(t1), np.asarray(j1), **LOGITS)
    np.testing.assert_allclose(to_numpy(t2), np.asarray(j2), **LOGITS)
    np.testing.assert_allclose(to_numpy(tc[0][0][:, :t + 1]), np.asarray(jc[0][0][:, :t + 1]),
                               **LOGITS)


@pytest.mark.parametrize("cfg", [
    {"tie_word_embeddings": True},
    {"attention_qkv_bias": True},
    {"sliding_window": 4},
    {"scale_embeddings": True, "mlp_activation": "gelu_tanh", "head_dim": 32},
], ids=["tied", "qkv_bias", "sliding_window", "scaled_geglu_headdim"])
def test_torch_llama_config_variants_match_jax(cfg):
    """The family knobs the decoder carries, prefill and one cached step."""
    jm = jax_llama(seed=4, **cfg)
    if cfg.get("attention_qkv_bias"):
        rng = np.random.default_rng(4)
        for _, v in nnx.to_flat_state(nnx.state(jm, nnx.Param)):
            if v[...].ndim == 1:  # the zero-init q/k/v biases, and the norm scales
                v.set_value(jnp.array(rng.normal(0.0, 0.1, v[...].shape).astype(np.float32)))
    tm = port_of(jm, **cfg)
    ids, mask = left_padded(seed=5, lens=(9, 7))
    b, t = ids.shape
    want = np.asarray(jm(jnp.array(ids), attention_mask=jnp.array(mask)))
    with torch.no_grad():
        got = tm(to_torch(ids, torch.long), attention_mask=to_torch(mask, torch.long))
    np.testing.assert_allclose(to_numpy(got), want, **LOGITS)

    mask_full = np.concatenate([mask, np.ones((b, 1), mask.dtype)], -1)
    pos = np.maximum(np.cumsum(mask, -1) - 1, 0)
    step = np.full((b, 1), 7, np.int32)
    jc = jax_init_caches(jm.config, b, t + 1, jnp.float32)
    _, jc = jm(jnp.array(ids), attention_mask=jnp.array(mask_full), positions=jnp.array(pos),
               caches=jc, cache_index=0)
    j2, _ = jm(jnp.array(step), attention_mask=jnp.array(mask_full),
               positions=jnp.array(pos[:, -1:] + 1), caches=jc, cache_index=t)
    tc = init_caches(tm.config, b, t + 1, torch.float32, device="cpu")
    with torch.no_grad():
        _, tc = tm(to_torch(ids, torch.long), attention_mask=to_torch(mask_full, torch.long),
                   positions=to_torch(pos, torch.long), caches=tc, cache_index=0)
        t2, _ = tm(to_torch(step, torch.long), attention_mask=to_torch(mask_full, torch.long),
                   positions=to_torch(pos[:, -1:] + 1, torch.long), caches=tc, cache_index=t)
    np.testing.assert_allclose(to_numpy(t2), np.asarray(j2), **LOGITS)


def test_torch_surgery_matches_jax():
    """init_monarch reports the same layers; param_stats, find_all_linear_names
    and merge/unmerge of all adapters agree with the JAX package."""
    jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(), rngs=nnx.Rngs(0))
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    assert surgery.find_all_linear_names(tm) == jpeft.find_all_linear_names(jm)
    assert surgery.init_monarch(tm, PEFT) == jpeft.init_monarch(jm, PEFT, rngs=nnx.Rngs(1))
    assert (surgery.param_stats(tm, verbose=False)
            == jpeft.param_stats(jm, verbose=False))

    jm = jax_llama(seed=3)
    tm = port_of(jm)
    ids, mask = left_padded(seed=3)
    assert surgery.merge_all_adapters(tm) == jpeft.merge_all_adapters(jm) == 14
    with torch.no_grad():
        got = tm(to_torch(ids, torch.long), attention_mask=to_torch(mask, torch.long))
    want = np.asarray(jm(jnp.array(ids), attention_mask=jnp.array(mask)))
    np.testing.assert_allclose(to_numpy(got), want, **LOGITS)
    assert surgery.unmerge_all_adapters(tm) == jpeft.unmerge_all_adapters(jm) == 14
    dense = tm.model.layers[1].mlp.down_proj.dense
    np.testing.assert_allclose(to_numpy(dense),
                               np.asarray(jm.model.layers[1].mlp.down_proj.dense[...]), **LOGITS)


@pytest.mark.parametrize("name", ["swiglu", "geglu"])
def test_torch_activations_match_jax(name):
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal((6, 32)).astype(np.float32) * 3 for _ in range(2))
    want = np.asarray(getattr(jact, name)(jnp.array(a), jnp.array(b)))
    got = getattr(tact, name)(to_torch(a), to_torch(b))
    np.testing.assert_allclose(to_numpy(got), want, **TOLERANCES["f32_op"])


def test_torch_llama_config_matches_jax():
    for preset in ("tiny", "llama2_7b", "mistral_7b", "gemma_2b", "qwen2_7b"):
        j, t = getattr(jmodels.LlamaConfig, preset)(), getattr(LlamaConfig, preset)()
        assert {f: getattr(j, f) for f in j.__dataclass_fields__} == {
            f: getattr(t, f) for f in t.__dataclass_fields__}
        assert (t.kv_heads, t.head_width) == (j.kv_heads, j.head_width)
    bf = LlamaConfig.tiny(dtype="bfloat16", param_dtype="bfloat16")
    assert (bf.compute_dtype, bf.params_dtype) == (torch.bfloat16, torch.bfloat16)
    assert LlamaConfig.tiny().compute_dtype is None
    assert LlamaConfig.tiny().params_dtype == torch.float32


@pytest.mark.parametrize("kw", [{"rmsnorm_unit_offset": True},
                                {"rmsnorm_unit_offset": True, "scale_embeddings": True,
                                 "mlp_activation": "gelu_tanh"}])
def test_torch_llama_refuses_unported_options(kw):
    """``UnitOffsetRMSNorm`` alone and with the rest of the Gemma preset's
    knobs; remat is ported (tests/test_torch_remat.py)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")


def test_torch_bridge_refuses_mismatch(pair):
    jm, _ = pair
    flat = {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(nnx.state(jm, nnx.Param))}
    fresh = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    surgery.init_monarch(fresh, PEFT)
    missing = dict(flat)
    missing.pop(("lm_head", "kernel"))
    with pytest.raises(KeyError, match="lm_head.weight"):
        load_jax_state(fresh, missing)
    with pytest.raises(KeyError, match="no port parameter"):
        load_jax_state(fresh, {**flat, ("model", "extra"): np.zeros(3)})
