"""The port's loaders for the other decoder families (``models/hf_convert``:
Gemma, GPT-2, GPT-Neo, GPT-NeoX, Backpack-GPT-2) on tiny HF-format
directories written here: ``transformers`` saves the first four (GPT-2's
projections in its ``Conv1D`` (in, out) layout); Backpack, which
``transformers`` lacks, is written from a port model in the reference's key
layout (``backpack.gpt2_model.*`` and ``backpack.sense_network.*`` Conv1D,
``backpack.sense_weight_net.c_attn`` an ``nn.Linear``).  Biases and norm
weights are drawn away from 0 and 1, so that a loader that skips one shows.

Held, float32: both packages' ``from_pretrained_causal_lm`` give the same
logits (``TOLERANCES["f32_logits"]``), and HF's own model the same where
``transformers`` has it; the routing picks each family's class (Backpack
by ``architectures``), GPT-2 loads with and without the ``transformer.``
prefix, a missing ``pad_token_id`` falls back to eos, and the GPT families
ignore the remat knobs as the JAX loader does.  (The harness tests write
their directories without ``transformers``:
``test_torch_run_alpaca_families.write_family_dir``.)
"""

import json
import os

import numpy as np
import pytest
import torch
import transformers

from sparse_matrix_fine_tuning_torch import models as tmodels
from sparse_matrix_fine_tuning_torch.models import hf_convert
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES
from test_torch_hf_convert import hf_logits, ids, jax_logits, port_logits

LOGITS = TOLERANCES["f32_logits"]
HF_TINY = {
    "gpt2": (transformers.GPT2Config, transformers.GPT2LMHeadModel,
             dict(n_embd=64, n_layer=2, n_head=4, n_positions=128)),
    "gpt_neo": (transformers.GPTNeoConfig, transformers.GPTNeoForCausalLM,
                dict(hidden_size=64, num_layers=2, num_heads=4, max_position_embeddings=128,
                     attention_types=[[["global", "local"], 1]], window_size=5)),
    "gpt_neox": (transformers.GPTNeoXConfig, transformers.GPTNeoXForCausalLM,
                 dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                      intermediate_size=128, max_position_embeddings=128, rotary_pct=0.25)),
    "gemma": (transformers.GemmaConfig, transformers.GemmaForCausalLM,
              dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=1, head_dim=32, intermediate_size=128,
                   max_position_embeddings=128)),
}
PORT_CLASS = {"gpt2": tmodels.GPT2LMHeadModel, "gpt_neo": tmodels.GPTNeoForCausalLM,
              "gpt_neox": tmodels.GPTNeoXForCausalLM, "gemma": tmodels.LlamaForCausalLM,
              "backpack": tmodels.BackpackGPT2LMHeadModel}


def _conv1d(name: str) -> bool:
    return name.endswith(".weight") and any(
        f".{m}." in name for m in ("c_attn", "c_proj", "c_fc")) and "sense_weight_net" not in name


def write_backpack(path, *, vocab_size: int = 256, dtype=torch.float32, seed: int = 0,
                   **overrides):
    """A tiny random Backpack-GPT-2 in the reference's checkpoint layout;
    returns the port model whose weights it holds (float32, eval mode)."""
    cfg = tmodels.BackpackGPT2Config.tiny(vocab_size=vocab_size, **overrides)
    model = tmodels.BackpackGPT2LMHeadModel(cfg, device="cpu",
                                            generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    tensors = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or ".ln" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
            tensors[name] = (p.T if _conv1d(name) else p).contiguous().to(dtype)
    os.makedirs(path, exist_ok=True)
    hf = {"model_type": "gpt2", "architectures": ["BackpackGPT2LMHeadModel"],
          "vocab_size": vocab_size, "n_embd": cfg.hidden_size, "n_layer": cfg.num_hidden_layers,
          "n_head": cfg.num_attention_heads, "n_positions": cfg.max_position_embeddings,
          "num_senses": cfg.num_senses, "sense_intermediate_scale": 4,
          "scale_attn_by_inverse_layer_idx": True, "bos_token_id": 50256 % vocab_size,
          "eos_token_id": 50256 % vocab_size}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    hf_convert.write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    return model.eval()


def write_hf_family(path, family: str, *, vocab_size: int = 256, dtype=torch.float32,
                    seed: int = 0, **overrides):
    """A random tiny HF causal LM of ``family`` saved into ``path`` in
    ``dtype`` (``transformers``, or ``write_backpack``); returns the model,
    float32, eval mode (HF's, or the port's for Backpack)."""
    if family == "backpack":
        return write_backpack(path, vocab_size=vocab_size, dtype=dtype, seed=seed, **overrides)
    cfg_cls, cls, tiny = HF_TINY[family]
    torch.manual_seed(seed)
    eos = {} if family in ("gemma", "gpt_neox") else dict(bos_token_id=vocab_size - 1,
                                                          eos_token_id=vocab_size - 1)
    model = cls(cfg_cls(**{**tiny, "vocab_size": vocab_size, **eos, **overrides},
                        attn_implementation="eager")).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "norm" in name or ".ln_" in name:
                p.add_(0.1 * torch.randn_like(p))
    model.to(dtype).save_pretrained(str(path))
    return model.float()


@pytest.mark.parametrize("family", ["gpt2", "gpt_neo", "gpt_neox", "gemma", "backpack"])
def test_torch_families_load_as_jax_and_hf(tmp_path, family):
    ref = write_hf_family(tmp_path, family)
    x = ids(256)
    model = hf_convert.from_pretrained_causal_lm(str(tmp_path), dtype="float32", device="cpu")
    assert type(model) is PORT_CLASS[family]
    got = port_logits(model, x)
    np.testing.assert_allclose(got, jax_logits(tmp_path, x), **LOGITS)
    want = port_logits(ref, x) if family == "backpack" else hf_logits(ref, x)
    np.testing.assert_allclose(got, want, **LOGITS)


def test_torch_gpt2_loads_without_prefix_and_pads_with_eos(tmp_path):
    ref = write_hf_family(tmp_path, "gpt2")
    sd = hf_convert.load_state_dict(str(tmp_path))
    assert any(k.startswith("transformer.") for k in sd)
    bare = {k.removeprefix("transformer."): v for k, v in sd.items()}
    with open(tmp_path / "config.json") as f:
        hf = json.load(f)
    hf.pop("pad_token_id", None)
    cfg = hf_convert.gpt2_config_from_hf(hf)
    assert cfg.pad_token_id == cfg.eos_token_id == 255
    model = tmodels.GPT2LMHeadModel(cfg, device="cpu")
    hf_convert.load_gpt2(model, bare)
    np.testing.assert_allclose(port_logits(model, ids(256)), hf_logits(ref, ids(256)), **LOGITS)


@pytest.mark.parametrize("family", ["gpt2", "gpt_neox"])
def test_torch_gpt_families_ignore_remat(tmp_path, family):
    write_hf_family(tmp_path, family)
    model = hf_convert.from_pretrained_causal_lm(str(tmp_path), device="cpu", remat=True,
                                                 remat_policy="dots", param_dtype="bfloat16")
    assert not hasattr(model.config, "remat")
    assert model.config.dtype == "bfloat16"
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_torch_gemma_config_from_hf(tmp_path):
    write_hf_family(tmp_path, "gemma")
    with open(tmp_path / "config.json") as f:
        hf = json.load(f)
    cfg = hf_convert.causal_lm_config_from_hf(hf)
    assert (cfg.mlp_activation, cfg.rmsnorm_unit_offset, cfg.scale_embeddings,
            cfg.tie_word_embeddings, cfg.head_width, cfg.kv_heads) == (
        "gelu_tanh", True, True, True, 32, 1)
    with pytest.raises(ValueError, match="unsupported causal-LM model_type 'bert'"):
        hf_convert.causal_lm_config_from_hf({**hf, "model_type": "bert"})
