"""The port's HF checkpoint loader (``models/hf_convert.py``) on tiny HF-format
directories that ``transformers`` writes here (``save_pretrained``):
safetensors in float32 and bfloat16, and ``pytorch_model.bin``.

The port's safetensors reader equals the ``safetensors`` package's bit for
bit; a loaded model's logits match HF's and the JAX package's loader's on
the same directory within ``TOLERANCES["f32_logits"]`` (float32 sums in
another order through two layers), for Llama (untied and tied), Mistral
with a sliding window shorter than the sequence, and Qwen2 with its qkv
biases; the other families route to their loaders
(``test_torch_hf_convert_families.py``) and a model_type neither package
has is refused before any weight is read.  ``write_hf_llama`` serves the
harness tests too.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch
import transformers

from sparse_matrix_fine_tuning_torch.models import hf_convert
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES
from sparse_matrix_fine_tuning_tpu.models import hf_convert as jhf

LOGITS = TOLERANCES["f32_logits"]
TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=128, max_position_embeddings=128,
            attn_implementation="eager")


def write_hf_llama(path, *, dtype=torch.float32, safe: bool = True, family: str = "llama",
                   seed: int = 0, **overrides):
    """A random HF causal LM of ``family`` (``TINY`` widths, ``overrides``
    on top) saved into ``path`` in ``dtype``; returns the HF model (float32,
    eval mode).  Its biases and norm weights, which HF starts at 0 and 1,
    are drawn too, so that a loader that skips them shows."""
    cls = {"llama": (transformers.LlamaConfig, transformers.LlamaForCausalLM),
           "mistral": (transformers.MistralConfig, transformers.MistralForCausalLM),
           "qwen2": (transformers.Qwen2Config, transformers.Qwen2ForCausalLM)}[family]
    torch.manual_seed(seed)
    model = cls[1](cls[0](**{**TINY, **overrides})).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    model.to(dtype).save_pretrained(str(path), safe_serialization=safe)
    return model.float()


def ids(vocab: int = 256, shape=(2, 12), seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(2, vocab, size=shape)


def hf_logits(model, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return model(input_ids=torch.tensor(x)).logits.numpy()


def port_logits(model, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return model(torch.tensor(x)).float().numpy()


def jax_logits(path, x: np.ndarray) -> np.ndarray:
    model = jhf.from_pretrained_causal_lm(str(path), dtype="float32")
    model.eval()
    return np.asarray(model(jnp.asarray(x)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_safetensors_reader_matches_the_package(tmp_path, dtype):
    write_hf_llama(tmp_path, dtype=dtype)
    got = hf_convert.load_state_dict(str(tmp_path))
    want = safetensors.torch.load_file(str(tmp_path / "model.safetensors"))
    assert sorted(got) == sorted(want) and len(got) == 2 * 9 + 3
    for name, value in want.items():
        assert got[name].dtype == value.dtype == dtype, name
        assert torch.equal(got[name].view(torch.int16 if dtype == torch.bfloat16 else
                                          torch.int32),
                           value.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    single = hf_convert.load_state_dict(str(tmp_path / "model.safetensors"))
    assert all(torch.equal(single[k], got[k]) for k in got)


def test_torch_safetensors_reader_takes_an_unaligned_header(tmp_path):
    """A header whose length leaves the data off the elements' alignment
    (the format pads it to 8 bytes, a hand-written file may not): the
    reader copies such a tensor out and gives the same values."""
    tensors = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
               "b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
               "c": torch.arange(3, dtype=torch.int64), "empty": torch.zeros(0)}
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": {torch.float32: "F32", torch.bfloat16: "BF16",
                                  torch.int64: "I64"}[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode() + b" "
    assert (8 + len(raw)) % 4
    path = tmp_path / "x.safetensors"
    path.write_bytes(len(raw).to_bytes(8, "little") + raw
                     + b"".join(t.view(torch.uint8).numpy().tobytes() for t in tensors.values()))
    got = hf_convert.load_state_dict(str(path))
    assert sorted(got) == sorted(tensors)
    assert all(torch.equal(got[k], v) and got[k].dtype == v.dtype for k, v in tensors.items())
    assert all(torch.equal(got[k], v) for k, v in safetensors.torch.load_file(str(path)).items())


def test_torch_bin_checkpoint_loads_like_torch_load(tmp_path):
    hf = write_hf_llama(tmp_path, safe=False)
    assert not (tmp_path / "model.safetensors").exists()
    got = hf_convert.load_state_dict(str(tmp_path))
    want = torch.load(str(tmp_path / "pytorch_model.bin"), weights_only=True)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    model = hf_convert.from_pretrained_llama(str(tmp_path), dtype="float32", device="cpu")
    np.testing.assert_allclose(port_logits(model, ids()), hf_logits(hf, ids()), **LOGITS)


def test_torch_missing_checkpoint_names_its_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        hf_convert.load_state_dict(str(tmp_path))


@pytest.mark.parametrize("tied", [False, True])
def test_torch_llama_logits_match_hf_and_jax(tmp_path, tied):
    hf = write_hf_llama(tmp_path, tie_word_embeddings=tied)
    assert ("lm_head.weight" in safetensors.torch.load_file(
        str(tmp_path / "model.safetensors"))) is not tied
    model = hf_convert.from_pretrained_llama(str(tmp_path), dtype="float32", device="cpu")
    assert (model.lm_head is None) is tied
    x = ids()
    got = port_logits(model, x)
    np.testing.assert_allclose(got, hf_logits(hf, x), **LOGITS)
    np.testing.assert_allclose(got, jax_logits(tmp_path, x), **LOGITS)


@pytest.mark.parametrize("family,extra", [("mistral", {"sliding_window": 5}),
                                          ("qwen2", {})])
def test_torch_mistral_and_qwen2_match_hf_and_jax(tmp_path, family, extra):
    """Mistral's window (5) is shorter than the sequence (12), so its mask
    bites; Qwen2 carries q, k and v biases."""
    hf = write_hf_llama(tmp_path, family=family, **extra)
    model = hf_convert.from_pretrained_causal_lm(str(tmp_path), dtype="float32", device="cpu")
    cfg = model.config
    assert cfg.sliding_window == extra.get("sliding_window")
    assert cfg.attention_qkv_bias is (family == "qwen2")
    if family == "qwen2":
        bias = model.model.layers[1].self_attn.k_proj.bias
        assert torch.equal(bias, hf.model.layers[1].self_attn.k_proj.bias) and bias.abs().sum() > 0
    x = ids()
    got = port_logits(model, x)
    np.testing.assert_allclose(got, hf_logits(hf, x), **LOGITS)
    np.testing.assert_allclose(got, jax_logits(tmp_path, x), **LOGITS)


def test_torch_bf16_load_keeps_the_checkpoints_bits(tmp_path):
    """A bfloat16 checkpoint loads into bfloat16 parameters unchanged, with
    ``remat`` and ``remat_policy`` in the config."""
    write_hf_llama(tmp_path, dtype=torch.bfloat16)
    model = hf_convert.from_pretrained_llama(str(tmp_path), device="cpu", remat=True,
                                             remat_policy="dots")
    cfg = model.config
    assert (cfg.dtype, cfg.param_dtype, cfg.remat, cfg.remat_policy) == \
        ("bfloat16", "bfloat16", True, "dots")
    written = safetensors.torch.load_file(str(tmp_path / "model.safetensors"))
    params = dict(model.named_parameters())
    assert len(params) == len(written)
    for name, value in written.items():
        assert params[name].dtype == torch.bfloat16
        assert torch.equal(params[name].detach().view(torch.int16), value.view(torch.int16)), name


HF_CONFIGS = [
    {"model_type": "llama", "vocab_size": 32000, "hidden_size": 2048, "num_hidden_layers": 22,
     "num_attention_heads": 32, "num_key_value_heads": 4, "intermediate_size": 5632,
     "max_position_embeddings": 2048, "rope_theta": 10000.0, "pad_token_id": None,
     "tie_word_embeddings": False},
    {"model_type": "llama", "vocab_size": 100, "hidden_size": 64, "num_hidden_layers": 1,
     "num_attention_heads": 4, "intermediate_size": 96, "head_dim": 32, "rope_theta": 5e5,
     "rms_norm_eps": 1e-6, "pad_token_id": 7, "bos_token_id": 3, "eos_token_id": 4,
     "tie_word_embeddings": True},
    {"model_type": "mistral", "vocab_size": 100, "hidden_size": 64, "num_hidden_layers": 1,
     "num_attention_heads": 4, "num_key_value_heads": 1, "intermediate_size": 96,
     "sliding_window": 16},
    {"model_type": "qwen2", "vocab_size": 100, "hidden_size": 64, "num_hidden_layers": 1,
     "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 96,
     "use_sliding_window": True, "sliding_window": 8, "rope_theta": 1e6},
]


@pytest.mark.parametrize("hf", HF_CONFIGS, ids=["tinyllama", "tied", "mistral", "qwen2"])
def test_torch_config_from_hf_matches_jax(hf):
    """Every field the two ``LlamaConfig``s share maps alike: rope_theta,
    head_dim, the KV heads, a null pad id (0), the windows, the biases."""
    got = dataclasses.asdict(hf_convert.causal_lm_config_from_hf(hf, remat=True))
    want = dataclasses.asdict(jhf.causal_lm_config_from_hf(hf, remat=True))
    shared = set(got) & set(want)
    assert len(shared) >= 25
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}


@pytest.mark.parametrize("config", [
    {"model_type": "gemma"}, {"model_type": "gpt2"}, {"model_type": "gpt_neo"},
    {"model_type": "gpt_neox"},
    {"model_type": "gpt2", "architectures": ["BackpackGPT2LMHeadModel"]},
], ids=["gemma", "gpt2", "gpt_neo", "gpt_neox", "backpack"])
def test_torch_unported_families_refused_before_the_weights(tmp_path, config):
    """These five families are ported now (tests/test_torch_hf_convert_families.py):
    none is refused, each is routed to its loader, which builds the model
    and then reaches for the weights (the directory holds none:
    FileNotFoundError).  A model_type that neither package has is still
    refused before the weights."""
    tiny = dict(vocab_size=64, hidden_size=32, n_embd=32, num_hidden_layers=1, n_layer=1,
                num_layers=1, num_attention_heads=2, n_head=2, num_heads=2,
                intermediate_size=64, max_position_embeddings=16, n_positions=16)
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump({**tiny, **config}, f)
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        hf_convert.from_pretrained_causal_lm(str(tmp_path), device="cpu")
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump({**tiny, "model_type": "bert"}, f)
    with pytest.raises(ValueError, match="unsupported causal-LM model_type 'bert'"):
        hf_convert.from_pretrained_causal_lm(str(tmp_path), device="cpu")
