"""Load HF-format checkpoints into the port's models: ``LlamaForCausalLM``,
``RobertaForSequenceClassification`` and ``DebertaV2ForSequenceClassification``.

Counterpart of ``sparse_matrix_fine_tuning_tpu/models/hf_convert.py``'s
loaders (``load_state_dict`` :32, ``load_roberta`` :70,
``causal_lm_config_from_hf`` :95, ``load_llama`` :141,
``from_pretrained_roberta`` :163, ``from_pretrained_llama`` :186,
``load_deberta`` :207, ``from_pretrained_deberta`` :233,
``from_pretrained_causal_lm`` :394).  A checkpoint directory holds
``config.json`` and one ``model.safetensors`` or ``pytorch_model.bin``, as
in the JAX package: sharded checkpoints do not load.

``load_state_dict`` reads safetensors itself (an 8-byte little-endian
header length, a JSON header, then the raw bytes), through a copy-on-write
``mmap`` and ``torch.frombuffer``, so that a tensor is read from the page
cache once, in its stored dtype, when it is copied into the model: no
``safetensors`` package and no float32 copy of a bfloat16 checkpoint.
``pytorch_model.bin`` goes through ``torch.load(weights_only=True,
mmap=True)``.

HF stores a linear's weight (out, in), as ``nn.Linear`` does, so nothing is
transposed (the JAX loader transposes into flax's (in, out)).  Llama, Mistral
(``sliding_window``) and Qwen2 (qkv biases) load; Gemma, gpt2, gpt_neo,
gpt_neox and Backpack checkpoints are refused before any weight is read
(ROADMAP.md queue A item 25).  RoBERTa and DeBERTa-v2/v3 encoders load into
the GLUE classifiers (float32 parameters, ``dtype`` the compute dtype); a
checkpoint without the classification head keeps the head drawn from the
caller's generator, as the JAX loaders keep theirs.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Optional

import torch

from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig, RobertaConfig
from sparse_matrix_fine_tuning_torch.models.deberta import (
    DebertaV2Config,
    DebertaV2ForSequenceClassification,
)
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification

# safetensors' dtype names (safetensors/src/tensor.rs) -> torch dtypes
_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
              "F64": torch.float64, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_LLAMA_TYPES = ("llama", "mistral", "qwen2")
_REFUSED_TYPES = ("gemma", "gpt2", "gpt_neo", "gpt_neox")
_FAMILIES_ITEM = "ROADMAP.md queue A item 25, 'Other model families'"


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of one ``.safetensors`` file, on the CPU, in their stored
    dtypes, backed by a copy-on-write map of the file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    start = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                             f"not one of {sorted(_ST_DTYPES)}")
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = info["shape"]
        size = dtype.itemsize
        count = (end - begin) // size
        offset = start + begin
        if not count:
            t = torch.empty(0, dtype=dtype)
        elif offset % size:  # frombuffer needs an aligned start: copy this one
            t = torch.frombuffer(bytearray(buf[offset:start + end]), dtype=dtype, count=count)
        else:
            t = torch.frombuffer(buf, dtype=dtype, count=count, offset=offset)
        out[name] = t.reshape(shape)
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """One ``.safetensors`` file: an 8-byte little-endian header length, the
    JSON header padded to 8 bytes, then each tensor's bytes in order."""
    names = {v: k for k, v in _ST_DTYPES.items()}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tofile(f)


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from an HF checkpoint directory or a single
    ``.safetensors`` / ``.bin`` / ``.pt`` file, on the CPU."""
    if os.path.isfile(path):
        if path.endswith(".safetensors"):
            return read_safetensors(path)
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(st_path):
        return read_safetensors(st_path)
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True, mmap=True)
    raise FileNotFoundError(f"no checkpoint found under {path} (model.safetensors or "
                            "pytorch_model.bin; sharded checkpoints do not load)")


def causal_lm_config_from_hf(hf: Dict, **overrides) -> LlamaConfig:
    """Map an HF ``config.json`` dict of a Llama, Mistral or Qwen2 checkpoint
    onto a ``LlamaConfig`` (the JAX function's fields and defaults)."""
    mt = hf.get("model_type", "llama")
    if mt in _REFUSED_TYPES:
        raise NotImplementedError(f"causal-LM model_type {mt!r}: {_FAMILIES_ITEM}")
    if mt not in _LLAMA_TYPES:
        raise ValueError(f"unsupported causal-LM model_type {mt!r} (llama | mistral | qwen2)")
    kw = dict(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get("num_key_value_heads"),
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        head_dim=hf.get("head_dim"),
        pad_token_id=hf.get("pad_token_id") or 0,
        bos_token_id=hf.get("bos_token_id", 1),
        eos_token_id=hf.get("eos_token_id", 2),
    )
    if mt == "mistral":
        kw["sliding_window"] = hf.get("sliding_window")
    elif mt == "qwen2":
        kw["attention_qkv_bias"] = True
        if hf.get("use_sliding_window"):
            kw["sliding_window"] = hf.get("sliding_window")
    kw.update(overrides)
    return LlamaConfig(**kw)


@torch.no_grad()
def _copy(param: torch.Tensor, sd: Dict[str, torch.Tensor], key: str) -> None:
    src = sd[key]
    if tuple(src.shape) != tuple(param.shape):
        raise ValueError(f"{key}: checkpoint shape {tuple(src.shape)}, model "
                         f"{tuple(param.shape)}")
    param.copy_(src)


def load_llama(model: LlamaForCausalLM, state_dict: Dict[str, torch.Tensor]) -> None:
    """Populate a ``LlamaForCausalLM`` from an HF Llama-family state dict, in
    place, each tensor cast to its parameter's dtype and device as it is
    copied.  qkv biases are set where the model has them; a tied checkpoint
    lacks ``lm_head.weight``, and a model with an ``lm_head`` then keeps its
    own, as in the JAX loader."""
    sd = state_dict
    _copy(model.model.embed_tokens.weight, sd, "model.embed_tokens.weight")
    for i, layer in enumerate(model.model.layers):
        p = f"model.layers.{i}"
        attn, mlp = layer.self_attn, layer.mlp
        for name, mod in (("self_attn.q_proj", attn.q_proj), ("self_attn.k_proj", attn.k_proj),
                          ("self_attn.v_proj", attn.v_proj), ("self_attn.o_proj", attn.o_proj),
                          ("mlp.gate_proj", mlp.gate_proj), ("mlp.up_proj", mlp.up_proj),
                          ("mlp.down_proj", mlp.down_proj)):
            _copy(mod.weight, sd, f"{p}.{name}.weight")
            if mod.bias is not None and f"{p}.{name}.bias" in sd:
                _copy(mod.bias, sd, f"{p}.{name}.bias")
        _copy(layer.input_layernorm.weight, sd, f"{p}.input_layernorm.weight")
        _copy(layer.post_attention_layernorm.weight, sd, f"{p}.post_attention_layernorm.weight")
    _copy(model.model.norm.weight, sd, "model.norm.weight")
    if model.lm_head is not None and "lm_head.weight" in sd:
        _copy(model.lm_head.weight, sd, "lm_head.weight")


def _read_config(path: str) -> Dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def from_pretrained_llama(path: str, dtype: Optional[str] = "bfloat16", *, device=None,
                          remat: bool = False, param_dtype: Optional[str] = None,
                          remat_policy: str = "nothing") -> LlamaForCausalLM:
    """Build a ``LlamaForCausalLM`` from the local HF directory ``path`` on
    ``device`` (the card when None) and load its weights.  ``dtype`` is the
    compute dtype, ``param_dtype`` the base's storage dtype (``dtype`` when
    None); ``remat`` and ``remat_policy`` as in ``LlamaConfig`` ("nothing"
    or "dots").  Attention stays "einsum", as in the JAX loader."""
    cfg = causal_lm_config_from_hf(_read_config(path), remat=remat, remat_policy=remat_policy,
                                   param_dtype=param_dtype or dtype, dtype=dtype)
    model = LlamaForCausalLM(cfg, device=device)
    load_llama(model, load_state_dict(path))
    return model


def from_pretrained_causal_lm(path: str, dtype: Optional[str] = "bfloat16", *, device=None,
                              remat: bool = False, remat_policy: str = "nothing",
                              param_dtype: Optional[str] = None) -> LlamaForCausalLM:
    """The harnesses' loader for ``--model <dir>``, routed by the
    checkpoint's ``model_type``: llama, mistral and qwen2 through
    ``from_pretrained_llama``.  Gemma, gpt2, gpt_neo, gpt_neox and Backpack
    (whose configs keep ``model_type`` "gpt2" and name it in
    ``architectures``) are refused before any weight is read."""
    hf = _read_config(path)
    if any("Backpack" in a for a in hf.get("architectures") or []):
        raise NotImplementedError(f"Backpack-GPT-2 checkpoint: {_FAMILIES_ITEM}")
    causal_lm_config_from_hf(hf)  # an unported family raises here, before the weights
    return from_pretrained_llama(path, dtype=dtype, device=device, remat=remat,
                                 remat_policy=remat_policy, param_dtype=param_dtype)


def _copy_linear(mod, sd: Dict[str, torch.Tensor], prefix: str) -> None:
    """weight (out, in) and, where both have one, bias."""
    _copy(mod.weight, sd, f"{prefix}.weight")
    if mod.bias is not None and f"{prefix}.bias" in sd:
        _copy(mod.bias, sd, f"{prefix}.bias")


def _copy_norm(mod, sd: Dict[str, torch.Tensor], prefix: str) -> None:
    _copy(mod.weight, sd, f"{prefix}.weight")
    if f"{prefix}.bias" in sd:
        _copy(mod.bias, sd, f"{prefix}.bias")


def load_roberta(model, state_dict: Dict[str, torch.Tensor]) -> None:
    """Populate a ``RobertaForSequenceClassification`` (or its ``.roberta``)
    from an HF ``roberta-*`` state dict, with or without the "roberta."
    prefix, in place; the classification head where the checkpoint has one."""
    sd = {k.removeprefix("roberta."): v for k, v in state_dict.items()}
    rob = model.roberta if hasattr(model, "roberta") else model
    emb = rob.embeddings
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        _copy(getattr(emb, name).weight, sd, f"embeddings.{name}.weight")
    _copy_norm(emb.LayerNorm, sd, "embeddings.LayerNorm")
    for i, layer in enumerate(rob.layer):
        p = f"encoder.layer.{i}"
        attn = layer.attention
        for name, mod in (("attention.self.query", attn.self.query),
                          ("attention.self.key", attn.self.key),
                          ("attention.self.value", attn.self.value),
                          ("attention.output.dense", attn.output.dense),
                          ("intermediate.dense", layer.intermediate.dense),
                          ("output.dense", layer.output.dense)):
            _copy_linear(mod, sd, f"{p}.{name}")
        _copy_norm(attn.output.LayerNorm, sd, f"{p}.attention.output.LayerNorm")
        _copy_norm(layer.output.LayerNorm, sd, f"{p}.output.LayerNorm")
    if hasattr(model, "classifier") and "classifier.dense.weight" in state_dict:
        _copy_linear(model.classifier.dense, state_dict, "classifier.dense")
        _copy_linear(model.classifier.out_proj, state_dict, "classifier.out_proj")


def load_deberta(model, state_dict: Dict[str, torch.Tensor]) -> None:
    """Populate a ``DebertaV2ForSequenceClassification`` from an HF
    ``deberta-v2/v3`` state dict, in place; the pooler and classifier where
    the checkpoint has them."""
    sd = state_dict
    deb = model.deberta if hasattr(model, "deberta") else model
    _copy(deb.word_embeddings.weight, sd, "deberta.embeddings.word_embeddings.weight")
    _copy_norm(deb.emb_LayerNorm, sd, "deberta.embeddings.LayerNorm")
    if deb.rel_embeddings is not None:
        _copy(deb.rel_embeddings.weight, sd, "deberta.encoder.rel_embeddings.weight")
    if deb.rel_LayerNorm is not None:
        _copy_norm(deb.rel_LayerNorm, sd, "deberta.encoder.LayerNorm")
    for i, layer in enumerate(deb.layer):
        p = f"deberta.encoder.layer.{i}"
        attn = layer.attention_self
        for name, mod in (("attention.self.query_proj", attn.query_proj),
                          ("attention.self.key_proj", attn.key_proj),
                          ("attention.self.value_proj", attn.value_proj),
                          ("attention.output.dense", layer.attention_output.dense),
                          ("intermediate.dense", layer.intermediate),
                          ("output.dense", layer.output_dense)):
            _copy_linear(mod, sd, f"{p}.{name}")
        _copy_norm(layer.attention_output.LayerNorm, sd, f"{p}.attention.output.LayerNorm")
        _copy_norm(layer.output_LayerNorm, sd, f"{p}.output.LayerNorm")
    if hasattr(model, "pooler") and "pooler.dense.weight" in sd:
        _copy_linear(model.pooler, sd, "pooler.dense")
        _copy_linear(model.classifier, sd, "classifier")


def roberta_config_from_hf(hf: Dict, **overrides) -> RobertaConfig:
    kw = dict(vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
              num_hidden_layers=hf["num_hidden_layers"],
              num_attention_heads=hf["num_attention_heads"],
              intermediate_size=hf["intermediate_size"],
              max_position_embeddings=hf["max_position_embeddings"],
              type_vocab_size=hf.get("type_vocab_size", 1),
              layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
              pad_token_id=hf.get("pad_token_id", 1))
    kw.update(overrides)
    return RobertaConfig(**kw)


def deberta_config_from_hf(hf: Dict, **overrides) -> DebertaV2Config:
    kw = dict(vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
              num_hidden_layers=hf["num_hidden_layers"],
              num_attention_heads=hf["num_attention_heads"],
              intermediate_size=hf["intermediate_size"],
              max_position_embeddings=hf["max_position_embeddings"],
              type_vocab_size=hf.get("type_vocab_size", 0),
              layer_norm_eps=hf.get("layer_norm_eps", 1e-7),
              pad_token_id=hf.get("pad_token_id", 0),
              relative_attention=hf.get("relative_attention", True),
              position_buckets=hf.get("position_buckets", 256),
              max_relative_positions=hf.get("max_relative_positions", -1),
              pos_att_type=tuple(hf.get("pos_att_type", ["p2c", "c2p"])),
              share_att_key=hf.get("share_att_key", True),
              norm_rel_ebd=hf.get("norm_rel_ebd", "layer_norm"),
              position_biased_input=hf.get("position_biased_input", False))
    kw.update(overrides)
    return DebertaV2Config(**kw)


def from_pretrained_roberta(path: str, num_labels: int = 2, dtype: Optional[str] = None, *,
                            device=None, generator: Optional[torch.Generator] = None
                            ) -> RobertaForSequenceClassification:
    """Build a ``RobertaForSequenceClassification`` from the local HF
    directory ``path`` on ``device`` (the card when None) and load its
    weights; a head the checkpoint lacks keeps its random init from
    ``generator``.  ``dtype``: the compute dtype (parameters stay float32)."""
    cfg = roberta_config_from_hf(_read_config(path), num_labels=num_labels, dtype=dtype)
    model = RobertaForSequenceClassification(cfg, device=device, generator=generator)
    load_roberta(model, load_state_dict(path))
    return model


def from_pretrained_deberta(path: str, num_labels: int = 2, dtype: Optional[str] = None, *,
                            device=None, generator: Optional[torch.Generator] = None
                            ) -> DebertaV2ForSequenceClassification:
    """``from_pretrained_roberta`` for a DeBERTa-v2/v3 directory."""
    cfg = deberta_config_from_hf(_read_config(path), num_labels=num_labels, dtype=dtype)
    model = DebertaV2ForSequenceClassification(cfg, device=device, generator=generator)
    load_deberta(model, load_state_dict(path))
    return model
