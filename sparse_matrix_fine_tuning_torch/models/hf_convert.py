"""Load HF-format checkpoints into the port's models: the causal LMs
(``LlamaForCausalLM``, ``GPT2LMHeadModel``, ``GPTNeoForCausalLM``,
``GPTNeoXForCausalLM``, ``BackpackGPT2LMHeadModel``),
``RobertaForSequenceClassification`` and ``DebertaV2ForSequenceClassification``.

Counterpart of ``sparse_matrix_fine_tuning_tpu/models/hf_convert.py``'s
loaders (``load_state_dict`` :32, ``load_roberta`` :70,
``causal_lm_config_from_hf`` :95, ``load_llama`` :141,
``from_pretrained_roberta`` :163, ``from_pretrained_llama`` :186,
``load_deberta`` :207, ``from_pretrained_deberta`` :233, the GPT-2,
Backpack, GPT-NeoX and GPT-Neo loaders :262-538 and
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
transposed (the JAX loader transposes into flax's (in, out)), except GPT-2's
``Conv1D``, which stores (in, out): GPT-2's and Backpack's projections are
transposed here, where the JAX loader copies them as they are (Backpack's
``sense_weight_net.c_attn`` is an ``nn.Linear``).  Llama, Mistral
(``sliding_window``), Qwen2 (qkv biases) and Gemma (unit-offset norms,
scaled embeddings, GeGLU, tied head) load into ``LlamaForCausalLM`` with
``param_dtype`` the compute dtype; gpt2, gpt_neo, gpt_neox and Backpack
(``model_type`` "gpt2", told apart by ``architectures``) into their own
models with float32 parameters and ``dtype`` the compute dtype, as the JAX
loaders build them; the ``transformer.`` prefix of a GPT-2 state dict is
optional and a missing ``pad_token_id`` falls back to eos.  RoBERTa and
DeBERTa-v2/v3 encoders load into the GLUE classifiers (float32 parameters, ``dtype`` the compute dtype); a
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

from sparse_matrix_fine_tuning_torch.models.backpack_gpt2 import (
    BackpackGPT2Config,
    BackpackGPT2LMHeadModel,
)
from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig, RobertaConfig
from sparse_matrix_fine_tuning_torch.models.deberta import (
    DebertaV2Config,
    DebertaV2ForSequenceClassification,
)
from sparse_matrix_fine_tuning_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from sparse_matrix_fine_tuning_torch.models.gpt_neo import GPTNeoConfig, GPTNeoForCausalLM
from sparse_matrix_fine_tuning_torch.models.gpt_neox import GPTNeoXConfig, GPTNeoXForCausalLM
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification

# safetensors' dtype names (safetensors/src/tensor.rs) -> torch dtypes
_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
              "F64": torch.float64, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_LLAMA_TYPES = ("llama", "mistral", "gemma", "qwen2")


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
    """Map an HF ``config.json`` dict of a Llama, Mistral, Gemma or Qwen2
    checkpoint onto a ``LlamaConfig`` (the JAX function's fields and
    defaults)."""
    mt = hf.get("model_type", "llama")
    if mt not in _LLAMA_TYPES:
        raise ValueError(f"unsupported causal-LM model_type {mt!r} "
                         "(llama | mistral | gemma | qwen2)")
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
    elif mt == "gemma":
        # HF GemmaMLP takes the tanh GELU whatever the legacy "gelu" string
        kw.update(mlp_activation="gelu_tanh", rmsnorm_unit_offset=True, scale_embeddings=True,
                  tie_word_embeddings=hf.get("tie_word_embeddings", True))
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
                              param_dtype: Optional[str] = None):
    """The harnesses' loader for ``--model <dir>``, routed as the JAX one:
    Backpack by ``architectures`` (its ``model_type`` is "gpt2"), then
    gpt2, gpt_neox and gpt_neo by ``model_type``, everything else through
    ``from_pretrained_llama``.  The GPT families ignore ``remat``,
    ``remat_policy`` and ``param_dtype``, as the JAX loader does."""
    hf = _read_config(path)
    if any("Backpack" in a for a in hf.get("architectures") or []):
        return from_pretrained_backpack_gpt2(path, dtype=dtype, device=device)
    family = {"gpt2": from_pretrained_gpt2, "gpt_neox": from_pretrained_gpt_neox,
              "gpt_neo": from_pretrained_gpt_neo}.get(hf.get("model_type"))
    if family is not None:
        return family(path, dtype=dtype, device=device)
    return from_pretrained_llama(path, dtype=dtype, device=device, remat=remat,
                                 remat_policy=remat_policy, param_dtype=param_dtype)


@torch.no_grad()
def _copy_conv1d(mod, sd: Dict[str, torch.Tensor], prefix: str) -> None:
    """An HF ``Conv1D``: its (in, out) weight transposed into the linear's
    (out, in), and its bias."""
    _copy(mod.weight, {prefix: sd[f"{prefix}.weight"].T}, prefix)
    if mod.bias is not None and f"{prefix}.bias" in sd:
        _copy(mod.bias, sd, f"{prefix}.bias")


def _gpt2_kw(hf: Dict) -> dict:
    kw = dict(vocab_size=hf["vocab_size"],
              hidden_size=hf.get("n_embd", hf.get("hidden_size", 768)),
              num_hidden_layers=hf.get("n_layer", hf.get("num_hidden_layers", 12)),
              num_attention_heads=hf.get("n_head", hf.get("num_attention_heads", 12)),
              intermediate_size=hf.get("n_inner"),
              max_position_embeddings=hf.get("n_positions",
                                             hf.get("max_position_embeddings", 1024)),
              layer_norm_eps=hf.get("layer_norm_epsilon", 1e-5),
              bos_token_id=hf.get("bos_token_id", 50256),
              eos_token_id=hf.get("eos_token_id", 50256),
              scale_attn_by_inverse_layer_idx=hf.get("scale_attn_by_inverse_layer_idx", False))
    kw["pad_token_id"] = hf.get("pad_token_id") or kw["eos_token_id"]
    return kw


def gpt2_config_from_hf(hf: Dict, **overrides) -> GPT2Config:
    """An HF GPT-2 ``config.json`` (n_embd / n_layer / n_head / n_positions)
    as a ``GPT2Config``."""
    return GPT2Config(**{**_gpt2_kw(hf), **overrides})


def _load_gpt2_body(tr, sd: Dict[str, torch.Tensor], pfx: str) -> None:
    """A ``GPT2Model``'s tensors under ``pfx``; its projections are Conv1D."""
    _copy(tr.wte.weight, sd, f"{pfx}wte.weight")
    _copy(tr.wpe.weight, sd, f"{pfx}wpe.weight")
    for i, blk in enumerate(tr.h):
        p = f"{pfx}h.{i}"
        _copy_norm(blk.ln_1, sd, f"{p}.ln_1")
        _copy_norm(blk.ln_2, sd, f"{p}.ln_2")
        for name, mod in (("attn.c_attn", blk.attn.c_attn), ("attn.c_proj", blk.attn.c_proj),
                          ("mlp.c_fc", blk.mlp.c_fc), ("mlp.c_proj", blk.mlp.c_proj)):
            _copy_conv1d(mod, sd, f"{p}.{name}")
    _copy_norm(tr.ln_f, sd, f"{pfx}ln_f")


def load_gpt2(model: GPT2LMHeadModel, state_dict: Dict[str, torch.Tensor]) -> None:
    """Populate a ``GPT2LMHeadModel`` from an HF ``gpt2`` state dict, with or
    without the ``transformer.`` prefix; the tied ``lm_head`` is not read."""
    pfx = "transformer." if any(k.startswith("transformer.") for k in state_dict) else ""
    _load_gpt2_body(model.transformer, state_dict, pfx)


def from_pretrained_gpt2(path: str, dtype: Optional[str] = None, *, device=None
                         ) -> GPT2LMHeadModel:
    """Build a ``GPT2LMHeadModel`` from the local HF directory ``path`` on
    ``device`` (the card when None) and load its weights; ``dtype`` the
    compute dtype, parameters float32."""
    model = GPT2LMHeadModel(gpt2_config_from_hf(_read_config(path), dtype=dtype), device=device)
    load_gpt2(model, load_state_dict(path))
    return model


def backpack_gpt2_config_from_hf(hf: Dict, **overrides) -> BackpackGPT2Config:
    """A Backpack-GPT-2 ``config.json`` (GPT-2's names, ``num_senses``,
    ``sense_intermediate_scale``) as a ``BackpackGPT2Config``;
    ``scale_attn_by_inverse_layer_idx`` defaults on."""
    kw = dict(_gpt2_kw(hf), num_senses=hf.get("num_senses", 16),
              sense_intermediate_scale=hf.get("sense_intermediate_scale", 4),
              scale_attn_by_inverse_layer_idx=hf.get("scale_attn_by_inverse_layer_idx", True))
    return BackpackGPT2Config(**{**kw, **overrides})


def load_backpack_gpt2(model: BackpackGPT2LMHeadModel,
                       state_dict: Dict[str, torch.Tensor]) -> None:
    """Populate a ``BackpackGPT2LMHeadModel`` from the reference Backpack
    state dict: ``backpack.gpt2_model.*`` (GPT-2, Conv1D),
    ``backpack.sense_network.*`` (Conv1D) and
    ``backpack.sense_weight_net.c_attn`` (an ``nn.Linear``: not
    transposed); the tied aliases of ``wte`` are not read."""
    sd, bp = state_dict, model.backpack
    _load_gpt2_body(bp.gpt2_model, sd, "backpack.gpt2_model.")
    sn, p = bp.sense_network, "backpack.sense_network"
    _copy_norm(sn.ln, sd, f"{p}.ln")
    _copy_norm(sn.block.ln_1, sd, f"{p}.block.ln_1")
    _copy_norm(sn.block.ln_2, sd, f"{p}.block.ln_2")
    for name, mod in (("block.mlp.c_fc", sn.block.mlp.c_fc),
                      ("block.mlp.c_proj", sn.block.mlp.c_proj),
                      ("final_mlp.c_fc", sn.final_mlp.c_fc),
                      ("final_mlp.c_proj", sn.final_mlp.c_proj)):
        _copy_conv1d(mod, sd, f"{p}.{name}")
    _copy_linear(bp.sense_weight_net.c_attn, sd, "backpack.sense_weight_net.c_attn")


def from_pretrained_backpack_gpt2(path: str, dtype: Optional[str] = None, *, device=None
                                  ) -> BackpackGPT2LMHeadModel:
    """``from_pretrained_gpt2`` for a Backpack-GPT-2 directory."""
    cfg = backpack_gpt2_config_from_hf(_read_config(path), dtype=dtype)
    model = BackpackGPT2LMHeadModel(cfg, device=device)
    load_backpack_gpt2(model, load_state_dict(path))
    return model


def gpt_neox_config_from_hf(hf: Dict, **overrides) -> GPTNeoXConfig:
    """An HF GPT-NeoX / Pythia ``config.json`` as a ``GPTNeoXConfig``."""
    kw = dict(vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
              num_hidden_layers=hf["num_hidden_layers"],
              num_attention_heads=hf["num_attention_heads"],
              intermediate_size=hf["intermediate_size"],
              max_position_embeddings=hf.get("max_position_embeddings", 2048),
              layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
              rotary_pct=hf.get("rotary_pct", 0.25),
              rope_theta=hf.get("rotary_emb_base", hf.get("rope_theta", 10000.0)),
              use_parallel_residual=hf.get("use_parallel_residual", True),
              hidden_act=hf.get("hidden_act", "gelu"),
              bos_token_id=hf.get("bos_token_id", 0), eos_token_id=hf.get("eos_token_id", 0),
              tie_word_embeddings=hf.get("tie_word_embeddings", False))
    kw["pad_token_id"] = hf.get("pad_token_id") or kw["eos_token_id"]
    return GPTNeoXConfig(**{**kw, **overrides})


def load_gpt_neox(model: GPTNeoXForCausalLM, state_dict: Dict[str, torch.Tensor]) -> None:
    """Populate a ``GPTNeoXForCausalLM`` from an HF ``gpt_neox`` state dict
    (its rotary and mask buffers are derived, not read)."""
    sd, nx = state_dict, model.gpt_neox
    _copy(nx.embed_in.weight, sd, "gpt_neox.embed_in.weight")
    for i, layer in enumerate(nx.layers):
        p = f"gpt_neox.layers.{i}"
        _copy_norm(layer.input_layernorm, sd, f"{p}.input_layernorm")
        _copy_norm(layer.post_attention_layernorm, sd, f"{p}.post_attention_layernorm")
        for name, mod in (("attention.query_key_value", layer.attention.query_key_value),
                          ("attention.dense", layer.attention.dense),
                          ("mlp.dense_h_to_4h", layer.mlp.dense_h_to_4h),
                          ("mlp.dense_4h_to_h", layer.mlp.dense_4h_to_h)):
            _copy_linear(mod, sd, f"{p}.{name}")
    _copy_norm(nx.final_layer_norm, sd, "gpt_neox.final_layer_norm")
    _copy_linear(model.embed_out, sd, "embed_out")


def from_pretrained_gpt_neox(path: str, dtype: Optional[str] = None, *, device=None
                             ) -> GPTNeoXForCausalLM:
    """``from_pretrained_gpt2`` for a GPT-NeoX / Pythia directory."""
    model = GPTNeoXForCausalLM(gpt_neox_config_from_hf(_read_config(path), dtype=dtype),
                               device=device)
    load_gpt_neox(model, load_state_dict(path))
    return model


def gpt_neo_config_from_hf(hf: Dict, **overrides) -> GPTNeoConfig:
    """An HF GPT-Neo ``config.json`` (num_layers / num_heads, nested
    ``attention_types``) as a ``GPTNeoConfig``."""
    layers = hf.get("attention_layers")
    if layers is None and hf.get("attention_types"):
        layers = [kind for kinds, n in hf["attention_types"] for _ in range(n) for kind in kinds]
    kw = dict(vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
              num_hidden_layers=hf.get("num_layers", hf.get("num_hidden_layers", 24)),
              num_attention_heads=hf.get("num_heads", hf.get("num_attention_heads", 16)),
              intermediate_size=hf.get("intermediate_size"),
              max_position_embeddings=hf.get("max_position_embeddings", 2048),
              layer_norm_eps=hf.get("layer_norm_epsilon", 1e-5),
              attention_layers=tuple(layers) if layers else None,
              window_size=hf.get("window_size", 256),
              bos_token_id=hf.get("bos_token_id", 50256),
              eos_token_id=hf.get("eos_token_id", 50256),
              tie_word_embeddings=hf.get("tie_word_embeddings", True))
    kw["pad_token_id"] = hf.get("pad_token_id") or kw["eos_token_id"]
    return GPTNeoConfig(**{**kw, **overrides})


def load_gpt_neo(model: GPTNeoForCausalLM, state_dict: Dict[str, torch.Tensor]) -> None:
    """Populate a ``GPTNeoForCausalLM`` from an HF ``gpt_neo`` state dict
    (HF nests the self-attention as ``attn.attention``); an ``lm_head``
    where the model has one and the checkpoint too."""
    sd, tr = state_dict, model.transformer
    _copy(tr.wte.weight, sd, "transformer.wte.weight")
    _copy(tr.wpe.weight, sd, "transformer.wpe.weight")
    for i, blk in enumerate(tr.h):
        p = f"transformer.h.{i}"
        _copy_norm(blk.ln_1, sd, f"{p}.ln_1")
        _copy_norm(blk.ln_2, sd, f"{p}.ln_2")
        attn = blk.attention
        for name, mod in (("attn.attention.q_proj", attn.q_proj),
                          ("attn.attention.k_proj", attn.k_proj),
                          ("attn.attention.v_proj", attn.v_proj),
                          ("attn.attention.out_proj", attn.out_proj),
                          ("mlp.c_fc", blk.mlp.c_fc), ("mlp.c_proj", blk.mlp.c_proj)):
            _copy_linear(mod, sd, f"{p}.{name}")
    _copy_norm(tr.ln_f, sd, "transformer.ln_f")
    if model.lm_head is not None and "lm_head.weight" in sd:
        _copy_linear(model.lm_head, sd, "lm_head")


def from_pretrained_gpt_neo(path: str, dtype: Optional[str] = None, *, device=None
                            ) -> GPTNeoForCausalLM:
    """``from_pretrained_gpt2`` for a GPT-Neo directory."""
    model = GPTNeoForCausalLM(gpt_neo_config_from_hf(_read_config(path), dtype=dtype),
                              device=device)
    load_gpt_neo(model, load_state_dict(path))
    return model


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
