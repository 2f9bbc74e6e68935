"""GPT-2 for the port: learned positions, pre-LayerNorm biased blocks, a fused
qkv projection and a tanh-GELU MLP, with a KV cache for decode.

Counterpart of ``sparse_matrix_fine_tuning_tpu/models/gpt2.py``, with HF's
attribute names (``c_attn``, ``c_proj``, ``c_fc``, ``wte``, ``wpe``,
``ln_1``, ``ln_2``, ``ln_f``), so that ``target_modules`` lists and the
loaders carry over.  The arithmetic follows the JAX model: the scores are
``q k^T * score_scale`` in the activation dtype (``score_scale`` is
``1/sqrt(head_dim)``, divided again by ``layer + 1`` under
``scale_attn_by_inverse_layer_idx``, Backpack's setting), plus the -1e9
bias, the softmax in fp32, the probabilities cast back.  The lm head is
``wte`` (tied).  The layers take ``Linear`` and ``LayerNorm``, the Llama's
and the encoders' mirrors of ``nnx.Linear`` and ``nnx.LayerNorm``.

``GPT2Config`` carries ``kv_heads``, ``head_width`` and ``inner`` so that
``models/llama.init_caches`` and ``models/generate.py`` serve it as they
serve the Llama; positions come from the attention mask there (left
padding).  A sequence or cache longer than ``max_position_embeddings`` is
refused (the JAX model's gather clamps the excess positions).
``layer_hooks`` as the Llama's: a plain int (a block output) or
``(layer, component)``, "block_input", "attention_output" and
"mlp_output" inside the block, "block_output" after it.

The model is built on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sparse_matrix_fine_tuning_torch.models.config import _resolve_dtype
from sparse_matrix_fine_tuning_torch.models.llama import (
    LlamaForCausalLM,
    Linear,
    attention_bias,
    default_positions,
    run_block,
    split_hooks,
    write_cache,
)
from sparse_matrix_fine_tuning_torch.models.roberta import LayerNorm, embed
from sparse_matrix_fine_tuning_torch.utils.device import resolve_device, seeded_generator


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """GPT-2 family config (the JAX ``GPT2Config``'s fields and defaults)."""
    vocab_size: int = 50257
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: Optional[int] = None  # None -> 4 * hidden
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    bos_token_id: int = 50256
    eos_token_id: int = 50256
    pad_token_id: int = 50256
    tie_word_embeddings: bool = True
    dtype: Optional[str] = None
    param_dtype: str = "float32"
    loss_chunk: int = 0
    scale_attn_by_inverse_layer_idx: bool = False

    @property
    def inner(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def kv_heads(self) -> int:
        return self.num_attention_heads

    @property
    def head_width(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return _resolve_dtype(self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return _resolve_dtype(self.param_dtype) or torch.float32

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=128)
        d.update(kw)
        return cls(**d)

    @classmethod
    def gpt2(cls, **kw):
        return cls(**kw)

    @classmethod
    def gpt2_medium(cls, **kw):
        d = dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16)
        d.update(kw)
        return cls(**d)


def linear(cfg, in_f: int, out_f: int, device, generator, bias: bool = True) -> Linear:
    """``nnx.Linear`` of the GPT families: N(0, 0.02), zero bias."""
    return Linear(in_f, out_f, bias, dtype=cfg.compute_dtype, param_dtype=cfg.params_dtype,
                  device=device, generator=generator)


def layer_norm(cfg, device) -> LayerNorm:
    return LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, dtype=cfg.compute_dtype,
                     device=device).to(cfg.params_dtype)


def embedding(cfg, num: int, std: float, device, generator) -> nn.Embedding:
    weight = torch.empty(num, cfg.hidden_size, dtype=cfg.params_dtype, device=device)
    return nn.Embedding(num, cfg.hidden_size, _weight=weight.normal_(0.0, std,
                                                                     generator=generator))


def attend(q, k, v, attn_bias, scale: float, dtype) -> torch.Tensor:
    """``softmax(q k^T * scale + bias)`` v with the scores in the activation
    dtype and the softmax in fp32 (the GPT-2 and GPT-NeoX attention);
    (b, t, heads * head_dim)."""
    b, t = q.shape[:2]
    scores = torch.einsum("bthd,bshd->bhts", q, k) * scale
    scores = scores + attn_bias
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, -1)


class GPT2Attention(nn.Module):
    def __init__(self, cfg: GPT2Config, *, layer_idx: int = 0, device=None, generator=None):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.head_width
        self.score_scale = 1.0 / math.sqrt(cfg.head_width)
        if cfg.scale_attn_by_inverse_layer_idx:
            self.score_scale /= float(layer_idx + 1)
        h = cfg.hidden_size
        self.c_attn = linear(cfg, h, 3 * h, device, generator)
        self.c_proj = linear(cfg, h, h, device, generator)

    def forward(self, x, attn_bias, cache=None):
        b, t, _ = x.shape
        q, k, v = self.c_attn(x).chunk(3, dim=-1)
        shape = (b, t, self.num_heads, self.head_dim)
        q, k, v = q.reshape(shape), k.reshape(shape), v.reshape(shape)
        k, v, new_cache = write_cache(k, v, cache)
        return self.c_proj(attend(q, k, v, attn_bias, self.score_scale, x.dtype)), new_cache


class GPT2MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, *, device=None, generator=None):
        super().__init__()
        self.c_fc = linear(cfg, cfg.hidden_size, cfg.inner, device, generator)
        self.c_proj = linear(cfg, cfg.inner, cfg.hidden_size, device, generator)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, *, layer_idx: int = 0, device=None, generator=None):
        super().__init__()
        self.ln_1 = layer_norm(cfg, device)
        self.attn = GPT2Attention(cfg, layer_idx=layer_idx, device=device, generator=generator)
        self.ln_2 = layer_norm(cfg, device)
        self.mlp = GPT2MLP(cfg, device=device, generator=generator)

    def forward(self, x, attn_bias, cache=None, hooks=None):
        return run_block(x, hooks, lambda h: self.attn(self.ln_1(h), attn_bias, cache),
                         lambda h: self.mlp(self.ln_2(h)))


def check_positions(cfg, t: int, caches) -> None:
    """Refuse a sequence, or a cache, longer than the learned position table
    (JAX's gather would clamp the excess positions to the last row)."""
    length = t if caches is None else caches[0][0].shape[1]
    if length > cfg.max_position_embeddings:
        raise ValueError(f"{length} positions, past the model's max_position_embeddings "
                         f"{cfg.max_position_embeddings}")


def run_layers(layers, x, bias, caches, cache_index, layer_hooks, **kw):
    """The blocks in order with their hooks: (x, new caches or None)."""
    block_hooks, inner_hooks = split_hooks(layer_hooks)
    new_caches = None if caches is None else []
    for i, layer in enumerate(layers):
        layer_bias = bias(i) if callable(bias) else bias
        if caches is None:
            x, _ = layer(x, layer_bias, hooks=inner_hooks.get(i), **kw)
        else:
            kc, vc = caches[i]
            x, nc = layer(x, layer_bias, cache=(kc, vc, cache_index), hooks=inner_hooks.get(i),
                          **kw)
            new_caches.append(nc)
        if i in block_hooks:
            x = block_hooks[i](x)
    return x, new_caches


class GPT2Model(nn.Module):
    def __init__(self, cfg: GPT2Config, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        self.config = cfg
        self.wte = embedding(cfg, cfg.vocab_size, 0.02, device, generator)
        self.wpe = embedding(cfg, cfg.max_position_embeddings, 0.01, device, generator)
        self.h = nn.ModuleList([GPT2Block(cfg, layer_idx=i, device=device, generator=generator)
                                for i in range(cfg.num_hidden_layers)])
        self.ln_f = layer_norm(cfg, device)

    def forward(self, input_ids, attention_mask=None, positions=None, caches=None,
                cache_index=None, segment_ids=None, layer_hooks=None):
        b, t = input_ids.shape
        check_positions(self.config, t, caches)
        if positions is None:
            positions = default_positions(b, t, segment_ids, input_ids.device)
        dtype = self.config.compute_dtype
        # positions may come as floats; wpe takes ints
        x = embed(self.wte, input_ids, dtype) + embed(self.wpe, positions.long(), dtype)
        bias = attention_bias(attention_mask, t, caches, cache_index, x.dtype, x.device,
                              segment_ids)
        x, new_caches = run_layers(self.h, x, bias, caches, cache_index, layer_hooks)
        return self.ln_f(x), new_caches


class GPT2LMHeadModel(nn.Module):
    """Causal LM with the head tied to ``wte`` (HF ``GPT2LMHeadModel``); the
    Llama's call and loss surface.  ``model`` is the body, as the Llama's."""

    def __init__(self, cfg: GPT2Config, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg
        self.transformer = GPT2Model(cfg, device=device,
                                     generator=seeded_generator(device, generator))

    @property
    def model(self):
        return self.transformer

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return hidden @ self.transformer.wte.weight.T.to(hidden.dtype)

    forward = LlamaForCausalLM.forward
    training_loss = LlamaForCausalLM.training_loss
    loss = LlamaForCausalLM.loss
