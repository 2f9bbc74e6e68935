"""GPT-Neo for the port: GPT-2's learned positions and pre-LN blocks, separate
unbiased q/k/v projections, unscaled fp32 scores, and layers that alternate
global and local (sliding-window) causal attention.

Counterpart of ``sparse_matrix_fine_tuning_tpu/models/gpt_neo.py``: HF's
names with the self-attention flat (``attention.q_proj`` for HF's
``attn.attention.q_proj``; ``models/hf_convert.load_gpt_neo`` maps them).
The scores are ``q k^T`` in fp32 with no ``1/sqrt(d)`` (HF
``GPTNeoSelfAttention``), plus the bias in fp32, the softmax in fp32 and the
probabilities in the activation dtype.  A local layer keeps the keys with
``q - k < window_size`` (the query counted), in training and over a cache
alike.  The lm head is tied to ``wte`` unless ``tie_word_embeddings`` is
off.  Past ``max_position_embeddings`` it refuses, as GPT-2.  Hooks, the
cache and the loss as ``models/gpt2.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sparse_matrix_fine_tuning_torch.models.config import _resolve_dtype
from sparse_matrix_fine_tuning_torch.models.gpt2 import (
    check_positions,
    embedding,
    layer_norm,
    linear,
    run_layers,
)
from sparse_matrix_fine_tuning_torch.models.llama import (
    LlamaForCausalLM,
    attention_bias,
    default_positions,
    run_block,
    write_cache,
)
from sparse_matrix_fine_tuning_torch.models.roberta import embed
from sparse_matrix_fine_tuning_torch.utils.device import resolve_device, seeded_generator


@dataclasses.dataclass(frozen=True)
class GPTNeoConfig:
    """The JAX ``GPTNeoConfig``'s fields and defaults."""
    vocab_size: int = 50257
    hidden_size: int = 2048
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: Optional[int] = None  # None -> 4 * hidden
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    # "global" | "local" a layer; None -> alternating, global first
    attention_layers: Optional[Tuple[str, ...]] = None
    window_size: int = 256
    bos_token_id: int = 50256
    eos_token_id: int = 50256
    pad_token_id: int = 50256
    tie_word_embeddings: bool = True
    dtype: Optional[str] = None
    param_dtype: str = "float32"
    loss_chunk: int = 0

    @property
    def inner(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def layer_types(self) -> Tuple[str, ...]:
        if self.attention_layers is not None:
            return tuple(self.attention_layers)
        return tuple("global" if i % 2 == 0 else "local" for i in range(self.num_hidden_layers))

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
                 num_attention_heads=4, max_position_embeddings=128, window_size=5)
        d.update(kw)
        return cls(**d)


class GPTNeoAttention(nn.Module):
    def __init__(self, cfg: GPTNeoConfig, *, device=None, generator=None):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.head_width
        h = cfg.hidden_size
        self.q_proj = linear(cfg, h, h, device, generator, bias=False)
        self.k_proj = linear(cfg, h, h, device, generator, bias=False)
        self.v_proj = linear(cfg, h, h, device, generator, bias=False)
        self.out_proj = linear(cfg, h, h, device, generator)

    def forward(self, x, attn_bias, cache=None):
        b, t, _ = x.shape
        shape = (b, t, self.num_heads, self.head_dim)
        q = self.q_proj(x).reshape(shape)
        k = self.k_proj(x).reshape(shape)
        v = self.v_proj(x).reshape(shape)
        k, v, new_cache = write_cache(k, v, cache)
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) + attn_bias.float()
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, -1)
        return self.out_proj(ctx), new_cache


class GPTNeoMLP(nn.Module):
    def __init__(self, cfg: GPTNeoConfig, *, device=None, generator=None):
        super().__init__()
        self.c_fc = linear(cfg, cfg.hidden_size, cfg.inner, device, generator)
        self.c_proj = linear(cfg, cfg.inner, cfg.hidden_size, device, generator)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class GPTNeoBlock(nn.Module):
    def __init__(self, cfg: GPTNeoConfig, *, device=None, generator=None):
        super().__init__()
        self.ln_1 = layer_norm(cfg, device)
        self.attention = GPTNeoAttention(cfg, device=device, generator=generator)
        self.ln_2 = layer_norm(cfg, device)
        self.mlp = GPTNeoMLP(cfg, device=device, generator=generator)

    def forward(self, x, attn_bias, cache=None, hooks=None):
        return run_block(x, hooks, lambda h: self.attention(self.ln_1(h), attn_bias, cache),
                         lambda h: self.mlp(self.ln_2(h)))


class GPTNeoModel(nn.Module):
    def __init__(self, cfg: GPTNeoConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        self.config = cfg
        self.wte = embedding(cfg, cfg.vocab_size, 0.02, device, generator)
        self.wpe = embedding(cfg, cfg.max_position_embeddings, 0.01, device, generator)
        self.h = nn.ModuleList([GPTNeoBlock(cfg, device=device, generator=generator)
                                for _ in range(cfg.num_hidden_layers)])
        self.ln_f = layer_norm(cfg, device)

    def forward(self, input_ids, attention_mask=None, positions=None, caches=None,
                cache_index=None, segment_ids=None, layer_hooks=None):
        b, t = input_ids.shape
        check_positions(self.config, t, caches)
        if positions is None:
            positions = default_positions(b, t, segment_ids, input_ids.device)
        dtype = self.config.compute_dtype
        x = embed(self.wte, input_ids, dtype) + embed(self.wpe, positions.long(), dtype)
        bias_g, bias_l = (attention_bias(attention_mask, t, caches, cache_index, x.dtype,
                                         x.device, segment_ids, window=window)
                          for window in (None, self.config.window_size))
        types = self.config.layer_types
        x, new_caches = run_layers(self.h, x, lambda i: bias_l if types[i] == "local" else bias_g,
                                   caches, cache_index, layer_hooks)
        return self.ln_f(x), new_caches


class GPTNeoForCausalLM(nn.Module):
    """Causal LM, the head tied to ``wte`` (HF's default) or an untied
    ``lm_head``."""

    def __init__(self, cfg: GPTNeoConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        self.config = cfg
        self.transformer = GPTNeoModel(cfg, device=device, generator=generator)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else linear(cfg, cfg.hidden_size, cfg.vocab_size, device, generator,
                                    bias=False))

    @property
    def model(self):
        return self.transformer

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return hidden @ self.transformer.wte.weight.T.to(hidden.dtype)
        return self.lm_head(hidden)

    forward = LlamaForCausalLM.forward
    training_loss = LlamaForCausalLM.training_loss
    loss = LlamaForCausalLM.loss
