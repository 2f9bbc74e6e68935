"""GPT-NeoX / Pythia for the port: partial rotary embeddings, the parallel
residual, a fused per-head ``query_key_value`` and an untied ``embed_out``.

Counterpart of ``sparse_matrix_fine_tuning_tpu/models/gpt_neox.py`` with
HF's names (``query_key_value``, ``dense``, ``dense_h_to_4h``,
``dense_4h_to_h``, ``embed_in``, ``embed_out``).  The fused projection's
output is laid out per head, (heads, 3 * head_dim), split q|k|v on the last
axis (not GPT-2's three hidden-size chunks).  The first ``rotary_ndims``
(``head_width * rotary_pct``) of each head rotate by the Llama's split-half
RoPE and the rest pass through.  With ``use_parallel_residual`` (Pythia's)
the block is ``x + attn(ln1(x)) + mlp(ln2(x))``, else sequential.  The
MLP's GELU is exact (erf) for "gelu" and tanh for "gelu_new".  Scores as
GPT-2's (``1/sqrt(head_dim)``, activation dtype, fp32 softmax).  Hooks, the
cache and the loss as ``models/gpt2.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sparse_matrix_fine_tuning_torch.models.config import _resolve_dtype
from sparse_matrix_fine_tuning_torch.models.gpt2 import (
    attend,
    embedding,
    layer_norm,
    linear,
    run_layers,
)
from sparse_matrix_fine_tuning_torch.models.llama import (
    LlamaForCausalLM,
    apply_rope,
    attention_bias,
    default_positions,
    write_cache,
)
from sparse_matrix_fine_tuning_torch.models.roberta import embed
from sparse_matrix_fine_tuning_torch.utils.device import resolve_device, seeded_generator


@dataclasses.dataclass(frozen=True)
class GPTNeoXConfig:
    """The JAX ``GPTNeoXConfig``'s fields and defaults."""
    vocab_size: int = 50432
    hidden_size: int = 2048
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 8192
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    rotary_pct: float = 0.25
    rope_theta: float = 10000.0
    use_parallel_residual: bool = True
    hidden_act: str = "gelu"
    bos_token_id: int = 0
    eos_token_id: int = 0
    pad_token_id: int = 0
    tie_word_embeddings: bool = False
    dtype: Optional[str] = None
    param_dtype: str = "float32"
    loss_chunk: int = 0

    @property
    def kv_heads(self) -> int:
        return self.num_attention_heads

    @property
    def head_width(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_ndims(self) -> int:
        return int(self.head_width * self.rotary_pct)

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return _resolve_dtype(self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return _resolve_dtype(self.param_dtype) or torch.float32

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=128, max_position_embeddings=128)
        d.update(kw)
        return cls(**d)

    @classmethod
    def pythia_1b(cls, **kw):
        d = dict(hidden_size=2048, num_hidden_layers=16, num_attention_heads=8,
                 intermediate_size=8192)
        d.update(kw)
        return cls(**d)


class GPTNeoXAttention(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.head_width
        h = cfg.hidden_size
        self.query_key_value = linear(cfg, h, 3 * h, device, generator)
        self.dense = linear(cfg, h, h, device, generator)

    def _rope_partial(self, x, positions):
        rot, theta = self.cfg.rotary_ndims, self.cfg.rope_theta
        if rot >= self.head_dim:
            return apply_rope(x, positions, theta)
        return torch.cat([apply_rope(x[..., :rot], positions, theta), x[..., rot:]], dim=-1)

    def forward(self, x, attn_bias, positions, cache=None):
        b, t, _ = x.shape
        qkv = self.query_key_value(x).reshape(b, t, self.num_heads, 3 * self.head_dim)
        q, k, v = qkv.split(self.head_dim, dim=-1)
        q = self._rope_partial(q, positions)
        k = self._rope_partial(k, positions)
        k, v, new_cache = write_cache(k, v, cache)
        ctx = attend(q, k, v, attn_bias, 1.0 / math.sqrt(self.head_dim), x.dtype)
        return self.dense(ctx), new_cache


class GPTNeoXMLP(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, *, device=None, generator=None):
        super().__init__()
        self.approximate = "tanh" if cfg.hidden_act == "gelu_new" else "none"
        self.dense_h_to_4h = linear(cfg, cfg.hidden_size, cfg.intermediate_size, device,
                                    generator)
        self.dense_4h_to_h = linear(cfg, cfg.intermediate_size, cfg.hidden_size, device,
                                    generator)

    def forward(self, x):
        return self.dense_4h_to_h(F.gelu(self.dense_h_to_4h(x), approximate=self.approximate))


class GPTNeoXLayer(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, *, device=None, generator=None):
        super().__init__()
        self.use_parallel_residual = cfg.use_parallel_residual
        self.input_layernorm = layer_norm(cfg, device)
        self.post_attention_layernorm = layer_norm(cfg, device)
        self.attention = GPTNeoXAttention(cfg, device=device, generator=generator)
        self.mlp = GPTNeoXMLP(cfg, device=device, generator=generator)

    def forward(self, x, attn_bias, positions, cache=None, hooks=None):
        hooks = hooks or {}
        if "block_input" in hooks:
            x = hooks["block_input"](x)
        attn_out, new_cache = self.attention(self.input_layernorm(x), attn_bias, positions,
                                             cache)
        if "attention_output" in hooks:
            attn_out = hooks["attention_output"](attn_out)
        if not self.use_parallel_residual:
            x = x + attn_out
        mlp_out = self.mlp(self.post_attention_layernorm(x))
        if "mlp_output" in hooks:
            mlp_out = hooks["mlp_output"](mlp_out)
        if self.use_parallel_residual:
            return x + attn_out + mlp_out, new_cache  # both branches read the input
        return x + mlp_out, new_cache


class GPTNeoXModel(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        self.config = cfg
        self.embed_in = embedding(cfg, cfg.vocab_size, 0.02, device, generator)
        self.layers = nn.ModuleList([GPTNeoXLayer(cfg, device=device, generator=generator)
                                     for _ in range(cfg.num_hidden_layers)])
        self.final_layer_norm = layer_norm(cfg, device)

    def forward(self, input_ids, attention_mask=None, positions=None, caches=None,
                cache_index=None, segment_ids=None, layer_hooks=None):
        b, t = input_ids.shape
        if positions is None:
            positions = default_positions(b, t, segment_ids, input_ids.device)
        x = embed(self.embed_in, input_ids, self.config.compute_dtype)
        bias = attention_bias(attention_mask, t, caches, cache_index, x.dtype, x.device,
                              segment_ids)
        x, new_caches = run_layers(self.layers, x, bias, caches, cache_index, layer_hooks,
                                   positions=positions)
        return self.final_layer_norm(x), new_caches


class GPTNeoXForCausalLM(nn.Module):
    """Causal LM with the untied ``embed_out`` head (HF
    ``GPTNeoXForCausalLM``)."""

    def __init__(self, cfg: GPTNeoXConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        self.config = cfg
        self.gpt_neox = GPTNeoXModel(cfg, device=device, generator=generator)
        self.embed_out = linear(cfg, cfg.hidden_size, cfg.vocab_size, device, generator,
                                bias=False)

    @property
    def model(self):
        return self.gpt_neox

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.embed_out(hidden)

    forward = LlamaForCausalLM.forward
    training_loss = LlamaForCausalLM.training_loss
    loss = LlamaForCausalLM.loss
