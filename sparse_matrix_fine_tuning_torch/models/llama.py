"""Llama decoder for the port: RMSNorm, split-half RoPE, GQA, SwiGLU, and a
preallocated KV cache for greedy decode.

Counterpart of ``sparse_matrix_fine_tuning_tpu/models/llama.py`` with the
same HF attribute names (``q_proj`` ... ``down_proj``), so ``init_monarch``
finds the same targets and ``utils/jax_bridge.py`` carries the same
parameters.  The arithmetic follows the JAX model: RMSNorm reduces in fp32;
attention is ``softmax(q k^T / sqrt(d) + bias)`` with the scores, the
additive bias and the softmax in fp32; the bias is -1e9 where a key is
masked.  ``forward`` with ``caches`` writes this call's keys and values into
the preallocated cache in place, at ``cache_index``, and attends over the
whole cache.

Training: ``loss`` is the shifted causal-LM cross-entropy over full logits
and ``training_loss`` the forward plus that loss, chunked over tokens when
``config.loss_chunk > 0`` (``ops/losses.py``), as the JAX model's
(llama.py:371-405).  ``lm_head`` may be replaced by a ``quant.Int8LMHead``
(``quant.quantize_lm_head``, which refuses a tied head); the loss takes
either as the head callable.

Not ported yet: ``UnitOffsetRMSNorm`` (Gemma), layer hooks, ``segment_ids``
packing, remat and the "dpa"/"splash" attention implementations (ROADMAP.md
queue A: "The Llama model, training part", "Interventions", "Other model
families"); a config or call asking for them is refused.

The model is built on the card unless ``device="cpu"`` is passed
(``utils/device.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.ops.activations import geglu, swiglu
from sparse_matrix_fine_tuning_torch.utils.device import resolve_device, seeded_generator


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (None: the promoted dtype of
    input and weight), initialised N(0, 0.02) with a zero bias, as the JAX
    model's ``nnx.Linear``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = False, *,
                 dtype: Optional[torch.dtype] = None, param_dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        device = resolve_device(device)
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=param_dtype)
        self.compute_dtype = dtype
        generator = seeded_generator(device, generator)
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def reset_parameters(self) -> None:
        """Init happens in ``__init__`` from an explicit generator."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = self.bias.to(dtype) if self.bias is not None else None
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


class RMSNorm(nn.Module):
    """RMSNorm as ``nnx.RMSNorm``: the mean square and the scaling in fp32,
    the result in ``dtype`` (None: the promoted dtype of input and weight)."""

    def __init__(self, dim: int, *, eps: float, dtype=None, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype,
                                              device=resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        xf = x.to(dtype).float()
        var = xf.square().mean(-1, keepdim=True)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(dtype).float()
        return (xf * mul).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding.  x: (b, t, heads, head_dim); positions: (b, t)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs            # (b, t, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _linear(cfg: LlamaConfig, in_f: int, out_f: int, device, generator, bias: bool = False):
    return Linear(in_f, out_f, bias, dtype=cfg.compute_dtype, param_dtype=cfg.params_dtype,
                  device=device, generator=generator)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_attention_heads
        self.num_kv = cfg.kv_heads
        self.head_dim = cfg.head_width
        h, qkv_bias = cfg.hidden_size, cfg.attention_qkv_bias
        self.q_proj = _linear(cfg, h, self.num_heads * self.head_dim, device, generator, qkv_bias)
        self.k_proj = _linear(cfg, h, self.num_kv * self.head_dim, device, generator, qkv_bias)
        self.v_proj = _linear(cfg, h, self.num_kv * self.head_dim, device, generator, qkv_bias)
        self.o_proj = _linear(cfg, self.num_heads * self.head_dim, h, device, generator)

    def forward(self, x, attn_bias, positions, cache=None):
        b, t, _ = x.shape
        q = self.q_proj(x).reshape(b, t, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, t, self.num_kv, self.head_dim)
        v = self.v_proj(x).reshape(b, t, self.num_kv, self.head_dim)
        q = apply_rope(q, positions, self.cfg.rope_theta)
        k = apply_rope(k, positions, self.cfg.rope_theta)

        new_cache = None
        if cache is not None:
            # in place: the cache is preallocated for the whole generation
            k_cache, v_cache, idx = cache
            k_cache[:, idx:idx + t] = k
            v_cache[:, idx:idx + t] = v
            k, v = k_cache, v_cache
            new_cache = (k_cache, v_cache)

        groups = self.num_heads // self.num_kv
        kr = k.repeat_interleave(groups, dim=2) if groups > 1 else k
        vr = v.repeat_interleave(groups, dim=2) if groups > 1 else v
        scores = torch.einsum("bthd,bshd->bhts", q, kr).float() / math.sqrt(self.head_dim)
        scores = scores + attn_bias.float()
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhts,bshd->bthd", probs, vr).reshape(b, t, -1)
        return self.o_proj(ctx), new_cache


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        if cfg.mlp_activation not in ("silu", "gelu_tanh"):
            raise ValueError(f"unknown mlp_activation {cfg.mlp_activation!r} (silu | gelu_tanh)")
        self.act = swiglu if cfg.mlp_activation == "silu" else geglu
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _linear(cfg, h, i, device, generator)
        self.up_proj = _linear(cfg, h, i, device, generator)
        self.down_proj = _linear(cfg, i, h, device, generator)

    def forward(self, x):
        return self.down_proj(self.act(self.gate_proj(x), self.up_proj(x)))


def _norm(cfg: LlamaConfig, device) -> RMSNorm:
    return RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, dtype=cfg.compute_dtype,
                   param_dtype=cfg.params_dtype, device=device)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        self.self_attn = LlamaAttention(cfg, device=device, generator=generator)
        self.mlp = LlamaMLP(cfg, device=device, generator=generator)
        self.input_layernorm = _norm(cfg, device)
        self.post_attention_layernorm = _norm(cfg, device)

    def forward(self, x, attn_bias, positions, cache=None):
        attn_out, new_cache = self.self_attn(self.input_layernorm(x), attn_bias, positions, cache)
        x = x + attn_out
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, new_cache


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        self.config = cfg
        weight = torch.empty(cfg.vocab_size, cfg.hidden_size, dtype=cfg.params_dtype,
                             device=device)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         _weight=weight.normal_(0.0, 0.02, generator=generator))
        self.layers = nn.ModuleList([LlamaDecoderLayer(cfg, device=device, generator=generator)
                                     for _ in range(cfg.num_hidden_layers)])
        self.norm = _norm(cfg, device)

    def _bias(self, attention_mask, t, caches, cache_index, dtype, device):
        cfg = self.config
        if caches is None:
            offs = torch.arange(t, device=device)
            causal = offs[None, :] <= offs[:, None]
            if cfg.sliding_window is not None:
                causal = causal & (offs[:, None] - offs[None, :] < cfg.sliding_window)
            bias = torch.where(causal[None, None], 0.0, -1e9).to(dtype)
            if attention_mask is not None:
                pad = (1.0 - attention_mask[:, None, None, :].to(dtype)) * torch.tensor(
                    -1e9, dtype=dtype, device=device)
                bias = bias + pad
            return bias
        # over a fixed-size cache: query row i sits at slot cache_index + i
        # and may attend any valid slot at or before it
        cache_len = caches[0][0].shape[1]
        slot_ids = torch.arange(cache_len, device=device)[None, :]
        row_pos = cache_index + torch.arange(t, device=device)[:, None]
        causal = slot_ids <= row_pos
        if cfg.sliding_window is not None:
            causal = causal & (row_pos - slot_ids < cfg.sliding_window)
        ok = causal[None, None] & (attention_mask[:, None, None, :] > 0)
        return torch.where(ok, 0.0, -1e9).to(dtype)

    def forward(self, input_ids, attention_mask=None, positions=None, caches=None,
                cache_index=None):
        cfg = self.config
        b, t = input_ids.shape
        x = self.embed_tokens(input_ids)
        if cfg.compute_dtype is not None:
            x = x.to(cfg.compute_dtype)
        if cfg.scale_embeddings:
            x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype, device=x.device)
        if positions is None:
            positions = torch.arange(t, device=x.device).expand(b, t)
        bias = self._bias(attention_mask, t, caches, cache_index, x.dtype, x.device)
        new_caches = None if caches is None else []
        for i, layer in enumerate(self.layers):
            if caches is None:
                x, _ = layer(x, bias, positions)
            else:
                kc, vc = caches[i]
                x, nc = layer(x, bias, positions, cache=(kc, vc, cache_index))
                new_caches.append(nc)
        return self.norm(x), new_caches


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, generator: Optional[torch.Generator] = None):
        """device: where to build; the card when None.  generator:
        ``torch.Generator`` on ``device`` for the random init; a fresh one
        seeded with 0 when None."""
        super().__init__()
        if cfg.rmsnorm_unit_offset:
            raise NotImplementedError(
                "UnitOffsetRMSNorm (Gemma): ROADMAP.md queue A, 'Other model families'")
        if cfg.attention_impl != "einsum":
            raise NotImplementedError(f"attention_impl {cfg.attention_impl!r}: the port has the "
                                      "einsum attention only (ROADMAP.md queue A, "
                                      "'The Llama model, training part')")
        if cfg.remat:
            raise NotImplementedError(
                "remat: ROADMAP.md queue A, 'The Llama model, training part'")
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        self.config = cfg
        self.model = LlamaModel(cfg, device=device, generator=generator)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else _linear(cfg, cfg.hidden_size, cfg.vocab_size, device, generator))

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return hidden @ self.model.embed_tokens.weight.T.to(hidden.dtype)
        return self.lm_head(hidden)

    def forward(self, input_ids, attention_mask=None, positions=None, caches=None,
                cache_index=None):
        hidden, new_caches = self.model(input_ids, attention_mask, positions, caches,
                                        cache_index)
        out = self.logits(hidden)
        return (out, new_caches) if caches is not None else out

    def training_loss(self, input_ids, labels, attention_mask=None, positions=None,
                      layer_hooks=None, segment_ids=None, weights=None,
                      ignore_index: int = -100) -> torch.Tensor:
        """Forward and shifted CE in one call; chunked over tokens, without
        the full (B, T, V) logits, when ``config.loss_chunk > 0``."""
        from sparse_matrix_fine_tuning_torch.ops.losses import model_training_loss

        return model_training_loss(
            self, input_ids, labels, attention_mask=attention_mask, positions=positions,
            layer_hooks=layer_hooks, segment_ids=segment_ids, weights=weights,
            ignore_index=ignore_index)

    def loss(self, logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Shifted causal-LM cross-entropy, fp32, mean over the positions
        whose label is not ``ignore_index`` (and whose row has a nonzero
        ``weights`` entry, for padded ragged-tail rows)."""
        shift_logits = logits[:, :-1].float()
        shift_labels = labels[:, 1:]
        mask = shift_labels != ignore_index
        if weights is not None:
            mask = mask & (weights[:, None] != 0)
        safe = torch.where(mask, shift_labels, torch.zeros_like(shift_labels))
        logp = torch.log_softmax(shift_logits, dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None].long()).squeeze(-1)
        maskf = mask.float()
        return (nll * maskf).sum() / maskf.sum().clamp_min(1.0)


def init_caches(cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                device=None) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Empty KV caches: one (k, v) pair of (b, max_len, kv_heads, head_dim) per
    layer, on ``device`` (the card when None)."""
    device = resolve_device(device)
    shape = (batch, max_len, cfg.kv_heads, cfg.head_width)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.num_hidden_layers)]
