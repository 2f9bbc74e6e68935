"""RoBERTa encoder and sequence classifier for the port.

Counterpart of ``sparse_matrix_fine_tuning_tpu/models/roberta.py`` with the
HF module names (``query``/``key``/``value``/``dense``/``LayerNorm``/
``classifier``), so the GLUE peft configs' ``target_modules`` find the same
linears and ``utils/jax_bridge.py`` carries the same parameters.  The
arithmetic follows the JAX model: parameters float32, compute in
``config.dtype`` (None: float32); LayerNorm as flax's (statistics in fp32,
var = E[x^2] - E[x]^2, the result cast once); attention ``softmax(q k^T /
sqrt(d) + bias)`` by two einsums in the compute dtype, the softmax in fp32,
the additive padding bias -1e9 where a key is padding; exact GELU.  The
attention has no kernel: the JAX model computes it by einsum outside any
Pallas kernel (roberta.py:84, :88), and so does this one.

Dropout (hidden and attention, ``nn.Dropout``) follows ``train()``/
``eval()``, as ``nnx.Module.train()/eval()`` switch the JAX model's.
``layer_hooks`` (MoReFT's intervention sites, the JAX roberta.py:152-170)
map a plain int or ``(layer, "block_output")`` to a function applied to
that layer's output, and ``(layer, "block_input")`` to one applied to its
input; any other component raises ``ValueError``.

The model is built on the card unless ``device="cpu"`` is passed
(``utils/device.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sparse_matrix_fine_tuning_torch.models.config import RobertaConfig
from sparse_matrix_fine_tuning_torch.models.llama import Linear
from sparse_matrix_fine_tuning_torch.utils.device import resolve_device, seeded_generator

ENCODER_HOOK_COMPONENTS = ("block_output", "block_input")


def split_encoder_hooks(layer_hooks) -> tuple[dict, dict]:
    """({layer: fn} block inputs, {layer: fn} block outputs) of an encoder's
    ``layer_hooks``: plain int keys are block outputs."""
    pre, post = {}, {}
    for key, fn in (layer_hooks or {}).items():
        if isinstance(key, tuple):
            i, comp = key
            if comp not in ENCODER_HOOK_COMPONENTS:
                raise ValueError(f"unsupported encoder hook component {comp!r} "
                                 f"({' | '.join(ENCODER_HOOK_COMPONENTS)})")
            (post if comp == "block_output" else pre)[int(i)] = fn
        else:
            post[int(key)] = fn
    return pre, post


def run_layers(layers, x, layer_hooks, *args):
    """Each encoder layer over ``x`` (``layer(x, *args)``) with the block
    input and output hooks around it."""
    pre, post = split_encoder_hooks(layer_hooks)
    for i, layer in enumerate(layers):
        if i in pre:
            x = pre[i](x)
        x = layer(x, *args)
        if i in post:
            x = post[i](x)
    return x


class LayerNorm(nn.Module):
    """``nnx.LayerNorm``: mean and variance (E[x^2] - E[x]^2, clipped at 0;
    with ``fast_variance=False`` the two-pass E[(x - mean)^2], flax's
    ``use_fast_variance=False``) in fp32, ``(x - mean) * (rsqrt(var + eps)
    * weight) + bias`` in fp32, the result in ``dtype`` (None: the promoted
    dtype of input and weight)."""

    def __init__(self, dim: int, *, eps: float, dtype: Optional[torch.dtype] = None,
                 device=None, fast_variance: bool = True):
        super().__init__()
        device = resolve_device(device)
        self.eps = eps
        self.dtype = dtype
        self.fast_variance = fast_variance
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        if self.fast_variance:
            var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        else:
            var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.float()) + self.bias.float()
        return y.to(self.dtype or torch.promote_types(x.dtype, self.weight.dtype))


def embedding(num: int, dim: int, device, generator) -> nn.Embedding:
    """An ``nn.Embedding`` initialised N(0, 0.02), as the JAX models' ``nnx.Embed``."""
    weight = torch.empty(num, dim, device=device).normal_(0.0, 0.02, generator=generator)
    return nn.Embedding(num, dim, _weight=weight)


def embed(table: nn.Embedding, ids: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    out = table(ids)
    return out if dtype is None else out.to(dtype)


def padding_bias(attention_mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(b, t) mask -> (b, 1, 1, t) additive bias: -1e9 (in ``dtype``) at padding."""
    neg = torch.tensor(-1e9, dtype=dtype, device=attention_mask.device)
    return (1.0 - attention_mask[:, None, None, :].to(dtype)) * neg


def classification_loss(num_labels: int, logits: torch.Tensor, labels: torch.Tensor,
                        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy in fp32, or the squared error for ``num_labels == 1``
    (STS-B); a mean over rows, or over the rows whose ``weights`` entry is
    nonzero (a padded ragged tail), as the JAX models' ``loss``."""
    if num_labels == 1:
        per_row = (logits.squeeze(-1) - labels) ** 2
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        per_row = -torch.gather(logp, -1, labels.long()[:, None]).squeeze(-1)
    if weights is None:
        return per_row.mean()
    w = weights.to(per_row.dtype)
    return (per_row * w).sum() / w.sum().clamp_min(1)


def create_position_ids(input_ids: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """RoBERTa's position ids: consecutive positions for non-pad tokens,
    offset past ``padding_idx``; pad tokens get ``padding_idx``."""
    mask = (input_ids != padding_idx).long()
    return torch.cumsum(mask, dim=-1) * mask + padding_idx


def _linear(cfg: RobertaConfig, in_f: int, out_f: int, device, generator) -> Linear:
    return Linear(in_f, out_f, True, dtype=cfg.compute_dtype, device=device, generator=generator)


def _norm(cfg: RobertaConfig, device) -> LayerNorm:
    return LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, dtype=cfg.compute_dtype,
                     device=device)


class RobertaEmbeddings(nn.Module):
    def __init__(self, cfg: RobertaConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = embedding(cfg.vocab_size, h, device, generator)
        self.position_embeddings = embedding(cfg.max_position_embeddings, h, device, generator)
        self.token_type_embeddings = embedding(cfg.type_vocab_size, h, device, generator)
        self.LayerNorm = _norm(cfg, device)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        dtype = self.cfg.compute_dtype
        pos_ids = create_position_ids(input_ids, self.cfg.pad_token_id)
        x = embed(self.word_embeddings, input_ids, dtype) \
            + embed(self.position_embeddings, pos_ids, dtype)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + embed(self.token_type_embeddings, token_type_ids, dtype)
        return self.dropout(self.LayerNorm(x))


class RobertaSelfAttention(nn.Module):
    def __init__(self, cfg: RobertaConfig, *, device=None, generator=None):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        h = cfg.hidden_size
        self.query = _linear(cfg, h, h, device, generator)
        self.key = _linear(cfg, h, h, device, generator)
        self.value = _linear(cfg, h, h, device, generator)
        self.dropout = nn.Dropout(cfg.attention_probs_dropout_prob)

    def forward(self, x, attn_bias):
        b, t, h = x.shape

        def split(z):
            return z.reshape(b, t, self.num_heads, self.head_dim)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(self.head_dim)
        scores = scores + attn_bias
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        probs = self.dropout(probs)
        ctx = torch.einsum("bhts,bshd->bthd", probs, v)
        return ctx.reshape(b, t, h)


class RobertaSelfOutput(nn.Module):
    def __init__(self, cfg: RobertaConfig, in_features: Optional[int] = None, *, device=None,
                 generator=None):
        super().__init__()
        self.dense = _linear(cfg, in_features or cfg.hidden_size, cfg.hidden_size, device,
                             generator)
        self.LayerNorm = _norm(cfg, device)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, residual):
        return self.LayerNorm(self.dropout(self.dense(x)) + residual)


class RobertaAttention(nn.Module):
    def __init__(self, cfg: RobertaConfig, *, device=None, generator=None):
        super().__init__()
        self.self = RobertaSelfAttention(cfg, device=device, generator=generator)
        self.output = RobertaSelfOutput(cfg, device=device, generator=generator)

    def forward(self, x, attn_bias):
        return self.output(self.self(x, attn_bias), x)


class RobertaIntermediate(nn.Module):
    def __init__(self, cfg: RobertaConfig, *, device=None, generator=None):
        super().__init__()
        self.dense = _linear(cfg, cfg.hidden_size, cfg.intermediate_size, device, generator)

    def forward(self, x):
        return F.gelu(self.dense(x))


class RobertaOutput(RobertaSelfOutput):
    def __init__(self, cfg: RobertaConfig, *, device=None, generator=None):
        super().__init__(cfg, cfg.intermediate_size, device=device, generator=generator)


class RobertaLayer(nn.Module):
    def __init__(self, cfg: RobertaConfig, *, device=None, generator=None):
        super().__init__()
        self.attention = RobertaAttention(cfg, device=device, generator=generator)
        self.intermediate = RobertaIntermediate(cfg, device=device, generator=generator)
        self.output = RobertaOutput(cfg, device=device, generator=generator)

    def forward(self, x, attn_bias):
        x = self.attention(x, attn_bias)
        return self.output(self.intermediate(x), x)


class RobertaModel(nn.Module):
    def __init__(self, cfg: RobertaConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        self.config = cfg
        self.embeddings = RobertaEmbeddings(cfg, device=device, generator=generator)
        self.layer = nn.ModuleList([RobertaLayer(cfg, device=device, generator=generator)
                                    for _ in range(cfg.num_hidden_layers)])

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, layer_hooks=None):
        if attention_mask is None:
            attention_mask = (input_ids != self.config.pad_token_id).long()
        x = self.embeddings(input_ids, token_type_ids)
        return run_layers(self.layer, x, layer_hooks, padding_bias(attention_mask, x.dtype))


class RobertaClassificationHead(nn.Module):
    """HF RoBERTa head: <s> token -> dense -> tanh -> out_proj."""

    def __init__(self, cfg: RobertaConfig, *, device=None, generator=None):
        super().__init__()
        self.dense = _linear(cfg, cfg.hidden_size, cfg.hidden_size, device, generator)
        self.out_proj = _linear(cfg, cfg.hidden_size, cfg.num_labels, device, generator)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, hidden):
        x = self.dropout(hidden[:, 0])
        x = self.dropout(torch.tanh(self.dense(x)))
        return self.out_proj(x)


class RobertaForSequenceClassification(nn.Module):
    def __init__(self, cfg: RobertaConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        """device: where to build; the card when None.  generator:
        ``torch.Generator`` on ``device`` for the random init; a fresh one
        seeded with 0 when None."""
        super().__init__()
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        self.config = cfg
        self.roberta = RobertaModel(cfg, device=device, generator=generator)
        self.classifier = RobertaClassificationHead(cfg, device=device, generator=generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, layer_hooks=None):
        hidden = self.roberta(input_ids, attention_mask, token_type_ids, layer_hooks=layer_hooks)
        return self.classifier(hidden)

    def loss(self, logits: torch.Tensor, labels: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Classification (CE) or regression (MSE, ``num_labels == 1``) loss;
        ``weights``: optional (B,) 0/1 rows, a padded ragged tail's zero."""
        return classification_loss(self.config.num_labels, logits, labels, weights)
