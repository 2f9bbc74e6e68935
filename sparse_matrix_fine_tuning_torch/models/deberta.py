"""DeBERTa-v2/v3 encoder and sequence classifier for the port.

Counterpart of ``sparse_matrix_fine_tuning_tpu/models/deberta.py``, with its
config (``DebertaV2Config``), its module names (``query_proj``/
``key_proj``/``value_proj``, the names of
``task_configs/deberta_glue/peft_config.json``) and its arithmetic:
disentangled attention adds to the content-content scores a
content-to-position and a position-to-content term, computed against one
table of log-bucketed relative position embeddings for the whole encoder
(LayerNormed for v3).  All three terms share the scale 1/sqrt(d *
(1 + len(pos_att_type))); c2p gathers at bucket(rel) + span, p2c at
bucket(-rel) + span and is then transposed.  With ``share_att_key`` the
position embeddings go through ``query_proj`` and ``key_proj`` themselves,
so an adapted layer runs each of those twice a forward (on the tokens and
on the 2 * span position rows) and ``value_proj`` once.  The attention is
einsums and gathers, as the JAX model computes it outside any Pallas
kernel.  LayerNorm, embeddings, the exact GELU and the loss are those of
``models/roberta.py``.

``make_log_bucket_position`` and ``build_relative_position`` are integer
functions of the JAX model's float32 arithmetic, equal to it bit for bit.
``layer_hooks`` take the block-output and block-input sites of
``models/roberta.py`` (the JAX model takes block outputs by plain int keys
only).  The model is built on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sparse_matrix_fine_tuning_torch.models.config import _resolve_dtype
from sparse_matrix_fine_tuning_torch.models.llama import Linear
from sparse_matrix_fine_tuning_torch.models.roberta import (
    LayerNorm,
    classification_loss,
    embed,
    embedding,
    run_layers,
)
from sparse_matrix_fine_tuning_torch.utils.device import resolve_device, seeded_generator


@dataclasses.dataclass(frozen=True)
class DebertaV2Config:
    vocab_size: int = 128100
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 0
    layer_norm_eps: float = 1e-7
    pad_token_id: int = 0
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    relative_attention: bool = True
    position_buckets: int = 256
    max_relative_positions: int = -1
    pos_att_type: Sequence[str] = ("p2c", "c2p")
    share_att_key: bool = True
    norm_rel_ebd: str = "layer_norm"
    position_biased_input: bool = False
    num_labels: int = 2
    dtype: Optional[str] = None

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return _resolve_dtype(self.dtype)

    @property
    def max_relative(self) -> int:
        """``max_relative_positions``, or ``max_position_embeddings`` below 1."""
        return self.max_relative_positions if self.max_relative_positions >= 1 \
            else self.max_position_embeddings

    @property
    def pos_ebd_size(self) -> int:
        return self.position_buckets if self.position_buckets > 0 else self.max_relative

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=64,
                 max_position_embeddings=64, position_buckets=8)
        d.update(kw)
        return cls(**d)


def make_log_bucket_position(relative_pos: torch.Tensor, bucket_size: int,
                             max_position: int) -> torch.Tensor:
    """HF's log-bucketed relative positions, in the JAX function's float32
    steps (``math.log`` of the bucket ratio taken in float64, then used as a
    float32 scalar); int32."""
    sign = torch.sign(relative_pos)
    mid = bucket_size // 2
    abs_pos = torch.where((relative_pos < mid) & (relative_pos > -mid),
                          torch.full_like(relative_pos, mid - 1), relative_pos.abs())
    safe = abs_pos.clamp_min(1).float()
    denom = torch.tensor(math.log((max_position - 1) / mid), dtype=torch.float32)
    log_pos = torch.ceil(torch.log(safe / mid) / denom * (mid - 1)) + mid
    bucket_pos = torch.where(abs_pos <= mid, relative_pos.float(), log_pos * sign)
    return bucket_pos.to(torch.int32)


def build_relative_position(query_size: int, key_size: int, bucket_size: int = -1,
                            max_position: int = -1, device=None) -> torch.Tensor:
    """(1, q, k) relative positions q_i - k_j, log-bucketed where both
    ``bucket_size`` and ``max_position`` are positive."""
    rel = (torch.arange(query_size, device=device)[:, None]
           - torch.arange(key_size, device=device)[None, :])
    if bucket_size > 0 and max_position > 0:
        rel = make_log_bucket_position(rel, bucket_size, max_position)
    return rel[None]


def _linear(cfg: DebertaV2Config, in_f: int, out_f: int, device, generator,
            bias: bool = True) -> Linear:
    return Linear(in_f, out_f, bias, dtype=cfg.compute_dtype, device=device, generator=generator)


def _norm(cfg: DebertaV2Config, device) -> LayerNorm:
    return LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, dtype=cfg.compute_dtype,
                     device=device)


class DisentangledSelfAttention(nn.Module):
    def __init__(self, cfg: DebertaV2Config, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        h = cfg.hidden_size
        self.query_proj = _linear(cfg, h, h, device, generator)
        self.key_proj = _linear(cfg, h, h, device, generator)
        self.value_proj = _linear(cfg, h, h, device, generator)
        self.dropout = nn.Dropout(cfg.attention_probs_dropout_prob)
        self.pos_dropout = nn.Dropout(cfg.hidden_dropout_prob)
        if not cfg.share_att_key and cfg.relative_attention:
            if "c2p" in cfg.pos_att_type:
                self.pos_key_proj = _linear(cfg, h, h, device, generator)
            if "p2c" in cfg.pos_att_type:
                self.pos_query_proj = _linear(cfg, h, h, device, generator, bias=False)

    def _split(self, x: torch.Tensor, b: int) -> torch.Tensor:
        """(b, t, heads * d) -> (b, heads, t, d)."""
        return x.reshape(b, -1, self.num_heads, self.head_dim).permute(0, 2, 1, 3)

    def forward(self, x, attn_bias, rel_embeddings=None, relative_pos=None):
        cfg = self.cfg
        b, t, _ = x.shape
        q = self._split(self.query_proj(x), b)
        k = self._split(self.key_proj(x), b)
        v = self._split(self.value_proj(x), b)
        scale_factor = 1 + len(cfg.pos_att_type) if cfg.relative_attention else 1
        scale = math.sqrt(self.head_dim * scale_factor)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / scale
        if cfg.relative_attention and rel_embeddings is not None:
            scores = scores + self._disentangled_bias(q, k, rel_embeddings, relative_pos, scale)
        scores = scores + attn_bias
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        probs = self.dropout(probs)
        ctx = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        return ctx.permute(0, 2, 1, 3).reshape(b, t, -1)

    def _disentangled_bias(self, q, k, rel_embeddings, relative_pos, scale):
        cfg = self.cfg
        b, h, t, _ = q.shape
        span = cfg.pos_ebd_size
        if relative_pos is None:
            relative_pos = build_relative_position(t, t, cfg.position_buckets, cfg.max_relative,
                                                   device=q.device)
        rel = self.pos_dropout(rel_embeddings[:span * 2])[None]  # (1, 2 span, hidden)
        if cfg.share_att_key:
            pos_q = self._split(self.query_proj(rel), 1)  # (1, heads, 2 span, d)
            pos_k = self._split(self.key_proj(rel), 1)
        else:
            pos_k = self._split(self.pos_key_proj(rel), 1) if "c2p" in cfg.pos_att_type else None
            pos_q = self._split(self.pos_query_proj(rel), 1) \
                if "p2c" in cfg.pos_att_type else None
        # an adapted projection of the fp32 table (no rel LayerNorm) answers
        # in fp32: the products then promote, as jnp.einsum does
        pos = pos_k if pos_k is not None else pos_q
        dtype = torch.promote_types(q.dtype, pos.dtype)
        q, k = q.to(dtype), k.to(dtype)
        score = 0.0
        if "c2p" in cfg.pos_att_type:
            c2p = torch.einsum("bhqd,xhkd->bhqk", q, pos_k.to(dtype))  # (b, heads, t, 2 span)
            idx = torch.clamp(relative_pos + span, 0, span * 2 - 1).long()
            score = score + torch.gather(c2p, -1, idx[:, None].expand(b, h, t, t)) / scale
        if "p2c" in cfg.pos_att_type:
            idx = torch.clamp(-relative_pos + span, 0, span * 2 - 1).long()
            p2c = torch.einsum("bhkd,xhqd->bhkq", k, pos_q.to(dtype))  # (b, heads, t, 2 span)
            p2c = torch.gather(p2c, -1, idx[:, None].expand(b, h, t, t))
            score = score + p2c.transpose(-1, -2) / scale
        return score


class DebertaSelfOutput(nn.Module):
    def __init__(self, cfg: DebertaV2Config, *, device=None, generator=None):
        super().__init__()
        self.dense = _linear(cfg, cfg.hidden_size, cfg.hidden_size, device, generator)
        self.LayerNorm = _norm(cfg, device)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, residual):
        return self.LayerNorm(self.dropout(self.dense(x)) + residual)


class DebertaLayer(nn.Module):
    def __init__(self, cfg: DebertaV2Config, *, device=None, generator=None):
        super().__init__()
        self.attention_self = DisentangledSelfAttention(cfg, device=device, generator=generator)
        self.attention_output = DebertaSelfOutput(cfg, device=device, generator=generator)
        self.intermediate = _linear(cfg, cfg.hidden_size, cfg.intermediate_size, device,
                                    generator)
        self.output_dense = _linear(cfg, cfg.intermediate_size, cfg.hidden_size, device,
                                    generator)
        self.output_LayerNorm = _norm(cfg, device)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attn_bias, rel_embeddings, relative_pos):
        ctx = self.attention_self(x, attn_bias, rel_embeddings, relative_pos)
        x = self.attention_output(ctx, x)
        out = self.dropout(self.output_dense(F.gelu(self.intermediate(x))))
        return self.output_LayerNorm(out + x)


class DebertaV2Model(nn.Module):
    def __init__(self, cfg: DebertaV2Config, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        self.config = cfg
        h = cfg.hidden_size
        self.word_embeddings = embedding(cfg.vocab_size, h, device, generator)
        self.position_embeddings = (embedding(cfg.max_position_embeddings, h, device, generator)
                                    if cfg.position_biased_input else None)
        self.emb_LayerNorm = _norm(cfg, device)
        self.emb_dropout = nn.Dropout(cfg.hidden_dropout_prob)
        self.layer = nn.ModuleList([DebertaLayer(cfg, device=device, generator=generator)
                                    for _ in range(cfg.num_hidden_layers)])
        self.rel_embeddings = (embedding(cfg.pos_ebd_size * 2, h, device, generator)
                               if cfg.relative_attention else None)
        self.rel_LayerNorm = (_norm(cfg, device) if cfg.relative_attention
                              and "layer_norm" in cfg.norm_rel_ebd else None)

    def get_rel_embedding(self) -> Optional[torch.Tensor]:
        """The float32 table, through ``rel_LayerNorm`` where there is one."""
        if self.rel_embeddings is None:
            return None
        rel = self.rel_embeddings.weight
        return self.rel_LayerNorm(rel) if self.rel_LayerNorm is not None else rel

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, layer_hooks=None):
        cfg = self.config
        b, t = input_ids.shape
        if attention_mask is None:
            attention_mask = (input_ids != cfg.pad_token_id).long()
        dtype = cfg.compute_dtype
        x = embed(self.word_embeddings, input_ids, dtype)
        if self.position_embeddings is not None:
            x = x + embed(self.position_embeddings,
                          torch.arange(t, device=input_ids.device)[None], dtype)
        x = self.emb_LayerNorm(x)
        # DeBERTa masks the embeddings too (HF: embeddings * mask)
        x = self.emb_dropout(x * attention_mask[..., None].to(x.dtype))
        # 2D mask product: token i attends j iff both are valid
        m = attention_mask.to(x.dtype)
        pair = m[:, None, :, None] * m[:, None, None, :]
        attn_bias = (1.0 - pair) * torch.tensor(-1e9, dtype=x.dtype, device=x.device)
        relative_pos = (build_relative_position(t, t, cfg.position_buckets, cfg.max_relative,
                                                device=x.device)
                        if cfg.relative_attention else None)
        return run_layers(self.layer, x, layer_hooks, attn_bias, self.get_rel_embedding(),
                          relative_pos)


class DebertaV2ForSequenceClassification(nn.Module):
    def __init__(self, cfg: DebertaV2Config, *, device=None,
                 generator: Optional[torch.Generator] = None):
        """device: where to build; the card when None.  generator:
        ``torch.Generator`` on ``device`` for the random init; a fresh one
        seeded with 0 when None."""
        super().__init__()
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        self.config = cfg
        self.deberta = DebertaV2Model(cfg, device=device, generator=generator)
        # ContextPooler + classifier (HF names: pooler.dense, classifier)
        self.pooler = _linear(cfg, cfg.hidden_size, cfg.hidden_size, device, generator)
        self.classifier = _linear(cfg, cfg.hidden_size, cfg.num_labels, device, generator)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, layer_hooks=None):
        hidden = self.deberta(input_ids, attention_mask, token_type_ids, layer_hooks=layer_hooks)
        pooled = F.gelu(self.pooler(self.dropout(hidden[:, 0])))
        return self.classifier(self.dropout(pooled))

    def loss(self, logits: torch.Tensor, labels: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        return classification_loss(self.config.num_labels, logits, labels, weights)
