"""BLIP (vision-language) for the port: the VQA and image-text-matching models.

Counterpart of ``sparse_matrix_fine_tuning_tpu/models/blip.py``, with its
attribute names (``patch_kernel``, ``qkv``, ``projection``, ``fc1``/``fc2``,
``query``/``key``/``value``/``dense``/``ln``, ``intermediate``/``output``/
``output_ln``, ``emb_ln``, ``transform_dense``/``transform_ln``/``decoder``,
the wrappers' ``m``), so that ``utils/jax_bridge.load_jax_state`` carries a
JAX BLIP across as it is and ``peft/surgery.init_monarch`` finds the same
linears by name.

- ``BlipVisionModel``: a pre-LN ViT.  The patch embedding is a product over
  the flat ``patch_kernel`` (3·p·p, d), each patch taken in (c, ph, pw)
  order; the loader reshapes HF's conv weight (d, 3, p, p) into it.
- ``BlipTextModel``: a BERT-style post-LN encoder with a cross-attention
  block in every layer (used where image or question embeds are given);
  ``is_decoder`` makes its self-attention causal, so the same class is the
  text decoder.
- ``BlipWrapper`` and ``BlipITMWrapper``: the reference wrappers' dict
  outputs (``decoder_logits`` / ``itm_score`` and the hidden states).  The
  decoder sees only BOS and cross-attends to the question embeds under the
  question's mask (the original BLIP; transformers 4.57 drops that mask,
  the JAX module's docstring, :36-45); the encoder cross-attends to the
  image with no mask.

The arithmetic is the JAX module's, float32 throughout: LayerNorm with the
two-pass variance (epsilon 1e-5 in the vision tower, 1e-12 in the text
towers), the exact erf GELU, attention ``softmax(q / sqrt(d) k^T + bias)``
by einsum (no kernel: the JAX module runs none there), additive masks of
-1e9.  ``hidden_states`` starts with the embeddings' output (layers + 1
entries).

``layer_hooks`` (the ReFT sites, all on the text encoder, as pyvene's BLIP
anchors): a plain int or ``(layer, "block_output")`` after a layer,
``(layer, c)`` for c in "block_input", "attention_output",
"cross_attention_output" (only where image embeds are given: the ITM
contrastive path has none) and "mlp_output" inside it; any other component
raises ``ValueError``.

The loaders (``load_blip_qa``, ``load_blip_itm``, ``from_pretrained_blip``)
read an HF ``BlipForQuestionAnswering`` / ``BlipForImageTextRetrieval``
state dict, as ``models/hf_convert.load_state_dict`` reads it from an
HF-format directory.  The models are built on the card unless
``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sparse_matrix_fine_tuning_torch.models.hf_convert import (
    _copy,
    _copy_linear,
    _copy_norm,
    load_state_dict,
)
from sparse_matrix_fine_tuning_torch.models.llama import Linear
from sparse_matrix_fine_tuning_torch.models.roberta import LayerNorm, embedding
from sparse_matrix_fine_tuning_torch.utils.device import resolve_device, seeded_generator

HOOK_COMPONENTS = ("block_output", "block_input", "attention_output",
                   "cross_attention_output", "mlp_output")
NEG = -1e9


@dataclasses.dataclass(frozen=True)
class BlipVisionConfig:
    """HF BlipVisionConfig's fields and defaults (the JAX config's)."""
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 384
    patch_size: int = 16
    layer_norm_eps: float = 1e-5

    @classmethod
    def tiny(cls, **kw):
        d = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, image_size=24, patch_size=8)
        d.update(kw)
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class BlipTextConfig:
    """HF BlipTextConfig's fields and defaults; ``encoder_hidden_size`` is
    the width of the cross-attended image embeds."""
    vocab_size: int = 30524
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    encoder_hidden_size: int = 768
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    bos_token_id: int = 30522
    sep_token_id: int = 102

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=99, hidden_size=32, intermediate_size=64,
                 num_hidden_layers=2, num_attention_heads=4,
                 encoder_hidden_size=32, max_position_embeddings=64,
                 bos_token_id=97, sep_token_id=98)
        d.update(kw)
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class BlipModelConfig:
    """HF BlipConfig: the text and vision configs and the ITM projection
    width."""
    text_config: BlipTextConfig = dataclasses.field(default_factory=BlipTextConfig)
    vision_config: BlipVisionConfig = dataclasses.field(default_factory=BlipVisionConfig)
    image_text_hidden_size: int = 256

    @property
    def hidden_size(self) -> int:
        """The interventions' width: the text width (every ReFT site is on
        the text encoder)."""
        return self.text_config.hidden_size

    @classmethod
    def tiny(cls, **kw):
        d = dict(text_config=BlipTextConfig.tiny(), vision_config=BlipVisionConfig.tiny(),
                 image_text_hidden_size=16)
        d.update(kw)
        return cls(**d)


def _linear(in_f: int, out_f: int, device, generator) -> Linear:
    return Linear(in_f, out_f, True, device=device, generator=generator)


def _ln(width: int, eps: float, device) -> LayerNorm:
    return LayerNorm(width, eps=eps, device=device, fast_variance=False)


def _attend(q, k, v, head_dim: int, bias=None):
    """``softmax(q / sqrt(head_dim) k^T + bias) v`` over (b, t, heads, hd)."""
    scores = torch.einsum("bthd,bshd->bhts", q * head_dim ** -0.5, k)
    if bias is not None:
        scores = scores + bias
    return torch.einsum("bhts,bshd->bthd", torch.softmax(scores, dim=-1), v)


class BlipVisionEmbeddings(nn.Module):
    """The class token, the patch product and learned positions."""

    def __init__(self, cfg: BlipVisionConfig, *, device, generator):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.hidden_size, cfg.patch_size
        num_pos = (cfg.image_size // p) ** 2 + 1

        def normal(*shape, std=1.0):
            return nn.Parameter(torch.empty(shape, device=device).normal_(0.0, std,
                                                                          generator=generator))
        self.class_embedding = normal(1, 1, d)
        self.patch_kernel = normal(3 * p * p, d, std=0.02)
        self.patch_bias = nn.Parameter(torch.zeros(d, device=device))
        self.position_embedding = normal(1, num_pos, d)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values: (b, 3, H, W), channels first as HF's."""
        b, c, hh, ww = pixel_values.shape
        p = self.cfg.patch_size
        gh, gw = hh // p, ww // p
        x = pixel_values.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
        patches = x.reshape(b, gh * gw, c * p * p) @ self.patch_kernel + self.patch_bias
        cls = self.class_embedding.expand(b, 1, patches.shape[-1])
        emb = torch.cat([cls, patches], dim=1)
        return emb + self.position_embedding[:, :emb.shape[1]]


class BlipVisionLayer(nn.Module):
    """Pre-LN block: LN, fused-qkv attention, residual; LN, MLP, residual."""

    def __init__(self, cfg: BlipVisionConfig, *, device, generator):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.head_dim = d // cfg.num_attention_heads
        self.layer_norm1 = _ln(d, cfg.layer_norm_eps, device)
        self.qkv = _linear(d, 3 * d, device, generator)
        self.projection = _linear(d, d, device, generator)
        self.layer_norm2 = _ln(d, cfg.layer_norm_eps, device)
        self.fc1 = _linear(d, cfg.intermediate_size, device, generator)
        self.fc2 = _linear(cfg.intermediate_size, d, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        qkv = self.qkv(self.layer_norm1(x)).reshape(b, t, 3, self.num_heads, self.head_dim)
        ctx = _attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], self.head_dim)
        x = x + self.projection(ctx.reshape(b, t, d))
        return x + self.fc2(F.gelu(self.fc1(self.layer_norm2(x))))


class BlipVisionModel(nn.Module):
    """The ViT and its ``post_layernorm``; returns (last hidden, pooled)."""

    def __init__(self, cfg: BlipVisionConfig, *, device, generator):
        super().__init__()
        self.config = cfg
        self.embeddings = BlipVisionEmbeddings(cfg, device=device, generator=generator)
        self.layers = nn.ModuleList([BlipVisionLayer(cfg, device=device, generator=generator)
                                     for _ in range(cfg.num_hidden_layers)])
        self.post_layernorm = _ln(cfg.hidden_size, cfg.layer_norm_eps, device)

    def forward(self, pixel_values: torch.Tensor):
        x = self.embeddings(pixel_values)
        for layer in self.layers:
            x = layer(x)
        last = self.post_layernorm(x)
        return last, last[:, 0]


class BlipTextAttention(nn.Module):
    """q/k/v, then ``ln(dense(ctx) + x)``; keys and values read ``kv``, of
    width ``kv_width`` (the image embeds' in cross-attention)."""

    def __init__(self, cfg: BlipTextConfig, kv_width: int, *, device, generator):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.head_dim = d // cfg.num_attention_heads
        self.query = _linear(d, d, device, generator)
        self.key = _linear(kv_width, d, device, generator)
        self.value = _linear(kv_width, d, device, generator)
        self.dense = _linear(d, d, device, generator)
        self.ln = _ln(d, cfg.layer_norm_eps, device)

    def forward(self, x, kv, bias=None):
        b, t, d = x.shape
        s = kv.shape[1]
        q = self.query(x).reshape(b, t, self.num_heads, self.head_dim)
        k = self.key(kv).reshape(b, s, self.num_heads, self.head_dim)
        v = self.value(kv).reshape(b, s, self.num_heads, self.head_dim)
        ctx = _attend(q, k, v, self.head_dim, bias)
        return self.ln(self.dense(ctx.reshape(b, t, d)) + x)


class BlipTextLayer(nn.Module):
    """Self-attention, cross-attention where embeds are given, the MLP;
    each with its post-LN residual."""

    def __init__(self, cfg: BlipTextConfig, *, device, generator):
        super().__init__()
        d = cfg.hidden_size
        self.attention = BlipTextAttention(cfg, d, device=device, generator=generator)
        self.crossattention = BlipTextAttention(cfg, cfg.encoder_hidden_size, device=device,
                                                generator=generator)
        self.intermediate = _linear(d, cfg.intermediate_size, device, generator)
        self.output = _linear(cfg.intermediate_size, d, device, generator)
        self.output_ln = _ln(d, cfg.layer_norm_eps, device)

    def forward(self, x, self_bias, enc=None, enc_bias=None, hooks=None):
        hooks = hooks or {}
        if "block_input" in hooks:
            x = hooks["block_input"](x)
        x = self.attention(x, x, self_bias)
        if "attention_output" in hooks:
            x = hooks["attention_output"](x)
        if enc is not None:
            x = self.crossattention(x, enc, enc_bias)
            if "cross_attention_output" in hooks:
                x = hooks["cross_attention_output"](x)
        mlp = self.output(F.gelu(self.intermediate(x)))
        if "mlp_output" in hooks:
            mlp = hooks["mlp_output"](mlp)
        return self.output_ln(mlp + x)


def _additive_mask(attention_mask: Optional[torch.Tensor], dtype: torch.dtype, t: int,
                   causal: bool, device) -> Optional[torch.Tensor]:
    """(b, s) 0/1 mask -> (b, 1, t, s) additive bias, causal where asked."""
    bias = None
    if attention_mask is not None:
        bias = (1.0 - attention_mask[:, None, None, :].to(dtype)) * NEG
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=device).tril()
        tri = torch.zeros(t, t, dtype=dtype, device=device).masked_fill(~keep, NEG)[None, None]
        bias = tri if bias is None else bias + tri
    return bias


def split_hooks(layer_hooks) -> tuple[dict, dict]:
    """({layer: fn} block outputs, {layer: {component: fn}} inside the
    layers) of a text encoder's ``layer_hooks``."""
    block, inner = {}, {}
    for key, fn in (layer_hooks or {}).items():
        if isinstance(key, tuple):
            i, comp = key
            if comp not in HOOK_COMPONENTS:
                raise ValueError(f"unsupported BLIP text hook component {comp!r} "
                                 f"({' | '.join(HOOK_COMPONENTS)})")
            if comp == "block_output":
                block[int(i)] = fn
            else:
                inner.setdefault(int(i), {})[comp] = fn
        else:
            block[int(key)] = fn
    return block, inner


class BlipTextModel(nn.Module):
    """BERT-style embeddings and cross-attending layers; ``is_decoder`` is a
    forward-time flag (causal self-attention), as HF's."""

    def __init__(self, cfg: BlipTextConfig, *, device, generator):
        super().__init__()
        self.config = cfg
        self.word_embeddings = embedding(cfg.vocab_size, cfg.hidden_size, device, generator)
        self.position_embeddings = embedding(cfg.max_position_embeddings, cfg.hidden_size,
                                             device, generator)
        self.emb_ln = _ln(cfg.hidden_size, cfg.layer_norm_eps, device)
        self.layer = nn.ModuleList([BlipTextLayer(cfg, device=device, generator=generator)
                                    for _ in range(cfg.num_hidden_layers)])

    def forward(self, input_ids, attention_mask=None, encoder_hidden_states=None,
                encoder_attention_mask=None, is_decoder: bool = False, layer_hooks=None):
        """(last hidden, hidden states: the embeddings' output, then every
        layer's)."""
        block_hooks, inner_hooks = split_hooks(layer_hooks)
        b, t = input_ids.shape
        pos = torch.arange(t, device=input_ids.device).expand(b, t)
        x = self.emb_ln(self.word_embeddings(input_ids) + self.position_embeddings(pos))
        self_bias = _additive_mask(attention_mask, x.dtype, t, is_decoder, x.device)
        enc_bias = None
        if encoder_hidden_states is not None:
            enc_bias = _additive_mask(encoder_attention_mask, x.dtype, t, False, x.device)
        hidden_states = (x,)
        for i, layer in enumerate(self.layer):
            x = layer(x, self_bias, encoder_hidden_states, enc_bias, hooks=inner_hooks.get(i))
            if i in block_hooks:
                x = block_hooks[i](x)
            hidden_states += (x,)
        return x, hidden_states


class BlipTextLMHead(nn.Module):
    """dense, GELU, LN, then the vocabulary product with its bias."""

    def __init__(self, cfg: BlipTextConfig, *, device, generator):
        super().__init__()
        d = cfg.hidden_size
        self.transform_dense = _linear(d, d, device, generator)
        self.transform_ln = _ln(d, cfg.layer_norm_eps, device)
        self.decoder = _linear(d, cfg.vocab_size, device, generator)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.transform_ln(F.gelu(self.transform_dense(hidden))))


class BlipForQuestionAnswering(nn.Module):
    """The vision tower, the text encoder and decoder, the LM head."""

    def __init__(self, cfg: BlipModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        """device: where to build; the card when None.  generator: a
        ``torch.Generator`` on ``device`` for the random init; a fresh one
        seeded with 0 when None."""
        super().__init__()
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        kw = dict(device=device, generator=generator)
        self.config = cfg
        self.vision_model = BlipVisionModel(cfg.vision_config, **kw)
        self.text_encoder = BlipTextModel(cfg.text_config, **kw)
        self.text_decoder = BlipTextModel(cfg.text_config, **kw)
        self.lm_head = BlipTextLMHead(cfg.text_config, **kw)
        self.decoder_start_token_id = cfg.text_config.bos_token_id
        self.pad_token_id = cfg.text_config.pad_token_id


class BlipWrapper(nn.Module):
    """The reference's VQA wrapper: one forward returning
    ``decoder_logits``, ``image_embeds``, ``encoder_last_hidden_state``,
    ``encoder_hidden_states`` and ``decoder_hidden_states``."""

    def __init__(self, model: BlipForQuestionAnswering):
        super().__init__()
        self.m = model
        self.config = model.config
        self.eos_token_id = (model.config.text_config.sep_token_id,)
        self.pad_token_id = model.config.text_config.pad_token_id

    def forward(self, input_ids, pixel_values, attention_mask=None, layer_hooks=None):
        m = self.m
        image_embeds, _ = m.vision_model(pixel_values)
        question_embeds, enc_hidden = m.text_encoder(
            input_ids, attention_mask=attention_mask, encoder_hidden_states=image_embeds,
            layer_hooks=layer_hooks)
        bos = torch.full((question_embeds.shape[0], 1), m.decoder_start_token_id,
                         dtype=input_ids.dtype, device=input_ids.device)
        dec_last, dec_hidden = m.text_decoder(
            bos, encoder_hidden_states=question_embeds,
            encoder_attention_mask=attention_mask, is_decoder=True)
        return {"decoder_logits": m.lm_head(dec_last), "image_embeds": image_embeds,
                "encoder_last_hidden_state": question_embeds,
                "encoder_hidden_states": enc_hidden, "decoder_hidden_states": dec_hidden}


class BlipForImageTextRetrieval(nn.Module):
    """The vision tower, the text encoder, the ITM head and the contrastive
    projections."""

    def __init__(self, cfg: BlipModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        kw = dict(device=device, generator=generator)
        self.config = cfg
        self.vision_model = BlipVisionModel(cfg.vision_config, **kw)
        self.text_encoder = BlipTextModel(cfg.text_config, **kw)
        width = cfg.image_text_hidden_size
        self.vision_proj = _linear(cfg.vision_config.hidden_size, width, device, generator)
        self.text_proj = _linear(cfg.text_config.hidden_size, width, device, generator)
        self.itm_head = _linear(cfg.text_config.hidden_size, 2, device, generator)


class BlipITMWrapper(nn.Module):
    """The reference's ITM wrapper: ``use_itm_head`` scores the first token
    of a cross-attending encode through the 2-way head; otherwise the
    image-text cosine matrix of the contrastive projections."""

    def __init__(self, model: BlipForImageTextRetrieval, use_itm_not_contrastive: bool = True):
        super().__init__()
        self.m = model
        self.config = model.config
        self.use_itm_head = use_itm_not_contrastive
        self.eos_token_id = (model.config.text_config.sep_token_id,)
        self.pad_token_id = model.config.text_config.pad_token_id

    def forward(self, input_ids, pixel_values, attention_mask=None, layer_hooks=None):
        m = self.m
        image_embeds, _ = m.vision_model(pixel_values)
        if self.use_itm_head:
            caption_embeds, hidden = m.text_encoder(
                input_ids, attention_mask=attention_mask, encoder_hidden_states=image_embeds,
                layer_hooks=layer_hooks)
            output = m.itm_head(caption_embeds[:, 0])
        else:
            caption_embeds, hidden = m.text_encoder(input_ids, attention_mask=attention_mask,
                                                    layer_hooks=layer_hooks)

            def unit(z):
                return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
            output = unit(m.vision_proj(image_embeds[:, 0])) @ unit(
                m.text_proj(caption_embeds[:, 0])).T
        return {"itm_score": output, "image_embeds": image_embeds,
                "encoder_last_hidden_state": caption_embeds, "encoder_hidden_states": hidden}


# --------------------------------------------------------------------------
# HF weights
# --------------------------------------------------------------------------

def blip_config_from_hf(hf: dict) -> BlipModelConfig:
    """An HF BlipConfig dict (``config.json``) as a ``BlipModelConfig``."""
    tc, vc = hf["text_config"], hf["vision_config"]
    return BlipModelConfig(
        text_config=BlipTextConfig(
            vocab_size=tc["vocab_size"], hidden_size=tc["hidden_size"],
            intermediate_size=tc["intermediate_size"],
            num_hidden_layers=tc["num_hidden_layers"],
            num_attention_heads=tc["num_attention_heads"],
            encoder_hidden_size=tc.get("encoder_hidden_size", vc["hidden_size"]),
            max_position_embeddings=tc["max_position_embeddings"],
            layer_norm_eps=tc.get("layer_norm_eps", 1e-12),
            pad_token_id=tc.get("pad_token_id", 0),
            bos_token_id=tc.get("bos_token_id", 30522),
            sep_token_id=tc.get("sep_token_id", 102)),
        vision_config=BlipVisionConfig(
            hidden_size=vc["hidden_size"], intermediate_size=vc["intermediate_size"],
            num_hidden_layers=vc["num_hidden_layers"],
            num_attention_heads=vc["num_attention_heads"],
            image_size=vc["image_size"], patch_size=vc["patch_size"],
            layer_norm_eps=vc.get("layer_norm_eps", 1e-5)),
        image_text_hidden_size=hf.get("image_text_hidden_size", 256))


def _load_vision(vis: BlipVisionModel, sd, prefix: str = "vision_model") -> None:
    emb = vis.embeddings
    _copy(emb.class_embedding, sd, f"{prefix}.embeddings.class_embedding")
    key = f"{prefix}.embeddings.patch_embedding.weight"
    w = sd[key]  # (d, 3, p, p), each patch flattened in (c, ph, pw) order
    _copy(emb.patch_kernel, {key: w.reshape(w.shape[0], -1).T}, key)
    _copy(emb.patch_bias, sd, f"{prefix}.embeddings.patch_embedding.bias")
    _copy(emb.position_embedding, sd, f"{prefix}.embeddings.position_embedding")
    for i, layer in enumerate(vis.layers):
        p = f"{prefix}.encoder.layers.{i}"
        _copy_norm(layer.layer_norm1, sd, f"{p}.layer_norm1")
        _copy_linear(layer.qkv, sd, f"{p}.self_attn.qkv")
        _copy_linear(layer.projection, sd, f"{p}.self_attn.projection")
        _copy_norm(layer.layer_norm2, sd, f"{p}.layer_norm2")
        _copy_linear(layer.fc1, sd, f"{p}.mlp.fc1")
        _copy_linear(layer.fc2, sd, f"{p}.mlp.fc2")
    _copy_norm(vis.post_layernorm, sd, f"{prefix}.post_layernorm")


def _load_text(txt: BlipTextModel, sd, prefix: str) -> None:
    _copy(txt.word_embeddings.weight, sd, f"{prefix}.embeddings.word_embeddings.weight")
    _copy(txt.position_embeddings.weight, sd, f"{prefix}.embeddings.position_embeddings.weight")
    _copy_norm(txt.emb_ln, sd, f"{prefix}.embeddings.LayerNorm")
    for i, layer in enumerate(txt.layer):
        p = f"{prefix}.encoder.layer.{i}"
        blocks = [(layer.attention, "attention")]
        if f"{p}.crossattention.self.query.weight" in sd:
            blocks.append((layer.crossattention, "crossattention"))
        for attn, name in blocks:
            for proj in ("query", "key", "value"):
                _copy_linear(getattr(attn, proj), sd, f"{p}.{name}.self.{proj}")
            _copy_linear(attn.dense, sd, f"{p}.{name}.output.dense")
            _copy_norm(attn.ln, sd, f"{p}.{name}.output.LayerNorm")
        _copy_linear(layer.intermediate, sd, f"{p}.intermediate.dense")
        _copy_linear(layer.output, sd, f"{p}.output.dense")
        _copy_norm(layer.output_ln, sd, f"{p}.output.LayerNorm")


def load_blip_qa(model: BlipForQuestionAnswering, state_dict) -> None:
    """Populate the model from an HF ``BlipForQuestionAnswering`` state
    dict, in place."""
    sd = dict(state_dict)
    _load_vision(model.vision_model, sd)
    _load_text(model.text_encoder, sd, "text_encoder")
    _load_text(model.text_decoder, sd, "text_decoder.bert")
    head, pfx = model.lm_head, "text_decoder.cls.predictions"
    _copy_linear(head.transform_dense, sd, f"{pfx}.transform.dense")
    _copy_norm(head.transform_ln, sd, f"{pfx}.transform.LayerNorm")
    # save_pretrained keeps one key of each tied pair: the decoder weight is
    # the decoder's word embeddings, its bias the head's free bias
    weight_key = f"{pfx}.decoder.weight"
    if weight_key not in sd:
        weight_key = "text_decoder.bert.embeddings.word_embeddings.weight"
    _copy(head.decoder.weight, sd, weight_key)
    bias_key = f"{pfx}.bias" if f"{pfx}.bias" in sd else f"{pfx}.decoder.bias"
    _copy(head.decoder.bias, sd, bias_key)


def load_blip_itm(model: BlipForImageTextRetrieval, state_dict) -> None:
    """Populate the model from an HF ``BlipForImageTextRetrieval`` state
    dict, in place."""
    sd = dict(state_dict)
    _load_vision(model.vision_model, sd)
    _load_text(model.text_encoder, sd, "text_encoder")
    for name in ("vision_proj", "text_proj", "itm_head"):
        _copy_linear(getattr(model, name), sd, name)


def from_pretrained_blip(path: str, task: str = "qa", *, device=None):
    """A ``BlipForQuestionAnswering`` (``task="qa"``) or
    ``BlipForImageTextRetrieval`` (``"itm"``) from an HF-format directory
    (``config.json`` and ``model.safetensors`` or ``pytorch_model.bin``),
    float32, on ``device`` (the card when None)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = blip_config_from_hf(json.load(f))
    sd = load_state_dict(path)
    if task == "qa":
        model = BlipForQuestionAnswering(cfg, device=device)
        load_blip_qa(model, sd)
    elif task == "itm":
        model = BlipForImageTextRetrieval(cfg, device=device)
        load_blip_itm(model, sd)
    else:
        raise ValueError(f"unknown BLIP task {task!r} (qa | itm)")
    return model
