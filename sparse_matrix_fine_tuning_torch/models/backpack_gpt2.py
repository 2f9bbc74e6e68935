"""Backpack-GPT-2 for the port (Hewitt et al. 2023): each output state is a
causal-attention-weighted sum over ``num_senses`` sense vectors of every
earlier token.

Counterpart of ``sparse_matrix_fine_tuning_tpu/models/backpack_gpt2.py``:
the sense network maps each token embedding alone to its ``nv`` sense
vectors, (b, nv, s, d); the weight network is a per-sense single-head causal
attention over the hidden states of a ``GPT2Model`` (the contextualization
network, ``scale_attn_by_inverse_layer_idx`` on), (b, nv, s, s); the output
is ``sum_nv(weights @ senses)`` and the lm head is the shared ``wte``.  The
weight network masks with an additive -10000 (future keys, and pad keys
where a mask is given), as the reference does.

``layer_hooks={"sense_network_output": fn}`` applies ``fn`` to the sense
tensor (pyvene's one Backpack site; ``interventions/reft.py`` lifts a
token-position intervention over the sense axis); the other keys go to the
contextualization network.  ``run_with_custom_contextualization`` swaps in
given weights.  No cache: decode does not serve this model, and packed
segments are refused, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from sparse_matrix_fine_tuning_torch.models.gpt2 import (
    GPT2Config,
    GPT2Model,
    layer_norm,
    linear,
)
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.utils.device import resolve_device, seeded_generator

SENSE_SITE = "sense_network_output"


@dataclasses.dataclass(frozen=True)
class BackpackGPT2Config(GPT2Config):
    """``GPT2Config`` and the two Backpack knobs (the JAX
    ``BackpackGPT2Config``)."""
    num_senses: int = 16
    sense_intermediate_scale: int = 4
    scale_attn_by_inverse_layer_idx: bool = True

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=128, num_senses=4)
        d.update(kw)
        return cls(**d)


class BackpackMLP(nn.Module):
    def __init__(self, embed_dim: int, intermediate_dim: int, out_dim: int,
                 cfg: BackpackGPT2Config, *, device=None, generator=None):
        super().__init__()
        self.c_fc = linear(cfg, embed_dim, intermediate_dim, device, generator)
        self.c_proj = linear(cfg, intermediate_dim, out_dim, device, generator)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class BackpackNoMixBlock(nn.Module):
    """A residual MLP block a token alone (no attention)."""

    def __init__(self, cfg: BackpackGPT2Config, *, device=None, generator=None):
        super().__init__()
        self.ln_1 = layer_norm(cfg, device)
        self.ln_2 = layer_norm(cfg, device)
        self.mlp = BackpackMLP(cfg.hidden_size, 4 * cfg.hidden_size, cfg.hidden_size, cfg,
                               device=device, generator=generator)

    def forward(self, hidden, residual):
        residual = hidden + residual
        residual = self.mlp(self.ln_1(residual)) + residual
        return self.ln_2(residual)


class BackpackSenseNetwork(nn.Module):
    def __init__(self, cfg: BackpackGPT2Config, *, device=None, generator=None):
        super().__init__()
        self.num_senses = cfg.num_senses
        self.n_embd = cfg.hidden_size
        self.block = BackpackNoMixBlock(cfg, device=device, generator=generator)
        self.ln = layer_norm(cfg, device)
        self.final_mlp = BackpackMLP(cfg.hidden_size,
                                     cfg.sense_intermediate_scale * cfg.hidden_size,
                                     cfg.hidden_size * cfg.num_senses, cfg, device=device,
                                     generator=generator)

    def forward(self, input_embeds):
        senses = self.final_mlp(self.block(self.ln(input_embeds), input_embeds))
        b, s, _ = senses.shape
        return senses.reshape(b, s, self.num_senses, self.n_embd).transpose(1, 2)


class BackpackWeightNetwork(nn.Module):
    def __init__(self, cfg: BackpackGPT2Config, *, device=None, generator=None):
        super().__init__()
        self.num_senses = cfg.num_senses
        self.embed_per_sense = cfg.hidden_size // cfg.num_senses
        self.c_attn = linear(cfg, cfg.hidden_size, 2 * cfg.num_senses * self.embed_per_sense,
                             device, generator)

    def forward(self, encoded, attention_mask=None):
        b, s, _ = encoded.shape
        qk = self.c_attn(encoded).reshape(b, s, 2, self.num_senses, self.embed_per_sense)
        q, k = qk[:, :, 0], qk[:, :, 1]
        # 1 / sqrt(e) with the root taken in q's dtype, as the JAX model
        scale = 1.0 / torch.tensor(float(self.embed_per_sense), dtype=q.dtype,
                                   device=q.device).sqrt()
        scores = torch.einsum("bthd,bshd->bhts", q, k * scale)
        bias = torch.triu(torch.full((s, s), -10000.0, dtype=scores.dtype,
                                     device=scores.device), 1)[None, None]
        if attention_mask is not None:
            pad = (1.0 - attention_mask.to(scores.dtype)) * -10000.0
            bias = bias + pad[:, None, None, :]
        return torch.softmax(scores + bias, dim=-1)


class BackpackGPT2Model(nn.Module):
    """``forward`` returns ``(hidden_states, contextualization)``."""

    def __init__(self, cfg: BackpackGPT2Config, *, device=None, generator=None):
        super().__init__()
        self.config = cfg
        self.gpt2_model = GPT2Model(cfg, device=device, generator=generator)
        self.sense_network = BackpackSenseNetwork(cfg, device=device, generator=generator)
        self.sense_weight_net = BackpackWeightNetwork(cfg, device=device, generator=generator)

    @property
    def wte(self):
        return self.gpt2_model.wte

    def senses(self, input_ids, layer_hooks=None) -> torch.Tensor:
        """(b, nv, s, d) sense vectors, the ``sense_network_output`` hook
        applied."""
        emb = self.wte(input_ids)
        if self.config.compute_dtype is not None:
            emb = emb.to(self.config.compute_dtype)
        senses = self.sense_network(emb)
        if layer_hooks and SENSE_SITE in layer_hooks:
            senses = layer_hooks[SENSE_SITE](senses)
        return senses

    def forward(self, input_ids, attention_mask=None, positions=None, layer_hooks=None,
                segment_ids=None):
        if segment_ids is not None:
            raise NotImplementedError("BackpackGPT2Model does not support packed segments: the "
                                      "sense-weight network attends across the whole sequence")
        senses = self.senses(input_ids, layer_hooks)
        gpt2_hooks = {k: v for k, v in (layer_hooks or {}).items() if k != SENSE_SITE}
        contextl, _ = self.gpt2_model(input_ids, attention_mask, positions=positions,
                                      layer_hooks=gpt2_hooks or None)
        contextualization = self.sense_weight_net(contextl, attention_mask)
        return _mix(contextualization, senses), contextualization

    def run_with_custom_contextualization(self, input_ids, contextualization, layer_hooks=None):
        senses = self.senses(input_ids, layer_hooks)
        return _mix(contextualization, senses), contextualization


def _mix(contextualization: torch.Tensor, senses: torch.Tensor) -> torch.Tensor:
    """sum over senses of (b, nv, t, s) weights @ (b, nv, s, d) -> (b, t, d)."""
    return torch.einsum("bhts,bhsd->bthd", contextualization, senses).sum(dim=2)


class BackpackGPT2LMHeadModel(nn.Module):
    """LM head tied to ``wte``; ``forward`` returns logits (the harnesses'
    contract) and ``forward_with_contextualization`` ``(logits,
    contextualization)``."""

    def __init__(self, cfg: BackpackGPT2Config, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg
        self.backpack = BackpackGPT2Model(cfg, device=device,
                                          generator=seeded_generator(device, generator))

    @property
    def model(self):
        return self.backpack

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return hidden @ self.backpack.wte.weight.T.to(hidden.dtype)

    def forward_with_contextualization(self, input_ids, attention_mask=None, positions=None,
                                       layer_hooks=None):
        hidden, ctx = self.backpack(input_ids, attention_mask, positions=positions,
                                    layer_hooks=layer_hooks)
        return self.logits(hidden), ctx

    def forward(self, input_ids, attention_mask=None, positions=None, layer_hooks=None,
                segment_ids=None):
        if segment_ids is not None:
            raise NotImplementedError("BackpackGPT2LMHeadModel does not support packed segments")
        return self.forward_with_contextualization(input_ids, attention_mask, positions,
                                                   layer_hooks)[0]

    def run_with_custom_contextualization(self, input_ids, contextualization, layer_hooks=None):
        hidden, ctx = self.backpack.run_with_custom_contextualization(
            input_ids, contextualization, layer_hooks=layer_hooks)
        return self.logits(hidden), ctx

    training_loss = LlamaForCausalLM.training_loss
    loss = LlamaForCausalLM.loss
