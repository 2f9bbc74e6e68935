"""Toy intervenable models: MLP and GRU classifiers.

Counterpart of ``sparse_matrix_fine_tuning_tpu/models/toy.py`` (the
reference's pyvene aux models, pyvene/models/mlp/modelings_mlp.py and
models/gru/modelings_gru.py): fixtures for interchange interventions
against a ``CausalModel`` (``interventions/das.py``).  Both take the
production models' ``layer_hooks`` (``{layer | (layer, "block_output"):
fn(hidden)}``, at block outputs), so that ``ReftModel`` wraps them as it
wraps a Llama.  Hidden states are (batch, positions, hidden), one position
for each causal-model input variable.

The JAX package's module names (``embed``, ``wpe``, ``blocks``, ``head``;
``cells``' ``wi`` and ``wh``), so that ``utils/jax_bridge.load_jax_state``
carries its weights.  The port draws its own initial weights from
``generator`` with the JAX defaults' laws (linears: truncated normal of
variance 1 / fan-in, zero bias; embeddings: normal of variance 1 / rows).
The blocks' GELU is the tanh form, ``jax.nn.gelu``'s default.  Built on
the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sparse_matrix_fine_tuning_torch.utils.device import resolve_device, seeded_generator

__all__ = ["ToyConfig", "MLPModel", "GRUModel"]


@dataclass
class ToyConfig:
    hidden_size: int = 32
    num_hidden_layers: int = 3
    num_classes: int = 2
    input_dim: int = 1          # per-position feature width (float inputs)
    vocab_size: Optional[int] = None  # int token inputs through an embedding
    squeeze_output: bool = False      # logits (b,) for a one-logit head
    # learned absolute position embeddings (0: none); without them the
    # positionwise blocks and the mean pool cannot tell positions apart
    max_positions: int = 0


# lecun_normal's truncated normal: the std of N(0, 1) cut at +-2 sigma
_TRUNC_STD = 0.87962566103423978


def _linear(din: int, dout: int, device, generator) -> nn.Linear:
    layer = nn.Linear(din, dout, device=device)
    with torch.no_grad():
        std = (1.0 / din) ** 0.5 / _TRUNC_STD
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        layer.bias.zero_()
    return layer


def _embedding(rows: int, dim: int, device, generator) -> nn.Embedding:
    weight = torch.empty(rows, dim, device=device).normal_(0.0, rows ** -0.5,
                                                           generator=generator)
    return nn.Embedding(rows, dim, _weight=weight)


def _block_hooks(layer_hooks) -> dict:
    """{layer: fn}: plain int keys or ``(layer, "block_output")``."""
    hooks = {}
    for key, fn in (layer_hooks or {}).items():
        if isinstance(key, tuple):
            i, comp = key
            if comp != "block_output":
                raise ValueError(f"toy models only expose block_output, got {comp!r}")
            key = i
        hooks[int(key)] = fn
    return hooks


class _Toy(nn.Module):
    def __init__(self, cfg: ToyConfig, device, generator):
        super().__init__()
        self.config = cfg
        if cfg.vocab_size is not None:
            self.embed = _embedding(cfg.vocab_size, cfg.hidden_size, device, generator)
        else:
            self.embed = _linear(cfg.input_dim, cfg.hidden_size, device, generator)

    def _embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        if self.config.vocab_size is not None:
            return self.embed(input_ids.long())
        x = input_ids[..., None] if input_ids.dim() == 2 else input_ids
        return self.embed(x.float())

    def _logits(self, pooled: torch.Tensor) -> torch.Tensor:
        logits = self.head(pooled)
        if self.config.squeeze_output and self.config.num_classes == 1:
            logits = logits[..., 0]
        return logits

    def loss(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, labels[:, None].long()).mean()


class MLPModel(_Toy):
    """Per-position MLP classifier (reference modelings_mlp.py): embed each
    position, ``num_hidden_layers`` blocks of Linear + GELU applied
    positionwise, mean pool (over the mask), a linear head."""

    def __init__(self, cfg: ToyConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        super().__init__(cfg, device, generator)
        self.wpe = (_embedding(cfg.max_positions, cfg.hidden_size, device, generator)
                    if cfg.max_positions else None)
        self.blocks = nn.ModuleList([_linear(cfg.hidden_size, cfg.hidden_size, device, generator)
                                     for _ in range(cfg.num_hidden_layers)])
        self.head = _linear(cfg.hidden_size, cfg.num_classes, device, generator)

    def forward(self, input_ids, attention_mask=None, layer_hooks=None):
        """input_ids: float (b, seq, input_dim) or (b, seq) features, or int
        (b, seq) tokens with ``vocab_size``.  Returns (b, num_classes)."""
        hooks = _block_hooks(layer_hooks)
        h = self._embed(input_ids)
        if self.wpe is not None:
            h = h + self.wpe(torch.arange(h.shape[1], device=h.device))[None]
        for i, blk in enumerate(self.blocks):
            h = F.gelu(blk(h), approximate="tanh")
            if i in hooks:
                h = hooks[i](h)
        if attention_mask is not None:
            m = attention_mask[..., None].to(h.dtype)
            pooled = (h * m).sum(1) / m.sum(1).clamp_min(1.0)
        else:
            pooled = h.mean(dim=1)
        return self._logits(pooled)


class GRUCell(nn.Module):
    """GRU cell with ``nn.GRU``'s gates (update, reset, candidate)."""

    def __init__(self, din: int, dh: int, *, device=None, generator=None):
        super().__init__()
        self.wi = _linear(din, 3 * dh, device, generator)
        self.wh = _linear(dh, 3 * dh, device, generator)

    def forward(self, h, x):
        i_r, i_z, i_n = self.wi(x).chunk(3, dim=-1)
        h_r, h_z, h_n = self.wh(h).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


class GRUModel(_Toy):
    """Stacked GRU classifier (reference modelings_gru.py): each layer runs
    its cell over time, ``layer_hooks`` fire on each layer's whole output
    sequence (b, seq, hidden), and the head reads the last valid step."""

    def __init__(self, cfg: ToyConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        super().__init__(cfg, device, generator)
        self.cells = nn.ModuleList([GRUCell(cfg.hidden_size, cfg.hidden_size, device=device,
                                            generator=generator)
                                    for _ in range(cfg.num_hidden_layers)])
        self.head = _linear(cfg.hidden_size, cfg.num_classes, device, generator)

    def forward(self, input_ids, attention_mask=None, layer_hooks=None):
        hooks = _block_hooks(layer_hooks)
        h = self._embed(input_ids)
        b = h.shape[0]
        for i, cell in enumerate(self.cells):
            state = h.new_zeros(b, self.config.hidden_size)
            steps = []
            for t in range(h.shape[1]):
                state = cell(state, h[:, t])
                steps.append(state)
            h = torch.stack(steps, dim=1)
            if i in hooks:
                h = hooks[i](h)
        if attention_mask is not None:
            idx = (attention_mask.sum(dim=1) - 1).clamp_min(0).long()
            final = h[torch.arange(b, device=h.device), idx]
        else:
            final = h[:, -1]
        return self._logits(final)
