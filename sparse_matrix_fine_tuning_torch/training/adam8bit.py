"""8-bit-state AdamW: Adam's moments kept as 8-bit codes between steps.

Counterpart of ``sparse_matrix_fine_tuning_tpu/training/adam8bit.py`` (the
reference's bitsandbytes ``Adam8bit``, whose embeddings keep 32-bit state).
Each moment is stored as ``uint8`` codes into a log-spaced codebook (signed
for m, unsigned for v), one float32 absmax scale for each block of 256
values (the flattened tensor zero-padded to whole blocks), on the
parameter's device: about 2 bytes a value where AdamW keeps 8.  A parameter
whose JAX state path contains "embed" (``default_fp32_predicate``, the JAX
default) keeps float32 m and v.  The blocks are those of the JAX leaf: a
linear's weight (out, in) whose JAX path ends in ``kernel`` (in, out) is
quantized transposed, so that each block's scale covers the same values.

Every step dequantizes, updates in float32 and quantizes again, as the JAX
module's ``scale_by_adam8bit`` (:81-131), then decays and scales by the
learning rate as ``adamw8bit`` (:134-144) chains optax's
``add_decayed_weights`` and ``scale_by_learning_rate``:

  m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
  u = (m / bc1) / (sqrt(v / bc2) + eps)     bc = 1 - b ** count, float32
  p = p + (-lr) (u + wd p)                  u in the parameter's dtype

A value's code is the first codebook midpoint not below it (a left-side
search over the float32 midpoints); a block's scale is its absmax, at least
1e-30.  The count and the bias corrections live on the device, so a step
makes no host sync.  A parameter without a gradient takes a zero gradient,
as every leaf of the JAX update has one.

This module needs numpy and torch only.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BLOCK = 256

# log-spaced codebooks over [1e-7, 1] of the block-normalised values: signed
# (255 entries) for m, unsigned (256) for v
_POS = np.geomspace(1e-7, 1.0, 127)
SIGNED_CB = np.concatenate([-_POS[::-1], [0.0], _POS]).astype(np.float32)
UNSIGNED_CB = np.concatenate([[0.0], np.geomspace(1e-7, 1.0, 255)]).astype(np.float32)


def default_fp32_predicate(path: str) -> bool:
    return "embed" in path


def jax_paths(model: nn.Module, names: Optional[Iterable[str]] = None) -> dict[str, str]:
    """{parameter name: the lowercased path of the JAX state leaf it
    mirrors} (``layers/0/mlp/down_proj/blkdiag1``; an ``nn.Embedding``'s
    weight is ``.../embedding``, a linear's ``.../kernel``), the strings the
    JAX ``fp32_predicate`` tests."""
    from sparse_matrix_fine_tuning_torch.utils.jax_bridge import _VALUE, _jax_key

    names = [n for n, _ in model.named_parameters()] if names is None else list(names)
    return {n: _jax_key(model, n)[0][:-len(_VALUE)].lower() for n in names}


class _Codebook:
    """A codebook and its float32 midpoints on one device."""

    def __init__(self, values: np.ndarray, device: torch.device):
        self.values = torch.from_numpy(values).to(device)
        self.mids = (self.values[1:] + self.values[:-1]) / 2


def quantize(x: torch.Tensor, book: _Codebook) -> tuple[torch.Tensor, torch.Tensor]:
    """(codes (blocks, 256) uint8, scales (blocks, 1) float32) of ``x``."""
    flat = x.reshape(-1).float()
    blocks = F.pad(flat, (0, -flat.numel() % BLOCK)).view(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    codes = torch.searchsorted(book.mids, blocks / scale, right=False)
    return codes.to(torch.uint8), scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor, book: _Codebook,
               shape: torch.Size) -> torch.Tensor:
    """The float32 tensor of ``shape`` that ``codes`` and ``scale`` hold."""
    vals = book.values[codes.long()] * scale
    return vals.reshape(-1)[:shape.numel()].reshape(shape)


class AdamW8bit(torch.optim.Optimizer):
    """AdamW with 8-bit moments (the JAX ``adamw8bit``).

    A param group may carry ``paths``, the JAX state path of each of its
    parameters (``jax_paths``), which ``default_fp32_predicate`` tests and
    whose ``kernel`` leaves are quantized transposed; without it no
    parameter keeps float32 moments.  State of a parameter: ``count`` (int32), and
    ``mq``/``ms``/``vq``/``vs`` (codes and scales) or float32 ``m``/``v``;
    made when the optimizer is built, as optax's ``init``.
    """

    def __init__(self, params, lr: float = 1e-3, betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self._books: dict = {}
        self._fp32, self._kernel = {}, {}
        for group in self.param_groups:
            paths = group.get("paths") or [""] * len(group["params"])
            for p, path in zip(group["params"], paths):
                self._fp32[p] = default_fp32_predicate(path)
                self._kernel[p] = path.endswith("/kernel") and p.ndim == 2
                self.state[p].update(self.fresh_state(p))

    def _book(self, kind: str, device: torch.device) -> _Codebook:
        key = (kind, device)
        if key not in self._books:
            self._books[key] = _Codebook(SIGNED_CB if kind == "m" else UNSIGNED_CB, device)
        return self._books[key]

    def _quantize(self, p: torch.Tensor, moment: torch.Tensor, kind: str):
        """A moment of ``p`` quantized in its JAX leaf's layout."""
        return quantize(moment.T if self._kernel[p] else moment, self._book(kind, p.device))

    def _dequantize(self, p: torch.Tensor, state: dict, kind: str) -> torch.Tensor:
        shape = p.T.shape if self._kernel[p] else p.shape
        x = dequantize(state[f"{kind}q"], state[f"{kind}s"], self._book(kind, p.device), shape)
        return x.T if self._kernel[p] else x

    def fresh_state(self, p: torch.Tensor) -> dict:
        """A parameter's state before its first step (zero moments)."""
        state = {"count": torch.zeros((), dtype=torch.int32, device=p.device)}
        zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if self._fp32[p]:
            return {**state, "m": zeros, "v": zeros.clone()}
        mq, ms = self._quantize(p, zeros, "m")
        vq, vs = self._quantize(p, zeros, "v")
        return {**state, "mq": mq, "ms": ms, "vq": vq, "vs": vs}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                state = self.state[p]
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                state["count"] += 1
                c = state["count"].float()
                bc1, bc2 = 1.0 - b1 ** c, 1.0 - b2 ** c
                g32 = g.float()
                if "m" in state:
                    m, v = state["m"], state["v"]
                else:
                    m, v = self._dequantize(p, state, "m"), self._dequantize(p, state, "v")
                m = b1 * m + (1.0 - b1) * g32
                v = b2 * v + (1.0 - b2) * g32 * g32
                u = ((m / bc1) / (torch.sqrt(v / bc2) + eps)).to(p.dtype)
                if "m" in state:
                    state["m"], state["v"] = m, v
                else:
                    state["mq"], state["ms"] = self._quantize(p, m, "m")
                    state["vq"], state["vs"] = self._quantize(p, v, "v")
                if wd:
                    u = u + wd * p
                p.add_(u * -lr)
        return loss

