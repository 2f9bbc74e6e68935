"""BOFT, butterfly orthogonal fine-tuning: the baseline of the paper's GLUE
table, PyTorch.

Counterpart of ``sparse_matrix_fine_tuning_tpu/peft/boft.py`` (peft's BOFT
Linear):

  y = ((x @ R) @ W^T) * boft_s + bias,   R = M_{F-1} @ ... @ M_0,
  M_i = P_i @ blockdiag(Cayley(boft_R[i])) @ P_i^T

The rotation acts on the input features; ``boft_R`` starts at zero, so R
starts at the identity; P_i are peft's block-butterfly permutations
(``_butterfly_perm``); ``boft_s`` (ones) scales each output feature.  For a
permutation matrix with P[j, perm[j]] = 1, x @ P = x[..., argsort(perm)] and
x @ P^T = x[..., perm], so each factor from F-1 down to 0 is a gather, a
block einsum and a gather.  The Cayley transform solves in float32
(``torch.linalg.solve``, a library call as ``jnp.linalg.solve`` is in
JAX); the rotation is plain PyTorch, as JAX runs it by einsum outside any
Pallas kernel; the frozen dense product accumulates in fp32 and rounds to
the input's dtype.

Multiplicative dropout (peft's ``MultiplicativeDropoutLayer``): in
``train()`` with ``boft_dropout`` p > 0, exactly int(p * D) of one factor's
D blocks, the factor and the blocks drawn at random, become the identity.
The draws come from the layer's own CPU ``torch.Generator`` (seeded from the
caller's), so that a run on the card draws the masks of the same run on the
CPU; the JAX package's masks come from its own RNG and differ.

Trainable (``peft/surgery.trainable_filter``): ``boft_R``, ``boft_s``, and
the bias where ``bias`` is "boft_only" or "all"; ``init_boft`` with "all"
makes every bias of the model trainable, LayerNorm's too (peft's bias
option).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparse_matrix_fine_tuning_torch.peft.surgery import _iter_parents


def cayley(skew_params: torch.Tensor) -> torch.Tensor:
    """Batched Cayley transform, peft's convention: S = 0.5 (R - R^T),
    Q = (I + S)^-1 (I - S).  Zero input gives the identity; the result is
    orthogonal."""
    S = 0.5 * (skew_params - skew_params.transpose(-1, -2))
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    return torch.linalg.solve(eye + S, eye - S)


class _Permute(torch.autograd.Function):
    """``x[..., idx]`` for a permutation ``idx`` whose inverse is ``inv``; its
    gradient is the gather ``g[..., inv]`` (autograd's own backward of an
    index is a sort and a scatter-add, 58 of a RoBERTa-large BOFT step's 91
    ms on the card)."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(inv)
        return x[..., idx]

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        return grad[..., inv], None, None


@functools.lru_cache(maxsize=256)
def _butterfly_perm(n: int, b: int, r: int, n_butterfly_factor: int) -> tuple:
    """peft ``BOFTLayer.block_butterfly_perm``: the indices that regroup the
    length-n feature axis so that the next factor's blocks mix features
    further apart.  A hashable tuple."""
    if n_butterfly_factor == 0:
        return tuple(range(n))
    if b * r * 2 > n:
        raise ValueError("Invalid number of blocks!")
    block_size = n // b
    indices = np.arange(n)
    step = block_size / r
    initial_order = np.arange(block_size)
    sorted_order = np.empty(block_size, dtype=np.int64)
    sorted_seq = np.concatenate([np.arange(0, step, 2), np.arange(1, step, 2)])
    for i, pos in enumerate(sorted_seq):
        sorted_order[int(i * r):int(i * r + r)] = initial_order[int(pos * r):int(pos * r + r)]
    for i in range(0, n, block_size):
        indices[i:i + block_size] = indices[i:i + block_size][sorted_order]
    return tuple(int(i) for i in indices)


class BOFTLinear(nn.Module):
    """A frozen dense linear with a trainable butterfly-orthogonal rotation of
    its input and a per-output scale."""

    adapter_params = ("boft_R", "boft_s")  # trainable (peft/surgery.py)

    def __init__(self, in_features: int, out_features: int, *, weights: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, block_size: int = 0, block_num: int = 0,
                 n_butterfly_factor: int = 1, dropout: float = 0.0, bias_mode: str = "none",
                 param_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        """
        Args:
          weights: the dense (out_features, in_features) weight, frozen, kept
            in ``param_dtype`` on its own device (the layer's).
          bias: the dense bias; trains with ``bias_mode`` "boft_only" or "all".
          block_size / block_num: exactly one > 0, over ``in_features``.
          generator: a CPU generator whose next draw seeds the dropout's
            (0 when None).
        """
        super().__init__()
        if (block_size > 0) == (block_num > 0):
            raise ValueError("exactly one of boft_block_size/boft_block_num must be set")
        if block_num > 0:
            if in_features % block_num:
                raise ValueError(f"in_features {in_features} % boft_block_num {block_num} != 0")
            block_size = in_features // block_num
        if in_features % block_size:
            raise ValueError(f"in_features {in_features} % boft_block_size {block_size} != 0")
        block_num = in_features // block_size
        n_factors = max(n_butterfly_factor, 1)
        if n_factors > 1:  # peft update_layer's rules for multi-factor butterflies
            if block_num % (2 ** (n_factors - 1)) or block_num % 2:
                raise ValueError(f"boft_block_num {block_num} incompatible with "
                                 f"n_butterfly_factor {n_factors}")
            if block_size % 2:
                raise ValueError(f"boft_block_size {block_size} must be even for butterflies")
        device = weights.device
        self.in_features = in_features
        self.out_features = out_features
        self.block_size = block_size
        self.n_blocks = block_num
        self.n_factors = n_factors
        self.dense = nn.Parameter(weights.detach().to(param_dtype), requires_grad=False)
        self.bias = (nn.Parameter(bias.detach().to(param_dtype), requires_grad=False)
                     if bias is not None else None)
        self.bias_trains = bias is not None and bias_mode in ("boft_only", "all")
        self.boft_R = nn.Parameter(torch.zeros(n_factors, block_num, block_size, block_size,
                                               dtype=param_dtype, device=device))
        self.boft_s = nn.Parameter(torch.ones(out_features, dtype=param_dtype, device=device))
        self.dropout_p = float(dropout)
        seed = 0 if generator is None else int(torch.randint(
            2 ** 62, (), generator=generator))
        self.drop_generator = torch.Generator().manual_seed(seed)
        for i in range(n_factors):
            perm = torch.tensor(self._perm(i), device=device)
            self.register_buffer(f"perm_{i}", perm, persistent=False)
            self.register_buffer(f"inv_perm_{i}", torch.argsort(perm), persistent=False)

    def _perm(self, i: int) -> tuple:
        """P_i, built with b = block_num / 2^i (peft update_layer)."""
        return _butterfly_perm(self.in_features, self.n_blocks // (2 ** i), self.block_size // 2,
                               self.n_factors - 1)

    def _dropped(self, Q: torch.Tensor, deterministic: Optional[bool]) -> torch.Tensor:
        """In training, int(p * D) of one random factor's D blocks become the
        identity."""
        det = not self.training if deterministic is None else deterministic
        if self.dropout_p <= 0 or det:
            return Q
        n_factors, n_blocks, size, _ = Q.shape
        factor = int(torch.randint(n_factors, (), generator=self.drop_generator))
        chosen = torch.randperm(n_blocks, generator=self.drop_generator)[
            :int(self.dropout_p * n_blocks)]
        full = torch.zeros(n_factors, n_blocks, 1, 1)
        full[factor, chosen] = 1.0
        full = full.to(Q.device)
        eye = torch.eye(size, dtype=Q.dtype, device=Q.device).expand_as(Q)
        return (1 - full) * Q + full * eye

    def forward(self, x: torch.Tensor, *, deterministic: Optional[bool] = None) -> torch.Tensor:
        Q = self._dropped(cayley(self.boft_R.float()), deterministic).to(x.dtype)
        lead = x.shape[:-1]
        h = x
        for i in range(self.n_factors - 1, -1, -1):
            perm, inv = getattr(self, f"perm_{i}"), getattr(self, f"inv_perm_{i}")
            hb = _Permute.apply(h, inv, perm).reshape(*lead, self.n_blocks, self.block_size)
            hb = torch.einsum("...nb,nbc->...nc", hb, Q[i])
            h = _Permute.apply(hb.reshape(*lead, self.in_features), perm, inv)
        y = F.linear(h, self.dense.to(x.dtype)) * self.boft_s.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def init_boft(model: nn.Module, peft_config: dict, *, generator: Optional[torch.Generator] = None,
              param_dtype: torch.dtype = torch.float32) -> list[str]:
    """Replace the target ``nn.Linear``s with BOFT layers, in place; returns
    their names.  ``generator``: a CPU generator that seeds each layer's
    dropout draws (seeded 0 when None).  With ``bias`` "all" every bias of the
    model trains; the head's paths train through the trainer's extra paths."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    targets = set(peft_config["target_modules"])
    adapted = []
    for parent, name, child in list(_iter_parents(model)):
        if name not in targets or not isinstance(child, nn.Linear):
            continue
        layer = BOFTLinear(
            child.in_features, child.out_features, weights=child.weight.detach(),
            bias=child.bias.detach() if child.bias is not None else None,
            block_size=peft_config.get("boft_block_size", 0) or 0,
            block_num=peft_config.get("boft_block_num", 0) or 0,
            n_butterfly_factor=peft_config.get("boft_n_butterfly_factor", 2),
            dropout=peft_config.get("boft_dropout", 0.0),
            bias_mode=peft_config.get("bias", "none"), param_dtype=param_dtype,
            generator=generator)
        setattr(parent, name, layer)
        adapted.append(name)
    if peft_config.get("bias") == "all":
        for module in model.modules():
            if isinstance(getattr(module, "bias", None), nn.Parameter):
                module.bias_trains = True
    return adapted
