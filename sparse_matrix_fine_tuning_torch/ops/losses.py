"""Memory-efficient causal-LM cross-entropy, chunked over tokens.

Counterpart of ``sparse_matrix_fine_tuning_tpu/ops/losses.py``.  The plain
loss materialises the (B, T, V) logits in fp32 twice (logits and
log-softmax); at B=4, T=512, V=32000 that is the largest activation of a
step.  ``chunked_causal_lm_loss`` never holds more than one (chunk, V) fp32
block: each chunk's logits are computed under ``torch.utils.checkpoint``,
so the backward recomputes them chunk by chunk instead of saving them, and
the head's parameters collect their gradient over all chunks.

Numerics as the full-logits loss: ``nll = logsumexp(logits_f32) -
logits_f32[label]``, mean over the unmasked positions (labels shifted by
one; ``ignore_index`` and zero rows of ``weights`` masked).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint


def _chunk_nll(x: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
               head: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    logits = head(x).float()                                     # (c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[:, None]).squeeze(-1)
    return ((lse - gold) * m).sum()


def chunked_causal_lm_loss(hidden: torch.Tensor, head: Callable[[torch.Tensor], torch.Tensor],
                           labels: torch.Tensor, *, ignore_index: int = -100,
                           weights: Optional[torch.Tensor] = None,
                           chunk_size: int = 1024) -> torch.Tensor:
    """Shifted causal-LM cross-entropy without the full logits.

    Args:
      hidden: (B, T, H) final hidden states (before the LM head).
      head: maps (N, H) to (N, V) logits; its parameters get gradients
        summed over all chunks.
      labels: (B, T) int labels; position t predicts token t+1, and
        ``ignore_index`` positions are masked.
      weights: optional (B,) 0/1 row mask for padded ragged-tail rows.
      chunk_size: tokens per chunk, each one (chunk_size, V) fp32 block.

    Returns: the scalar fp32 mean NLL over the unmasked positions.
    """
    b, t, h = hidden.shape
    sh = hidden[:, :-1, :].reshape(b * (t - 1), h)
    sl = labels[:, 1:]
    mask = sl != ignore_index
    if weights is not None:
        mask = mask & (weights[:, None] != 0)
    sl = torch.where(mask, sl, torch.zeros_like(sl)).reshape(-1).long()
    maskf = mask.reshape(-1).float()

    n = sh.shape[0]
    c = max(min(int(chunk_size), n), 1)
    total = hidden.new_zeros((), dtype=torch.float32)
    for start in range(0, n, c):
        stop = min(start + c, n)
        total = total + checkpoint(_chunk_nll, sh[start:stop], sl[start:stop],
                                   maskf[start:stop], head, use_reentrant=False)
    return total / maskf.sum().clamp_min(1.0)


def model_training_loss(model, input_ids, labels, *, attention_mask=None, positions=None,
                        layer_hooks=None, segment_ids=None,
                        weights: Optional[torch.Tensor] = None,
                        ignore_index: int = -100) -> torch.Tensor:
    """Forward and shifted CE for a causal LM of this package: chunked when
    ``model.config.loss_chunk > 0``, otherwise ``model.loss`` over full
    logits.  ``segment_ids`` (a packed batch) goes to the model; the seams
    need no mask here, since each segment's first label is already
    ``ignore_index``.  ``layer_hooks`` go to the model (``models/llama.py``)."""
    hidden, _ = model.model(input_ids, attention_mask, positions, segment_ids=segment_ids,
                            layer_hooks=layer_hooks)
    chunk = getattr(model.config, "loss_chunk", 0)
    if chunk:
        return chunked_causal_lm_loss(hidden, model.logits, labels, ignore_index=ignore_index,
                                      weights=weights, chunk_size=chunk)
    return model.loss(model.logits(hidden), labels, ignore_index=ignore_index,
                      weights=weights)
