"""Distributed Alignment Search (DAS) training.

Counterpart of ``sparse_matrix_fine_tuning_tpu/interventions/das.py``, the
pyvene tutorials' workflow: given a high-level ``CausalModel`` and a trained
network wrapped in ``ReftModel``, learn a (low-rank) rotation such that
interchanging the rotated coordinates of a hidden state reproduces the
causal model's counterfactual behaviour.  Each step is the source forward,
the intervened base forward (``ReftModel.swap_forward``), the
counterfactual loss and an Adam update (torch's, with ``optax.adam``'s
defaults) of the trainable interventions' parameters only
(``peft/surgery.trainable_filter`` with no extra paths: the network's own
weights are frozen).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from sparse_matrix_fine_tuning_torch.peft.surgery import trainable_filter

__all__ = ["train_das", "interchange_accuracy"]


def _default_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy for integer class labels (b,)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[:, None].long()).mean()


def train_das(reft, base_ids, source_ids, labels, *, base_locations, source_locations,
              steps: int = 200, learning_rate: float = 1e-2,
              loss_fn: Optional[Callable] = None, attention_mask=None,
              log_every: int = 0) -> list[float]:
    """Fit the trainable interventions so that ``swap_forward(base, source)``
    predicts the counterfactual ``labels`` (e.g. from
    ``CausalModel.generate_counterfactual_dataset``).  Inputs are tensors on
    the model's device.  Returns each step's loss, taken before its
    update."""
    loss_fn = loss_fn or _default_loss
    names = set(trainable_filter(reft, ()))
    params = [p for n, p in reft.named_parameters() if n in names]
    opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    history = []
    for i in range(steps):
        opt.zero_grad()
        logits = reft.swap_forward(base_ids, source_ids, base_locations=base_locations,
                                   source_locations=source_locations,
                                   base_mask=attention_mask, source_mask=attention_mask)
        loss = loss_fn(logits, labels)
        loss.backward()
        opt.step()
        history.append(float(loss))
        if log_every and i % log_every == 0:
            print(f"das step {i}: loss {history[-1]:.4f}")
    return history


@torch.no_grad()
def interchange_accuracy(reft, base_ids, source_ids, labels, *, base_locations,
                         source_locations, attention_mask=None) -> float:
    """Share of the examples whose intervened argmax is the causal model's
    counterfactual label."""
    logits = reft.swap_forward(base_ids, source_ids, base_locations=base_locations,
                               source_locations=source_locations,
                               base_mask=attention_mask, source_mask=attention_mask)
    pred = torch.argmax(logits, dim=-1)
    return float((pred == labels.to(pred.dtype)).float().mean())
