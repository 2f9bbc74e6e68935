"""Batched prediction of the classification harnesses (GLUE, AG News).

Counterpart of ``sparse_matrix_fine_tuning_tpu/evaluation/predict.py``.  The
JAX module runs one jitted ``(state, ids, mask) -> logits`` function a batch
shape; here the loop is eager, under ``torch.no_grad()`` in ``eval()`` mode,
on the model's device.  As there, every batch has ``batch_size`` rows: the
tail is filled by repeating its last row (always a valid example; an
all-zero attention mask would put NaN into the softmax), and the filled
rows' outputs are dropped.

``locations`` (ReFT-intervened classification, MoReFT GLUE) is refused:
ROADMAP.md queue A item 24.
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_matrix_fine_tuning_torch.models.roberta import INTERVENTIONS_ITEM


@torch.no_grad()
def predict_logits(model: torch.nn.Module, data, batch_size: int = 64,
                   locations=None) -> np.ndarray:
    """The classifier's (n, num_labels) float32 logits over ``data``, a dict
    with "input_ids" and "attention_mask" (array-likes, (n, L))."""
    if locations is not None:
        raise NotImplementedError(f"predict with intervention locations (MoReFT GLUE): "
                                  f"{INTERVENTIONS_ITEM}")
    model.eval()
    device = next(model.parameters()).device
    ids = np.asarray(data["input_ids"])
    mask = np.asarray(data["attention_mask"])
    n = len(ids)
    outs = []
    for s in range(0, n, batch_size):
        b_ids, b_mask = ids[s:s + batch_size], mask[s:s + batch_size]
        k = len(b_ids)
        if k < batch_size:
            reps = batch_size - k
            b_ids = np.concatenate([b_ids, np.repeat(b_ids[-1:], reps, 0)])
            b_mask = np.concatenate([b_mask, np.repeat(b_mask[-1:], reps, 0)])
        logits = model(torch.from_numpy(b_ids).long().to(device),
                       torch.from_numpy(b_mask).long().to(device))
        outs.append(logits[:k].float().cpu().numpy())
    if outs:
        return np.concatenate(outs)
    # an empty split keeps the logit width, so that predict_classes still
    # takes the argmax of a multi-class model
    width = getattr(getattr(model, "config", None), "num_labels", 1)
    return np.zeros((0, width), np.float32)


def predict_classes(model: torch.nn.Module, data, batch_size: int = 64,
                    locations=None) -> np.ndarray:
    """argmax predictions, or the raw scores of a single-logit regression head."""
    logits = predict_logits(model, data, batch_size, locations=locations)
    if logits.shape[-1] == 1:
        return logits[:, 0]
    return np.argmax(logits, -1)
