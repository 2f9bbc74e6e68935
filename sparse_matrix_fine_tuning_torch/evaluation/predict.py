"""Batched prediction of the classification harnesses (GLUE, AG News).

Counterpart of ``sparse_matrix_fine_tuning_tpu/evaluation/predict.py``.  The
JAX module runs one jitted ``(state, ids, mask) -> logits`` function a batch
shape; here the loop is eager, under ``torch.no_grad()`` in ``eval()`` mode,
on the model's device.  As there, every batch has ``batch_size`` rows: the
tail is filled by repeating its last row (always a valid example; an
all-zero attention mask would put NaN into the softmax), and the filled
rows' outputs are dropped.

``locations`` (n, num_interventions, p): ReFT-intervened classification
(MoReFT GLUE), each batch's rows passed to the model as its
``intervention_locations``, the tail filled like the inputs.
"""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def predict_logits(model: torch.nn.Module, data, batch_size: int = 64,
                   locations=None) -> np.ndarray:
    """The classifier's (n, num_labels) float32 logits over ``data``, a dict
    with "input_ids" and "attention_mask" (array-likes, (n, L)); with
    ``locations``, a ReFT model's intervened forward."""
    model.eval()
    device = next(model.parameters()).device
    arrays = [np.asarray(data["input_ids"]), np.asarray(data["attention_mask"])]
    if locations is not None:
        arrays.append(np.asarray(locations))
    n = len(arrays[0])
    outs = []
    for s in range(0, n, batch_size):
        batch = [a[s:s + batch_size] for a in arrays]
        k = len(batch[0])
        if k < batch_size:
            batch = [np.concatenate([a, np.repeat(a[-1:], batch_size - k, 0)]) for a in batch]
        ids, mask, *locs = (torch.from_numpy(a).long().to(device) for a in batch)
        kw = {"intervention_locations": locs[0]} if locs else {}
        logits = model(ids, mask, **kw)
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
