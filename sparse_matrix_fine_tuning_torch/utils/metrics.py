"""Task metrics of the port, implemented directly (no ``evaluate`` dependency).

A copy of ``sparse_matrix_fine_tuning_tpu/utils/metrics.py``; its results
equal the JAX module's bit for bit (``tests/test_torch_glue_data.py``).

Covers every metric the reference consumes: GLUE (matthews, acc, f1,
pearson/spearman -- run_glue.py metric selection), exact-match accuracy for
reasoning, and MMLU subject accuracy.
"""

from __future__ import annotations

import numpy as np


def accuracy(preds, labels) -> float:
    preds, labels = np.asarray(preds), np.asarray(labels)
    return float((preds == labels).mean())


def f1_score(preds, labels, positive: int = 1) -> float:
    preds, labels = np.asarray(preds), np.asarray(labels)
    tp = int(((preds == positive) & (labels == positive)).sum())
    fp = int(((preds == positive) & (labels != positive)).sum())
    fn = int(((preds != positive) & (labels == positive)).sum())
    if tp == 0:
        return 0.0
    prec = tp / (tp + fp)
    rec = tp / (tp + fn)
    return float(2 * prec * rec / (prec + rec))


def matthews_corrcoef(preds, labels) -> float:
    preds, labels = np.asarray(preds), np.asarray(labels)
    tp = int(((preds == 1) & (labels == 1)).sum())
    tn = int(((preds == 0) & (labels == 0)).sum())
    fp = int(((preds == 1) & (labels == 0)).sum())
    fn = int(((preds == 0) & (labels == 1)).sum())
    denom = np.sqrt(float(tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    if denom == 0:
        return 0.0
    return float((tp * tn - fp * fn) / denom)


def pearson_corr(preds, labels) -> float:
    preds, labels = np.asarray(preds, np.float64), np.asarray(labels, np.float64)
    if preds.std() == 0 or labels.std() == 0:
        return 0.0
    return float(np.corrcoef(preds, labels)[0, 1])


def _rankdata(x):
    order = np.argsort(x)
    ranks = np.empty(len(x), np.float64)
    ranks[order] = np.arange(1, len(x) + 1)
    # average ties
    vals, inv, counts = np.unique(x, return_inverse=True, return_counts=True)
    sums = np.zeros(len(vals))
    np.add.at(sums, inv, ranks)
    return sums[inv] / counts[inv]


def spearman_corr(preds, labels) -> float:
    return pearson_corr(_rankdata(np.asarray(preds)), _rankdata(np.asarray(labels)))


# GLUE metric selection (mirrors evaluate.load("glue") behaviour per task)
GLUE_METRICS = {
    "cola": lambda p, l: {"matthews_correlation": matthews_corrcoef(p, l)},
    "sst2": lambda p, l: {"accuracy": accuracy(p, l)},
    "mrpc": lambda p, l: {"accuracy": accuracy(p, l), "f1": f1_score(p, l)},
    "qqp": lambda p, l: {"accuracy": accuracy(p, l), "f1": f1_score(p, l)},
    "stsb": lambda p, l: {"pearson": pearson_corr(p, l),
                          "spearmanr": spearman_corr(p, l)},
    "mnli": lambda p, l: {"accuracy": accuracy(p, l)},
    "qnli": lambda p, l: {"accuracy": accuracy(p, l)},
    "rte": lambda p, l: {"accuracy": accuracy(p, l)},
    "wnli": lambda p, l: {"accuracy": accuracy(p, l)},
}

# the metric each task tunes on (reference run_glue.py HPO target metrics)
GLUE_TARGET_METRIC = {
    "cola": "matthews_correlation",
    "sst2": "accuracy",
    "mrpc": "f1",
    "qqp": "f1",
    "stsb": "pearson",
    "mnli": "accuracy",
    "qnli": "accuracy",
    "rte": "accuracy",
    "wnli": "accuracy",
}


def glue_compute(task: str, preds, labels) -> dict:
    return GLUE_METRICS[task](preds, labels)
