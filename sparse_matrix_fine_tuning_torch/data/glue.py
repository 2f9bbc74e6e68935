"""GLUE data pipeline of the port.

A numpy-only copy of ``sparse_matrix_fine_tuning_tpu/data/glue.py``: the
reference's ``task_to_keys`` (run_glue.py:66-77), the label counts, the
learnable synthetic splits, ``load_glue_raw`` and ``tokenize_glue``, which
give the JAX functions' arrays bit for bit (``tests/test_torch_glue_data.py``).

One change: ``load_glue_raw`` reads HF ``datasets`` from the local cache
only (``load_dataset_offline``: HF's offline mode around the call), so a
machine without the data falls back to the synthetic splits at once and
never reaches for the network (the JAX function retries the hub first).
With a local cache it reads the same data.
"""

from __future__ import annotations

import os
import sys

import numpy as np

OFFLINE_FLAGS = ("HF_DATASETS_OFFLINE", "HF_HUB_OFFLINE")

TASK_TO_KEYS = {
    "cola": ("sentence", None),
    "mnli": ("premise", "hypothesis"),
    "mrpc": ("sentence1", "sentence2"),
    "qnli": ("question", "sentence"),
    "qqp": ("question1", "question2"),
    "rte": ("sentence1", "sentence2"),
    "sst2": ("sentence", None),
    "stsb": ("sentence1", "sentence2"),
    "wnli": ("sentence1", "sentence2"),
}

TASK_NUM_LABELS = {
    "cola": 2, "mnli": 3, "mrpc": 2, "qnli": 2, "qqp": 2,
    "rte": 2, "sst2": 2, "stsb": 1, "wnli": 2,
}

_SYN_VOCAB = [
    "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel",
    "india", "juliet", "kilo", "lima", "mike", "november", "oscar", "papa",
]


def load_dataset_offline(*args):
    """``datasets.load_dataset(*args)`` with HF's offline mode on for the
    call: the environment flags (read when ``datasets`` is first imported)
    and the flags of ``datasets.config`` and ``huggingface_hub.constants``
    where they are imported already; all restored after."""
    saved = {k: os.environ.get(k) for k in OFFLINE_FLAGS}
    os.environ.update(dict.fromkeys(OFFLINE_FLAGS, "1"))
    try:
        import datasets as hfds

        mods = [m for m in (hfds.config, sys.modules.get("huggingface_hub.constants")) if m]
        flags = [(m, k, getattr(m, k)) for m in mods for k in OFFLINE_FLAGS if hasattr(m, k)]
        for m, k, _ in flags:
            setattr(m, k, True)
        try:
            return hfds.load_dataset(*args)
        finally:
            for m, k, v in flags:
                setattr(m, k, v)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _synthetic_split(task: str, n: int, seed: int, test: bool = False):
    """Learnable synthetic sentences: the label is encoded by marker words,
    so a working model/optimizer must reach high metric values."""
    rng = np.random.default_rng(seed)
    num_labels = TASK_NUM_LABELS[task]
    k1, k2 = TASK_TO_KEYS[task]
    rows = {k1: []}
    if k2:
        rows[k2] = []
    labels = []
    markers = ["positive wonderful great", "negative terrible awful",
               "neutral plain ordinary"]
    for i in range(n):
        if task == "stsb":
            y = float(rng.uniform(0, 5))
            base = [_SYN_VOCAB[j] for j in rng.integers(0, 16, 6)]
            s1 = " ".join(base)
            # similarity ~ overlap
            n_keep = int(round(y))
            s2 = " ".join(base[:n_keep] + [_SYN_VOCAB[j] for j in rng.integers(0, 16, 6 - n_keep)])
            rows[k1].append(s1)
            rows[k2].append(s2)
            labels.append(y)
        else:
            y = int(rng.integers(0, num_labels))
            words = [_SYN_VOCAB[j] for j in rng.integers(0, 16, 5)]
            s1 = markers[y] + " " + " ".join(words)
            rows[k1].append(s1)
            if k2:
                rows[k2].append(" ".join([_SYN_VOCAB[j] for j in rng.integers(0, 16, 5)]))
            labels.append(y)
    if test:
        labels = [-1] * n  # hidden test labels, like the GLUE server splits
    return rows, np.asarray(labels)


def load_glue_raw(task: str, smoke: bool = False, smoke_n: int = 256):
    """Returns {split: (texts_dict, labels)}.  Real HF datasets when
    available; synthetic when ``smoke`` or loading fails."""
    splits = {}
    if not smoke:
        try:
            raw = load_dataset_offline("glue", task)
            for split in raw:
                k1, k2 = TASK_TO_KEYS[task]
                texts = {k1: raw[split][k1]}
                if k2:
                    texts[k2] = raw[split][k2]
                labels = np.asarray(raw[split]["label"])
                splits[split] = (texts, labels)
            return splits
        except Exception as e:
            print(f"[glue] falling back to synthetic data ({type(e).__name__}: {e})")
    names = ["train", "validation", "test"]
    if task == "mnli":
        names = ["train", "validation_matched", "validation_mismatched",
                 "test_matched", "test_mismatched"]
    import zlib
    task_seed = zlib.crc32(task.encode()) % 1000  # stable across processes
    for i, split in enumerate(names):
        n = smoke_n if split == "train" else max(smoke_n // 4, 32)
        splits[split] = _synthetic_split(task, n, seed=17 * i + task_seed,
                                         test=split.startswith("test"))
    return splits


def tokenize_glue(task: str, splits: dict, tokenizer, max_seq_length: int = 128):
    """{split: {input_ids, attention_mask, labels}} as numpy arrays."""
    k1, k2 = TASK_TO_KEYS[task]
    out = {}
    for split, (texts, labels) in splits.items():
        ids, mask = tokenizer.encode_batch(
            texts[k1], texts.get(k2) if k2 else None, max_length=max_seq_length)
        lab = np.asarray(labels)
        lab = lab.astype(np.float32) if task == "stsb" else lab.astype(np.int32)
        out[split] = {"input_ids": ids, "attention_mask": mask, "labels": lab}
    return out
