"""MMLU evaluation data + A/B/C/D logit scoring.

The reference's qlora harness evaluates 5-shot MMLU by taking the logits at
the answer position and argmaxing over the A/B/C/D token ids, reporting
accuracy by subject (reference qlora/qlora_monarch.py:671-715).

Counterpart of ``sparse_matrix_fine_tuning_tpu/data/mmlu.py``: the prompt
formatting and the loaders (local CSV/JSON files, else a synthetic
learnable 4-choice task) are copies; the scoring is an eager
``torch.no_grad()`` loop over the model in ``eval()`` mode on the model's
device.  ``mmlu_choice_logits`` returns the (n, 4) logits that
``mmlu_accuracy`` argmaxes, so that they can be held against another
model's.
"""

from __future__ import annotations

import csv
import json
import os
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np
import torch

ABCD = ["A", "B", "C", "D"]


def format_mmlu_example(question: str, choices: Sequence[str],
                        answer: Optional[str] = None) -> str:
    s = question.strip() + "\n"
    for letter, choice in zip(ABCD, choices):
        s += f"{letter}. {choice}\n"
    s += "Answer:"
    if answer is not None:
        s += f" {answer}\n\n"
    return s


def build_fewshot_prompt(dev_examples: list, item: dict, k: int = 5) -> str:
    """k-shot prompt: subject header + k dev examples + the question."""
    subject = item.get("subject", "misc").replace("_", " ")
    prompt = (f"The following are multiple choice questions (with answers) "
              f"about {subject}.\n\n")
    for ex in dev_examples[:k]:
        prompt += format_mmlu_example(ex["question"], ex["choices"], ex["answer"])
    prompt += format_mmlu_example(item["question"], item["choices"])
    return prompt


def _load_qlora_mmlu_jsonl(path: str):
    """The qlora repo's MMLU artifact format (reference
    qlora/data/mmlu/zero_shot_mmlu_val.json, loaded at qlora.py:636-660):
    JSON-lines of {subject, input, output} where ``input`` is the fully
    formatted prompt ending in "Answer:" and ``output`` is the letter.
    Returned as pre-formatted items ({prompt, answer, subject})."""
    items = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            items.append({"prompt": d["input"], "answer": d["output"].strip(),
                          "subject": d.get("subject", "misc")})
    return items


def load_mmlu_items(data_dir: str, split: str = "eval", smoke: bool = False,
                    smoke_n: int = 32, seed: int = 0):
    """Items: {question, choices[4], answer in ABCD, subject} -- or
    pre-formatted {prompt, answer, subject} for qlora-format files."""
    if not smoke:
        for cand in (os.path.join(data_dir, "mmlu", f"{split}.json"),
                     os.path.join(data_dir, f"mmlu_{split}.json")):
            if os.path.exists(cand):
                with open(cand) as f:
                    head = f.readline().strip()
                if head.startswith("{") and '"input"' in head:
                    return _load_qlora_mmlu_jsonl(cand)
                with open(cand) as f:
                    return json.load(f)
        # qlora artifact names (zero_shot_mmlu_val.json / five_shot_mmlu_*.json)
        for fn in (f"zero_shot_mmlu_{'val' if split == 'eval' else split}.json",
                   f"five_shot_mmlu_{'val' if split == 'eval' else split}.json"):
            cand = os.path.join(data_dir, "mmlu", fn)
            if os.path.exists(cand):
                return _load_qlora_mmlu_jsonl(cand)
        csv_dir = os.path.join(data_dir, "mmlu", split)
        if os.path.isdir(csv_dir):
            items = []
            for fn in sorted(os.listdir(csv_dir)):
                if not fn.endswith(".csv"):
                    continue
                subject = fn.rsplit("_", 1)[0]
                with open(os.path.join(csv_dir, fn)) as f:
                    for row in csv.reader(f):
                        items.append({"question": row[0], "choices": row[1:5],
                                      "answer": row[5], "subject": subject})
            if items:
                return items
        print("[mmlu] no local data; using synthetic")
    rng = np.random.default_rng(seed)
    items = []
    subjects = ["arith", "letters"]
    for i in range(smoke_n):
        sub = subjects[i % 2]
        ans_idx = int(rng.integers(0, 4))
        word = ["apple", "banana", "cherry", "date"][ans_idx]
        q = f"Which word is the marker word {word} ?"
        choices = ["apple", "banana", "cherry", "date"]
        items.append({"question": q, "choices": choices,
                      "answer": ABCD[ans_idx], "subject": sub})
    return items


def abcd_token_ids(tokenizer) -> list[int]:
    """Token ids of the " A" style continuations; with the hash tokenizer
    these are the ids of the bare letters."""
    return [tokenizer.encode_ids(f" {letter}", add_bos=False)[-1] for letter in ABCD]


def encode_mmlu_prompts(tokenizer, items: list, dev_items: Optional[list] = None,
                        k_shot: int = 5, max_length: int = 1024):
    """(ids, mask), int32 (n, T): each item's k-shot prompt (or its
    pre-formatted qlora prompt), truncated from the HEAD to ``max_length``
    tokens so that the scored "Answer:" position survives, and LEFT-padded
    so that it is always the last."""
    dev_by_subject = defaultdict(list)
    for ex in (dev_items or []):
        dev_by_subject[ex.get("subject", "misc")].append(ex)
    prompts = []
    for item in items:
        if "prompt" in item:  # qlora pre-formatted (zero-shot) artifact
            prompts.append(item["prompt"])
            continue
        dev = dev_by_subject.get(item.get("subject", "misc"), [])
        prompts.append(build_fewshot_prompt(dev, item, k=k_shot))
    enc = [tokenizer.encode_ids(p)[-max_length:] for p in prompts]
    maxlen = max(len(e) for e in enc)
    n = len(enc)
    ids = np.full((n, maxlen), tokenizer.pad_token_id, np.int32)
    mask = np.zeros((n, maxlen), np.int32)
    for i, e in enumerate(enc):
        ids[i, maxlen - len(e):] = e
        mask[i, maxlen - len(e):] = 1
    return ids, mask


@torch.no_grad()
def mmlu_choice_logits(model, tokenizer, items: list, dev_items: Optional[list] = None,
                       k_shot: int = 5, max_length: int = 1024,
                       batch_size: int = 8) -> np.ndarray:
    """(n, 4) float32: the last position's logits at the A/B/C/D ids, batch
    by batch, the tail batch filled with repeats of its last row."""
    ids, mask = encode_mmlu_prompts(tokenizer, items, dev_items, k_shot, max_length)
    abcd = abcd_token_ids(tokenizer)
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    out = []
    try:
        for s in range(0, len(ids), batch_size):
            b_ids, b_mask = ids[s:s + batch_size], mask[s:s + batch_size]
            n_valid = len(b_ids)
            if n_valid < batch_size:
                reps = batch_size - n_valid
                b_ids = np.concatenate([b_ids, np.repeat(b_ids[-1:], reps, 0)])
                b_mask = np.concatenate([b_mask, np.repeat(b_mask[-1:], reps, 0)])
            logits = model(torch.from_numpy(b_ids).long().to(device),
                           attention_mask=torch.from_numpy(b_mask).long().to(device))
            last = logits[:n_valid, -1, abcd].float().cpu().numpy()
            out.append(last)
    finally:
        model.train(was_training)
    return np.concatenate(out)


def mmlu_scores(items: list, choice_logits: np.ndarray) -> dict:
    """Per-subject accuracies and the overall 'mmlu_eval_accuracy' of the
    argmax over each row of ``choice_logits``."""
    preds = np.argmax(choice_logits, -1)
    per_subject = defaultdict(list)
    correct = []
    for item, p in zip(items, preds):
        ok = ABCD[int(p)] == item["answer"]
        correct.append(ok)
        per_subject[item.get("subject", "misc")].append(ok)
    metrics = {f"mmlu_eval_accuracy_{sub}": float(np.mean(v))
               for sub, v in per_subject.items()}
    metrics["mmlu_eval_accuracy"] = float(np.mean(correct)) if correct else 0.0
    return metrics


def mmlu_accuracy(model, tokenizer, items: list, dev_items: Optional[list] = None,
                  k_shot: int = 5, max_length: int = 1024, batch_size: int = 8) -> dict:
    """Accuracy via answer-position logits over A/B/C/D token ids
    (reference qlora_monarch.py:671-715).  Returns metrics dict with
    per-subject accuracies and the overall 'mmlu_eval_accuracy'."""
    return mmlu_scores(items, mmlu_choice_logits(model, tokenizer, items, dev_items, k_shot,
                                                 max_length, batch_size))
