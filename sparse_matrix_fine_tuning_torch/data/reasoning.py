"""Reasoning / instruction-tuning datasets: the part the Alpaca harness uses.

A copy of part of ``sparse_matrix_fine_tuning_tpu/data/reasoning.py``
(reference pyreft/loreft/dataset.py:140-300): the task registry
``TASK_CONFIG``, prompt templating per task (``build_prompt``) and the raw
items from local JSON or the crc32-seeded synthetic generator, with the HPO
split semantics (``load_data_items``), and the reasoning harness's
tokenizing (``tokenize_reasoning``, with ``parse_positions`` and
``get_intervention_locations``).  ``tokenize_glue_reft`` is not copied yet
(ROADMAP.md queue A item 20).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Optional, Sequence

import numpy as np

from sparse_matrix_fine_tuning_torch.data.templates import (
    IGNORE_INDEX,
    alpaca_prompt_no_input_template,
    alpaca_prompt_template,
)

__all__ = ["IGNORE_INDEX", "TASK_CONFIG", "build_prompt", "get_intervention_locations",
           "load_data_items", "parse_positions", "tokenize_reasoning"]

# Task registry (values mirror reference pyreft/loreft/task_config.py:3-176).
TASK_CONFIG = {
    "commonsense": {
        "train_datasets": ["commonsense_170k"],
        "eval_datasets": ["boolq", "piqa", "social_i_qa", "hellaswag",
                          "winogrande", "ARC-Easy", "ARC-Challenge", "openbookqa"],
        "task_prompt_template": "%s\n",
        "trigger_tokens": "the correct answer is ",
        "generation_args": {
            True: {"max_new_tokens": 32, "do_sample": False},
            False: {"max_new_tokens": 32, "temperature": 0.1, "top_p": 0.75,
                    "top_k": 40, "num_beams": 4, "do_sample": True},
        },
    },
    "math": {
        "train_datasets": ["math_10k"],
        "eval_datasets": ["MultiArith", "gsm8k", "SVAMP", "mawps", "AddSub",
                          "AQuA", "SingleEq"],
        "task_prompt_template": alpaca_prompt_no_input_template,
        "trigger_tokens": "### Response:",
        "generation_args": {
            True: {"max_new_tokens": 512, "do_sample": False},
            False: {"max_new_tokens": 512, "temperature": 0.3, "top_p": 0.75,
                    "top_k": 40, "num_beams": 4, "do_sample": True},
        },
    },
    "alpaca": {
        "train_datasets": ["alpaca_data_cleaned"],
        "eval_datasets": ["alpaca_eval"],
        "task_prompt_template": alpaca_prompt_template,
        "trigger_tokens": "### Response:",
        "generation_args": {
            True: {"max_length": 2048, "do_sample": False},
            False: {"max_length": 2048, "no_repeat_ngram_size": 5,
                    "repetition_penalty": 1.1, "do_sample": False},
        },
    },
    "gsm8k": {
        "train_datasets": ["gsm8k"],
        "eval_datasets": ["gsm8k"],
        "task_prompt_template": alpaca_prompt_template,
        "trigger_tokens": "### Response:",
        "generation_args": {
            True: {"max_new_tokens": 256, "do_sample": False},
            False: {"max_new_tokens": 256, "temperature": 0.8, "top_p": 0.95,
                    "top_k": 40, "do_sample": True},
        },
    },
    # alpaca-shaped instruction-tuning tasks (reference task_config.py:122-159;
    # items carry instruction/input/output fields)
    "instruct": {
        "train_datasets": ["instruct"],
        "eval_datasets": ["alpaca_eval"],
        "task_prompt_template": alpaca_prompt_template,
        "trigger_tokens": "### Response:",
        "generation_args": {
            True: {"max_length": 2048, "do_sample": False},
            False: {"max_length": 2048, "no_repeat_ngram_size": 5,
                    "repetition_penalty": 1.1, "do_sample": False},
        },
    },
    "ultrafeedback": {
        "train_datasets": ["ultrafeedback"],
        "eval_datasets": ["alpaca_eval"],
        "task_prompt_template": alpaca_prompt_template,
        "trigger_tokens": "### Response:",
        "generation_args": {
            True: {"max_length": 2048, "do_sample": False},
            False: {"max_length": 2048, "no_repeat_ngram_size": 5,
                    "repetition_penalty": 1.1, "do_sample": False},
        },
    },
    # sequence classification through the ReFT wrapper (MoReFT GLUE,
    # reference moreft_glue.sh + task_config.py:160); datasets come from
    # the GLUE loaders, not this registry
    "glue": {"train_datasets": None, "eval_datasets": None,
             "task_prompt_template": None, "trigger_tokens": None},
}
# HPO variants evaluate on a held-out slice of the train set
TASK_CONFIG["tune_math"] = dict(TASK_CONFIG["math"],
                                eval_datasets=["math_10k"], _tune_of="math",
                                _num_eval=800)
TASK_CONFIG["tune_commonsense"] = dict(TASK_CONFIG["commonsense"],
                                       eval_datasets=["commonsense_170k"],
                                       _tune_of="commonsense", _num_eval=10000)


def parse_positions(positions: str):
    """"f7+l7" -> (7, 7); "f5" -> (5, 0); "l3" -> (0, 3)
    (reference pyreft/pyreft/dataset.py:48-59)."""
    first_n, last_n = 0, 0
    if "+" in positions:
        first_n = int(positions.split("+")[0].strip("f"))
        last_n = int(positions.split("+")[1].strip("l"))
    elif "f" in positions:
        first_n = int(positions.strip("f"))
    elif "l" in positions:
        last_n = int(positions.strip("l"))
    return first_n, last_n


def get_intervention_locations(*, last_position: int, first_n: int, last_n: int,
                               num_interventions: int, share_weights: bool = False,
                               pad_mode: str = "first"):
    """Padded per-layer token-position lists
    (reference pyreft/pyreft/dataset.py:62-108)."""
    _first_n, _last_n = first_n, last_n
    first_n = min(last_position // 2, _first_n)
    last_n = min(last_position // 2, _last_n)
    pad_amount = (_first_n - first_n) + (_last_n - last_n)
    pad_position = -1 if pad_mode == "first" else last_position
    if share_weights or (first_n == 0 or last_n == 0):
        position_list = (list(range(first_n))
                         + list(range(last_position - last_n, last_position))
                         + [pad_position] * pad_amount)
        return [position_list] * num_interventions
    left = list(range(first_n)) + [pad_position] * (_first_n - first_n)
    right = (list(range(last_position - last_n, last_position))
             + [pad_position] * (_last_n - last_n))
    if len(left) > len(right):
        right += [pad_position] * (len(left) - len(right))
    else:
        left += [pad_position] * (len(right) - len(left))
    return ([left] * (num_interventions // 2)
            + [right] * (num_interventions // 2))


# ----------------------------------------------------------------------
def build_prompt(task: str, item: dict, tokenizer_eos: str = "</s>"):
    """(prompt, full_input) per task (reference loreft/dataset.py:211-232)."""
    cfg = TASK_CONFIG[task.replace("tune_", "")] if task.startswith("tune_") \
        else TASK_CONFIG[task]
    tpl = cfg["task_prompt_template"]
    trig = cfg["trigger_tokens"]
    base_task = task.replace("tune_", "")
    if base_task == "commonsense":
        prompt = tpl % item["instruction"]
        full = prompt + trig + item["answer"] + tokenizer_eos
    elif base_task == "math":
        prompt = tpl % item["instruction"]
        full = prompt + item["output"] + tokenizer_eos
    elif base_task in ("alpaca", "instruct", "ultrafeedback"):
        # identical formatting for all three (reference dataset.py:217-221)
        if not item.get("input"):
            prompt = alpaca_prompt_no_input_template % item["instruction"]
        else:
            prompt = tpl % (item["instruction"], item["input"])
        full = prompt + item["output"] + tokenizer_eos
    elif base_task == "gsm8k":
        prompt = tpl % (
            "Answer the above question. First think step by step and then "
            "answer the final number.", item["question"])
        full = prompt + item["answer"].replace(
            "####", "The final answer is: ") + tokenizer_eos
    else:
        raise ValueError(f"unrecognized task {task}")
    return prompt, full


def load_data_items(task: str, dataset_name: str, data_dir: str,
                    split: str = "train", is_eval: bool = False,
                    max_n_example: Optional[int] = None, seed: int = 42,
                    smoke: bool = False, smoke_n: int = 64):
    """Load the raw item dicts from local JSON (LLM-Adapters layout:
    {data_dir}/{dataset_name}/{split}.json) or synthesize for smoke runs."""
    # synthetic data is seeded by dataset_name so a 7-dataset eval loop sees
    # 7 DIFFERENT datasets (round 1 produced identical accuracies everywhere)
    syn_seed = seed + zlib.crc32(f"{dataset_name}/{split}".encode()) % 100003
    if not smoke:
        for cand in (os.path.join(data_dir, dataset_name, f"{split}.json"),
                     os.path.join(data_dir, f"{dataset_name}.json")):
            if os.path.exists(cand):
                with open(cand) as f:
                    items = json.load(f)
                break
        else:
            print(f"[reasoning] no local data for {dataset_name}; using synthetic")
            items = _synthetic_items(task, smoke_n, syn_seed)
    else:
        items = _synthetic_items(task, smoke_n, syn_seed)
    # HPO split semantics (reference loreft/dataset.py:170-194)
    tcfg = TASK_CONFIG.get(task, {})
    num_eval = tcfg.get("_num_eval")
    if task.startswith("tune_") and num_eval:
        num_eval = min(num_eval, max(len(items) // 4, 1))
        items = items[-num_eval:] if is_eval else items[:-num_eval]
    if max_n_example is not None and len(items) > max_n_example:
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(items))[:max_n_example]
        items = [items[i] for i in idx]
    return items


def _synthetic_items(task: str, n: int, seed: int):
    """Tiny learnable tasks with the real templates so EM eval is meaningful."""
    rng = np.random.default_rng(seed)
    items = []
    base = task.replace("tune_", "")
    for i in range(n):
        if base in ("math", "gsm8k"):
            a, b = int(rng.integers(1, 6)), int(rng.integers(1, 6))
            q = f"What is {a} plus {b} ?"
            ans = str(a + b)
            if base == "math":
                items.append({"instruction": q,
                              "output": f"The answer is {ans}", "answer": ans})
            else:
                items.append({"question": q, "answer": f"#### {ans}"})
        elif base == "commonsense":
            y = int(rng.integers(0, 2))
            inst = (f"Question: is the sky word{'A' if y else 'B'} color ? "
                    f"Answer choices: true false")
            items.append({"instruction": inst,
                          "answer": "true" if y else "false"})
        else:  # alpaca
            items.append({"instruction": f"Repeat the word token{i % 7}",
                          "input": "", "output": f"token{i % 7}"})
    return items



def tokenize_reasoning(task: str, items: Sequence[dict], tokenizer,
                       max_length: int = 512, split: str = "train",
                       position: str = "f7+l7", num_interventions: int = 1,
                       share_weights: bool = True):
    """Padded numpy arrays.

    train: RIGHT-padded full sequences with IGNORE_INDEX labels on prompt
    and padding.  eval: LEFT-padded prompts for generation.  Both get a
    single leading pad "sink" token and intervention locations
    (reference loreft/dataset.py:253-283).
    """
    # EOS is appended as a TOKEN ID, never as template text: the "</s>"
    # string would be word-tokenized by the hash tokenizer
    pad_id = tokenizer.pad_token_id
    first_n, last_n = parse_positions(position)
    rows_ids, rows_labels, rows_locs = [], [], []
    for item in items:
        prompt, full = build_prompt(task, item, "")
        prompt_ids = tokenizer.encode_ids(prompt)[:max_length - 1]
        if split == "train":
            full_ids = (tokenizer.encode_ids(full)[:max_length - 1]
                        + [tokenizer.eos_token_id])
            labels = [IGNORE_INDEX] * min(len(prompt_ids), len(full_ids)) \
                + full_ids[len(prompt_ids):]
            ids = full_ids
        else:
            ids, labels = prompt_ids, None
        locs = get_intervention_locations(
            last_position=len(prompt_ids), first_n=first_n, last_n=last_n,
            num_interventions=num_interventions, share_weights=share_weights,
            pad_mode="first")
        # single leading pad ("sink") token; locations shift by 1
        ids = [pad_id] + ids
        if labels is not None:
            labels = [IGNORE_INDEX] + labels
        locs = [[p + 1 for p in lay] for lay in locs]
        rows_ids.append(ids)
        rows_labels.append(labels)
        rows_locs.append(locs)

    maxlen = min(max(len(r) for r in rows_ids), max_length + 1)
    n = len(rows_ids)
    input_ids = np.full((n, maxlen), pad_id, np.int32)
    attention_mask = np.zeros((n, maxlen), np.int32)
    out = {"input_ids": input_ids, "attention_mask": attention_mask,
           "intervention_locations": np.asarray(rows_locs, np.int32),
           "id": np.arange(n, dtype=np.int32)}
    if split == "train":
        labels_arr = np.full((n, maxlen), IGNORE_INDEX, np.int32)
    for i, ids in enumerate(rows_ids):
        ids = ids[:maxlen]
        if split == "train":
            input_ids[i, :len(ids)] = ids           # right-pad
            attention_mask[i, :len(ids)] = 1
            lab = rows_labels[i][:maxlen]
            labels_arr[i, :len(lab)] = lab
        else:
            input_ids[i, maxlen - len(ids):] = ids  # left-pad for generation
            attention_mask[i, maxlen - len(ids):] = 1
    if split == "train":
        out["labels"] = labels_arr
    return out
