"""Reasoning / instruction-tuning datasets: the part the Alpaca harness uses.

A copy of part of ``sparse_matrix_fine_tuning_tpu/data/reasoning.py``
(reference pyreft/loreft/dataset.py:140-300): the task registry
``TASK_CONFIG``, prompt templating per task (``build_prompt``) and the raw
items from local JSON or the crc32-seeded synthetic generator, with the HPO
split semantics (``load_data_items``).  Tokenizing for the reasoning and
GLUE-ReFT harnesses (``tokenize_reasoning``, ``tokenize_glue_reft``) and the
ReFT intervention locations are not copied yet (ROADMAP.md queue A items 18
and 20).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Optional

import numpy as np

from sparse_matrix_fine_tuning_torch.data.templates import (
    IGNORE_INDEX,
    alpaca_prompt_no_input_template,
    alpaca_prompt_template,
)

__all__ = ["IGNORE_INDEX", "TASK_CONFIG", "build_prompt", "load_data_items"]

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

