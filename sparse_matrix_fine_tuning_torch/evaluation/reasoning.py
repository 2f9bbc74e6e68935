"""Generation-based evaluation for the reasoning benchmarks.

Counterpart of ``sparse_matrix_fine_tuning_tpu/evaluation/reasoning.py``
over the port's ``generate``: answer extraction as the reference (itself
LLM-Adapters') does it, last number for math, first A-E letter for AQuA,
trigger-token splitting of the raw decode (reference pyreft/loreft/
compute_metrics.py:21-98), and the exact-match loop (:199-244).  The tail
batch is filled by repeating its last row, as the JAX package does for its
static shapes: the batch's row count is what the kernels see, so keeping it
keeps their plans, and a bfloat16 run's bits, those of a full batch.

A ReFT model (one with ``interventions``) whose eval data carry
``intervention_locations`` generates with them (the JAX reasoning.py:
132-161): each row's positions, relative to its unpadded prompt, shifted by
its left padding, -1 pads kept, the tail batch filled like the prompts, and
repeated for each beam.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

from sparse_matrix_fine_tuning_torch.data.reasoning import TASK_CONFIG
from sparse_matrix_fine_tuning_torch.models.generate import GenerationConfig, generate

OPEN_ENDED = ("alpaca", "instruct", "ultrafeedback")


def is_float(element) -> bool:
    if element is None:
        return False
    try:
        float(element)
        return True
    except ValueError:
        return False


def extract_answer_number(sentence: str) -> float:
    """Last number in the generation (reference compute_metrics.py:31-46)."""
    sentence = sentence.replace(",", "")
    pred = re.findall(r"-?\d+\.?\d*", sentence)
    if not pred:
        return float("inf")
    return float(pred[-1])


def extract_answer_letter(sentence: str) -> str:
    """First A-E letter (reference compute_metrics.py:49-68)."""
    pred = re.findall(r"A|B|C|D|E", sentence.strip())
    return pred[0] if pred else ""


def extract_output(pred: str, trigger: str = "") -> str:
    """Text after the first prompt trigger (reference compute_metrics.py:71-79)."""
    if not trigger:
        return pred
    start = pred.find(trigger)
    if start < 0:
        return ""
    return pred[start + len(trigger):].lstrip()


def score_generation(task: str, raw_generation: str, example: dict,
                     normalize=None) -> bool:
    """Exact-match scoring per task (reference compute_metrics.py:199-223)."""
    norm = normalize or (lambda x: x)
    if task in ("commonsense", "tune_commonsense"):
        return raw_generation.strip() == norm(example["answer"]).strip()
    if task in ("math", "tune_math"):
        answer = example["answer"].strip()
        if not is_float(answer):  # AQuA letters
            return extract_answer_letter(raw_generation).strip() == answer
        return abs(float(answer) - extract_answer_number(raw_generation)) <= 0.001
    if task == "gsm8k":
        answer = example["answer"].split("####")[-1].strip()
        gen = extract_answer_number(raw_generation)
        return abs(extract_answer_number(answer) - gen) <= 0.001
    raise ValueError(f"no EM scoring for task {task}")


def generation_config(task: str, tokenizer, prompt_len: int, *, greedy_decoding: bool = True,
                      temperature: Optional[float] = None, top_p: Optional[float] = None,
                      top_k: Optional[int] = None,
                      max_new_tokens: Optional[int] = None) -> GenerationConfig:
    """The task's ``generation_args`` (greedy or not) with the caller's
    overrides; a total-length budget (``max_length``, the alpaca-shaped
    tasks) becomes a new-token budget against ``prompt_len``."""
    gen_args = dict(TASK_CONFIG[task.replace("tune_", "")]["generation_args"][greedy_decoding])
    for key, value in (("temperature", temperature), ("top_p", top_p), ("top_k", top_k),
                       ("max_new_tokens", max_new_tokens)):
        if value is not None:
            gen_args[key] = value
    if "max_new_tokens" not in gen_args and "max_length" in gen_args:
        # HF semantics: max_length counts prompt + generation
        gen_args["max_new_tokens"] = max(1, gen_args["max_length"] - prompt_len)
    return GenerationConfig(
        max_new_tokens=gen_args.get("max_new_tokens", 32),
        num_beams=gen_args.get("num_beams", 1),
        do_sample=gen_args.get("do_sample", False),
        temperature=gen_args.get("temperature", 1.0),
        top_p=gen_args.get("top_p", 1.0),
        top_k=gen_args.get("top_k", 0),
        repetition_penalty=gen_args.get("repetition_penalty", 1.0),
        no_repeat_ngram_size=gen_args.get("no_repeat_ngram_size", 0),
        eos_token_id=tokenizer.eos_token_id,
        pad_token_id=tokenizer.pad_token_id,
    )


def compute_reasoning_metrics(
    task: str,
    dataset_name: str,
    model,
    tokenizer,
    eval_data: dict,
    data_items: list,
    *,
    batch_size: int = 8,
    greedy_decoding: bool = True,
    temperature: Optional[float] = None,
    top_p: Optional[float] = None,
    top_k: Optional[int] = None,
    max_new_tokens: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
):
    """Batched generate + extract + EM accuracy, on the model's device.

    eval_data: left-padded {input_ids, attention_mask, id} numpy arrays.
    data_items: the raw example dicts (for the answers).
    generator: sampling's ``torch.Generator``; None gives each batch a fresh
    one seeded 0 (the JAX function's default key).
    Returns (generations, {"eval/<dataset>": accuracy}); the open-ended
    tasks return their alpaca_eval-format generations and no accuracy.
    """
    base_task = task.replace("tune_", "")
    # the trigger normalised through the tokenizer, so that string matching
    # works for the hash tokenizer too
    trigger = tokenizer.decode(tokenizer.encode_ids(TASK_CONFIG[base_task]["trigger_tokens"],
                                                    add_bos=False))
    ids = np.asarray(eval_data["input_ids"])
    mask = np.asarray(eval_data["attention_mask"])
    gc = generation_config(task, tokenizer, ids.shape[1], greedy_decoding=greedy_decoding,
                           temperature=temperature, top_p=top_p, top_k=top_k,
                           max_new_tokens=max_new_tokens)
    ex_ids = eval_data.get("id", np.arange(len(ids)))
    all_locs = eval_data.get("intervention_locations")
    is_reft = hasattr(model, "interventions") and all_locs is not None
    device = next(model.parameters()).device
    correct, total = 0, 0
    generations = []
    n = len(ids)

    def norm(a):
        return tokenizer.decode(tokenizer.encode_ids(a, add_bos=False))

    for s in range(0, n, batch_size):
        batch_ids, batch_mask = ids[s:s + batch_size], mask[s:s + batch_size]
        if len(batch_ids) < batch_size:  # the tail batch filled by repeats
            reps = batch_size - len(batch_ids)
            batch_ids = np.concatenate([batch_ids, np.repeat(batch_ids[-1:], reps, 0)])
            batch_mask = np.concatenate([batch_mask, np.repeat(batch_mask[-1:], reps, 0)])
        shifted = None
        if is_reft:
            locs = np.asarray(all_locs[s:s + batch_size])
            if len(locs) < batch_size:
                locs = np.concatenate([locs, np.repeat(locs[-1:], batch_size - len(locs), 0)])
            shift = (batch_ids.shape[1] - batch_mask.sum(axis=1) - 1)[:, None, None]
            shifted = np.where(locs >= 0, locs + shift, -1)
            if gc.num_beams > 1:
                shifted = np.repeat(shifted, gc.num_beams, axis=0)
            shifted = torch.from_numpy(shifted).long().to(device)
        out = generate(model, torch.from_numpy(batch_ids).long().to(device),
                       torch.from_numpy(batch_mask).long().to(device), gc,
                       generator=generator, intervention_locations=shifted).cpu().numpy()
        for j in range(min(batch_size, n - s)):
            example = data_items[int(ex_ids[s + j])]
            text = tokenizer.decode([t for t in out[j] if t != tokenizer.pad_token_id])
            raw_generation = extract_output(text, trigger)
            if base_task in OPEN_ENDED:
                # no EM for open-ended instruction tasks: the generations in
                # alpaca_eval's format (reference compute_metrics.py:236-245)
                generations.append({
                    "instruction": example.get("instruction", ""),
                    "output": raw_generation,
                    "dataset": dataset_name,
                    "generator": f"{task}_model",
                })
                continue
            ok = score_generation(task, raw_generation, example, normalize=norm)
            correct += int(ok)
            total += 1
            generations.append({
                "instruction": example.get("instruction", example.get("question", "")),
                "raw_generation": raw_generation,
                "answer": example.get("answer", ""),
                "correct": bool(ok),
            })
    if base_task in OPEN_ENDED:
        return generations, {}
    return generations, {f"eval/{dataset_name}": correct / max(total, 1)}
