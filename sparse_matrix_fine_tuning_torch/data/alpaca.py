"""Alpaca-style causal-LM collation with INDEPENDENT source/target
truncation -- the qlora data path.

A copy of part of ``sparse_matrix_fine_tuning_tpu/data/alpaca.py``
(reference qlora/qlora_monarch.py:322-378):
  * source = BOS + formatted prompt, truncated to ``source_max_len``
  * target = output + EOS, truncated to ``target_max_len`` (independently,
    so a long prompt cannot eat the answer's budget and vice versa)
  * labels = IGNORE_INDEX over the source span + the target ids, unless
    ``train_on_source`` (then labels copy the full sequence)
  * ``predict_with_generate`` keeps only the source ids (no labels) and
    LEFT-pads them: ``models/generate.py``'s prefill takes the next-token
    logit at position -1, so prompts must end flush right
  * training rows are right-padded to the longest row (at most
    ``source_max_len + target_max_len``); attention mask = not-pad.

Sequence packing (``pack_causal_lm``, ``pack_tokenized``, JAX
data/alpaca.py:127-228): several examples a row, bin-packed best-fit
decreasing, with ``segment_ids`` (1..n a row, 0 = pad) that the model turns
into per-segment positions and segment-masked attention
(``models/llama.py``); each segment's first label is ``IGNORE_INDEX``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from sparse_matrix_fine_tuning_torch.data.reasoning import IGNORE_INDEX, build_prompt


def format_items(items: Sequence[dict], dataset_format: str | None,
                 dataset_name: str = "alpaca") -> list:
    """Per-dataset raw-row -> {source, output} normalisation (reference
    qlora_monarch.py format_dataset, :488-530).  Alpaca-family rows keep
    their {instruction, input, output} shape (the prompt template applies
    at collate time); the other formats produce a pre-built ``raw_input``
    source string exactly as the reference's collator consumes it."""
    fmt = dataset_format or (
        dataset_name if dataset_name in
        ("chip2", "self-instruct", "hh-rlhf", "oasst1") else "alpaca")
    if fmt in ("alpaca", "alpaca-clean"):
        return list(items)
    out = []
    for x in items:
        if fmt == "chip2":
            head, _, tail = x["text"].partition("\n<bot>: ")
            out.append({"raw_input": head.replace("<human>: ", ""),
                        "output": tail})
        elif fmt == "self-instruct":
            out.append({"raw_input": x["prompt"], "output": x["completion"]})
        elif fmt == "hh-rlhf":
            out.append({"raw_input": "", "output": x["chosen"]})
        elif fmt == "oasst1":
            out.append({"raw_input": "", "output": x["text"]})
        elif fmt == "input-output":
            out.append({"raw_input": x.get("input", ""),
                        "output": x["output"]})
        else:
            raise ValueError(f"unknown dataset_format {fmt!r}")
    return out


def _encode_example(item: dict, tokenizer, *, source_max_len: int,
                    target_max_len: int, train_on_source: bool, task: str):
    """One example -> (src_ids, full_ids, labels) with INDEPENDENT source/
    target truncation.  The single shared tokenize path for the collator
    AND the packer, so truncation/BOS/EOS semantics can never diverge."""
    if "raw_input" in item:  # pre-built source (format_items non-alpaca)
        prompt, target_text = item["raw_input"], item["output"]
    else:
        prompt, full = build_prompt(task, item, "")
        target_text = full[len(prompt):]
    # BOS carried by the source (reference prepends tokenizer.bos_token)
    src = tokenizer.encode_ids(prompt, add_bos=True)[:source_max_len]
    tgt = (tokenizer.encode_ids(target_text, add_bos=False)
           + [tokenizer.eos_token_id])[:target_max_len]
    ids = src + tgt
    if train_on_source:
        labels = list(ids)
    else:
        labels = [IGNORE_INDEX] * len(src) + list(tgt)
    return src, ids, labels


def collate_causal_lm(items: Sequence[dict], tokenizer, *,
                      source_max_len: int = 1024, target_max_len: int = 256,
                      train_on_source: bool = False,
                      predict_with_generate: bool = False,
                      task: str = "alpaca"):
    """Returns {input_ids, attention_mask[, labels]} as numpy arrays."""
    pad_id = tokenizer.pad_token_id
    rows_ids, rows_labels = [], []
    for item in items:
        src, ids, labels = _encode_example(
            item, tokenizer, source_max_len=source_max_len,
            target_max_len=target_max_len, train_on_source=train_on_source,
            task=task)
        if predict_with_generate:
            rows_ids.append(src)
            rows_labels.append(None)
        else:
            rows_ids.append(ids)
            rows_labels.append(labels)

    total = source_max_len + (0 if predict_with_generate else target_max_len)
    maxlen = min(max(len(r) for r in rows_ids), total)
    n = len(rows_ids)
    input_ids = np.full((n, maxlen), pad_id, np.int32)
    attention_mask = np.zeros((n, maxlen), np.int32)
    labels = np.full((n, maxlen), IGNORE_INDEX, np.int32)
    for i, ids in enumerate(rows_ids):
        L = min(len(ids), maxlen)
        if predict_with_generate:
            input_ids[i, maxlen - L:] = ids[:L]
            attention_mask[i, maxlen - L:] = 1
            continue
        input_ids[i, :L] = ids[:L]
        attention_mask[i, :L] = 1
        if rows_labels[i] is not None:
            labels[i, :L] = rows_labels[i][:L]
    out = {"input_ids": input_ids, "attention_mask": attention_mask}
    if not predict_with_generate:
        out["labels"] = labels
    return out


def _bin_pack_decreasing(lengths: Sequence[int], max_len: int) -> list:
    """Bin indices by BEST-fit decreasing; each bin's lengths sum <= max_len.

    bisect on a sorted free-space list keeps this ~O(n log n + n * bins
    memmove-in-C) -- a naive first-fit scan is O(n * bins) pure Python,
    minutes of startup on the 52k-example alpaca set."""
    import bisect
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    bins: list[list[int]] = []
    free: list[tuple] = []  # sorted (space, bin_idx)
    for i in order:
        L = min(int(lengths[i]), max_len)
        j = bisect.bisect_left(free, (L, -1))
        if j < len(free):
            space, b = free.pop(j)
            bins[b].append(i)
            bisect.insort(free, (space - L, b))
        else:
            bins.append([i])
            bisect.insort(free, (max_len - L, len(bins) - 1))
    return bins


def _fill_bins(rows: list, bins: list, max_len: int, pad_id: int):
    """rows: [(ids, labels)] ragged; emit the packed arrays + efficiency."""
    n = len(bins)
    p_ids = np.full((n, max_len), pad_id, np.int32)
    p_seg = np.zeros((n, max_len), np.int32)
    p_lab = np.full((n, max_len), IGNORE_INDEX, np.int32)
    true_tokens = 0
    for r, members in enumerate(bins):
        pos = 0
        for s, i in enumerate(members, start=1):
            r_ids, r_lab = rows[i]
            L = len(r_ids)
            p_ids[r, pos:pos + L] = r_ids
            p_lab[r, pos:pos + L] = r_lab
            p_seg[r, pos:pos + L] = s
            pos += L
        true_tokens += pos
    packed = {"input_ids": p_ids,
              "attention_mask": (p_seg > 0).astype(np.int32),
              "segment_ids": p_seg, "labels": p_lab}
    return packed, true_tokens / max(n * max_len, 1)


def pack_tokenized(data: dict, max_len: int):
    """Pack ALREADY-TOKENIZED right-padded rows into segment-masked rows.

    Generic sibling of pack_causal_lm for harnesses that tokenize first
    (run_reasoning.py): takes {input_ids, attention_mask, labels}, extracts
    each row's true tokens (mask > 0 -- works even with a leading masked
    sink token), bin-packs them, and emits segment ids.  Each segment's
    first token label is forced to IGNORE (seam masking for the shifted
    loss).  Returns (packed dict, token efficiency).
    """
    ids = np.asarray(data["input_ids"])
    mask = np.asarray(data["attention_mask"])
    labels = np.asarray(data["labels"])
    rows = []
    for i in range(len(ids)):
        sel = mask[i] > 0
        r_ids, r_lab = ids[i][sel][:max_len], labels[i][sel][:max_len].copy()
        if len(r_lab):
            r_lab[0] = IGNORE_INDEX
        rows.append((r_ids, r_lab))
    bins = _bin_pack_decreasing([len(r[0]) for r in rows], max_len)
    pad_id = int(ids[mask == 0][0]) if (mask == 0).any() else 0
    return _fill_bins(rows, bins, max_len, pad_id)


def pack_causal_lm(items: Sequence[dict], tokenizer, *,
                   max_len: int = 2048, source_max_len: int = 1024,
                   target_max_len: int = 256, train_on_source: bool = False,
                   task: str = "alpaca"):
    """SEQUENCE PACKING: several examples per row with segment ids.

    The sibling of group_by_length: instead of trimming
    per-batch padding, short examples are bin-packed (first-fit decreasing)
    into full ``max_len`` rows.  ``segment_ids`` (1..n per row, 0 = pad)
    drive block-diagonal attention masking and per-segment RoPE restarts in
    models/llama.py, so the packed forward is exactly equivalent to running
    each example alone.  Each segment's FIRST token gets an IGNORE label
    (it is BOS; this also keeps the shifted loss from pairing a segment's
    last logit with the next segment's first token when train_on_source).

    Returns ({input_ids, attention_mask, segment_ids, labels}, efficiency)
    where efficiency = true tokens / (rows * max_len).
    """
    pad_id = tokenizer.pad_token_id
    seqs = []
    for item in items:
        _, ids, labels = _encode_example(
            item, tokenizer, source_max_len=source_max_len,
            target_max_len=target_max_len, train_on_source=train_on_source,
            task=task)
        ids, labels = ids[:max_len], labels[:max_len]
        labels[0] = IGNORE_INDEX  # segment seam / BOS
        seqs.append((ids, labels))

    bins = _bin_pack_decreasing([len(s[0]) for s in seqs], max_len)
    return _fill_bins(seqs, bins, max_len, pad_id)


def train_eval_split(items: Sequence[dict], eval_dataset_size: int, seed: int = 42):
    """Held-out eval split (reference qlora.py eval_dataset_size /
    train_test_split; round 1 evaluated loss on the training set)."""
    items = list(items)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(items))
    n_eval = max(1, min(int(eval_dataset_size), len(items) // 5))
    eval_items = [items[i] for i in idx[:n_eval]]
    train_items = [items[i] for i in idx[n_eval:]]
    return train_items, eval_items
