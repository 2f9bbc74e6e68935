"""Greedy autoregressive generation for the port.

Counterpart of the greedy path of ``sparse_matrix_fine_tuning_tpu/models/
generate.py``: prompts are LEFT-padded, positions come from the attention
mask, one prefill fills a preallocated KV cache, then each step feeds one
token per row.  A row that emitted EOS emits ``pad_token_id`` from then on,
and the loop stops early once every row has finished.  The loop is eager
PyTorch under ``torch.inference_mode()``.  It skips the forward after the
last token, whose logits nothing reads; the tokens are those of the JAX
loop.

Sampling, repetition penalties, n-gram bans and beam search are not ported
yet (ROADMAP.md queue A, "Decode and the reasoning harness"); a config
asking for them is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sparse_matrix_fine_tuning_torch.models.llama import init_caches


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = 2
    pad_token_id: int = 0
    num_beams: int = 1
    do_sample: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    length_penalty: float = 1.0
    early_stopping: bool = True
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0


def _positions_from_mask(mask: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.cumsum(mask, dim=-1) - 1, min=0)


def _check_supported(cfg: GenerationConfig) -> None:
    unsupported = {
        "num_beams > 1 (beam search)": cfg.num_beams > 1,
        "do_sample (sampling)": cfg.do_sample,
        "repetition_penalty != 1": cfg.repetition_penalty != 1.0,
        "no_repeat_ngram_size > 0": cfg.no_repeat_ngram_size > 0,
    }
    asked = [name for name, on in unsupported.items() if on]
    if asked:
        raise NotImplementedError(
            f"generate supports greedy decoding only; {', '.join(asked)}: ROADMAP.md "
            "queue A, 'Decode and the reasoning harness'")


@torch.inference_mode()
def generate(model, input_ids: torch.Tensor, attention_mask: torch.Tensor,
             gen_config: GenerationConfig) -> torch.Tensor:
    """Greedy continuations.  input_ids/attention_mask: (B, T), LEFT-padded,
    on the model's device.  Returns (B, T + max_new_tokens): the prompt and
    the generation, padded with ``pad_token_id`` after EOS."""
    _check_supported(gen_config)
    cfg = model.config
    b, t = input_ids.shape
    n_new = gen_config.max_new_tokens
    eos, pad = gen_config.eos_token_id, gen_config.pad_token_id
    dev = input_ids.device
    caches = init_caches(cfg, b, t + n_new, cfg.compute_dtype or torch.float32, dev)
    mask_full = torch.cat([attention_mask, attention_mask.new_zeros(b, n_new)], dim=-1)
    positions = _positions_from_mask(attention_mask)
    logits, caches = model(input_ids, attention_mask=mask_full, positions=positions,
                           caches=caches, cache_index=0)
    last = logits[:, -1]
    pos = positions[:, -1] + 1
    out = torch.full((b, n_new), pad, dtype=input_ids.dtype, device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    for i in range(n_new):
        if eos is not None and bool(finished.all()):
            break
        tok = torch.argmax(last.float(), dim=-1)
        tok = torch.where(finished, torch.full_like(tok, pad), tok)
        if eos is not None:
            finished |= tok == eos
        out[:, i] = tok
        if i + 1 == n_new:
            break
        slot = t + i
        mask_full[:, slot] = 1
        logits, caches = model(tok[:, None].to(input_ids.dtype), attention_mask=mask_full,
                               positions=pos[:, None], caches=caches, cache_index=slot)
        last = logits[:, 0]
        pos = pos + 1
    return torch.cat([input_ids, out], dim=-1)
