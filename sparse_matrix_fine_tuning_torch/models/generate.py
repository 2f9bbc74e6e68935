"""Autoregressive generation for the port: greedy, sampling and beam search.

Counterpart of ``sparse_matrix_fine_tuning_tpu/models/generate.py``: prompts
are LEFT-padded, positions come from the attention mask, one prefill fills
a preallocated KV cache, then each step feeds one token per row.  The loops
are eager PyTorch under ``torch.inference_mode()``; they skip the forward
after the last step, whose logits nothing reads, and give the JAX loops'
tokens.

Greedy and sampling (``generate``): a row that emitted EOS emits
``pad_token_id`` from then on, and the loop stops once every row has
finished.  Before each pick, the HF logits processors of the reference's
generation_args, in the JAX order: the repetition penalty over the prompt
(pads included) and the tokens so far, then the n-gram ban (none until an
n-gram can exist), then for sampling the temperature, top-k (clamped to the
vocabulary, ties kept) and top-p (the sorted cumulative cutoff), and a
categorical draw by the Gumbel-max rule from ``generator``.  A
``torch.Generator`` draws other numbers than a JAX ``PRNGKey`` (and a card's
generator other numbers than the CPU's), so sampled tokens equal the JAX
package's only in distribution; ``generator=None`` is a fresh one seeded 0
on the prompts' device, as the JAX default key is ``PRNGKey(0)``.

Beam search (``beam_generate``, the JAX ``_compiled_beam``, itself HF's
vectorised ``_beam_search``): a 2K candidate pool a step, a K-slot bank of
finished hypotheses scored by sum-logprobs / length ** length_penalty, the
early-stop heuristic and the three-way stop; a finished hypothesis's tail
is filled with ``pad_token_id or eos_token_id`` (HF's rule).  The running
beams' KV cache rows, attention mask and positions are reordered each step
by a copying ``index_select``.  Every top-k here is a stable sort, so ties
go to the lower index as ``lax.top_k`` gives them (``torch.topk``'s order
among ties is unspecified).  Beam-sample picks the 2K candidates by
Gumbel-top-k over the temperature-scaled scores.

ReFT-intervened generation (the JAX generate.py:140-160): the prefill
runs with layer hooks, built from ``intervention_locations`` (B,
num_interventions, p) by the model's ``_hooks`` (a ``ReftModel``), or the
caller's ``prefill_hooks``; no decode step sees a hook, so the in-place
cache and the beams' reorder never meet one.  Beam search takes the
locations already expanded to B * num_beams rows (``np.repeat`` on axis 0,
as ``evaluation/reasoning.py`` does).

Refused as the JAX package refuses them: beams with a repetition penalty or
n-gram bans, and beam-sample with top-k or top-p (ROADMAP.md C.13).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sparse_matrix_fine_tuning_torch.models.llama import init_caches
from sparse_matrix_fine_tuning_torch.utils.device import seeded_generator

NEG = -1e9


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


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, descending, ties in
    index order."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def filter_logits(logits: torch.Tensor, cfg: GenerationConfig) -> torch.Tensor:
    """Sampling's warpers on float32 logits: divide by the temperature, then
    set to ``NEG`` what top-k and top-p drop."""
    logits = logits / max(cfg.temperature, 1e-6)
    if cfg.top_k and cfg.top_k > 0:
        k = min(cfg.top_k, logits.shape[-1])  # HF clamps top_k to the vocabulary
        kth = top_k(logits, k)[0][..., -1:]
        logits = torch.where(logits < kth, NEG, logits)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < cfg.top_p).sum(-1, keepdim=True).clamp_max(logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, NEG, logits)
    return logits


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator],
                   cfg: GenerationConfig) -> torch.Tensor:
    logits = logits.float()
    if not cfg.do_sample:
        return torch.argmax(logits, dim=-1)
    logits = filter_logits(logits, cfg)
    return torch.argmax(logits + gumbel(logits.shape, generator, logits.device), dim=-1)


def beam_candidates(cand: torch.Tensor, k2: int, generator: Optional[torch.Generator] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam search's pool: the ``k2`` best of the (b, K * V) candidate
    scores, or with a ``generator`` (beam-sample) ``k2`` drawn without
    replacement by Gumbel-top-k, HF's ``torch.multinomial`` in law.
    (scores, flat indices), each (b, k2)."""
    if generator is None:
        return top_k(cand, k2)
    idx = top_k(cand + gumbel(cand.shape, generator, cand.device), k2)[1]
    return torch.gather(cand, 1, idx), idx


def _apply_repetition_penalty(logits: torch.Tensor, presence: torch.Tensor,
                              penalty: float) -> torch.Tensor:
    """CTRL-style: divide the positive and multiply the negative logits of
    every token present (HF RepetitionPenaltyLogitsProcessor)."""
    lp = logits.float()
    pen = torch.where(lp > 0, lp / penalty, lp * penalty)
    return torch.where(presence, pen, lp)


def _prompt_presence(input_ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """(b, V) bool: the tokens of the prompt, PADS INCLUDED, as HF's
    processor gathers over the whole padded ``input_ids``."""
    presence = torch.zeros(input_ids.shape[0], vocab, dtype=torch.bool,
                           device=input_ids.device)
    return presence.scatter_(1, input_ids.long(), True)


def _ban_repeated_ngrams(logits: torch.Tensor, seq: torch.Tensor, n: int) -> torch.Tensor:
    """Set to ``NEG`` every token that would complete an n-gram already in
    ``seq`` (b, cur_len), the prompt and the tokens so far (HF
    NoRepeatNGramLogitsProcessor); no ban while cur_len < n."""
    lf = logits.float()
    b, cur_len = seq.shape
    if cur_len < n:
        return lf
    windows = seq.unfold(1, n, 1)                       # (b, cur_len - n + 1, n)
    prefix = seq[:, cur_len - (n - 1):]                 # the n - 1 tokens the next extends
    match = (windows[..., :n - 1] == prefix[:, None, :]).all(-1)
    hits = torch.zeros(lf.shape, dtype=torch.int32, device=lf.device)
    hits.scatter_add_(1, windows[..., n - 1].long(), match.int())
    return lf.masked_fill(hits > 0, NEG)


def _check_supported(cfg: GenerationConfig) -> None:
    if cfg.num_beams > 1:
        if cfg.repetition_penalty != 1.0 or cfg.no_repeat_ngram_size > 0:
            raise NotImplementedError(
                "repetition_penalty / no_repeat_ngram_size are implemented for the "
                "greedy/sampling decode only, as in the JAX package (the reference recipes "
                "use them with num_beams=1)")
        if cfg.do_sample and (cfg.top_k > 0 or cfg.top_p < 1.0):
            raise NotImplementedError(
                "beam-sample supports temperature only, as in the JAX package (HF applies "
                "top-k/top-p warpers there too): ROADMAP.md C.13")


def _prefill_kwargs(model, prefill_hooks, intervention_locations, device) -> dict:
    """The prefill's ``layer_hooks``: the caller's, or those the model's
    ``_hooks`` builds from the locations; none without either."""
    if prefill_hooks is not None:
        return {"layer_hooks": prefill_hooks}
    if intervention_locations is None:
        return {}
    if not hasattr(model, "_hooks"):
        raise ValueError("intervention_locations need a model with interventions (ReftModel)")
    locs = torch.as_tensor(intervention_locations, device=device).long()
    return {"layer_hooks": model._hooks(locs)}


@torch.inference_mode()
def generate(model, input_ids: torch.Tensor, attention_mask: torch.Tensor,
             gen_config: GenerationConfig, generator: Optional[torch.Generator] = None,
             prefill_hooks=None, intervention_locations=None) -> torch.Tensor:
    """Continuations.  input_ids/attention_mask: (B, T), LEFT-padded, on the
    model's device; ``generator`` feeds sampling (a fresh one seeded 0 when
    None).  ``intervention_locations`` / ``prefill_hooks``: see the module
    docstring.  ``num_beams > 1`` goes to ``beam_generate``.  Returns (B, T +
    max_new_tokens): the prompt and the generation, padded with
    ``pad_token_id`` after EOS."""
    _check_supported(gen_config)
    if gen_config.num_beams > 1:
        return beam_generate(model, input_ids, attention_mask, gen_config, generator,
                             prefill_hooks=prefill_hooks,
                             intervention_locations=intervention_locations)
    cfg = model.config
    b, t = input_ids.shape
    n_new = gen_config.max_new_tokens
    eos, pad = gen_config.eos_token_id, gen_config.pad_token_id
    dev = input_ids.device
    if gen_config.do_sample:
        generator = seeded_generator(dev, generator)
    caches = init_caches(cfg, b, t + n_new, cfg.compute_dtype or torch.float32, dev)
    mask_full = torch.cat([attention_mask, attention_mask.new_zeros(b, n_new)], dim=-1)
    positions = _positions_from_mask(attention_mask)
    logits, caches = model(input_ids, attention_mask=mask_full, positions=positions,
                           caches=caches, cache_index=0,
                           **_prefill_kwargs(model, prefill_hooks, intervention_locations, dev))
    last = logits[:, -1]
    pos = positions[:, -1] + 1
    out = torch.full((b, n_new), pad, dtype=input_ids.dtype, device=dev)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    use_pen = gen_config.repetition_penalty != 1.0
    ngram = gen_config.no_repeat_ngram_size
    if use_pen:
        presence = _prompt_presence(input_ids, last.shape[-1])
    for i in range(n_new):
        if eos is not None and bool(finished.all()):
            break
        lg = last
        if use_pen:
            lg = _apply_repetition_penalty(lg, presence, gen_config.repetition_penalty)
        if ngram > 0:
            lg = _ban_repeated_ngrams(lg, torch.cat([input_ids, out[:, :i]], dim=-1), ngram)
        tok = _sample_logits(lg, generator, gen_config)
        tok = torch.where(finished, torch.full_like(tok, pad), tok)
        if use_pen:
            presence.scatter_(1, tok[:, None], True)
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


@torch.inference_mode()
def beam_generate(model, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                  gen_config: GenerationConfig, generator: Optional[torch.Generator] = None,
                  prefill_hooks=None, intervention_locations=None) -> torch.Tensor:
    """HF-parity beam search (see the module docstring); ``generator`` is
    drawn from only for beam-sample.  ``intervention_locations`` and
    ``prefill_hooks`` are those of the beam-expanded batch (B * num_beams
    rows).  Returns (B, T + max_new_tokens): the prompt and the best
    finished hypothesis."""
    cfg = model.config
    gc = gen_config
    K = gc.num_beams
    K2 = 2 * K  # HF's beams_to_keep with at most one EOS id
    b, t = input_ids.shape
    N = gc.max_new_tokens
    dev = input_ids.device
    bk = b * K
    if gc.do_sample:
        generator = seeded_generator(dev, generator)
    ids_k = input_ids.repeat_interleave(K, dim=0)
    mask_k = attention_mask.repeat_interleave(K, dim=0)
    caches = init_caches(cfg, bk, t + N, cfg.compute_dtype or torch.float32, dev)
    mask_full = torch.cat([mask_k, mask_k.new_zeros(bk, N)], dim=-1)
    positions = _positions_from_mask(mask_k)
    logits, caches = model(ids_k, attention_mask=mask_full, positions=positions,
                           caches=caches, cache_index=0,
                           **_prefill_kwargs(model, prefill_hooks, intervention_locations, dev))
    last = logits[:, -1]
    pos = positions[:, -1] + 1

    # beam 0 live, the others NEG, so that the first step picks K distinct tokens
    run_scores = torch.full((b, K), NEG, dtype=torch.float32, device=dev)
    run_scores[:, 0] = 0.0
    if gc.eos_token_id is not None:
        fill = gc.pad_token_id or gc.eos_token_id  # HF: `pad_token_id or eos_token_id[0]`
    else:
        fill = gc.pad_token_id if gc.pad_token_id is not None else -1
    run_toks = torch.full((b, K, N), fill, dtype=input_ids.dtype, device=dev)
    bank_scores = torch.full((b, K), NEG, dtype=torch.float32, device=dev)
    bank_toks = torch.full((b, K, N), fill, dtype=input_ids.dtype, device=dev)
    bank_fin = torch.zeros((b, K), dtype=torch.bool, device=dev)
    heur_unsat = torch.ones((b, 1), dtype=torch.bool, device=dev)
    es = gc.early_stopping is True
    rank_ok = (torch.arange(K2, device=dev) < K)[None]
    row_base = torch.arange(b, device=dev)[:, None] * K

    def take(x, idx):  # (b, M, ...) gathered at (b, k) along dim 1
        return torch.gather(x, 1, idx.view(*idx.shape, *([1] * (x.dim() - 2))).expand(
            *idx.shape, *x.shape[2:]))

    for i in range(N):
        logp = torch.log_softmax(last.float(), dim=-1)
        if gc.do_sample and gc.temperature != 1.0:
            # HF's temperature warper acts on the log-probs that join the scores
            logp = logp / max(gc.temperature, 1e-6)
        V = logp.shape[-1]
        cand = (logp.view(b, K, V) + run_scores[:, :, None]).view(b, K * V)
        sc2k, idx2k = beam_candidates(cand, K2, generator if gc.do_sample else None)
        src = idx2k // V
        tok = (idx2k % V).to(input_ids.dtype)
        cand_toks = take(run_toks, src)
        cand_toks[:, :, i] = tok
        hits = torch.full(tok.shape, i + 1 >= N, dtype=torch.bool, device=dev)
        if gc.eos_token_id is not None:
            hits |= tok == gc.eos_token_id

        # the next running beams: the best K candidates that did not finish
        run_scores, run_sel_idx = top_k(sc2k + hits.float() * NEG, K)
        run_toks = take(cand_toks, run_sel_idx)
        new_tok = torch.gather(tok, 1, run_sel_idx)
        flat_src = (row_base + torch.gather(src, 1, run_sel_idx)).view(-1)
        caches = [(k.index_select(0, flat_src), v.index_select(0, flat_src)) for k, v in caches]
        mask_full = mask_full.index_select(0, flat_src)
        pos = pos.index_select(0, flat_src)

        # the bank: finished candidates in the top K ranks join it while the
        # batch can still improve
        denom = torch.tensor(float(i + 1), dtype=torch.float32, device=dev) ** gc.length_penalty
        norm = sc2k / denom
        batch_full = bank_fin.all(-1, keepdim=True) & es
        addable = hits & rank_ok & ~batch_full & heur_unsat
        merged_scores = torch.cat([bank_scores, torch.where(addable, norm, NEG)], dim=1)
        merged_fin = torch.cat([bank_fin, addable], dim=1)
        merged_toks = torch.cat([bank_toks, cand_toks], dim=1)
        bank_scores, top_i = top_k(merged_scores, K)
        bank_fin = torch.gather(merged_fin, 1, top_i)
        bank_toks = take(merged_toks, top_i)

        # early stop: can the best running beam still beat the worst banked
        # hypothesis?  (sticky once it cannot)
        best_possible = run_scores[:, :1] / denom
        worst_fin = torch.where(bank_fin, bank_scores.min(-1, keepdim=True).values, NEG)
        heur_unsat &= (best_possible > worst_fin).any(-1, keepdim=True)
        improvement = heur_unsat.any()
        exists_open = ~(bank_fin.all() & es)
        valid_cont = ~hits.all()
        if i + 1 == N or not bool(improvement & exists_open & valid_cont):
            break
        slot = t + i
        mask_full[:, slot] = 1
        logits, caches = model(new_tok.reshape(-1, 1), attention_mask=mask_full,
                               positions=pos[:, None], caches=caches, cache_index=slot)
        last = logits[:, 0]
        pos = pos + 1
    # the bank stays sorted descending: slot 0 is the best hypothesis
    return torch.cat([input_ids, bank_toks[:, 0]], dim=-1)
