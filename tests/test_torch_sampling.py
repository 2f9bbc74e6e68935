"""Sampling in the port's ``generate``, held by its rules: a
``torch.Generator`` draws other numbers than a JAX ``PRNGKey``, so no token
can be compared with the JAX package's, except where the rules leave one
token (top-k 1, ``test_torch_generate.py``).

The kept set of the temperature, top-k and top-p warpers equals a numpy
brute force of the rules and HF's ``TopKLogitsWarper`` and
``TopPLogitsWarper``; top-k 1 is the argmax; seeded draws repeat; the
frequencies of 4,000 draws fit the filtered softmax (Pearson's chi-square
below its 0.999 quantile, and no dropped token ever drawn); beam-sample's
pool is drawn from the live beams only, without repeats, its first pick's
frequencies fitting the candidates' softmax likewise, and near temperature
0 beam-sample gives deterministic beam search's tokens, in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch
from transformers.generation.logits_process import (
    TemperatureLogitsWarper,
    TopKLogitsWarper,
    TopPLogitsWarper,
)

from sparse_matrix_fine_tuning_torch.models.generate import (
    NEG,
    GenerationConfig,
    _sample_logits,
    beam_candidates,
    beam_generate,
    filter_logits,
    generate,
)
from sparse_matrix_fine_tuning_torch.utils.testing import to_torch
from sparse_matrix_fine_tuning_tpu.models import generate as jgen
from test_torch_generate import LENS, NEW, pair, prompts  # noqa: F401  (the module's fixture)

DRAWS = 4000
CHI2_QUANTILE = 0.999


def logits(shape=(6, 64), seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).normal(0, 2, shape).astype(np.float32))


def brute_force_kept(row: np.ndarray, temperature: float, k: int, p: float) -> set:
    """The tokens the rules keep, one at a time: the k largest (ties at the
    k-th kept), then the fewest of the largest whose probabilities, renormalised
    over the top-k, sum to at least p."""
    z = row.astype(np.float64) / temperature
    order = sorted(range(len(z)), key=lambda i: -z[i])
    kept = set(order) if k <= 0 else {i for i in order if z[i] >= z[order[min(k, len(z)) - 1]]}
    if p >= 1.0:
        return kept
    pz = np.exp(z - z.max())
    total = sum(pz[i] for i in kept)
    out, acc = set(), 0.0
    for i in order:
        if i not in kept:
            continue
        if acc >= p:
            break
        out.add(i)
        acc += pz[i] / total
    return out


def hf_kept(lg: torch.Tensor, temperature: float, k: int, p: float) -> torch.Tensor:
    scores = TemperatureLogitsWarper(temperature)(None, lg.clone())
    if k > 0:
        scores = TopKLogitsWarper(k)(None, scores)
    if p < 1.0:
        scores = TopPLogitsWarper(p)(None, scores)
    return torch.isfinite(scores)


@pytest.mark.parametrize("temperature,k,p", [(1.0, 5, 1.0), (0.7, 0, 0.75), (0.3, 40, 0.75),
                                             (0.8, 40, 0.95), (1.5, 3, 0.5), (1.0, 500, 0.9)])
def test_torch_kept_set_matches_brute_force_and_hf(temperature, k, p):
    lg = logits()
    cfg = GenerationConfig(do_sample=True, temperature=temperature, top_k=k, top_p=p)
    kept = filter_logits(lg, cfg) > NEG / 2
    torch.testing.assert_close(kept, hf_kept(lg, temperature, k, p), rtol=0, atol=0)
    for row, mask in zip(lg.numpy(), kept):
        assert set(torch.nonzero(mask).flatten().tolist()) == \
            brute_force_kept(row, temperature, k, p)
    assert kept.sum(-1).min() >= 1


def test_torch_top_k_one_is_the_argmax():
    lg = logits()
    cfg = GenerationConfig(do_sample=True, top_k=1, temperature=0.7)
    for seed in range(5):
        got = _sample_logits(lg, torch.Generator().manual_seed(seed), cfg)
        torch.testing.assert_close(got, lg.argmax(-1), rtol=0, atol=0)


def test_torch_seeded_draws_repeat(pair):
    _, tm = pair
    ids, mask = prompts()
    cfg = GenerationConfig(max_new_tokens=NEW, do_sample=True, top_k=40, top_p=0.95,
                           temperature=0.8, eos_token_id=None)
    args = (tm, to_torch(ids, torch.long), to_torch(mask, torch.long), cfg)
    runs = [generate(*args, generator=torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert torch.equal(generate(*args), generate(*args, generator=torch.Generator().manual_seed(0)))


def chi_square_fits(counts: np.ndarray, probs: np.ndarray) -> tuple[float, float]:
    """(Pearson's statistic over the tokens with probability, its 0.999
    quantile); every token without probability must have no draw."""
    live = probs > 0
    assert counts[~live].sum() == 0
    expected = probs[live] * counts.sum()
    stat = float(((counts[live] - expected) ** 2 / expected).sum())
    return stat, float(scipy.stats.chi2.ppf(CHI2_QUANTILE, live.sum() - 1))


@pytest.mark.parametrize("temperature,k,p", [(1.0, 0, 1.0), (0.8, 6, 0.95), (1.2, 0, 0.75)])
def test_torch_draw_frequencies_fit_the_filtered_softmax(temperature, k, p):
    row = 0.25 * logits((1, 12), seed=3)
    cfg = GenerationConfig(do_sample=True, temperature=temperature, top_k=k, top_p=p)
    draws = _sample_logits(row.expand(DRAWS, -1), torch.Generator().manual_seed(11), cfg)
    counts = np.bincount(draws.numpy(), minlength=12)
    probs = torch.softmax(filter_logits(row, cfg), -1)[0].double().numpy()
    probs[probs < 1e-12] = 0.0
    assert (probs > 0).sum() >= 4
    stat, bound = chi_square_fits(counts, probs)
    assert stat < bound, (stat, bound, counts)


def test_torch_beam_sample_pool_lies_in_the_live_beams():
    """Step 0 of a 4-beam search: beams 1-3 stand at NEG, so the 8 drawn
    candidates come from beam 0's V, distinct, with their own scores; the
    first pick is a categorical draw from the candidates' softmax."""
    k, v = 4, 16
    live = logits((1, v), seed=5)
    cand = torch.full((DRAWS, k * v), NEG)
    cand[:, :v] = torch.log_softmax(live, -1)
    scores, idx = beam_candidates(cand, 2 * k, torch.Generator().manual_seed(2))
    assert (idx < v).all()
    assert all(len(set(r)) == 2 * k for r in idx.tolist())
    torch.testing.assert_close(scores, torch.gather(cand, 1, idx), rtol=0, atol=0)
    counts = np.bincount(idx[:, 0].numpy(), minlength=v)
    stat, bound = chi_square_fits(counts, torch.softmax(live, -1)[0].double().numpy())
    assert stat < bound, (stat, bound, counts)


def test_torch_beam_sample_near_zero_temperature_is_beam_search(pair):
    """At temperature 1e-6 the scaled scores' gaps dwarf the Gumbel noise:
    beam-sample keeps deterministic beam search's beams, in both
    packages."""
    jm, tm = pair
    ids, mask = prompts()
    sample = dict(do_sample=True, temperature=1e-6)
    args = (to_torch(ids, torch.long), to_torch(mask, torch.long))
    plain = beam_generate(tm, *args, GenerationConfig(max_new_tokens=NEW, num_beams=4))
    got = beam_generate(tm, *args, GenerationConfig(max_new_tokens=NEW, num_beams=4, **sample),
                        generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    jax_cfg = jgen.GenerationConfig(max_new_tokens=NEW, num_beams=4, **sample)
    want = jgen.beam_generate(jm, jnp.array(ids), jnp.array(mask), jax_cfg,
                              rng=jax.random.PRNGKey(1))
    np.testing.assert_array_equal(np.asarray(want), plain.numpy())
