"""The port's ``generate`` against the JAX one on the CPU in float32:
left-padded prompts of different real lengths, with and without EOS;
greedy with repetition penalties (pads penalised, as HF does) and n-gram
bans; beams, sampling at top-k 1, the penalty and the ban through
``generate``.  The tokens must be identical.  Each refusal is held in both
packages.  One JAX model serves the whole module (JAX compiles its decode
loop once per config).  ``test_torch_beam_search.py`` holds the beams and
``test_torch_sampling.py`` sampling, by its rules.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.generate import (
    GenerationConfig,
    beam_generate,
    generate,
)
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import to_torch
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam
from sparse_matrix_fine_tuning_tpu.models import generate as jgen

PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj"]}
LENS = (12, 7, 4, 1)
NEW = 10


@pytest.fixture(scope="module")
def pair():
    jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(), rngs=nnx.Rngs(5))
    jpeft.init_monarch(jm, PEFT, rngs=nnx.Rngs(6))
    rng = np.random.default_rng(5)
    for _, v in nnx.to_flat_state(nnx.state(jm, AdapterParam)):
        v.set_value(jnp.array(rng.normal(0.0, 0.1, v[...].shape).astype(np.float32)))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    init_monarch(tm, PEFT)
    load_jax_state(tm, {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
                        for path, v in nnx.to_flat_state(nnx.state(jm, nnx.Param))})
    return jm, tm.eval()


def prompts():
    rng = np.random.default_rng(7)
    t = max(LENS)
    ids = rng.integers(3, 256, (len(LENS), t)).astype(np.int32)
    mask = np.zeros_like(ids)
    for row, n in enumerate(LENS):
        mask[row, t - n:] = 1
    return ids * mask, mask


def both(pair, ids_mask=None, beam: bool = False, **cfg):
    """(port's tokens, JAX's) of ``generate`` (``beam_generate`` with
    ``beam``) on ``pair`` with ``cfg``."""
    jm, tm = pair
    ids, mask = prompts() if ids_mask is None else ids_mask
    jfn, tfn = (jgen.beam_generate, beam_generate) if beam else (jgen.generate, generate)
    want = np.asarray(jfn(jm, jnp.array(ids), jnp.array(mask),
                          jgen.GenerationConfig(max_new_tokens=NEW, **cfg)))
    got = tfn(tm, to_torch(ids, torch.long), to_torch(mask, torch.long),
              GenerationConfig(max_new_tokens=NEW, **cfg))
    return got.numpy(), want


def test_torch_greedy_matches_jax_without_eos(pair):
    got, want = both(pair, eos_token_id=None)
    assert got.shape == (len(LENS), max(LENS) + NEW)
    np.testing.assert_array_equal(got, want)


def test_torch_greedy_matches_jax_with_eos(pair):
    """EOS is the token row 0 emits at its third step, so that row finishes
    early and is padded after it, while the other rows go on."""
    free, _ = both(pair, eos_token_id=None)
    eos = int(free[0, max(LENS) + 2])
    got, want = both(pair, eos_token_id=eos, pad_token_id=0)
    np.testing.assert_array_equal(got, want)
    row = got[0, max(LENS):]
    first = int(np.argmax(row == eos))
    assert row[first] == eos and (row[first + 1:] == 0).all()


def test_torch_greedy_early_exit_when_all_rows_finish(pair):
    """Rows with the same prompt emit the same tokens; with EOS their second
    token, every row finishes at once and the loop stops, all pad after."""
    ids, mask = prompts()
    same = (np.repeat(ids[:1], 3, axis=0), np.repeat(mask[:1], 3, axis=0))
    free, _ = both(pair, same, eos_token_id=None)
    eos = int(free[0, max(LENS) + 1])
    got, want = both(pair, same, eos_token_id=eos, pad_token_id=0)
    np.testing.assert_array_equal(got, want)
    tail = got[:, max(LENS):]
    assert (tail[:, 1] == eos).all() and (tail[:, 2:] == 0).all()


@pytest.mark.parametrize("cfg", [{"num_beams": 4}, {"do_sample": True, "top_k": 1},
                                 {"repetition_penalty": 1.1}, {"no_repeat_ngram_size": 3}])
def test_torch_generate_decoding_matches_jax(pair, cfg):
    """Beams, sampling (top-k 1 keeps one token, so the draw is the JAX
    package's too), the penalty and the n-gram ban, each through
    ``generate`` as the harnesses call it."""
    got, want = both(pair, **cfg)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("penalty", [1.1, 1.5, 0.8])
def test_torch_penalised_greedy_matches_jax(pair, penalty):
    """Rows 1-3 are left-padded with id 0, the pad, which the penalty covers
    from the first step."""
    free, _ = both(pair, eos_token_id=None)
    got, want = both(pair, eos_token_id=None, repetition_penalty=penalty)
    np.testing.assert_array_equal(got, want)
    assert (got != free).any()


@pytest.mark.parametrize("n", [2, 3])
def test_torch_ngram_ban_matches_jax(pair, n):
    free, _ = both(pair, eos_token_id=None)
    got, want = both(pair, eos_token_id=None, no_repeat_ngram_size=n)
    np.testing.assert_array_equal(got, want)
    assert (got != free).any()  # the ban bites on these rows
    for row in got:  # no n-gram twice in prompt + generation
        grams = [tuple(row[i:i + n]) for i in range(len(row) - n + 1)]
        new = grams[max(LENS) - n + 1:]
        assert len(set(new)) == len(new) and not set(new) & set(grams[:max(LENS) - n + 1])


@pytest.mark.parametrize("cfg", [
    {"num_beams": 4, "repetition_penalty": 1.1},
    {"num_beams": 4, "no_repeat_ngram_size": 3},
    {"num_beams": 4, "do_sample": True, "top_k": 40},
    {"num_beams": 4, "do_sample": True, "top_p": 0.75},
])
def test_torch_generate_refusals_match_jax(pair, cfg):
    jm, tm = pair
    ids, mask = prompts()
    with pytest.raises(NotImplementedError):
        jgen.generate(jm, jnp.array(ids), jnp.array(mask), jgen.GenerationConfig(**cfg))
    with pytest.raises(NotImplementedError, match="as in the JAX package"):
        generate(tm, to_torch(ids, torch.long), to_torch(mask, torch.long),
                 GenerationConfig(**cfg))


@pytest.mark.parametrize("kw", [{"intervention_locations": [[[1, 11]], [[6, 11]], [[8, -1]],
                                                          [[11, -1]]]},
                                {"prefill_hooks": {0: lambda h: h * 1.5}}])
def test_torch_generate_refuses_interventions(pair, kw):
    """Intervened greedy generation against the JAX package's, equal
    tokens: a ReftModel's locations (Loreft at layer 1's block output,
    bridged), or a caller's prefill hook (layer 0's block output scaled)."""
    from test_torch_reft import state_of

    from sparse_matrix_fine_tuning_torch.interventions import reft as treft
    from sparse_matrix_fine_tuning_tpu.interventions import reft as jreft

    jm, tm = pair
    ids, mask = prompts()
    if "intervention_locations" in kw:
        reps = [{"layer": 1, "intervention": "LoreftIntervention"}]
        jm = jreft.get_reft_model(jm, jreft.ReftConfig(representations=reps), rngs=nnx.Rngs(2))
        for _, v in nnx.to_flat_state(nnx.state(jm.interventions, nnx.Param)):
            v.set_value(v[...] + 0.5)
        tm = treft.get_reft_model(tm, treft.ReftConfig(representations=reps)).eval()
        load_jax_state(tm, state_of(jm))
        kw = {"intervention_locations": np.asarray(kw["intervention_locations"], np.int32)}
    want = np.asarray(jgen.generate(jm, jnp.array(ids), jnp.array(mask),
                                    jgen.GenerationConfig(max_new_tokens=NEW), **kw))
    tkw = {k: (to_torch(v, torch.long) if k == "intervention_locations" else v)
           for k, v in kw.items()}
    got = generate(tm, to_torch(ids, torch.long), to_torch(mask, torch.long),
                   GenerationConfig(max_new_tokens=NEW), **tkw)
    np.testing.assert_array_equal(got.numpy(), want)