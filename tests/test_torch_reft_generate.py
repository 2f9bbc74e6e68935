"""ReFT-intervened generation and evaluation of the port against the JAX
package's on the CPU, in float32: a ``ReftModel`` (Loreft at both layers'
block outputs, untied ``f2+l2`` positions) over ``test_torch_generate.py``'s
tiny Llama, its weights bridged; greedy and beam-4 generation with the
interventions on the prompt (the hooks at the prefill only): equal tokens;
then ``compute_reasoning_metrics`` over intervention locations shifted by
the left padding, with a ragged tail batch: equal generations and metrics,
greedy and beam-4."""

import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.interventions import reft as treft
from sparse_matrix_fine_tuning_torch.models.generate import GenerationConfig, generate
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import to_torch
from sparse_matrix_fine_tuning_tpu.interventions import reft as jreft
from sparse_matrix_fine_tuning_tpu.models import generate as jgen
from test_torch_eval_reasoning import metrics
from test_torch_generate import pair, prompts  # noqa: F401  (the module's fixture)
from test_torch_reft import state_of

REPS = [{"layer": layer, "intervention": "LoreftIntervention", "low_rank_dimension": 4}
        for layer in (0, 1, 0, 1)]


@pytest.fixture(scope="module")
def reft_pair(pair):  # noqa: F811
    jm, tm = pair
    jr = jreft.get_reft_model(jm, jreft.ReftConfig(representations=REPS), rngs=nnx.Rngs(9))
    rng = np.random.default_rng(12)
    for _, v in nnx.to_flat_state(nnx.state(jr.interventions, nnx.Param)):
        v.set_value(v[...] + rng.normal(0, 0.3, v[...].shape).astype(np.float32))
    jr.eval()
    tr = treft.get_reft_model(tm, treft.ReftConfig(representations=REPS))
    load_jax_state(tr, state_of(jr))
    return jr, tr.eval()


def prompt_locations(mask, beams=1):
    """f2+l2 locations, untied: per row the first two and the last two real
    positions, in the padded prompt; -1 pads on the shortest prompts."""
    t = mask.shape[1]
    locs = []
    for row in mask:
        start = t - int(row.sum())
        first = [start + i if start + i < t else -1 for i in range(2)]
        last = [t - 2 + i if t - 2 + i >= start else -1 for i in range(2)]
        locs.append([first, last, first, last])
    return np.repeat(np.asarray(locs, np.int32), beams, axis=0)


@pytest.mark.parametrize("beams", [1, 4])
def test_torch_intervened_generation_matches_jax(reft_pair, beams):
    jr, tr = reft_pair
    ids, mask = prompts()
    locs = prompt_locations(mask, beams)
    cfg = dict(max_new_tokens=8, num_beams=beams, eos_token_id=None)
    want = np.asarray(jgen.generate(jr, ids, mask, jgen.GenerationConfig(**cfg),
                                    intervention_locations=locs))
    got = generate(tr, to_torch(ids, torch.long), to_torch(mask, torch.long),
                   GenerationConfig(**cfg), intervention_locations=to_torch(locs, torch.long))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = np.asarray(jgen.generate(jr.model, ids, mask, jgen.GenerationConfig(**cfg)))
    assert (plain != want).any()  # the interventions change the tokens


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "beam-4"])
def test_torch_reft_eval_matches_jax(reft_pair, greedy):
    """The ReFT branch of ``compute_reasoning_metrics``: math's
    greedy eval and its beam-4 (beam-sample near temperature 0 with top-k
    and top-p off, equal to beam search)."""
    jr, tr = reft_pair
    kw = dict(max_new_tokens=5, greedy_decoding=greedy)
    if not greedy:
        kw.update(top_k=0, top_p=1.0, temperature=1e-6)
    tok = dict(position="f2+l2", num_interventions=len(REPS))
    got_gens, got = metrics("port", tr, "math", tokenize=tok, **kw)
    want_gens, want = metrics("jax", jr, "math", tokenize=tok, **kw)
    assert got_gens == want_gens and got == want
    plain_gens, _ = metrics("jax", jr.model, "math", tokenize=tok, **kw)
    assert plain_gens != want_gens
