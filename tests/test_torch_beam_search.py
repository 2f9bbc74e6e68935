"""The port's ``beam_generate`` against the JAX one on the CPU in float32,
on ``test_torch_generate.py``'s model and prompts: beam 4 with early
stopping on and off at length penalties 0, 0.6 and 2, with an EOS reached
mid-search, and over a head whose logits tie in pairs; beam 1 against
greedy.  The tokens must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_generate import LENS, both, pair  # noqa: F401  (the module's fixture)


@pytest.mark.parametrize("early_stopping", [True, False])
@pytest.mark.parametrize("length_penalty", [0.0, 0.6, 2.0])
def test_torch_beam_search_matches_jax(pair, early_stopping, length_penalty):
    got, want = both(pair, beam=True, num_beams=4, early_stopping=early_stopping,
                     length_penalty=length_penalty)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("step", [1, 4])
def test_torch_beam_search_eos_mid_search_matches_jax(pair, step):
    """EOS is the token row 0's best beam emits at ``step`` without one, so
    hypotheses finish mid-search and fill their tails (pad 0: EOS, HF's
    rule)."""
    free, _ = both(pair, beam=True, num_beams=4, eos_token_id=None)
    eos = int(free[0, max(LENS) + step])
    got, want = both(pair, beam=True, num_beams=4, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    assert (got[:, max(LENS):] == eos).any()


def test_torch_beam_of_one_is_greedy(pair):
    """Without EOS, one beam keeps the argmax path: greedy's tokens."""
    greedy, jax_greedy = both(pair, eos_token_id=None)
    got, want = both(pair, beam=True, num_beams=1, eos_token_id=None)
    np.testing.assert_array_equal(got, greedy)
    np.testing.assert_array_equal(want, jax_greedy)


@pytest.fixture(scope="module")
def tied_pair():
    """The pair with the head's second half a copy of its first: every
    token's logit ties with its twin's, and the beams' pools hold ties."""
    jm, tm = pair.__wrapped__()
    kernel = np.array(jm.lm_head.kernel[...])
    kernel[:, 128:] = kernel[:, :128]
    jm.lm_head.kernel.set_value(jnp.array(kernel))
    with torch.no_grad():
        tm.lm_head.weight[128:] = tm.lm_head.weight[:128]
    return jm, tm


def test_torch_beam_search_ties_match_jax(tied_pair):
    """``lax.top_k`` takes the lower index among ties, and so does the
    port's stable sort (``torch.topk`` does not promise an order)."""
    got, want = both(tied_pair, beam=True, num_beams=4, eos_token_id=None)
    np.testing.assert_array_equal(got, want)
