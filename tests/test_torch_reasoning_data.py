"""The port's copy of the reasoning harness's tokenizing
(``data/reasoning.py``: ``parse_positions``, ``get_intervention_locations``,
``tokenize_reasoning``) against the JAX package's, bit for bit: the arrays'
values and dtypes, for the math, commonsense, gsm8k and instruct tasks'
synthetic items, train (right-padded, with labels) and eval (left-padded)
splits, at positions f7+l7 and f5+l5, tied and untied, one and four
interventions, and at a max length that truncates."""

import numpy as np
import pytest

from sparse_matrix_fine_tuning_torch.data import reasoning as treasoning
from sparse_matrix_fine_tuning_torch.data.tokenizer import SimpleTokenizer
from sparse_matrix_fine_tuning_tpu.data import reasoning as jreasoning


@pytest.mark.parametrize("positions", ["f7+l7", "f5+l5", "f3", "l2", "f1+l0"])
def test_torch_parse_positions_matches_jax(positions):
    assert treasoning.parse_positions(positions) == jreasoning.parse_positions(positions)


@pytest.mark.parametrize("last_position", [1, 4, 9, 30])
@pytest.mark.parametrize("share,n,mode", [(True, 1, "first"), (False, 4, "first"),
                                          (False, 2, "last"), (True, 3, "last")])
def test_torch_intervention_locations_match_jax(last_position, share, n, mode):
    for first_n, last_n in ((7, 7), (5, 0), (0, 3), (2, 6)):
        kw = dict(last_position=last_position, first_n=first_n, last_n=last_n,
                  num_interventions=n, share_weights=share, pad_mode=mode)
        assert treasoning.get_intervention_locations(**kw) == \
            jreasoning.get_intervention_locations(**kw)


@pytest.mark.parametrize("task", ["math", "commonsense", "gsm8k", "instruct"])
@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("position,share,n", [("f7+l7", True, 1), ("f5+l5", False, 4)])
def test_torch_tokenize_reasoning_matches_jax(task, split, position, share, n):
    items = jreasoning.load_data_items(task, "any", "unused", smoke=True, smoke_n=12, seed=3)
    assert treasoning.load_data_items(task, "any", "unused", smoke=True, smoke_n=12,
                                      seed=3) == items
    tok = SimpleTokenizer(vocab_size=1024)
    for max_length in (512, 12):  # the second truncates every row
        kw = dict(max_length=max_length, split=split, position=position,
                  num_interventions=n, share_weights=share)
        got = treasoning.tokenize_reasoning(task, items, tok, **kw)
        want = jreasoning.tokenize_reasoning(task, items, tok, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        assert ("labels" in got) is (split == "train")
