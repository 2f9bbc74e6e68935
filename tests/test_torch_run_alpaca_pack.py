"""The port's Alpaca + MMLU harness against the JAX one on the CPU with
``--pack=True`` (sequence packing, JAX run_alpaca.py:265-275): the training
examples bin-packed into rows of source + target max len with segment
ids, the eval split unpacked.  ``test_torch_run_alpaca.py``'s runs and
checks, with its tolerances."""

import numpy as np
import pytest

from test_torch_run_alpaca import (
    check_losses,
    check_mmlu,
    check_predictions,
    check_watch_layers,
    run_both,
)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("alpaca_pack"), 16, extra=["--pack=True"])


def test_torch_alpaca_pack_losses_match_jax(both):
    check_losses(both)
    run = both["port"]
    packed, evals = run.trainer.train_data, run.trainer.eval_data
    assert set(packed) == {"input_ids", "attention_mask", "segment_ids", "labels"}
    assert packed["input_ids"].shape[1] == 128 + 64  # the smoke source + target max len
    n_examples = sum(len(set(row[row > 0])) for row in packed["segment_ids"])
    assert len(packed["input_ids"]) == 6 < n_examples == 26  # 32 items, 6 held out
    assert "segment_ids" not in evals
    np.testing.assert_array_equal(packed["attention_mask"], packed["segment_ids"] > 0)


def test_torch_alpaca_pack_mmlu_matches_jax(both):
    check_mmlu(both)


def test_torch_alpaca_pack_watch_layers_match_jax(both):
    check_watch_layers(both)


def test_torch_alpaca_pack_predictions_match_jax(both):
    check_predictions(both)
