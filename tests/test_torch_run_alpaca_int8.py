"""The port's Alpaca + MMLU harness against the JAX one on the CPU over an
int8 base (``--bits 8``: the port's int8 quantizer matches the JAX one bit
for bit): ``test_torch_run_alpaca.py``'s runs and checks, with its
tolerances."""

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
    return run_both(tmp_path_factory.mktemp("alpaca8"), 8)


def test_torch_alpaca_int8_losses_match_jax(both):
    check_losses(both)


def test_torch_alpaca_int8_mmlu_matches_jax(both):
    check_mmlu(both)


def test_torch_alpaca_int8_watch_layers_match_jax(both):
    check_watch_layers(both)


def test_torch_alpaca_int8_predictions_match_jax(both):
    check_predictions(both)
