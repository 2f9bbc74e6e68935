"""The port's Alpaca + MMLU harness against the JAX one on the CPU over an
int4 base (``--bits 4``, group 64; the JAX codes and scales are carried
across bit for bit): ``test_torch_run_alpaca.py``'s runs and checks, with
its tolerances."""

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
    return run_both(tmp_path_factory.mktemp("alpaca4"), 4)


def test_torch_alpaca_int4_losses_match_jax(both):
    check_losses(both)


def test_torch_alpaca_int4_mmlu_matches_jax(both):
    check_mmlu(both)


def test_torch_alpaca_int4_watch_layers_match_jax(both):
    check_watch_layers(both)


def test_torch_alpaca_int4_predictions_match_jax(both):
    check_predictions(both)
