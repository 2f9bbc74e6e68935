"""The port's Alpaca + MMLU harness against the JAX one on the CPU with
``--optim adamw8bit`` over an int4 base (``--bits 4``, the QLoRA pairing):
``test_torch_run_alpaca.py``'s runs and checks, with its tolerances."""

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
    return run_both(tmp_path_factory.mktemp("alpaca8bit"), 4, extra=["--optim=adamw8bit"])


def test_torch_alpaca_adamw8bit_losses_match_jax(both):
    check_losses(both)
    opt = both["port"].trainer.optimizer
    assert type(opt.opt).__name__ == "AdamW8bit"


def test_torch_alpaca_adamw8bit_mmlu_matches_jax(both):
    check_mmlu(both)


def test_torch_alpaca_adamw8bit_watch_layers_match_jax(both):
    check_watch_layers(both)


def test_torch_alpaca_adamw8bit_predictions_match_jax(both):
    check_predictions(both)
