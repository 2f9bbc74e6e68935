"""The port's Alpaca harness against the JAX one on the CPU with
``--resume=True``: 2 optimizer steps of 2 micro-batches (4 steps an
epoch: 26 training items), then a second run of each harness into the same output directory
with ``--max_steps=4 --resume=True``, which goes on from the first run's
checkpoint mid-epoch.  The four logged losses and the eval loss within 1e-4
of the JAX harness's (``TOLERANCES["f32_logits"]``, as
``test_torch_run_alpaca.py``); and, bit for bit, the port's resumed run
against a straight 4-step run: the logged losses and the trained
factors."""

import numpy as np
import pytest
import torch

from sparse_matrix_fine_tuning_torch.scripts import run_alpaca as port
from test_torch_run_alpaca import LOGITS, _records, run_both

ARGV = ["--smoke=True", "--dropout=0.0", "--logging_steps=1", "--max_n_train_example=32",
        "--eval_dataset_size=8", "--do_mmlu_eval=False", "--gradient_accumulation_steps=2"]
LEGS = (["--max_steps=2"], ["--max_steps=4", "--resume=True"])


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    out = run_both(tmp_path_factory.mktemp("alpaca_resume"), 16, argv=ARGV, legs=LEGS)
    straight = str(out["port_dir"]) + "_straight"
    out["straight"] = port.run([*ARGV, "--bits", "16", "--max_steps=4",
                                f"--output_dir={straight}", "--platform=cpu"], build=out["build"])
    out["straight_dir"] = straight
    return out


def _losses(out_dir):
    return [r["loss"] for r in _records(out_dir, "metrics.jsonl") if "loss" in r]


def test_torch_alpaca_resume_matches_jax(both):
    want, got = _losses(both["jax_dir"]), _losses(both["port_dir"])
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, **LOGITS)
    np.testing.assert_allclose(both["port"].metrics["eval_loss"], both["jax"]["eval_loss"],
                               **LOGITS)
    assert both["port"].trainer.step == 4


def test_torch_alpaca_resume_matches_a_straight_run(both):
    assert _losses(both["port_dir"]) == _losses(both["straight_dir"])
    resumed = dict(both["port"].trainer.model.named_parameters())
    for name, p in both["straight"].trainer.model.named_parameters():
        if p.requires_grad:
            assert torch.equal(resumed[name], p), name
