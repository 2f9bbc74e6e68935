"""The port's GLUE harness's ASHA search (``--do_tune``) against the JAX
harness's on the CPU, and the port's two deliberate differences there:

  * ``--do_tune=True`` on STS-B: 3 trials in two rungs, each resumed in its
    own directory, then the final run with the best hyperparameters
    (``test_torch_run_glue_baselines.run_both``: dropout off, each JAX
    build's state carried into the port's build at the same point);
  * ``--tune_grace=0`` (ROADMAP C.5: the port takes 0 as 0);
  * ``--lora=True`` alone (C.15: the port adapts with LoRA), and the search
    spaces and budgets equal to the JAX harness's.

Held: the trials' ids, hyperparameters and budgets equal, their pearson
within 1e-3 (``test_torch_run_glue_stsb.py``'s bound); the best
hyperparameters and the output files equal; the final run's logged losses
and ``eval_loss`` within ``TOLERANCES["f32_logits"]``.
"""

import json
import os
import sys

import numpy as np
import pytest

from sparse_matrix_fine_tuning_torch.models.config import RobertaConfig
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.peft.surgery import ScaledLoRA
from sparse_matrix_fine_tuning_torch.scripts import run_glue as port
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES
from test_torch_run_glue import config, losses
from test_torch_run_glue_baselines import REPO, run_both

sys.path.insert(0, REPO)
import run_glue as jax_harness  # noqa: E402  (the JAX harness at the root)

LOGITS = TOLERANCES["f32_logits"]
CORRELATION_ATOL = 1e-3


def test_torch_run_glue_do_tune_matches_jax(tmp_path):
    """3 STS-B trials (lr scaled 10x, so that three steps move the scores):
    the first rung of a third of an epoch each, the best one resumed to the
    whole epoch, then the final run with the best hyperparameters.  The
    sampled lrs differ, and their pearson values lie further apart than the
    frameworks' 1e-3, so no rung can rank two trials differently."""
    cut = ["--smoke=True", "--logging_steps=1", "--num_train_epochs=1", "--do_tune=True",
           "--n_trials=3", "--tune_grace=0.34", "--tune_lr_scale=10", "--resume=True"]
    want, got, jax_dir, port_dir, seen = run_both(config("monarch_roberta_glue", "stsb"),
                                                  tmp_path, cut=cut)
    states = [[json.loads(line) for line in open(d / "hpo_state.jsonl")]
              for d in (jax_dir, port_dir)]
    assert len(states[0]) == len(states[1]) == 4 and len(seen) == 5
    for a, b in zip(*states):
        assert (a["id"], a["hp"], a["epochs"]) == (b["id"], b["hp"], b["epochs"])
        assert abs(a["eval_pearson"] - b["eval_pearson"]) <= CORRELATION_ATOL
    first = sorted(r["eval_pearson"] for r in states[1][:3])
    assert min(np.diff(first)) > 2 * CORRELATION_ATOL
    assert [r["epochs"] for r in states[1]] == [0.34] * 3 + [1.0]
    assert got.search["best_hyperparams"] == json.loads(
        (jax_dir / "best_hyperparams.json").read_text())
    assert (port_dir / "best_hyperparams.json").read_text() == \
        (jax_dir / "best_hyperparams.json").read_text()
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    np.testing.assert_allclose(losses(port_dir), losses(jax_dir), **LOGITS)
    np.testing.assert_allclose(got.results["stsb"]["eval_loss"], want["stsb"]["eval_loss"],
                               **LOGITS)


def test_torch_run_glue_reads_tune_grace_zero(tmp_path, monkeypatch):
    """ROADMAP C.5: ``--tune_grace=0`` makes the first rung 0 epochs in the
    port; the JAX harness reads 0 as unset and takes the task's grace, 3."""
    calls = []

    def search(run_trial, space, **kw):
        calls.append(kw)
        return {"best_hyperparams": {"learning_rate": 1e-3}, "best_metric": 0.0, "trials": []}

    def build(*_, **__):
        raise AssertionError("no model: the search is stubbed, the final run is cut")

    monkeypatch.setattr(port, "hyperparameter_search", search)
    monkeypatch.setattr("sparse_matrix_fine_tuning_tpu.training.hpo.hyperparameter_search",
                        search)
    argv = [config("monarch_roberta_glue", "cola"), "--smoke=True", "--do_tune=True",
            "--num_train_epochs=5", "--tune_grace=0"]
    with pytest.raises(AssertionError, match="no model"):
        port.main([*argv, f"--output_dir={tmp_path / 'port'}", "--platform=cpu"], build=build)
    real_build = jax_harness.build_model
    monkeypatch.setattr(jax_harness, "build_model", build)
    monkeypatch.setattr(sys, "argv", ["run_glue.py", *argv, f"--output_dir={tmp_path / 'jax'}"])
    with pytest.raises(AssertionError, match="no model"):
        jax_harness.main()
    assert jax_harness.build_model is build and real_build is not build
    assert [(c["min_epochs"], c["max_epochs"]) for c in calls] == [(0.0, 5.0), (3.0, 5.0)]


def test_torch_run_glue_lora_flag_wins_over_monarch():
    """ROADMAP C.15: ``--lora=True`` alone adapts with LoRA in the port (the
    JAX harness needs ``--monarch=False``, and alone adapts nothing); the
    search spaces are the JAX harness's."""
    args, _ = port.parse_args([config("lora_roberta_glue", "cola"), "--lora=True",
                               "--smoke=True", "--platform=cpu"])
    model = RobertaForSequenceClassification(RobertaConfig.tiny(vocab_size=port.SMOKE_VOCAB),
                                             device="cpu")
    peft = json.load(open(os.path.join(REPO, "task_configs", "lora_roberta_glue",
                                       "peft_config.json")))
    port.adapt_model(model, args, peft, 0)
    assert sum(isinstance(m, ScaledLoRA) for m in model.modules()) == 6
    train_args = port.TrainingArgs(seed=7, weight_decay=0.01)
    for flags in ([], ["--boft=True"], ["--monarch=False"], ["--tune_blk_config=True"],
                  ["--n_trials=4", "--tune_lr_scale=10"]):
        a, _ = port.parse_args(["x.json", *flags])
        got = port.build_search_space(a, {"blk_r": 8, "nblocks": 2}, train_args)
        want = jax_harness.build_search_space(a, {"blk_r": 8, "nblocks": 2}, train_args)
        assert repr(got) == repr(want)
    for task in ("cola", "mrpc", "rte"):
        assert port.load_hpo_budget(task) == jax_harness.load_hpo_budget(task)
