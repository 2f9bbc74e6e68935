"""The port's GLUE harness against the JAX one on STS-B (regression: one
logit, the squared-error loss, float labels, pearson and spearman, scores
in the TSV as %3.3f) and on DeBERTa (``task_configs/deberta_glue/mrpc.json``,
a sentence-pair task: accuracy and f1), as ``test_torch_run_glue.py`` runs
them: 3 steps, dropout off, the JAX harness's initial weights carried
across.

Held: the logged losses and ``eval_loss`` within
``TOLERANCES["f32_logits"]``; accuracy, f1 and the TSV files equal;
pearson and spearman within 1e-3: three steps from a random init leave the
scores close together, and a correlation divides the frameworks' float32
differences in the scores by the scores' spread (1.3e-5 apart at the
recipe's rate here, 1.1e-4 at 100 times it).
"""

import numpy as np

from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES
from test_torch_run_glue import FAST, STEPS, check_run, config, losses, run_both

LOGITS = TOLERANCES["f32_logits"]
CORRELATION_ATOL = 1e-3


def test_torch_run_glue_stsb_matches_jax(tmp_path):
    want, got, jax_dir, port_dir = run_both(config("monarch_roberta_glue", "stsb"), tmp_path)
    scores = ("eval_pearson", "eval_spearmanr")
    for key in scores:
        np.testing.assert_allclose(got.results["stsb"][key], want["stsb"][key], rtol=0,
                                   atol=CORRELATION_ATOL)
    check_run({"stsb": {k: v for k, v in want["stsb"].items() if k not in scores}},
              got, jax_dir, port_dir, ["STS-B.tsv"], skip=scores)
    assert got.trainer.model.config.num_labels == 1
    assert got.trainer.train_data["labels"].dtype == np.float32


def test_torch_run_glue_deberta_mrpc_matches_jax(tmp_path):
    want, got, jax_dir, port_dir = run_both(config("deberta_glue", "mrpc"), tmp_path, FAST)
    check_run(want, got, jax_dir, port_dir, ["MRPC.tsv"])
    assert {"eval_accuracy", "eval_f1"} <= set(got.results["mrpc"])
    assert type(got.trainer.model).__name__ == "DebertaV2ForSequenceClassification"
    assert len(losses(port_dir)) == STEPS
