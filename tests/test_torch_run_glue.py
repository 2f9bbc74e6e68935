"""The port's GLUE harness (``scripts/run_glue.py``) against the JAX one
(``run_glue.py`` at the repository's root) on the CPU.

Both ``main``s run ``task_configs/monarch_roberta_glue/<task>.json
--smoke=True`` (the tiny RoBERTa, the synthetic splits, the recipe's
adapters, batch 16, length grouping) cut to 3 optimizer steps with the loss
logged at each (``--max_steps=3 --logging_steps=1``; CoLA and MNLI at 100
times the recipe's learning rate, so that the predictions move), then the recipe's
final eval (load the best checkpoint) and ``do_predict``'s TSV files.
Dropout is off in both (the frameworks draw other masks): the JAX
harness's ``build_model`` is wrapped to set every ``nnx.Dropout``'s rate to
0 and to keep its initial state, which the port's ``build`` carries across
with ``utils/jax_bridge.load_jax_state``.  CoLA (matthews), MNLI (three
labels, matched and mismatched evals, two TSV files) and STS-B
(regression, ``test_torch_run_glue_stsb.py``).

Held: the logged losses and ``eval_loss`` within ``TOLERANCES["f32_logits"]``
(float32 sums in another order through the steps); the classification
metrics and the TSV files equal; the refusals of items 21 and 22.
"""

import json
import os
import sys

import numpy as np
import pytest
from flax import nnx

from sparse_matrix_fine_tuning_torch.models.config import RobertaConfig
from sparse_matrix_fine_tuning_torch.models.deberta import (
    DebertaV2Config,
    DebertaV2ForSequenceClassification,
)
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch
from sparse_matrix_fine_tuning_torch.scripts import run_glue as port
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import run_glue as jax_harness  # noqa: E402  (the JAX harness at the root)

LOGITS = TOLERANCES["f32_logits"]
STEPS = 3
CUT = ["--smoke=True", f"--max_steps={STEPS}", "--logging_steps=1"]
# 100x the recipes' rate, so that 3 steps move the predictions off one class
FAST = ["--learning_rate=0.003"]
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def config(family: str, task: str) -> str:
    return os.path.join(REPO, "task_configs", family, f"{task}.json")


def flat_state(model) -> dict:
    return {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def port_build(state: dict):
    """The port's ``build`` seam: the smoke encoder of the config's family,
    without dropout, adapted as the harness adapts it, carrying the JAX
    harness's initial weights."""
    def build(args, data_args, peft_config, num_labels, seed):
        if "deberta" in data_args.model_name_or_path.lower():
            cfg = DebertaV2Config.tiny(num_labels=num_labels, vocab_size=port.SMOKE_VOCAB,
                                       **NO_DROPOUT)
            model = DebertaV2ForSequenceClassification(cfg, device="cpu")
        else:
            cfg = RobertaConfig.tiny(num_labels=num_labels, vocab_size=port.SMOKE_VOCAB,
                                     **NO_DROPOUT)
            model = RobertaForSequenceClassification(cfg, device="cpu")
        init_monarch(model, peft_config)
        load_jax_state(model, state)
        return model
    return build


def run_both(config_path: str, out, extra=()):
    """The JAX harness's ``main`` and the port's ``run`` on one argv; returns
    (JAX results, port GlueRun, JAX task dir, port task dir)."""
    built = {}
    real_build = jax_harness.build_model

    def jax_build(*a, **kw):
        model = real_build(*a, **kw)
        for _, m in nnx.iter_modules(model):
            if isinstance(m, nnx.Dropout):
                m.rate = 0.0
        built["state"] = flat_state(model)
        return model

    argv = [config_path, *CUT, *extra]
    old_argv, jax_harness.build_model = sys.argv, jax_build
    try:
        sys.argv = ["run_glue.py", *argv, f"--output_dir={out / 'jax'}"]
        want = jax_harness.main()
    finally:
        sys.argv, jax_harness.build_model = old_argv, real_build
    got = port.run([*argv, f"--output_dir={out / 'port'}", "--platform=cpu"],
                   build=port_build(built["state"]))
    task = next(iter(want))
    return want, got, out / "jax" / task, out / "port" / task


def losses(task_dir) -> list:
    with open(os.path.join(task_dir, "metrics.jsonl")) as f:
        return [r["loss"] for r in map(json.loads, f) if "loss" in r]


def check_results(want: dict, got: dict, skip=()) -> None:
    """Equal keys but ``skip``; eval_loss within LOGITS; every other metric
    equal."""
    assert got.keys() == want.keys()
    for split, metrics in want.items():
        assert set(got[split]) - set(skip) == set(metrics)
        for key, value in metrics.items():
            if key == "eval_loss":
                np.testing.assert_allclose(got[split][key], value, **LOGITS)
            else:
                assert got[split][key] == value, (split, key)


def check_run(want, got, jax_dir, port_dir, tsvs, skip=()) -> None:
    want_losses, got_losses = losses(jax_dir), losses(port_dir)
    assert len(got_losses) == len(want_losses) == STEPS
    np.testing.assert_allclose(got_losses, want_losses, **LOGITS)
    check_results(want, got.results, skip)
    assert [os.path.basename(p) for p in got.tsv_paths] == tsvs
    for name in tsvs:
        text = (port_dir / "predict" / name).read_text()
        assert text == (jax_dir / "predict" / name).read_text()
        assert text.startswith("index\tprediction\n") and len(text.splitlines()) > 32


@pytest.fixture(scope="module")
def cola(tmp_path_factory):
    return run_both(config("monarch_roberta_glue", "cola"), tmp_path_factory.mktemp("cola"),
                    FAST)


def test_torch_run_glue_cola_matches_jax(cola):
    want, got, jax_dir, port_dir = cola
    check_run(want, got, jax_dir, port_dir, ["CoLA.tsv"])
    assert "eval_matthews_correlation" in got.results["cola"]
    assert got.trainer.step == STEPS


def test_torch_run_glue_logs_as_jax(cola):
    """``metrics.jsonl`` holds the same records, keys and adapter watch
    statistics as the JAX harness's."""
    _, got, jax_dir, port_dir = cola

    def keys(task_dir):
        with open(os.path.join(task_dir, "metrics.jsonl")) as f:
            return [sorted(k for k in json.loads(line) if not k.startswith("_"))
                    for line in f]
    assert keys(port_dir) == keys(jax_dir)
    assert (port_dir / "full_group.txt").read_text() == (jax_dir / "full_group.txt").read_text()


def test_torch_run_glue_mnli_matches_jax(tmp_path):
    want, got, jax_dir, port_dir = run_both(config("monarch_roberta_glue", "mnli"), tmp_path,
                                            FAST)
    check_run(want, got, jax_dir, port_dir, ["MNLI-m.tsv", "MNLI-mm.tsv"])
    assert set(got.results) == {"mnli", "mnli-mm"}


@pytest.mark.parametrize("flag,item", [("--do_tune=True", "item 21"), ("--lora=True", "item 22"),
                                       ("--boft=True", "item 22")])
def test_torch_run_glue_refuses_unported_options(tmp_path, flag, item):
    def build(*_):
        raise AssertionError("a refused option built a model")

    with pytest.raises(NotImplementedError, match=item):
        port.main([config("monarch_roberta_glue", "cola"), "--smoke=True", flag,
                   f"--output_dir={tmp_path}", "--platform=cpu"], build=build)
    assert not any(tmp_path.iterdir())
