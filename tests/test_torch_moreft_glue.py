"""MoReFT GLUE (``scripts/run_reasoning.py --task glue``) against the JAX
harness on the CPU: the reference's reasoning_scripts/moreft_glue.sh recipe
(MoReIntervention, ``-p f1``, ``--allow_cls_grad``) at the smoke size
(the tiny RoBERTa, the synthetic CoLA split, 2 optimizer steps of 16), with
and without the classifier training.  Dropout is off in both (the
frameworks draw other masks): the JAX harness's ``get_reft_model`` is
wrapped to set every ``nnx.Dropout``'s rate to 0 and keep the wrapped
model's initial state, which the port's ``build`` carries across.  Held:
the logged losses within ``TOLERANCES["f32_logits"]``, the metrics and
``metrics.json`` equal.  Then ``tokenize_glue_reft`` bit for bit."""

import json
import sys

import numpy as np
import pytest
from flax import nnx

from sparse_matrix_fine_tuning_torch.data import reasoning as treasoning
from sparse_matrix_fine_tuning_torch.data.glue import load_glue_raw
from sparse_matrix_fine_tuning_torch.data.tokenizer import SimpleTokenizer
from sparse_matrix_fine_tuning_torch.models.config import RobertaConfig
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.scripts import run_reasoning as port
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_tpu import interventions as jinterventions
from sparse_matrix_fine_tuning_tpu.data import reasoning as jreasoning
from sparse_matrix_fine_tuning_tpu.data.glue import load_glue_raw as jax_load_glue_raw
from sparse_matrix_fine_tuning_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from test_torch_reft import state_of
from test_torch_run_reasoning import LOGITS, jax_harness

ARGV = ["-task", "glue", "-train_dataset", "cola", "-p", "f1", "-e", "1", "-lr", "3e-3",
        "--intervention_type=MoReIntervention", "-batch_size", "16",
        "-gradient_accumulation_steps", "1", "-max_length", "64", "-rank", "4",
        "--smoke=True", "--max_steps=2", "--logging_steps=1"]


def port_build(state):
    def build(args, num_labels, vocab_size):
        cfg = RobertaConfig.tiny(num_labels=num_labels, vocab_size=vocab_size,
                                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        model = port.wrap_reft(RobertaForSequenceClassification(cfg, device="cpu"), args,
                               port.glue_intervention_type(args))
        load_jax_state(model, state)
        return model
    return build


@pytest.mark.parametrize("extra", [["-allow_cls_grad"], []], ids=["cls-grad", "interventions"])
def test_torch_moreft_glue_matches_jax(tmp_path, monkeypatch, capsys, extra):
    built = {}
    real = jinterventions.get_reft_model

    def jax_get_reft_model(*a, **kw):
        model = real(*a, **kw)
        for _, m in nnx.iter_modules(model):
            if isinstance(m, nnx.Dropout):
                m.rate = 0.0
        built["state"] = state_of(model)
        return model

    monkeypatch.setattr(jinterventions, "get_reft_model", jax_get_reft_model)
    monkeypatch.setattr(sys, "argv", ["run_reasoning.py", *ARGV, *extra,
                                      f"--output_dir={tmp_path / 'jax'}"])
    want = jax_harness.main()
    jax_log = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith('{"step"')]
    got = port.run([*ARGV, *extra, f"--output_dir={tmp_path / 'port'}", "--platform=cpu"],
                   build=port_build(built["state"]))
    assert got.results == want and "matthews_correlation" in want
    assert json.loads((tmp_path / "port" / "glue_cola" / "metrics.json").read_text()) == \
        json.loads((tmp_path / "jax" / "glue_cola" / "metrics.json").read_text())
    losses = [r["loss"] for r in got.trainer.log_history if "loss" in r]
    assert len(losses) == len(jax_log) == 2
    np.testing.assert_allclose(losses, [r["loss"] for r in jax_log], **LOGITS)
    trains = {n for n, p in got.trainer.model.named_parameters() if p.requires_grad}
    assert any("classifier" in n for n in trains) == bool(extra)
    assert not any(".roberta." in n for n in trains)
    assert got.evaluate() == want


@pytest.mark.parametrize("position,n,share", [("f1", 2, False), ("f3+l3", 4, False),
                                              ("f2+l2", 2, True)])
def test_torch_tokenize_glue_reft_matches_jax_bit_for_bit(position, n, share):
    kw = dict(position=position, num_interventions=n, share_weights=share, max_seq_length=24)
    want = jreasoning.tokenize_glue_reft("mrpc", jax_load_glue_raw("mrpc", smoke=True),
                                         JaxTokenizer(1024), **kw)
    got = treasoning.tokenize_glue_reft("mrpc", load_glue_raw("mrpc", smoke=True),
                                        SimpleTokenizer(1024), **kw)
    assert got.keys() == want.keys()
    for split in want:
        assert got[split].keys() == want[split].keys()
        for key, value in want[split].items():
            assert got[split][key].dtype == value.dtype
            np.testing.assert_array_equal(got[split][key], value)
