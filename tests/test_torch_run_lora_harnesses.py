"""The LoRA baseline in the port's AG News and Alpaca harnesses, against
the JAX harnesses at the root on the CPU:

  * ``run_agnews --method lora`` (rank 8 on query and value, the head
    trains), as ``test_torch_run_agnews.py`` runs ``monarch`` and ``full``;
  * ``run_alpaca --adapter=lora`` (rank 4 x blk_r on every linear), as
    ``test_torch_run_alpaca.py`` runs ``--bits 16``.

Dropout is off in both packages; the JAX model's state, taken before
training, is carried into the port's build.  Held: the logged losses and
``eval_loss`` within ``TOLERANCES["f32_logits"]``; accuracies and MMLU
scores equal, MMLU's choice logits within the same bound; the parameter
counts as ``test_torch_run_agnews.py`` holds them (ROADMAP C.14).
"""

import json
import os
import sys

import numpy as np
from flax import nnx

import sparse_matrix_fine_tuning_tpu.peft as jpeft
from sparse_matrix_fine_tuning_torch.models.config import RobertaConfig
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.peft.surgery import ScaledLoRA, init_lora
from sparse_matrix_fine_tuning_torch.scripts import run_agnews
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES
from test_torch_run_alpaca import check_losses, check_mmlu
from test_torch_run_alpaca import run_both as alpaca_both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import run_agnews as jax_agnews  # noqa: E402  (the JAX harness at the root)

LOGITS = TOLERANCES["f32_logits"]


def flat_state(model) -> dict:
    return {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def records(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_torch_run_agnews_lora_matches_jax(tmp_path, monkeypatch):
    built = {}
    real_stats = jpeft.param_stats

    def stats(model, *a, **kw):
        for _, m in nnx.iter_modules(model):
            if isinstance(m, nnx.Dropout):
                m.rate = 0.0
        built["state"] = flat_state(model)
        built["rng"] = sum(v[...].size for _, v in nnx.to_flat_state(nnx.state(model,
                                                                                 nnx.RngState)))
        return real_stats(model, *a, **kw)

    def build(args):
        model = RobertaForSequenceClassification(
            RobertaConfig.tiny(num_labels=4, vocab_size=run_agnews.SMOKE_VOCAB,
                               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
            device="cpu")
        init_lora(model, run_agnews.LORA_PEFT)
        load_jax_state(model, built["state"])
        return model

    argv = ["--smoke=True", "-e", "0.25", "--logging_steps=1", "--method", "lora"]
    monkeypatch.setattr(jpeft, "param_stats", stats)
    monkeypatch.setattr(sys, "argv", ["run_agnews.py", *argv, f"--output_dir={tmp_path}/jax"])
    want = jax_agnews.main()
    got = run_agnews.run([*argv, f"--output_dir={tmp_path}/port", "--platform=cpu"],
                         build=build)
    loss = [[r["loss"] for r in records(tmp_path / d / "lora" / "metrics.jsonl") if "loss" in r]
            for d in ("jax", "port")]
    assert len(loss[0]) == len(loss[1]) == 2
    np.testing.assert_allclose(loss[1], loss[0], **LOGITS)
    np.testing.assert_allclose(got.result["eval_loss"], want["eval_loss"], **LOGITS)
    for key in ("method", "trainable_params", "eval_accuracy", "step"):
        assert got.result[key] == want[key], key
    assert got.result["total_params"] == want["total_params"] - built["rng"]
    trained = {n for n, p in got.trainer.model.named_parameters() if p.requires_grad}
    assert trained == {n for n, _ in got.trainer.model.named_parameters()
                       if n.endswith(("lora_a", "lora_b")) or n.startswith("classifier.")}
    assert sum(isinstance(m, ScaledLoRA) for m in got.trainer.model.modules()) == 4


def test_torch_run_alpaca_lora_matches_jax(tmp_path):
    both = alpaca_both(tmp_path, 16, extra=["--adapter=lora"])
    check_losses(both)
    check_mmlu(both)
    model = both["port"].trainer.model
    loras = [m for m in model.modules() if isinstance(m, ScaledLoRA)]
    assert len(loras) == 14 and all(m.lora_a.shape[1] == 16 for m in loras)  # r = 4 x blk_r
    assert both["port"].search is None
