"""The ASHA search (``--do_tune``) in the port's Alpaca and reasoning
harnesses, against the JAX harnesses at the root on the CPU:

  * ``run_alpaca --do_tune``: 2 trials of the lr and blk_r search, one step
    each, scored on 1-shot MMLU over 4 items;
  * ``run_reasoning --do_tune -task tune_math``: 2 trials of the lr, blk_r
    and nblocks search, scored by greedy generation; and its refusal of an
    open-ended task before any work.

Dropout is off in both packages; each JAX build's state, taken before
training, is carried into the port's build at the same point (a search
builds one model a trial, of the trial's blk_r and nblocks, then the final
run's).  Held: the trial records and best hyperparameters equal, and the
final run's accuracies, ``eval/*`` results and generations equal (the
searches' metrics are accuracies over a few items: ties are exact in both
packages, and a stable sort keeps them in trial order in both); its
``eval_loss`` within ``TOLERANCES["f32_logits"]``.
"""

import json
import os
import sys

import numpy as np
import pytest
from flax import nnx

from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch
from sparse_matrix_fine_tuning_torch.scripts import run_alpaca, run_reasoning
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES
from test_torch_run_alpaca import ARGV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import run_alpaca as jax_alpaca  # noqa: E402  (the JAX harnesses at the root)
import run_reasoning as jax_reasoning  # noqa: E402

LOGITS = TOLERANCES["f32_logits"]


def flat_state(model) -> dict:
    return {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def search_both(tmp_path, harness, port, argv, port_build):
    """A ``--do_tune`` run of the JAX harness and of the port on one argv,
    the JAX builds' states served to the port's builds in order."""
    states = []
    real_build = harness.build_model

    def jax_build(args, peft_config):
        model = real_build(args, peft_config)
        states.append(flat_state(model))
        return model

    old_argv, harness.build_model = sys.argv, jax_build
    try:
        sys.argv = ["harness.py", *argv, f"--output_dir={tmp_path / 'jax'}"]
        want = harness.main()
    finally:
        sys.argv, harness.build_model = old_argv, real_build

    def build(args, peft_config):
        model = port_build(args, peft_config)
        load_jax_state(model, states.pop(0))
        return model

    got = port.run([*argv, f"--output_dir={tmp_path / 'port'}", "--platform=cpu"], build=build)
    assert not states
    return want, got


def test_torch_run_alpaca_do_tune_matches_jax(tmp_path):
    argv = [a for a in ARGV if not a.startswith(("--max_steps", "--do_predict"))] + [
        "--max_steps=1", "--gradient_accumulation_steps=1", "--do_tune=True", "--n_trials=2",
        "--max_mmlu_samples=4"]

    def build(args, peft_config):
        model = LlamaForCausalLM(
            LlamaConfig.tiny(vocab_size=run_alpaca.SMOKE_VOCAB, hidden_size=128,
                             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                             intermediate_size=256, max_position_embeddings=2048),
            device="cpu")
        return run_alpaca.adapt_model(model, args, peft_config)

    want, got = search_both(tmp_path, jax_alpaca, run_alpaca, argv, build)
    trials = got.search["trials"]
    assert [(t["id"], t["epochs"]) for t in trials] == [(0, 1.0), (1, 1.0)]
    assert {t["hp"]["blk_r"] for t in trials} <= {4, 8, 16}
    best = json.loads((tmp_path / "jax" / "alpaca" / "best_hyperparams.json").read_text())
    assert got.search["best_hyperparams"] == best
    assert got.trainer.model.model.layers[0].self_attn.q_proj.blk_r == best["blk_r"]
    for key in ("eval_mmlu_eval_accuracy", "step"):
        assert got.metrics[key] == want[key], key
    np.testing.assert_allclose(got.metrics["eval_loss"], want["eval_loss"], **LOGITS)
    assert sorted(os.listdir(tmp_path / "port" / "alpaca")) == \
        sorted(os.listdir(tmp_path / "jax" / "alpaca"))


def test_torch_run_reasoning_do_tune_matches_jax(tmp_path):
    argv = ["-task", "tune_math", "--smoke=True", "-e", "1", "-batch_size", "8",
            "-gradient_accumulation_steps", "1", "--dropout=0.0", "--max_n_train_example=8",
            "--max_n_eval_example=4", "--do_tune=True", "--n_trials=2"]

    def build(args, peft_config):
        model = LlamaForCausalLM(
            LlamaConfig.tiny(vocab_size=run_reasoning.SMOKE_VOCAB, hidden_size=128,
                             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                             intermediate_size=256, max_position_embeddings=1024),
            device="cpu")
        init_monarch(model, peft_config)
        return model

    want, got = search_both(tmp_path, jax_reasoning, run_reasoning, argv, build)
    assert got.results == want and "eval/average" in want
    best = json.loads((tmp_path / "jax" / "tune_math" / "best_hyperparams.json").read_text())
    assert got.search["best_hyperparams"] == best
    assert [(t["id"], t["epochs"], t["eval/average"]) for t in got.search["trials"]] == \
        [(i, 1.0, t["eval/average"]) for i, t in enumerate(got.search["trials"])]
    for trial in ("trial_0", "trial_1"):
        gens = [tmp_path / d / "tune_math" / trial / "generations.json" for d in ("jax", "port")]
        assert json.loads(gens[1].read_text()) == json.loads(gens[0].read_text())
    with pytest.raises(SystemExit, match="open-ended"):
        run_reasoning.main(["-task", "alpaca", "--do_tune=True", "--platform=cpu",
                            f"--output_dir={tmp_path / 'never'}"],
                           build=lambda *_: pytest.fail("built a model"))
    assert not (tmp_path / "never").exists()
