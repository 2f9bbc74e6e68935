"""The port's reasoning harness (``scripts/run_reasoning.py``) against the JAX
one (``run_reasoning.py`` at the repository's root) on the CPU.

Both ``main``s run the JAX harness's smoke argv (``-task math --smoke=True``,
``tests/harness/test_run_reasoning.py``) at fewer examples (16 to train: 2
optimizer steps of 2 micro-batches of 8; 4 to evaluate a dataset, a ragged
batch of the 8 the eval takes) and ``--dropout=0.0`` (the frameworks draw
other dropout masks); the port's model is the JAX harness's first model,
carried across with ``utils/jax_bridge.load_jax_state`` before either
trains.  The logged losses agree within ``TOLERANCES["f32_logits"]``
(float32 sums in another order through two layers and two AdamW steps);
the ``eval/<dataset>`` keys and values and the generations are equal.  Then
``-task instruct``'s alpaca_eval dump.  ``test_torch_run_reasoning_options.py``
holds ``--model <tiny HF dir>`` and the refusals.
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
from sparse_matrix_fine_tuning_torch.scripts import run_reasoning as port
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import run_reasoning as jax_harness  # noqa: E402  (the JAX harness at the root)

LOGITS = TOLERANCES["f32_logits"]
SMOKE = ["-task", "math", "--smoke=True", "-e", "2", "-batch_size", "8",
         "-gradient_accumulation_steps", "2", "--logging_steps=1", "--dropout=0.0",
         "--max_n_train_example=16", "--max_n_eval_example=4"]


def records(out_dir: str, task: str, name: str):
    with open(os.path.join(out_dir, task, name)) as f:
        return [json.loads(line) for line in f] if name.endswith(".jsonl") else json.load(f)


def flat_state(model) -> dict:
    return {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def tiny_build(state):
    """The port's ``build`` seam: the smoke model's structure with the JAX
    harness's weights."""
    def build(args, peft_config):
        model = LlamaForCausalLM(
            LlamaConfig.tiny(vocab_size=port.SMOKE_VOCAB, hidden_size=128, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2,
                             intermediate_size=256, max_position_embeddings=1024),
            device="cpu")
        init_monarch(model, peft_config)
        load_jax_state(model, state)
        return model
    return build


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reasoning")
    jax_dir, port_dir = str(tmp / "jax"), str(tmp / "port")
    built = {}
    real_build = jax_harness.build_model

    def jax_build(args, peft_config):
        model = real_build(args, peft_config)
        built["state"] = flat_state(model)
        return model

    old_argv, jax_harness.build_model = sys.argv, jax_build
    try:
        sys.argv = ["run_reasoning.py", *SMOKE, f"--output_dir={jax_dir}"]
        jax_results = jax_harness.main()
    finally:
        sys.argv, jax_harness.build_model = old_argv, real_build
    result = port.run([*SMOKE, f"--output_dir={port_dir}", "--platform=cpu"],
                      build=tiny_build(built["state"]))
    return {"jax": jax_results, "port": result, "jax_dir": jax_dir, "port_dir": port_dir}


def test_torch_reasoning_losses_match_jax(both):
    want = [r["loss"] for r in records(both["jax_dir"], "math", "metrics.jsonl") if "loss" in r]
    got = [r["loss"] for r in records(both["port_dir"], "math", "metrics.jsonl") if "loss" in r]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, **LOGITS)


def test_torch_reasoning_eval_matches_jax(both):
    got = both["port"].results
    assert got == both["jax"]
    assert len(got) == 8 and "eval/average" in got  # seven datasets and their mean
    assert records(both["port_dir"], "math", "eval_results.json") == got
    logged = records(both["port_dir"], "math", "metrics.jsonl")
    assert any(k.startswith("watch/") for r in logged for k in r)
    assert {k: v for k, v in logged[-2].items() if k.startswith("eval/")} == got


def test_torch_reasoning_generations_match_jax(both):
    got = records(both["port_dir"], "math", "generations.json")
    assert len(got) == 7 * 4 and got == records(both["jax_dir"], "math", "generations.json")


def test_torch_reasoning_evaluate_is_the_harness_eval(both, tmp_path):
    """``ReasoningRun.evaluate`` on the trained model repeats the run's
    greedy eval."""
    again = both["port"].evaluate(out=str(tmp_path))
    assert again == both["port"].results
    assert json.loads((tmp_path / "generations.json").read_text()) == \
        records(both["port_dir"], "math", "generations.json")


def test_torch_reasoning_instruct_dumps_alpaca_eval_generations(tmp_path):
    results = port.main(["-task", "instruct", "--smoke=True", "-p", "f5+l5", "-e", "1",
                         "-batch_size", "4", "-gradient_accumulation_steps", "1",
                         "-max_length", "96", f"--output_dir={tmp_path}", "--logging_steps=0",
                         "--max_n_train_example=8", "--max_n_eval_example=3",
                         "--platform=cpu"])
    assert results == {}
    gens = json.loads((tmp_path / "instruct" / "generations.json").read_text())
    assert len(gens) == 3
    assert all(set(g) == {"instruction", "output", "dataset", "generator"} for g in gens)
    assert {g["dataset"] for g in gens} == {"alpaca_eval"}
