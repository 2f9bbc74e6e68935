"""The reasoning harness over the other decoder families' tiny HF-format
directories (``test_torch_run_alpaca_families.write_family_dir``, float32,
32000 ids) in both packages on the CPU, without ``--smoke``: ``-task
commonsense`` for 2 steps of 4 rows at max length 64, then its greedy eval
of 4 boolq items, both harnesses loading in float32 (as
``test_torch_run_alpaca_families.py`` says why).  Gemma here, with the peft config's targets (the Llama's
seven names: 14 layers adapted); GPT-2 in
``test_torch_run_reasoning_gpt2.py`` with ``--all_linear=False`` (its fused
``c_attn`` alone: 2).  The port's model takes the JAX model's state before
either trains.  Held: the same adapted layers, the logged losses within
``TOLERANCES["f32_logits"]``, ``eval_results.json`` and
``generations.json`` equal.

ROADMAP.md C.18: over GPT-2 with the default ``--all_linear=True`` the
Llama's names match no layer, and both harnesses refuse to train nothing.
C.19: the JAX harness reads ``num_hidden_layers`` from ``config.json``,
which GPT-2's (``n_layer``) lacks, so the GPT-2 directories given to both
here carry it too; over one without it, the JAX harness raises KeyError and
the port's runs.
"""

import json
import os
import sys

import numpy as np
import pytest

from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear
from sparse_matrix_fine_tuning_torch.scripts import run_reasoning as port
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import MonarchLinear as JaxMonarch
from test_torch_run_alpaca_families import adapted_names, jax_loads_float32, write_family_dir
from test_torch_run_reasoning import flat_state, jax_harness, records

LOGITS = TOLERANCES["f32_logits"]

ARGV = ["-task", "commonsense", "-e", "1", "-batch_size", "4", "-gradient_accumulation_steps",
        "1", "--logging_steps=1", "--dropout=0.0", "--max_steps=2", "--max_n_train_example=8",
        "--max_n_eval_example=4", "-eval_dataset", "boolq", "-max_length", "64"]


def write_dir(path, family: str, num_hidden_layers: bool = True) -> str:
    write_family_dir(path, family)
    if num_hidden_layers:
        with open(path / "config.json") as f:
            hf = json.load(f)
        hf.setdefault("num_hidden_layers", hf.get("n_layer"))
        with open(path / "config.json", "w") as f:
            json.dump(hf, f)
    return str(path)


def run_jax(argv, built):
    real_build = jax_harness.build_model

    def jax_build(args, peft_config):
        model = real_build(args, peft_config)
        built["state"] = flat_state(model)
        built["jax_adapted"] = adapted_names(model, JaxMonarch)
        return model

    old_argv, jax_harness.build_model = sys.argv, jax_build
    try:
        sys.argv = ["run_reasoning.py", *argv]
        with jax_loads_float32():
            return jax_harness.main()
    finally:
        sys.argv, jax_harness.build_model = old_argv, real_build


def check_family_run(tmp_path, family: str, extra: list, n_adapted: int):
    argv = ["--model", write_dir(tmp_path / "ckpt", family), *ARGV, *extra]
    built = {}
    jax_results = run_jax([*argv, f"--output_dir={tmp_path / 'jax'}"], built)

    def bridged(args, peft_config):
        model = port.build_model(args, peft_config, dtype="float32")
        built["port_adapted"] = adapted_names(model, MonarchLinear)
        load_jax_state(model, built["state"])
        return model

    result = port.run([*argv, f"--output_dir={tmp_path / 'port'}", "--platform=cpu"],
                      build=bridged)
    assert built["port_adapted"] == built["jax_adapted"]
    assert len(built["port_adapted"]) == n_adapted
    dirs = [str(tmp_path / d) for d in ("jax", "port")]
    want, got = ([r["loss"] for r in records(d, "commonsense", "metrics.jsonl") if "loss" in r]
                 for d in dirs)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, **LOGITS)
    assert result.results == jax_results and "eval/boolq" in jax_results
    for name in ("eval_results.json", "generations.json"):
        files = [records(d, "commonsense", name) for d in dirs]
        assert files[1] == files[0] and files[0], name


def test_torch_reasoning_over_gemma_matches_jax(tmp_path):
    check_family_run(tmp_path, "gemma", [], 2 * 7)


def test_torch_reasoning_over_gpt2_all_linear_trains_nothing_as_jax(tmp_path):
    argv = ["--model", write_dir(tmp_path / "ckpt", "gpt2"), *ARGV]
    with pytest.raises(AssertionError, match="training nothing"):
        run_jax([*argv, f"--output_dir={tmp_path / 'jax'}"], {})
    with pytest.raises(ValueError, match="training nothing"):
        port.run([*argv, f"--output_dir={tmp_path / 'port'}", "--platform=cpu"])


def test_torch_reasoning_reads_gpt2_layer_count(tmp_path):
    argv = ["--model", write_dir(tmp_path / "ckpt", "gpt2", num_hidden_layers=False), *ARGV,
            "--all_linear=False", "--max_steps=1", "--intervention_type=LoreftIntervention",
            "-l", "all", "-p", "f1", "-sw"]
    with pytest.raises(KeyError, match="num_hidden_layers"):
        run_jax([*argv, f"--output_dir={tmp_path / 'jax'}"], {})
    result = port.run([*argv, f"--output_dir={tmp_path / 'port'}", "--platform=cpu"])
    assert len(result.trainer.model.interventions) == 2
    assert os.path.getsize(os.path.join(tmp_path / "port", "commonsense",
                                        "generations.json")) > 0
