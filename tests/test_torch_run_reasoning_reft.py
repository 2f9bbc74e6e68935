"""The port's reasoning harness with ReFT (``scripts/run_reasoning.py
--intervention_type LoreftIntervention``) against the JAX one on the CPU:
the smoke argv (``-task math``, one eval dataset) with Loreft at both
layers, ``f7+l7`` untied (four interventions) and tied (``-sw``, two), over
the Monarch-adapted tiny Llama; the port's model is the JAX harness's
first ``ReftModel`` (base and interventions), carried across with
``utils/jax_bridge.load_jax_state``.  Held: the logged losses within
``TOLERANCES["f32_logits"]``, the eval results, the generations and
``eval_results.json`` equal."""

import sys

import numpy as np
import pytest
import torch

from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch
from sparse_matrix_fine_tuning_torch.scripts import run_reasoning as port
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from test_torch_run_reasoning import LOGITS, flat_state, jax_harness, records

SMOKE = ["-task", "math", "--smoke=True", "-e", "1", "-batch_size", "4",
         "-gradient_accumulation_steps", "2", "--logging_steps=1", "--dropout=0.0",
         "--max_n_train_example=16", "--max_n_eval_example=5", "-eval_batch_size", "4",
         "-eval_dataset", "AddSub", "--intervention_type", "LoreftIntervention", "-p", "f7+l7",
         "-rank", "4"]


def port_build(state):
    """The smoke model and its wrapping, with the JAX harness's weights."""
    def build(args, peft_config):
        model = LlamaForCausalLM(
            LlamaConfig.tiny(vocab_size=port.SMOKE_VOCAB, hidden_size=128, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2,
                             intermediate_size=256, max_position_embeddings=1024),
            device="cpu")
        init_monarch(model, peft_config)
        model = port.wrap_reft(model, args, args.intervention_type)
        load_jax_state(model, state)
        return model
    return build


def run_both(tmp_path, extra):
    built = {}
    real_build = jax_harness.build_model

    def jax_build(args, peft_config):
        model = real_build(args, peft_config)
        built["state"] = flat_state(model)
        return model

    old_argv, jax_harness.build_model = sys.argv, jax_build
    try:
        sys.argv = ["run_reasoning.py", *SMOKE, *extra, f"--output_dir={tmp_path / 'jax'}"]
        want = jax_harness.main()
    finally:
        sys.argv, jax_harness.build_model = old_argv, real_build
    got = port.run([*SMOKE, *extra, f"--output_dir={tmp_path / 'port'}", "--platform=cpu"],
                   build=port_build(built["state"]))
    return want, got


@pytest.mark.parametrize("extra,n", [([], 4), (["-sw"], 2)], ids=["untied", "tied"])
def test_torch_reasoning_loreft_matches_jax(tmp_path, extra, n):
    want, got = run_both(tmp_path, extra)
    model = got.trainer.model
    assert len(model.interventions) == n
    assert got.results == want and set(want) == {"eval/AddSub", "eval/average"}
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    w = [r["loss"] for r in records(jd, "math", "metrics.jsonl") if "loss" in r]
    g = [r["loss"] for r in records(pd, "math", "metrics.jsonl") if "loss" in r]
    assert len(g) == len(w) == 2
    np.testing.assert_allclose(g, w, **LOGITS)
    assert records(pd, "math", "generations.json") == records(jd, "math", "generations.json")
    assert records(pd, "math", "eval_results.json") == records(jd, "math", "eval_results.json")
    assert all(p.requires_grad for p in model.interventions.parameters())
    assert not any(p.requires_grad for n_, p in model.model.named_parameters()
                   if n_.endswith(("dense", "embed_tokens.weight")))
    assert isinstance(model.interventions[0].rotate, torch.nn.Parameter)
