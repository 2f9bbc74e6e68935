"""The Alpaca harness over the other decoder families' tiny HF-format
directories (``write_family_dir``: float32, 32000 ids for the hash
tokenizer), in both packages on the CPU, without ``--smoke``: GPT-2 here,
GPT-NeoX in ``test_torch_run_alpaca_neox.py`` and GPT-2 over an int8 and an
int4 base in ``test_torch_run_alpaca_gpt2_int{8,4}.py``.  Each harness loads
the directory through its own ``from_pretrained_causal_lm`` and adapts
every linear ``find_all_linear_names`` gives (GPT-2: c_attn, c_proj, c_fc,
c_proj a layer; GPT-NeoX: four a layer and ``embed_out``); the port's model
then takes the JAX model's state (the adapters' inits draw from other
generators) and one optimizer step of two micro-batches follows.

Both harnesses load in float32 here (the JAX one's loader wrapped to ask
for it, the port's ``build_model(dtype=...)``), where they load bfloat16
for a user: in bf16 the two packages' greedy tokens part at near-ties of
the argmax (seen at one token of eight), which no file comparison can hold;
the families' bf16 arithmetic is held by the models' own tests
(``test_torch_gpt2.py`` and the others).  Held: the same adapted layers,
the logged loss and ``eval_loss`` within ``TOLERANCES["f32_logits"]``,
``predictions.jsonl`` equal and ``eval_results.json`` equal but for
``eval_loss`` (held above).
"""

import contextlib
import json
import os
import sys

import numpy as np
import torch

from sparse_matrix_fine_tuning_torch import models as tmodels
from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear
from sparse_matrix_fine_tuning_torch.models import hf_convert
from sparse_matrix_fine_tuning_torch.scripts import run_alpaca as port
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import MonarchLinear as JaxMonarch
from sparse_matrix_fine_tuning_tpu.models import hf_convert as jhf
from test_torch_run_alpaca import _flat_state, _records, jax_harness

LOGITS = TOLERANCES["f32_logits"]

ARGV = ["--max_steps=1", "--gradient_accumulation_steps=2", "--batch_size=2",
        "--logging_steps=1", "--do_mmlu_eval=False", "--max_n_train_example=10",
        "--eval_dataset_size=3", "--do_predict=True", "--max_new_tokens=4",
        "--source_max_len=64", "--target_max_len=32", "--dropout=0.0"]


# family -> (tiny config.json less the vocabulary, its config map, the port model)
FAMILY_DIRS = {
    "gpt2": ({"model_type": "gpt2", "architectures": ["GPT2LMHeadModel"], "n_embd": 64,
              "n_layer": 2, "n_head": 4, "n_positions": 128},
             hf_convert.gpt2_config_from_hf, tmodels.GPT2LMHeadModel),
    "gpt_neox": ({"model_type": "gpt_neox", "architectures": ["GPTNeoXForCausalLM"],
                  "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
                  "intermediate_size": 128, "max_position_embeddings": 128, "rotary_pct": 0.25},
                 hf_convert.gpt_neox_config_from_hf, tmodels.GPTNeoXForCausalLM),
    "gemma": ({"model_type": "gemma", "architectures": ["GemmaForCausalLM"], "hidden_size": 64,
               "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 1,
               "head_dim": 32, "intermediate_size": 128, "max_position_embeddings": 128},
              hf_convert.causal_lm_config_from_hf, tmodels.LlamaForCausalLM),
}


def write_family_dir(path, family: str, *, vocab_size: int = port.HASH_VOCAB,
                     dtype=torch.float32, seed: int = 0) -> str:
    """A tiny random HF-format directory of ``family`` (``FAMILY_DIRS``),
    without ``transformers``: a port model's weights under HF's names (the
    port keeps them), GPT-2's projections in ``Conv1D``'s (in, out) layout,
    biases and norm weights drawn away from 0 and 1; returns the path.
    ``test_torch_hf_convert_families.py`` holds the loaders against HF's
    own writer."""
    hf, config_from_hf, cls = FAMILY_DIRS[family]
    hf = {**hf, "vocab_size": vocab_size}
    g = torch.Generator().manual_seed(seed)
    model = cls(config_from_hf(hf), device="cpu", generator=g)
    tensors = {}
    with torch.no_grad():
        for name, p in model.state_dict().items():
            if name.endswith("bias") or "norm" in name or ".ln_" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
            conv1d = family == "gpt2" and name.endswith("weight") and any(
                f".{m}." in name for m in ("c_attn", "c_proj", "c_fc"))
            tensors[name] = (p.T if conv1d else p).contiguous().to(dtype)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    hf_convert.write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    return str(path)


@contextlib.contextmanager
def jax_loads_float32():
    """The JAX harnesses' ``from_pretrained_causal_lm`` (imported inside
    their ``build_model``) asked for float32 compute."""
    real = jhf.from_pretrained_causal_lm

    def float32(path, dtype="bfloat16", **kw):
        return real(path, dtype="float32", **kw)

    jhf.from_pretrained_causal_lm = float32
    try:
        yield
    finally:
        jhf.from_pretrained_causal_lm = real


def adapted_names(model, cls) -> list:
    if hasattr(model, "named_modules"):
        return sorted(n for n, m in model.named_modules() if isinstance(m, cls))
    from flax import nnx

    return sorted(".".join(map(str, path)) for path, m in nnx.iter_graph(model)
                  if isinstance(m, cls))


def run_family(tmp, family: str, extra=()) -> dict:
    """Both harnesses over ``family``'s tiny directory with ``ARGV`` and
    ``extra``; the port's model bridged from the JAX harness's before
    training."""
    argv = ["--model", write_family_dir(tmp / "ckpt", family), *ARGV, *extra]
    built = {}
    real_build = jax_harness.build_model

    def jax_build(args, peft_config):
        model = real_build(args, peft_config)
        built["state"] = _flat_state(model)
        built["jax_adapted"] = adapted_names(model, JaxMonarch)
        return model

    old_argv, jax_harness.build_model = sys.argv, jax_build
    try:
        sys.argv = ["run_alpaca.py", *argv, f"--output_dir={tmp / 'jax'}"]
        with jax_loads_float32():
            jax_metrics = jax_harness.main()
    finally:
        sys.argv, jax_harness.build_model = old_argv, real_build

    def bridged(args, peft_config):
        model = port.build_model(args, peft_config, dtype="float32")
        built["port_adapted"] = adapted_names(model, MonarchLinear)
        built["port_model"] = model
        load_jax_state(model, built["state"])
        return model

    metrics = port.main([*argv, f"--output_dir={tmp / 'port'}", "--platform=cpu"],
                        build=bridged)
    return {"jax": jax_metrics, "port": metrics, "built": built, "tmp": tmp}


def check_family_run(run, n_adapted: int):
    built, tmp = run["built"], run["tmp"]
    assert built["port_adapted"] == built["jax_adapted"]
    assert len(built["port_adapted"]) == n_adapted
    want = [r["loss"] for r in _records(str(tmp / "jax"), "metrics.jsonl") if "loss" in r]
    got = [r["loss"] for r in _records(str(tmp / "port"), "metrics.jsonl") if "loss" in r]
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, **LOGITS)
    np.testing.assert_allclose(run["port"]["eval_loss"], run["jax"]["eval_loss"], **LOGITS)
    rows = [_records(str(tmp / d), "predictions.jsonl") for d in ("jax", "port")]
    assert rows[1] == rows[0] and len(rows[0]) == run["port"]["predict_samples"] >= 2
    files = []
    for d in ("jax", "port"):
        with open(os.path.join(tmp / d, "alpaca", "eval_results.json")) as f:
            files.append(json.load(f))
    # the port's adds the predictions' wall seconds (predict_runtime)
    assert files[1] == run["port"] and set(files[0]) <= set(files[1])
    assert {k: files[1][k] for k in files[0] if k != "eval_loss"} == {
        k: v for k, v in files[0].items() if k != "eval_loss"}


def test_torch_alpaca_over_gpt2_matches_jax(tmp_path):
    check_family_run(run_family(tmp_path, "gpt2"), 2 * 4)
