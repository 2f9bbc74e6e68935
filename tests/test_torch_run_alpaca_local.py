"""The Alpaca harness with ``--model <tiny HF dir>`` (written by
``transformers`` in bfloat16, as TinyLlama's checkpoint is, with 32000 ids
for the hash tokenizer) in both packages on the CPU: each harness loads the
checkpoint in bfloat16 through its own ``from_pretrained_causal_lm``, and
the two models' weights are equal bit for bit (the JAX loader sets each
parameter to the checkpoint's array as it is, so a float32 checkpoint
would stay float32 there; the forward rounds it to bfloat16 as the port
does at load).
The port's model then takes the JAX model's adapter factors (their inits
draw from other generators), and one optimizer step of two micro-batches
follows: the logged loss within ``bf16_atol`` (two bfloat16 ulps of the
loss), ``--gradient_checkpointing`` and ``--remat_policy`` in the port
model's config, and beam-4 predictions written."""

import sys

import numpy as np
import pytest
import torch

from sparse_matrix_fine_tuning_torch.scripts import run_alpaca as port
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import bf16_atol, to_numpy
from test_torch_hf_convert import write_hf_llama
from test_torch_run_alpaca import _flat_state, _records, jax_harness

ARGV = ["--max_steps=1", "--gradient_accumulation_steps=2", "--batch_size=2",
        "--logging_steps=1", "--do_mmlu_eval=False", "--max_n_train_example=10",
        "--eval_dataset_size=3", "--do_predict=True", "--max_new_tokens=4",
        "--num_beams=4", "--source_max_len=64", "--target_max_len=32", "--dropout=0.0"]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("alpaca_local")
    write_hf_llama(tmp / "ckpt", vocab_size=port.HASH_VOCAB, dtype=torch.bfloat16)
    argv = ["--model", str(tmp / "ckpt"), *ARGV]
    built = {}
    real_build = jax_harness.build_model

    def jax_build(args, peft_config):
        model = real_build(args, peft_config)
        built["state"] = _flat_state(model)
        return model

    old_argv, jax_harness.build_model = sys.argv, jax_build
    try:
        sys.argv = ["run_alpaca.py", *argv, f"--output_dir={tmp / 'jax'}"]
        jax_metrics = jax_harness.main()
    finally:
        sys.argv, jax_harness.build_model = old_argv, real_build

    def bridged(args, peft_config):
        model = port.build_model(args, peft_config)
        built["port_base"] = {n: to_numpy(p) for n, p in model.named_parameters()
                              if "blkdiag" not in n}
        built["config"] = model.config
        load_jax_state(model, built["state"])
        return model

    metrics = port.main([*argv, f"--output_dir={tmp / 'port'}", "--platform=cpu",
                         "--remat_policy=dots"], build=bridged)
    return {"jax": jax_metrics, "port": metrics, "built": built, "tmp": tmp}


def test_torch_alpaca_local_bases_equal_jax(both):
    built = both["built"]
    jax_base = {".".join(str(p) for p in path): v for path, v in built["state"].items()}
    assert len(built["port_base"]) == 2 * 7 + 2 * 2 + 3  # dense, norms, embed, norm, head
    for name, value in built["port_base"].items():
        key = name.replace(".weight", ".scale" if "norm" in name else ".kernel")
        key = key.replace("embed_tokens.kernel", "embed_tokens.embedding")
        want = jax_base[key]
        if key.endswith(".kernel"):
            want = want.T  # flax keeps (in, out)
        np.testing.assert_array_equal(value, want.astype(np.float32), err_msg=name)


def test_torch_alpaca_local_loss_and_remat_flags(both):
    cfg = both["built"]["config"]
    assert (cfg.remat, cfg.remat_policy, cfg.dtype, cfg.param_dtype) == \
        (True, "dots", "bfloat16", "bfloat16")
    tmp = both["tmp"]
    want = [r["loss"] for r in _records(str(tmp / "jax"), "metrics.jsonl") if "loss" in r]
    got = [r["loss"] for r in _records(str(tmp / "port"), "metrics.jsonl") if "loss" in r]
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=0, atol=bf16_atol(want))
    rows = _records(str(tmp / "port"), "predictions.jsonl")
    assert len(rows) == both["port"]["predict_samples"] >= 2
    assert all(len(r["prediction"].split()) <= 4 for r in rows)
