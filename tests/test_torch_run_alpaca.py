"""The port's Alpaca + MMLU harness against the JAX one on the CPU.

Both ``main``s run with the same argv (the tiny smoke Llama in float32, 2
optimizer steps of 16 micro-batches, eval loss, 1-shot MMLU and greedy
``--do_predict``) at ``--bits 16`` here, ``--bits 8`` and ``4`` in
``test_torch_run_alpaca_int8.py`` and ``..._int4.py``, with ``--pack=True``
in ``..._pack.py`` and ``--resume=True`` in ``..._resume.py``, which take
their runs and checks from here.  The JAX harness
(``run_alpaca.py`` at the repository's root) builds its model with its own
``build_model``; the port's ``build`` seam builds the same structure
(``adapt_model``) and carries that model's state across with
``utils/jax_bridge.load_jax_state``, before either trains.  Tolerances: the
logged losses, ``eval_loss`` and the (n, 4) MMLU choice logits 1e-4
(``TOLERANCES["f32_logits"]``: float32 sums in another order through two
layers and two AdamW steps); the MMLU accuracies equal; ``watch_layers``
1e-6; the predictions token for token (equal decoded rows).  Then each
refused option and ``--profile``'s trace.  ``test_torch_run_alpaca_decode.py``
holds ``--do_predict``'s decoding flags and ``..._local.py`` ``--model <dir>``.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.scripts import run_alpaca as port
from sparse_matrix_fine_tuning_torch.utils import profiling
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.logging import watch_layers
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES
from sparse_matrix_fine_tuning_tpu.data import mmlu as jmmlu
from sparse_matrix_fine_tuning_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from sparse_matrix_fine_tuning_tpu.quant import QuantScales
from sparse_matrix_fine_tuning_tpu.utils import logging as jlogging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import run_alpaca as jax_harness  # noqa: E402  (the JAX harness at the root)

LOGITS = TOLERANCES["f32_logits"]
ARGV = ["--smoke=True", "--dropout=0.0", "--max_steps=2", "--logging_steps=1",
        "--max_n_train_example=32", "--eval_dataset_size=8", "--max_mmlu_samples=8",
        "--do_predict=True", "--max_new_tokens=8"]


def _flat_state(model) -> dict:
    state = nnx.state(model, nnx.Any(nnx.Param, QuantScales))
    return {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(state)}


def _jax_choice_logits(model, args, items, dev_items) -> np.ndarray:
    """The JAX model's last-position logits at the A/B/C/D ids, on the
    batches ``mmlu_accuracy`` (data/mmlu.py:111-173) builds."""
    tok = JaxTokenizer(vocab_size=jax_harness.SMOKE_VOCAB)
    kw = port.mmlu_kwargs(args)
    abcd = [tok.encode_ids(f" {letter}", add_bos=False)[-1] for letter in jmmlu.ABCD]
    by_subject = {}
    for ex in dev_items:
        by_subject.setdefault(ex["subject"], []).append(ex)
    enc = [tok.encode_ids(jmmlu.build_fewshot_prompt(by_subject.get(it["subject"], []), it,
                                                     k=kw["k_shot"]))[-kw["max_length"]:]
           for it in items]
    t = max(len(e) for e in enc)
    ids = np.full((len(enc), t), tok.pad_token_id, np.int32)
    mask = np.zeros((len(enc), t), np.int32)
    for i, e in enumerate(enc):
        ids[i, t - len(e):] = e
        mask[i, t - len(e):] = 1
    out = []
    for s in range(0, len(ids), 8):
        b_ids, b_mask = ids[s:s + 8], mask[s:s + 8]
        n = len(b_ids)
        b_ids = np.concatenate([b_ids, np.repeat(b_ids[-1:], 8 - n, 0)])
        b_mask = np.concatenate([b_mask, np.repeat(b_mask[-1:], 8 - n, 0)])
        logits = model(jnp.asarray(b_ids), attention_mask=jnp.asarray(b_mask))
        out.append(np.asarray(logits[:n, -1, :])[:, abcd])
    return np.concatenate(out)


def _records(out_dir: str, name: str) -> list:
    with open(os.path.join(out_dir, "alpaca", name)) as f:
        return [json.loads(line) for line in f]


def run_both(tmp_path, bits: int, extra=(), argv=ARGV, legs=((),)) -> dict:
    """Both harnesses on ``argv`` with ``--bits`` and ``extra``, once for
    each of ``legs`` (flags added to the argv) into the same output
    directory; the port's model bridged from the JAX harness's first model,
    before training.  The last leg's metrics and run."""
    argv = [*argv, "--bits", str(bits), *extra]
    built = {}
    real_build = jax_harness.build_model

    def jax_build(args, peft_config):
        built["model"] = real_build(args, peft_config)
        # copies, taken before training, of the first model (a resumed run
        # builds the same one again)
        built.setdefault("state", _flat_state(built["model"]))
        return built["model"]

    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    old_argv, jax_harness.build_model = sys.argv, jax_build
    try:
        for leg in legs:
            sys.argv = ["run_alpaca.py", *argv, *leg, f"--output_dir={jax_dir}"]
            jax_metrics = jax_harness.main()
    finally:
        sys.argv, jax_harness.build_model = old_argv, real_build

    def bridged(args, peft_config):
        model = LlamaForCausalLM(
            LlamaConfig.tiny(vocab_size=port.SMOKE_VOCAB, hidden_size=128, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2,
                             intermediate_size=256, max_position_embeddings=2048),
            device="cpu")
        port.adapt_model(model, args, peft_config)
        load_jax_state(model, built["state"])
        return model

    for leg in legs:
        result = port.run([*argv, *leg, f"--output_dir={port_dir}", "--platform=cpu"],
                          build=bridged)
    return {"jax": jax_metrics, "port": result, "jax_model": built["model"],
            "jax_dir": jax_dir, "port_dir": port_dir, "build": bridged}


def check_losses(both):
    want = [r["loss"] for r in _records(both["jax_dir"], "metrics.jsonl") if "loss" in r]
    got = [r["loss"] for r in _records(both["port_dir"], "metrics.jsonl") if "loss" in r]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, **LOGITS)
    np.testing.assert_allclose(both["port"].metrics["eval_loss"], both["jax"]["eval_loss"],
                               **LOGITS)


def check_mmlu(both):
    run = both["port"]
    want = _jax_choice_logits(both["jax_model"], run.args, run.mmlu_eval, run.mmlu_dev)
    got = run.choice_logits()
    assert got.shape == want.shape == (8, 4)
    np.testing.assert_allclose(got, want, **LOGITS)
    acc = {k: v for k, v in run.metrics.items() if "accuracy" in k}
    assert acc == {k: v for k, v in both["jax"].items() if "accuracy" in k} and acc
    assert run.metrics["eval_mmlu_runtime"] > 0


def check_watch_layers(both):
    want = jlogging.watch_layers(both["jax_model"])
    got = watch_layers(both["port"].trainer.model)
    assert sorted(got) == sorted(want) and len(got) == 7 * 2 * 3
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-6, key
    logged = [r for r in _records(both["port_dir"], "metrics.jsonl")
              if any(k.startswith("watch/") for k in r)]
    assert len(logged) == 2  # before and after training


def check_predictions(both):
    want = _records(both["jax_dir"], "predictions.jsonl")
    got = _records(both["port_dir"], "predictions.jsonl")
    assert len(got) == both["port"].metrics["predict_samples"] == 6
    assert got == want
    with open(os.path.join(both["port_dir"], "alpaca", "eval_results.json")) as f:
        assert json.load(f) == both["port"].metrics


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("alpaca16"), 16)


def test_torch_alpaca_losses_match_jax(both):
    check_losses(both)


def test_torch_alpaca_mmlu_matches_jax(both):
    check_mmlu(both)


def test_torch_alpaca_watch_layers_match_jax(both):
    check_watch_layers(both)


def test_torch_alpaca_predictions_match_jax(both):
    check_predictions(both)


@pytest.mark.parametrize("extra,item", [
    (["--optim=adamw8bit"], "item 27"),
])
def test_torch_alpaca_refusals(tmp_path, extra, item):
    """Each refused option raises before any work: nothing is built and the
    output directory is never made."""
    def never(args, peft_config):
        raise AssertionError("built a model")

    out = tmp_path / "out"
    with pytest.raises(NotImplementedError, match=item):
        port.main(["--platform=cpu", f"--output_dir={out}", *extra], build=never)
    assert not out.exists()


def test_torch_alpaca_profile_writes_a_trace(tmp_path):
    metrics = port.main(["--smoke=True", "--platform=cpu", "--profile", "--max_steps=1",
                         "--gradient_accumulation_steps=1", "--do_mmlu_eval=False",
                         "--max_n_train_example=16", f"--output_dir={tmp_path}"])
    path = tmp_path / "alpaca" / "profile" / "trace.json"
    assert path.exists() and json.loads(path.read_text())["traceEvents"]
    assert np.isfinite(metrics["eval_loss"])


def test_torch_step_timer_and_memory_stats():
    """``StepTimer`` keeps a window of step times; ``device_memory_stats``
    names no device where there is no card, and never one of the CPU."""
    timer = profiling.StepTimer(window=2)
    assert timer.tick() is None and timer.mean_step_s is None
    steps = [timer.tick() for _ in range(3)]
    assert all(s >= 0 for s in steps) and len(timer._times) == 2
    assert timer.mean_step_s == pytest.approx(sum(steps[1:]) / 2)
    stats = profiling.device_memory_stats()
    assert len(stats) == torch.cuda.device_count()
    assert all(set(v) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
               for v in stats.values())


def test_torch_alpaca_runs_without_smoke(tmp_path):
    """The default argv (no ``--smoke``, no local weights): the hash
    tokenizer's 32000 ids reach the tiny model, whose vocabulary is the
    tokenizer's, through a training step, the eval loss, 5-shot MMLU and a
    prediction."""
    seen = []

    def build(args, peft_config):
        model = port.build_model(args, peft_config)
        seen.append(model.config.vocab_size)
        return model

    run = port.run(["--platform=cpu", "--max_steps=1", "--gradient_accumulation_steps=1",
                    "--max_n_train_example=20", "--eval_dataset_size=4",
                    "--max_mmlu_samples=2", "--do_predict=True", "--max_new_tokens=2",
                    f"--output_dir={tmp_path}"], build=build)
    assert seen == [run.tokenizer.vocab_size] == [port.HASH_VOCAB]
    assert run.args.mmlu_kshot == 5
    assert all(np.isfinite(run.metrics[k]) for k in ("eval_loss", "eval_mmlu_eval_accuracy"))
    assert run.metrics["predict_samples"] == 4


def test_torch_alpaca_step_context_wraps_each_step(tmp_path):
    """``run``'s ``step_context`` reaches the trainer, which enters it
    around each optimizer step's ``train_step`` and nothing else, with the
    step's index."""
    events = []

    class Spy:
        def __init__(self, step):
            self.step = step

        def __enter__(self):
            events.append(("enter", self.step))

        def __exit__(self, *exc):
            events.append(("exit", self.step))

    def build(args, peft_config):
        model = port.build_model(args, peft_config)
        model.model.register_forward_pre_hook(  # the decoder stack: every forward
            lambda m, a: events.append(("forward", m.training)))
        return model

    port.run(["--smoke=True", "--platform=cpu", "--max_steps=2",
              "--gradient_accumulation_steps=2", "--max_n_train_example=16",
              "--do_mmlu_eval=False", f"--output_dir={tmp_path}"],
             build=build, step_context=Spy)
    inside = [e for e in events if e[0] != "forward" or e[1]]
    assert inside == [("enter", 0), ("forward", True), ("forward", True), ("exit", 0),
                      ("enter", 1), ("forward", True), ("forward", True), ("exit", 1)]
    assert ("forward", False) in events  # the eval loss, outside every step
