"""The Alpaca harness's ``--do_predict`` decoding flags against the JAX
harness's on the CPU in float32: the port's ``predict_generations`` and the
JAX one (``run_alpaca.py`` at the repository's root) on the smoke model
(the JAX harness's ``build_model``, carried across with
``utils/jax_bridge.load_jax_state``), seven smoke items and the same
flags write equal ``predictions.jsonl`` rows: beams, sampling at top-k 1
(one token kept, so the draw is the JAX package's too), the warpers
without ``--do_sample`` (which leave decoding greedy, as HF's
``generate``), the repetition penalty and the n-gram ban.  Beams with a
penalty are refused by both."""

import json
import os

import pytest

from sparse_matrix_fine_tuning_torch.data.alpaca import train_eval_split
from sparse_matrix_fine_tuning_torch.data.reasoning import load_data_items
from sparse_matrix_fine_tuning_torch.data.tokenizer import SimpleTokenizer
from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.scripts import run_alpaca as port
from sparse_matrix_fine_tuning_torch.utils.config import load_json
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_tpu.data import alpaca as jalpaca
from sparse_matrix_fine_tuning_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from test_torch_run_alpaca import _flat_state, jax_harness

ARGV = ["--smoke=True", "--platform=cpu", "--max_new_tokens=8", "--batch_size=3"]
SRC_LEN = 128  # the smoke source length


@pytest.fixture(scope="module")
def models():
    args, _ = port.parse_args(ARGV)
    peft_config = dict(load_json(port.PEFT_CONFIG), dropout=0.0)
    jm = jax_harness.build_model(args, peft_config)
    tm = LlamaForCausalLM(
        LlamaConfig.tiny(vocab_size=port.SMOKE_VOCAB, hidden_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2, intermediate_size=256,
                         max_position_embeddings=2048), device="cpu")
    port.adapt_model(tm, args, peft_config)
    load_jax_state(tm, _flat_state(jm))
    items = load_data_items("alpaca", "alpaca_data_cleaned", "dataset", smoke=True, seed=42,
                            max_n_example=16)
    return jm, tm.eval(), train_eval_split(items, 7, seed=42)[0][:7]


def predictions(package, models, flags, out_dir) -> list:
    jm, tm, eval_items = models
    args, _ = port.parse_args([*ARGV, *flags])
    if package == "jax":
        jax_harness.predict_generations(jm, JaxTokenizer(port.SMOKE_VOCAB), eval_items, args,
                                        out_dir, src_len=SRC_LEN,
                                        collate_causal_lm=jalpaca.collate_causal_lm)
    else:
        port.predict_generations(tm, SimpleTokenizer(port.SMOKE_VOCAB), eval_items, args,
                                 out_dir, src_len=SRC_LEN)
    with open(os.path.join(out_dir, "predictions.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("flags", [
    ["--num_beams=4"], ["--do_sample=True", "--top_k=1", "--temperature=0.7"],
    ["--temperature=0.7"], ["--top_p=0.9"], ["--top_k=40"],
    ["--repetition_penalty=1.1"], ["--no_repeat_ngram_size=5"],
], ids=["beams", "sample-top-k-1", "temperature", "top-p", "top-k", "penalty", "ngram"])
def test_torch_alpaca_decoding_flags_match_jax(models, flags, tmp_path):
    got = predictions("port", models, flags, str(tmp_path / "port"))
    want = predictions("jax", models, flags, str(tmp_path / "jax"))
    assert len(got) == len(models[2]) == 7 and got == want
    assert any(row["prediction"] for row in got)


def test_torch_alpaca_beams_with_a_penalty_refused_in_both(models, tmp_path):
    flags = ["--num_beams=4", "--repetition_penalty=1.1"]
    for package in ("jax", "port"):
        with pytest.raises(NotImplementedError):
            predictions(package, models, flags, str(tmp_path / package))
