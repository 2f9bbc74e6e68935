"""The port's AG News harness (``scripts/run_agnews.py``) against the JAX one
(``run_agnews.py`` at the repository's root) on the CPU, ``--smoke=True``
(the tiny RoBERTa with 4 labels, the synthetic topic items) cut to 2
optimizer steps of 32 (``-e 0.25``), the loss logged at each, with
``--method monarch`` (adapters on query/key/value, the head trains) and
``--method full`` (every parameter trains).  Dropout is off in both: the
JAX harness's ``param_stats`` is wrapped to set every ``nnx.Dropout``'s
rate to 0 and to keep the model's state once it is adapted, which the
port's ``build`` carries across with ``utils/jax_bridge.load_jax_state``.

Held: the logged losses and ``eval_loss`` within
``TOLERANCES["f32_logits"]``; the method, the trainable count and the
accuracy equal; the total count equal to the JAX one less its dropouts'
random state, which the JAX ``param_stats`` counts as parameters (ROADMAP
C.14); the synthetic data equal bit for bit.  ``--method lora``:
``test_torch_run_lora_harnesses.py``.
"""

import json
import os
import sys

import numpy as np
import pytest
from flax import nnx

import sparse_matrix_fine_tuning_tpu.peft as jpeft
from sparse_matrix_fine_tuning_torch.data.tokenizer import SimpleTokenizer
from sparse_matrix_fine_tuning_torch.models.config import RobertaConfig
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch
from sparse_matrix_fine_tuning_torch.scripts import run_agnews as port
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import run_agnews as jax_harness  # noqa: E402  (the JAX harness at the root)

LOGITS = TOLERANCES["f32_logits"]
SMOKE = ["--smoke=True", "-e", "0.25", "--logging_steps=1"]


def run_both(method: str, out):
    built = {}
    real_stats = jpeft.param_stats

    def stats(model, *a, **kw):
        for _, m in nnx.iter_modules(model):
            if isinstance(m, nnx.Dropout):
                m.rate = 0.0
        built["state"] = {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
                          for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}
        built["rng"] = sum(v[...].size for _, v in nnx.to_flat_state(nnx.state(model,
                                                                                 nnx.RngState)))
        return real_stats(model, *a, **kw)

    def build(args):
        model = RobertaForSequenceClassification(
            RobertaConfig.tiny(num_labels=4, vocab_size=port.SMOKE_VOCAB,
                               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
            device="cpu")
        if args.method == "monarch":
            init_monarch(model, port.MONARCH_PEFT)
        load_jax_state(model, built["state"])
        return model

    argv = [*SMOKE, "--method", method]
    old_argv, jpeft.param_stats = sys.argv, stats
    try:
        sys.argv = ["run_agnews.py", *argv, f"--output_dir={out / 'jax'}"]
        want = jax_harness.main()
    finally:
        sys.argv, jpeft.param_stats = old_argv, real_stats
    got = port.run([*argv, f"--output_dir={out / 'port'}", "--platform=cpu"], build=build)
    return want, got, out / "jax" / method, out / "port" / method, built["rng"]


def losses(run_dir) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r["loss"] for r in map(json.loads, f) if "loss" in r]


@pytest.mark.parametrize("method", ["monarch", "full"])
def test_torch_run_agnews_matches_jax(tmp_path, method):
    want, got, jax_dir, port_dir, rng_elements = run_both(method, tmp_path)
    assert len(losses(port_dir)) == len(losses(jax_dir)) == 2
    np.testing.assert_allclose(losses(port_dir), losses(jax_dir), **LOGITS)
    assert got.result.keys() == want.keys()
    np.testing.assert_allclose(got.result["eval_loss"], want["eval_loss"], **LOGITS)
    for key in ("method", "trainable_params", "eval_accuracy", "step"):
        assert got.result[key] == want[key], key
    # the JAX total counts each dropout's RNG key and counter too (ROADMAP C.14)
    assert rng_elements == 2 * 8
    assert got.result["total_params"] == want["total_params"] - rng_elements
    trained = {n for n, p in got.trainer.model.named_parameters() if p.requires_grad}
    if method == "full":
        assert trained == {n for n, _ in got.trainer.model.named_parameters()}
    else:
        assert all("blkdiag" in n or n.startswith("classifier.") for n in trained)


def test_torch_agnews_synthetic_data_match_jax():
    tok = SimpleTokenizer(vocab_size=port.SMOKE_VOCAB)
    want = jax_harness.load_agnews(tok, 128, smoke=True)
    got = port.load_agnews(tok, 128, smoke=True)
    assert got.keys() == want.keys() == {"train", "test"}
    for split in want:
        for key, arr in want[split].items():
            assert got[split][key].dtype == arr.dtype and np.array_equal(got[split][key], arr)

