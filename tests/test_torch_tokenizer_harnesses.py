"""The harnesses over a checkpoint directory that holds a BPE
``tokenizer.json``: the arrays that the port's ``run_alpaca``,
``run_reasoning`` and ``run_glue`` tokenize through ``get_tokenizer`` equal
the JAX harnesses' (``transformers``' ``AutoTokenizer`` there), exactly.

Each harness runs up to its model build, which both packages' seams stop:
the tokenized data are taken from the harness's own call of its data
function.  The directories are ``test_torch_tokenizer_bpe.write_dir``'s:
Llama-2 style byte-fallback BPE for the decoder harnesses, the
RoBERTa one for GLUE.  GLUE's raw splits are the synthetic ones in both
packages (``load_glue_raw(smoke=True)``): without a dataset cache the JAX
loader spends its time in hub retries before the same fallback.
"""

import json
import os
import sys

import numpy as np
import pytest
from test_torch_tokenizer_bpe import write_dir

from sparse_matrix_fine_tuning_torch.data.hf_tokenizer import BPETokenizer
from sparse_matrix_fine_tuning_torch.scripts import run_alpaca as port_alpaca
from sparse_matrix_fine_tuning_torch.scripts import run_glue as port_glue
from sparse_matrix_fine_tuning_torch.scripts import run_reasoning as port_reasoning
from sparse_matrix_fine_tuning_tpu.data import alpaca as jalpaca
from sparse_matrix_fine_tuning_tpu.data import glue as jglue
from sparse_matrix_fine_tuning_tpu.data import reasoning as jreasoning

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import run_alpaca as jax_alpaca  # noqa: E402  (the JAX harnesses at the root)
import run_glue as jax_glue  # noqa: E402
import run_reasoning as jax_reasoning  # noqa: E402


class Stop(Exception):
    """Raised by the build seams: the data are tokenized by then."""


def _stop(*_args, **_kw):
    raise Stop


def _recording(fn, out: list, tokenizers: list):
    def wrapped(*args, **kw):
        tokenizers.append(args[2] if fn.__name__ != "collate_causal_lm" else args[1])
        result = fn(*args, **kw)
        out.append(result)
        return result
    return wrapped


def run_both(monkeypatch, jax_main, jax_module, port_module, port_run, fn_name, argv,
             patches=()):
    """Run the JAX harness's ``main`` and the port's ``run`` on ``argv`` up
    to the build; returns the data each gave ``fn_name`` and its tokenizer."""
    got, want, tok_got, tok_want = [], [], [], []
    monkeypatch.setattr(jax_module, fn_name, _recording(getattr(jax_module, fn_name), want,
                                                        tok_want))
    monkeypatch.setattr(port_module, fn_name, _recording(getattr(port_module, fn_name), got,
                                                         tok_got))
    for target, name, value in patches:
        monkeypatch.setattr(target, name, value)
    monkeypatch.setattr(jax_main, "build_model", _stop)
    monkeypatch.setattr(sys, "argv", [f"{jax_main.__name__}.py", *argv])
    with pytest.raises(Stop):
        jax_main.main()
    with pytest.raises(Stop):
        port_run([*argv, "--platform=cpu"], build=_stop)
    assert len(got) == len(want) >= 1
    assert isinstance(tok_got[0], BPETokenizer)
    assert type(tok_want[0]).__name__ == "HFTokenizerWrapper"
    return got, want


def _same(got, want, path="") -> None:
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("llama_tok") / "ckpt"
    write_dir(path, "llama2")
    (path / "config.json").write_text(json.dumps({"model_type": "llama",
                                                  "num_hidden_layers": 2}))
    return str(path)


def test_torch_alpaca_harness_tokenizes_as_jax(monkeypatch, tmp_path, llama_dir):
    argv = ["--model", llama_dir, "--max_n_train_example=12", "--eval_dataset_size=3",
            "--do_eval=True", "--do_mmlu_eval=False", "--source_max_len=40",
            "--target_max_len=24", f"--output_dir={tmp_path}"]
    got, want = run_both(monkeypatch, jax_alpaca, jalpaca, port_alpaca, port_alpaca.run,
                         "collate_causal_lm", argv)
    _same(got, want)


@pytest.mark.parametrize("task", ["math", "commonsense"])
def test_torch_reasoning_harness_tokenizes_as_jax(monkeypatch, tmp_path, llama_dir, task):
    argv = ["-task", task, "--model", llama_dir, "--max_n_train_example=12",
            "--max_length=48", f"--output_dir={tmp_path}"]
    got, want = run_both(monkeypatch, jax_reasoning, jreasoning, port_reasoning,
                         port_reasoning.run, "tokenize_reasoning", argv)
    _same(got, want)


def test_torch_glue_harness_tokenizes_as_jax(monkeypatch, tmp_path_factory):
    path = tmp_path_factory.mktemp("roberta_tok") / "roberta"
    write_dir(path, "roberta")
    config = os.path.join(REPO, "task_configs", "monarch_roberta_glue", "rte.json")
    argv = [config, f"--model_name_or_path={path}", "--max_seq_length=40",
            f"--output_dir={tmp_path_factory.mktemp('glue_out')}"]
    synthetic = [(jglue, "load_glue_raw",
                  lambda task, smoke=False, _f=jglue.load_glue_raw: _f(task, smoke=True)),
                 (port_glue, "load_glue_raw",
                  lambda task, smoke=False, _f=port_glue.load_glue_raw: _f(task, smoke=True))]
    got, want = run_both(monkeypatch, jax_glue, jglue, port_glue, port_glue.run,
                         "tokenize_glue", argv, patches=synthetic)
    _same(got, want)
