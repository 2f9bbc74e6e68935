"""The port's copies of the GLUE data pipeline (``data/glue.py``) and the
task metrics (``utils/metrics.py``) against the JAX package's, bit for bit,
for every GLUE task.

The non-smoke load is held with HF ``datasets`` patched: raising at once
(no cache: both fall back to the same synthetic splits, and the port's
call ran with HF's offline flags set, restored after), and returning a
small in-memory GLUE-shaped dataset (a local cache: both read the same
arrays).  No test reaches the network.
"""

import os

import datasets
import numpy as np
import pytest

from sparse_matrix_fine_tuning_torch.data import glue as tglue
from sparse_matrix_fine_tuning_torch.data.tokenizer import SimpleTokenizer
from sparse_matrix_fine_tuning_torch.utils import metrics as tmetrics
from sparse_matrix_fine_tuning_tpu.data import glue as jglue
from sparse_matrix_fine_tuning_tpu.utils import metrics as jmetrics

TASKS = sorted(jglue.TASK_TO_KEYS)


def assert_splits_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for split in want:
        (gt, gl), (wt, wl) = got[split], want[split]
        assert gt == wt and gl.dtype == wl.dtype and np.array_equal(gl, wl), split


def assert_arrays_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for split in want:
        assert list(got[split]) == list(want[split])
        for key, arr in want[split].items():
            assert got[split][key].dtype == arr.dtype, (split, key)
            assert np.array_equal(got[split][key], arr), (split, key)


def test_torch_glue_tables_match_jax():
    assert tglue.TASK_TO_KEYS == jglue.TASK_TO_KEYS
    assert tglue.TASK_NUM_LABELS == jglue.TASK_NUM_LABELS
    assert tmetrics.GLUE_TARGET_METRIC == jmetrics.GLUE_TARGET_METRIC
    assert set(tmetrics.GLUE_METRICS) == set(jmetrics.GLUE_METRICS) == set(TASKS)


@pytest.mark.parametrize("task", TASKS)
def test_torch_glue_smoke_splits_and_tokens_match_jax(task):
    want, got = jglue.load_glue_raw(task, smoke=True), tglue.load_glue_raw(task, smoke=True)
    assert_splits_equal(got, want)
    tok = SimpleTokenizer(vocab_size=1024)
    assert_arrays_equal(tglue.tokenize_glue(task, got, tok, 64),
                        jglue.tokenize_glue(task, want, tok, 64))


def test_torch_glue_falls_back_offline_as_jax(monkeypatch, capsys):
    seen = []

    def no_cache(*args, **kw):
        seen.append((args, datasets.config.HF_HUB_OFFLINE, datasets.config.HF_DATASETS_OFFLINE,
                     os.environ.get("HF_HUB_OFFLINE"), os.environ.get("HF_DATASETS_OFFLINE")))
        raise ConnectionError("no local copy")

    monkeypatch.setattr(datasets, "load_dataset", no_cache)
    flags = (datasets.config.HF_HUB_OFFLINE, datasets.config.HF_DATASETS_OFFLINE,
             os.environ.get("HF_HUB_OFFLINE"), os.environ.get("HF_DATASETS_OFFLINE"))
    for task in ("mnli", "stsb"):
        want = jglue.load_glue_raw(task)
        got = tglue.load_glue_raw(task)
        assert_splits_equal(got, want)
        assert ("test_matched" if task == "mnli" else "test") in got
    assert [s[0] for s in seen] == [("glue", "mnli")] * 2 + [("glue", "stsb")] * 2
    assert seen[1][1:] == (True, True, "1", "1") and seen[3][1:] == (True, True, "1", "1")
    assert flags == (datasets.config.HF_HUB_OFFLINE, datasets.config.HF_DATASETS_OFFLINE,
                     os.environ.get("HF_HUB_OFFLINE"), os.environ.get("HF_DATASETS_OFFLINE"))
    assert "[glue] falling back to synthetic data (ConnectionError" in capsys.readouterr().out


def test_torch_glue_reads_a_local_copy_as_jax(monkeypatch):
    rng = np.random.default_rng(0)

    def split(n):
        return {"sentence1": [f"a {i} b" for i in range(n)],
                "sentence2": [f"c {i}" for i in range(n)],
                "label": rng.integers(0, 2, n).tolist()}

    local = {"train": split(10), "validation": split(4), "test": split(3)}
    monkeypatch.setattr(datasets, "load_dataset", lambda *a, **kw: local)
    want, got = jglue.load_glue_raw("mrpc"), tglue.load_glue_raw("mrpc")
    assert_splits_equal(got, want)
    assert len(got["train"][1]) == 10
    tok = SimpleTokenizer()
    assert_arrays_equal(tglue.tokenize_glue("mrpc", got, tok, 16),
                        jglue.tokenize_glue("mrpc", want, tok, 16))


@pytest.mark.parametrize("task", TASKS)
def test_torch_glue_metrics_match_jax(task):
    rng = np.random.default_rng(len(task))
    n = 97
    if task == "stsb":
        labels = np.round(rng.uniform(0, 5, n), 1)  # ties for spearman's average ranks
        preds = np.round(labels + rng.normal(0, 1, n), 1).astype(np.float32)
    else:
        k = tglue.TASK_NUM_LABELS[task]
        labels = rng.integers(0, k, n)
        preds = np.where(rng.random(n) < 0.7, labels, rng.integers(0, k, n))
    want = jmetrics.glue_compute(task, preds, labels)
    got = tmetrics.glue_compute(task, preds, labels)
    assert got == want and all(type(v) is float for v in got.values())


@pytest.mark.parametrize("preds,labels", [
    ([0, 0, 0], [0, 0, 0]), ([1, 1, 0, 0], [0, 0, 1, 1]), ([1, 0, 1], [1, 1, 0])],
    ids=["constant", "inverse", "mixed"])
def test_torch_metrics_edges_match_jax(preds, labels):
    for name in ("accuracy", "f1_score", "matthews_corrcoef", "pearson_corr", "spearman_corr"):
        assert getattr(tmetrics, name)(preds, labels) == getattr(jmetrics, name)(preds, labels)
