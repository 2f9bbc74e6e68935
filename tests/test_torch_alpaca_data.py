"""The port's copies of the JAX package's numpy-only data, config and
logging code against the originals, on the same seeded inputs, bit for bit:
the hash tokenizer, Alpaca formatting, collation and the eval split, the
synthetic (and local-file) items, MMLU prompts, the config overrides and
best-HP files, and ``RunLogger``'s JSONL.  ``get_tokenizer`` gives the JAX
one's hash tokenizer for a name and for a checkpoint directory without
tokenizer files, and refuses a directory with them, which the JAX one would
hand to ``transformers``.  ``test_torch_reasoning_data.py`` holds the
reasoning harness's tokenizing."""

import csv
import dataclasses
import json
import warnings

import numpy as np
import pytest

from sparse_matrix_fine_tuning_torch.data import alpaca as talpaca
from sparse_matrix_fine_tuning_torch.data import mmlu as tmmlu
from sparse_matrix_fine_tuning_torch.data import reasoning as treasoning
from sparse_matrix_fine_tuning_torch.data import templates as ttemplates
from sparse_matrix_fine_tuning_torch.data import tokenizer as ttok
from sparse_matrix_fine_tuning_torch.utils import config as tconfig
from sparse_matrix_fine_tuning_torch.utils import logging as tlogging
from sparse_matrix_fine_tuning_tpu.data import alpaca as jalpaca
from sparse_matrix_fine_tuning_tpu.data import mmlu as jmmlu
from sparse_matrix_fine_tuning_tpu.data import reasoning as jreasoning
from sparse_matrix_fine_tuning_tpu.data import templates as jtemplates
from sparse_matrix_fine_tuning_tpu.data import tokenizer as jtok
from sparse_matrix_fine_tuning_tpu.utils import config as jconfig
from sparse_matrix_fine_tuning_tpu.utils import logging as jlogging

TEXTS = ["Hello, world!", "Repeat the word token3", "What is 2 plus 3 ?\n### Response:",
         "", "Ünïcode wörds and   spaces\t\ttabs"]


def _assert_same(got, want):
    """Equal item lists, or dicts of equal arrays (dtype included)."""
    if isinstance(want, dict) and want and isinstance(next(iter(want.values())), np.ndarray):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    else:
        assert got == want


def test_torch_templates_are_the_jax_templates():
    names = [n for n in vars(jtemplates) if not n.startswith("_")]
    assert names and all(getattr(ttemplates, n) == getattr(jtemplates, n) for n in names)


@pytest.mark.parametrize("vocab", [1024, 32000])
@pytest.mark.parametrize("text", TEXTS)
def test_torch_simple_tokenizer_matches_jax(text, vocab):
    t, j = ttok.SimpleTokenizer(vocab), jtok.SimpleTokenizer(vocab)
    assert t.encode_ids(text) == j.encode_ids(text)
    assert t.encode_ids(text, add_bos=False) == j.encode_ids(text, add_bos=False)
    assert t.encode(text, "a pair", max_length=12) == j.encode(text, "a pair", max_length=12)
    _assert_same(dict(zip("im", t.encode_batch([text, "x"], max_length=9))),
                 dict(zip("im", j.encode_batch([text, "x"], max_length=9))))
    ids = t.encode_ids(text) + [7, t.eos_token_id, t.pad_token_id]
    assert t.decode(ids) == j.decode(j.encode_ids(text) + [7, 2, 1])
    assert (t.bos_token_id, t.pad_token_id, t.eos_token_id, t.eos_token) == \
        (j.bos_token_id, j.pad_token_id, j.eos_token_id, j.eos_token)


def test_torch_get_tokenizer_matches_jax_without_tokenizer_files(tmp_path):
    """A name, None and a checkpoint directory without tokenizer files (the
    weights and config alone, where the JAX function's AutoTokenizer fails)
    give the hash tokenizer at the vocabulary asked, in both packages."""
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "llama"}))
    (tmp_path / "model.safetensors").write_bytes(b"")
    for name, vocab in (("llama-2-7b", 500), (None, 50265), (str(tmp_path), 32000)):
        got, want = ttok.get_tokenizer(name, vocab_size=vocab), jtok.get_tokenizer(
            name, vocab_size=vocab)
        assert isinstance(got, ttok.SimpleTokenizer) and isinstance(want, jtok.SimpleTokenizer)
        assert got.vocab_size == want.vocab_size == vocab
        assert got.encode_ids(TEXTS[2]) == want.encode_ids(TEXTS[2])


@pytest.mark.parametrize("fname", ttok.TOKENIZER_FILES)
def test_torch_get_tokenizer_refuses_a_tokenizer_directory(tmp_path, fname):
    (tmp_path / fname).write_text("{}")
    with pytest.raises(NotImplementedError, match="item 13"):
        ttok.get_tokenizer(str(tmp_path))


RAW = {
    "alpaca": [{"instruction": "Name a fruit", "input": "", "output": "apple"},
               {"instruction": "Add", "input": "2 and 3", "output": "5"}],
    "chip2": [{"text": "<human>: hi there\n<bot>: hello"}, {"text": "<human>: no bot"}],
    "self-instruct": [{"prompt": "Write a poem", "completion": "Roses are red"}],
    "hh-rlhf": [{"chosen": "Human: hi Assistant: hello", "rejected": "x"}],
    "oasst1": [{"text": "### Human: a ### Assistant: b"}],
    "input-output": [{"input": "in", "output": "out"}, {"output": "only out"}],
}
FORMATS = [(None, "alpaca"), ("alpaca", "alpaca"), ("alpaca-clean", "alpaca"),
           ("chip2", "chip2"), (None, "chip2"), ("self-instruct", "self-instruct"),
           (None, "self-instruct"), ("hh-rlhf", "hh-rlhf"), (None, "hh-rlhf"),
           ("oasst1", "oasst1"), (None, "oasst1"), ("input-output", "input-output")]


@pytest.mark.parametrize("fmt,data", FORMATS)
def test_torch_format_items_matches_jax(fmt, data):
    name = "alpaca" if data == "input-output" else data
    assert talpaca.format_items(RAW[data], fmt, name) == jalpaca.format_items(RAW[data], fmt, name)
    with pytest.raises(ValueError, match="unknown dataset_format"):
        talpaca.format_items(RAW["alpaca"], "csv", "alpaca")


ITEMS = (RAW["alpaca"] + jalpaca.format_items(RAW["chip2"], "chip2")
         + jreasoning.load_data_items("alpaca", "alpaca_data_cleaned", "none", smoke=True,
                                      smoke_n=9, seed=3))


@pytest.mark.parametrize("kw", [
    dict(source_max_len=64, target_max_len=16),
    dict(source_max_len=64, target_max_len=16, train_on_source=True),
    dict(source_max_len=8, target_max_len=3),                      # both truncated
    dict(source_max_len=64, target_max_len=0, predict_with_generate=True),
    dict(source_max_len=12, target_max_len=0, predict_with_generate=True),
], ids=["train", "train_on_source", "truncated", "predict", "predict_truncated"])
def test_torch_collate_causal_lm_matches_jax(kw):
    t, j = ttok.SimpleTokenizer(1024), jtok.SimpleTokenizer(1024)
    _assert_same(talpaca.collate_causal_lm(ITEMS, t, **kw),
                 jalpaca.collate_causal_lm(ITEMS, j, **kw))


@pytest.mark.parametrize("n,size,seed", [(64, 8, 42), (32, 8, 42), (10, 1024, 0), (3, 2, 5)])
def test_torch_train_eval_split_matches_jax(n, size, seed):
    items = [{"i": i} for i in range(n)]
    assert talpaca.train_eval_split(items, size, seed) == jalpaca.train_eval_split(items, size,
                                                                                    seed)


@pytest.mark.parametrize("task,name,kw", [
    ("alpaca", "alpaca_data_cleaned", dict(smoke=True)),
    ("alpaca", "alpaca_data_cleaned", dict(smoke=True, max_n_example=32)),
    ("alpaca", "alpaca_data_cleaned", dict(smoke=False)),           # no file: synthetic
    ("math", "math_10k", dict(smoke=True, seed=7)),
    ("gsm8k", "gsm8k", dict(smoke=True, split="test")),
    ("commonsense", "boolq", dict(smoke=True, smoke_n=20)),
    ("tune_math", "math_10k", dict(smoke=True)),
    ("tune_math", "math_10k", dict(smoke=True, is_eval=True)),
    ("alpaca", "local", dict(smoke=False, max_n_example=3)),        # the local JSON file
])
def test_torch_load_data_items_matches_jax(tmp_path, task, name, kw):
    (tmp_path / "local").mkdir()
    (tmp_path / "local" / "train.json").write_text(json.dumps(RAW["alpaca"] * 3))
    got = treasoning.load_data_items(task, name, str(tmp_path), **kw)
    assert got == jreasoning.load_data_items(task, name, str(tmp_path), **kw) and got
    if task in ("alpaca", "math", "gsm8k", "commonsense"):
        item = got[0]
        assert treasoning.build_prompt(task, item) == jreasoning.build_prompt(task, item)


def _write_mmlu(root, kind):
    mmlu = root / "mmlu"
    mmlu.mkdir()
    rows = [{"question": "2+2?", "choices": ["1", "2", "3", "4"], "answer": "D",
             "subject": "math"}]
    if kind == "json":
        (mmlu / "eval.json").write_text(json.dumps(rows))
    elif kind == "qlora":
        lines = [json.dumps({"subject": "law", "input": "Q?\nA. x\nAnswer:", "output": " B"})]
        (mmlu / "zero_shot_mmlu_val.json").write_text("\n".join(lines + [""]))
    else:
        (mmlu / "eval").mkdir()
        with open(mmlu / "eval" / "high_school_physics_test.csv", "w", newline="") as f:
            csv.writer(f).writerows([["What is g?", "9.8", "1", "0", "3", "A"]])


@pytest.mark.parametrize("kind,kw", [
    ("none", dict(smoke=True)), ("none", dict(smoke=True, seed=43, smoke_n=8)),
    ("none", dict(smoke=False, smoke_n=5)), ("json", dict(smoke=False)),
    ("qlora", dict(smoke=False)), ("csv", dict(smoke=False)),
])
def test_torch_load_mmlu_items_matches_jax(tmp_path, kind, kw):
    if kind != "none":
        _write_mmlu(tmp_path, kind)
    got = tmmlu.load_mmlu_items(str(tmp_path), "eval", **kw)
    assert got == jmmlu.load_mmlu_items(str(tmp_path), "eval", **kw) and got


@pytest.mark.parametrize("k", [0, 1, 3, 5])
def test_torch_build_fewshot_prompt_matches_jax(k):
    dev = jmmlu.load_mmlu_items("none", "dev", smoke=True, seed=1, smoke_n=8)
    for item in jmmlu.load_mmlu_items("none", "eval", smoke=True, seed=0, smoke_n=4):
        assert tmmlu.build_fewshot_prompt(dev, item, k) == jmmlu.build_fewshot_prompt(dev, item, k)
    assert tmmlu.format_mmlu_example("q", list("wxyz"), "C") == \
        jmmlu.format_mmlu_example("q", list("wxyz"), "C")


def test_torch_encode_mmlu_prompts_left_pads_and_keeps_the_tail():
    """The prompts ``mmlu_accuracy`` scores: truncated from the head, left
    padded, the scored "Answer:" token last in every row."""
    tok = ttok.SimpleTokenizer(1024)
    dev = tmmlu.load_mmlu_items("none", "dev", smoke=True, seed=1, smoke_n=8)
    items = tmmlu.load_mmlu_items("none", "eval", smoke=True, seed=0, smoke_n=5)
    items.append({"prompt": "Q?\nAnswer:", "answer": "A", "subject": "law"})
    ids, mask = tmmlu.encode_mmlu_prompts(tok, items, dev, k_shot=5, max_length=40)
    assert ids.shape == mask.shape == (6, 40) and ids.dtype == np.int32
    answer = tok.encode_ids("Answer", add_bos=False)[0]
    colon = tok.encode_ids(":", add_bos=False)[0]
    assert (ids[:, -2] == answer).all() and (ids[:, -1] == colon).all()
    assert (ids[mask == 0] == tok.pad_token_id).all() and mask[-1].sum() < 40
    assert tmmlu.abcd_token_ids(tok) == [tok.encode_ids(c, add_bos=False)[0] for c in "ABCD"]


@dataclasses.dataclass
class _Args:
    learning_rate: float = 1e-3
    epochs: int = 1
    name: str = "x"
    maybe: object = None


@pytest.mark.parametrize("overrides", [
    ["--learning_rate=2", "--blk_r=8", "--nblocks=sqrt(n)", "--unknown=[1, 2]"],
    ["--epochs 3", "--dropout=0.0", "--name=abc", "--maybe=True"],
    ["--name=5", "--epochs=2.5"],                                     # type changes warn
    {"learning_rate": 5e-4, "blk_r": 16, "other": "y"},
    [],
])
def test_torch_override_config_and_best_hp_round_trip(tmp_path, overrides):
    """The overrides land where the JAX function puts them, with the same
    unmatched rest; the best-HP file written by either package loads in the
    other."""
    outs = []
    for cfg_mod in (tconfig, jconfig):
        peft = {"blk_r": 4, "nblocks": 4, "dropout": 0.1}
        args = _Args()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            extra = cfg_mod.override_config([peft, args], overrides)
        outs.append((peft, dataclasses.asdict(args), extra, [str(w.message) for w in caught]))
    assert outs[0] == outs[1]
    hp = {"learning_rate": 3e-4, "blk_r": 8}
    tconfig.save_best_hp(hp, str(tmp_path / "run"), str(tmp_path / "task"))
    assert jconfig.load_best_hp(str(tmp_path / "run")) == hp
    assert tconfig.load_best_hp(str(tmp_path / "nowhere"), str(tmp_path / "task")) == hp
    jconfig.save_best_hp({"blk_r": 16}, str(tmp_path / "jrun"))
    assert tconfig.load_best_hp(str(tmp_path / "jrun")) == {"blk_r": 16}
    assert tconfig.load_best_hp(str(tmp_path / "none")) is None
    assert tconfig.load_json(str(tmp_path / "run" / "best_hyperparams.json")) == hp
    with pytest.raises(ValueError, match="wrong format"):
        tconfig.override_config([{}], ["learning_rate=1"])


def test_torch_run_logger_jsonl_matches_jax(tmp_path):
    """Both loggers write the same records (their timestamps aside), and the
    run groups and the persisted group agree."""
    recs = []
    for mod, sub in ((tlogging, "port"), (jlogging, "jax")):
        logger = mod.RunLogger(str(tmp_path / sub), group="g", name="n",
                               config={"bits": 4, "hp": {}})
        logger.log({"step": 1, "loss": 2.5})
        logger.log({"step": 2, "eval_loss": 1.25, "_ts": 7.0})
        logger.finish()
        with open(tmp_path / sub / "metrics.jsonl") as f:
            lines = [json.loads(line) for line in f]
        assert all("_ts" in r for r in lines)
        recs.append([{k: v for k, v in r.items() if k != "_ts"} for r in lines])
        assert lines[-1]["_ts"] == 7.0
    assert recs[0] == recs[1] and len(recs[0]) == 3
    for kw in (dict(task_name="alpaca", cur_time="t"), dict(do_tune=True, group="g", notes="n",
                                                           cur_time="t")):
        assert tlogging.get_run_group(**kw) == jlogging.get_run_group(**kw)
    assert tlogging.host_tag() == jlogging.host_tag()
    d = str(tmp_path / "grp")
    assert tlogging.persist_run_group(d, "first") == "first"
    assert tlogging.persist_run_group(d, "second", resume=True) == \
        jlogging.persist_run_group(d, "third", resume=True) == "first"


def test_torch_run_logger_mirrors_to_wandb_only_with_a_key(tmp_path, monkeypatch):
    """Without ``WANDB_API_KEY`` the logger never imports wandb (a stand-in
    module records every call); with one it starts a run and mirrors each
    record without its ``_`` keys."""
    import sys
    import types

    calls = []

    class _Run:
        def log(self, rec):
            calls.append(("log", rec))

        def finish(self):
            calls.append(("finish",))

    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: calls.append(("init", kw)) or _Run()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    logger = tlogging.RunLogger(str(tmp_path / "a"), group="g", name="n", config={"bits": 4})
    logger.log({"step": 1, "loss": 2.0})
    logger.finish()
    assert calls == [] and logger.wandb_run is None
    monkeypatch.setenv("WANDB_API_KEY", "x")
    monkeypatch.setenv("WANDB_HOST", "h")
    logger = tlogging.RunLogger(str(tmp_path / "b"), group="g", name="n", config={"bits": 4})
    logger.log({"step": 1, "loss": 2.0})
    logger.finish()
    assert [c[0] for c in calls] == ["init", "log", "log", "finish"]
    assert calls[0][1] == {"project": "sparse_matrix_fine_tuning_torch", "group": "g",
                           "name": "n", "config": {"bits": 4}, "dir": str(tmp_path / "b")}
    assert calls[1][1] == {"step": 0} and calls[2][1] == {"step": 1, "loss": 2.0}
    with open(tmp_path / "b" / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2
