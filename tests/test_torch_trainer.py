"""The port's ``Trainer`` against the JAX one on the CPU: a tiny Llama
(2 layers, hidden 64, GQA 4/2, Monarch adapters on all seven projections,
random nonzero factors) trained 3 optimizer steps with gradient
accumulation 2 by both packages from the same weights and data, with merged
training off and on; and checkpoints that each package writes and the
other loads.

Tolerances: the per-step losses and the final trainable parameters within
1e-4 (utils/testing.TOLERANCES["f32_logits"]): three AdamW steps of float32
sums taken in another order.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.training import checkpoint as tckpt
from sparse_matrix_fine_tuning_torch.training.trainer import Trainer, TrainingArgs
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import (
    load_jax_state,
    read_jax_trainable,
    write_jax_trainable,
)
from sparse_matrix_fine_tuning_torch.utils.logging import RunLogger, watch_layers
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam
from sparse_matrix_fine_tuning_tpu.training import Trainer as JaxTrainer
from sparse_matrix_fine_tuning_tpu.training import TrainingArgs as JaxTrainingArgs
from sparse_matrix_fine_tuning_tpu.training import checkpoint as jckpt
from sparse_matrix_fine_tuning_tpu.peft.surgery import trainable_filter as jax_trainable_filter
from sparse_matrix_fine_tuning_tpu.utils.logging import watch_layers as jax_watch_layers

MODEL = TOLERANCES["f32_logits"]
PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj"]}
BS, GA, STEPS, T = 2, 2, 3, 12


def _jax_model(seed=0):
    jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(), rngs=nnx.Rngs(seed))
    jpeft.init_monarch(jm, PEFT, rngs=nnx.Rngs(seed + 1))
    rng = np.random.default_rng(seed)
    for _, v in nnx.to_flat_state(nnx.state(jm, AdapterParam)):
        v.set_value(jnp.array(rng.normal(0.0, 0.1, v[...].shape).astype(np.float32)))
    return jm


def _port_of(jm):
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    surgery.init_monarch(tm, PEFT)
    load_jax_state(tm, {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
                        for path, v in nnx.to_flat_state(nnx.state(jm, nnx.Param))})
    return tm


def _data(seed=1, n=BS * GA * STEPS):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 256, (n, T)).astype(np.int32)
    mask = np.ones_like(ids)
    for row in range(0, n, 3):
        mask[row, T - 1 - row % 5:] = 0  # some right padding
    labels = np.where(mask > 0, ids, -100).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


def _args(cls, tmp_path, name, merged):
    return cls(output_dir=str(tmp_path / name), learning_rate=1e-2, max_steps=STEPS,
               per_device_train_batch_size=BS, gradient_accumulation_steps=GA,
               logging_steps=1, log_param_steps=0, merged_training=merged, seed=7)


def _trainable(jm):
    return {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(v[...])
            for path, v in nnx.to_flat_state(nnx.state(jm, jax_trainable_filter()))}


@pytest.mark.parametrize("merged", ["off", "on"])
def test_torch_trainer_steps_match_jax(tmp_path, merged):
    jm = _jax_model()
    tm = _port_of(jm)
    data = _data()
    # merged on also evaluates and keeps the best model, as the JAX trainer
    kw = {"load_best_model_at_end": True} if merged == "on" else {}
    evals = {"eval_data": _data(seed=2, n=5)} if merged == "on" else {}
    jtr = JaxTrainer(jm, dataclasses.replace(_args(JaxTrainingArgs, tmp_path, "jax", merged),
                                             **kw), train_data=data, **evals)
    ttr = Trainer(tm, dataclasses.replace(_args(TrainingArgs, tmp_path, "port", merged), **kw),
                  train_data=data, device="cpu", **evals)
    assert ttr._n_merged == jtr._n_merged == (14 if merged == "on" else 0)
    want_metrics = jtr.train()
    got_metrics = ttr.train()
    assert set(got_metrics) == set(want_metrics)
    if evals:
        np.testing.assert_allclose(got_metrics["eval_loss"], want_metrics["eval_loss"], **MODEL)
        assert ttr.best_ckpt == os.path.join(str(tmp_path / "port"), "checkpoint-best")
    want = [r["loss"] for r in jtr.log_history if "loss" in r]
    got = [r["loss"] for r in ttr.log_history if "loss" in r]
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, **MODEL)
    params = dict(tm.named_parameters())
    jparams = _trainable(jm)
    assert len(jparams) == 29  # 28 adapter factors and the LM head
    for name, value in jparams.items():
        port = params[name.replace("lm_head.kernel", "lm_head.weight")]
        port = port.T if name == "lm_head.kernel" else port
        assert port.requires_grad
        np.testing.assert_allclose(to_numpy(port), value, **MODEL)
    assert not tm.model.layers[0].mlp.down_proj.dense.requires_grad
    # both wrote a final checkpoint and the completed marker
    for run in ("jax", "port"):
        assert os.path.exists(tmp_path / run / "completed")
        assert os.path.exists(tmp_path / run / f"checkpoint-{STEPS}" / "trainable.npz")


@pytest.mark.parametrize("grouped", [False, True], ids=["shuffled", "length_grouped"])
def test_torch_trainer_batches_match_jax(tmp_path, grouped):
    """The same batches in the same order for a seed, the ragged tail padded
    and masked; with group_by_length, rows sorted by length within
    megabatches and the time axis trimmed to a multiple of length_bucket."""
    jm = _jax_model()
    data = _data(n=BS * GA * 2 + 3)
    lengths = np.random.default_rng(2).integers(2, T + 1, len(data["attention_mask"]))
    data["attention_mask"] = (np.arange(T)[None, :] < lengths[:, None]).astype(np.int32)
    kw = {"group_by_length": grouped, "length_bucket": 4}
    jtr = JaxTrainer(jm, dataclasses.replace(_args(JaxTrainingArgs, tmp_path, "jax", "off"), **kw),
                     train_data=data)
    ttr = Trainer(_port_of(jm), dataclasses.replace(_args(TrainingArgs, tmp_path, "port", "off"),
                                                    **kw), train_data=data, device="cpu")
    want = list(jtr._batches(data, BS, shuffle=True, seed=11, accum=GA))
    got = list(ttr._batches(data, BS, shuffle=True, seed=11, accum=GA))
    assert len(got) == len(want) == 3
    if grouped:  # some batch was trimmed
        assert min(b["input_ids"].shape[-1] for b, _ in got) < T
    for (gb, gn), (wb, wn) in zip(got, want):
        assert gn == wn and set(gb) == set(wb)
        for k in wb:
            np.testing.assert_array_equal(gb[k].numpy(), np.asarray(wb[k]))


def test_torch_trainable_npz_crosses_between_packages(tmp_path):
    """trainable.npz written by each package and loaded by the other."""
    jm = _jax_model(seed=3)
    tm = _port_of(_jax_model(seed=4))  # other values, same structure
    surgery.trainable_filter(tm)
    jfile = str(tmp_path / "jax_trainable.npz")
    jckpt._save_tree(jfile, nnx.state(jm, jax_trainable_filter()))
    names = read_jax_trainable(jfile, tm)
    assert len(names) == 29
    params = dict(tm.named_parameters())
    for name, value in _trainable(jm).items():
        port = params[name.replace("lm_head.kernel", "lm_head.weight")]
        port = port.T if name == "lm_head.kernel" else port
        np.testing.assert_array_equal(to_numpy(port), value)

    with torch.no_grad():
        for name, p in tm.named_parameters():
            if p.requires_grad:
                p.mul_(-0.5)
    tfile = str(tmp_path / "port_trainable.npz")
    assert write_jax_trainable(tfile, tm) == sorted(np.load(jfile).files)
    restored = jckpt._load_tree(tfile, nnx.state(jm, jax_trainable_filter()), strict=True)
    nnx.update(jm, restored)
    for name, value in _trainable(jm).items():
        port = params[name.replace("lm_head.kernel", "lm_head.weight")]
        port = port.T if name == "lm_head.kernel" else port
        np.testing.assert_array_equal(to_numpy(port), value)


def test_torch_trainer_checkpoint_round_trip(tmp_path):
    """save_checkpoint then load_checkpoint restores the factors, the
    optimizer's state, the step and the merged operands exactly; pruning
    keeps the newest numbered checkpoints."""
    tm = _port_of(_jax_model(seed=5))
    args = dataclasses.replace(_args(TrainingArgs, tmp_path, "port", "on"), save_total_limit=2)
    tr = Trainer(tm, args, train_data=_data(), device="cpu")
    batch, _ = next(tr._batches(tr.train_data, BS, accum=GA))
    tr.train_step(batch)
    tr.step = 1
    first = tr.save_checkpoint()
    best = tr.save_checkpoint(tag="best")
    saved = {n: p.detach().clone() for n, p in tm.named_parameters() if p.requires_grad}
    opt = {k: v.clone() for k, v in tr.optimizer.state_arrays().items()}
    for step in (2, 3):
        tr.train_step(batch)
        tr.step = step
        tr.save_checkpoint()
    assert not os.path.exists(first) and os.path.exists(best)
    assert tckpt.get_last_checkpoint(args.output_dir) == (
        os.path.join(args.output_dir, "checkpoint-3"), False)
    tr.load_checkpoint(best)
    assert tr.step == 1 and tr.optimizer.count == 1
    for n, p in tm.named_parameters():
        if p.requires_grad:
            torch.testing.assert_close(p.detach(), saved[n], rtol=0, atol=0)
    for k, v in tr.optimizer.state_arrays().items():
        torch.testing.assert_close(v, opt[k], rtol=0, atol=0)
    layer = tm.model.layers[0].self_attn.q_proj
    torch.testing.assert_close(layer.wm_cache, layer._build_merged()[0], rtol=0, atol=0)


@pytest.mark.parametrize("kw,item", [({"merged_training": "sometimes"}, ValueError),
                                     ({"state_split": False}, NotImplementedError),
                                     ({"sequence_parallel": "on"}, NotImplementedError)])
def test_torch_trainer_refuses_unported_options(tmp_path, kw, item):
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    surgery.init_monarch(tm, PEFT)
    args = dataclasses.replace(_args(TrainingArgs, tmp_path, "port", "off"), **kw)
    with pytest.raises(item):
        Trainer(tm, args, train_data=_data(), device="cpu")


def _resume_args(tmp_path, name, steps, grouped):
    """Constant lr (a decaying schedule's horizon would differ between the
    two budgets), a checkpoint at every step."""
    return dataclasses.replace(
        _args(TrainingArgs, tmp_path, name, "off"), max_steps=steps, save_steps=1,
        lr_scheduler_type="constant", warmup_ratio=0.0, group_by_length=grouped,
        length_bucket=4)


def _resume_model():
    """The tiny Llama with adapter dropout 0.1: the resumed run must replay
    the random state too."""
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                          generator=torch.Generator().manual_seed(3))
    surgery.init_monarch(tm, {**PEFT, "dropout": 0.1}, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if "blkdiag2" in name:
                p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(5))
    return tm


def _ragged_lengths(data):
    lengths = np.random.default_rng(8).integers(2, T + 1, len(data["attention_mask"]))
    data["attention_mask"] = (np.arange(T)[None, :] < lengths[:, None]).astype(np.int32)
    data["labels"] = np.where(data["attention_mask"] > 0, data["input_ids"], -100).astype(np.int32)
    return data


@pytest.mark.parametrize("grouped", [False, True], ids=["shuffled", "length_grouped"])
def test_torch_trainer_resume_matches_a_straight_run(tmp_path, grouped):
    """Mid-epoch-exact resume, as the JAX trainer's (tests/training/
    test_trainer.py:424): 4 steps an epoch; 3 steps, then a fresh trainer
    resumed to 6, against 6 straight: the same losses at every step, the
    same factors and optimizer state, bit for bit."""
    data = _ragged_lengths(_data(n=BS * GA * 4))
    torch.manual_seed(9)
    first = Trainer(_resume_model(), _resume_args(tmp_path, "cut", 3, grouped),
                    train_data=data, device="cpu")
    assert first.steps_per_epoch() == 4
    first.train()
    with open(tmp_path / "cut" / "checkpoint-3" / "meta.json") as f:
        meta = json.load(f)
    assert (meta["epoch"], meta["batch_in_epoch"], meta["data_seed"]) == (0, 3, 7)
    torch.manual_seed(10)  # the checkpoint's random state replaces it
    resumed = Trainer(_resume_model(), _resume_args(tmp_path, "cut", 6, grouped),
                      train_data=data, device="cpu")
    resumed.train(resume=True)
    torch.manual_seed(9)
    straight = Trainer(_resume_model(), _resume_args(tmp_path, "straight", 6, grouped),
                       train_data=data, device="cpu")
    straight.train()
    assert resumed.step == straight.step == 6
    losses = [[r["loss"] for r in t.log_history if "loss" in r] for t in (resumed, straight)]
    assert losses[0] == losses[1] and len(losses[0]) == 6
    got = dict(resumed.model.named_parameters())
    for name, p in straight.model.named_parameters():
        if p.requires_grad:
            assert torch.equal(got[name], p), name
    want_opt = straight.optimizer.state_arrays()
    got_opt = resumed.optimizer.state_arrays()
    assert sorted(got_opt) == sorted(want_opt)
    for k, v in want_opt.items():
        assert torch.equal(torch.as_tensor(got_opt[k]), torch.as_tensor(v)), k


@pytest.mark.parametrize("grouped", [False, True], ids=["shuffled", "length_grouped"])
@pytest.mark.parametrize("skip", [0, 1, 3])
def test_torch_trainer_skipped_batches_match_jax(tmp_path, grouped, skip):
    """``_batches(skip=k)`` is the same batches as the JAX trainer's, the
    first k passed over, with length grouping on and off."""
    jm = _jax_model()
    data = _ragged_lengths(_data(n=BS * GA * 3 + 3))
    kw = {"group_by_length": grouped, "length_bucket": 4}
    jtr = JaxTrainer(jm, dataclasses.replace(_args(JaxTrainingArgs, tmp_path, "jax", "off"), **kw),
                     train_data=data)
    ttr = Trainer(_port_of(jm), dataclasses.replace(_args(TrainingArgs, tmp_path, "port", "off"),
                                                    **kw), train_data=data, device="cpu")
    want = list(jtr._batches(data, BS, shuffle=True, seed=11, accum=GA, skip=skip))
    got = list(ttr._batches(data, BS, shuffle=True, seed=11, accum=GA, skip=skip))
    every = list(ttr._batches(data, BS, shuffle=True, seed=11, accum=GA))
    assert len(got) == len(want) == 4 - skip
    for (gb, gn), (wb, wn), (eb, _) in zip(got, want, every[skip:]):
        assert gn == wn and set(gb) == set(wb) == set(eb)
        for k in wb:
            np.testing.assert_array_equal(gb[k].numpy(), np.asarray(wb[k]))
            assert torch.equal(gb[k], eb[k])


def test_torch_trainer_resume_of_a_finished_run_loads_it(tmp_path):
    """As the JAX trainer (tests/training/test_trainer.py:239, :257): with
    no checkpoint, resume starts fresh; a run completed at this budget is
    loaded and not trained again; a resumed run keeps the best metric, its
    checkpoint and the log history from before."""
    data, evals = _data(), _data(seed=2, n=5)
    fresh = Trainer(_port_of(_jax_model(seed=6)), _args(TrainingArgs, tmp_path, "run", "off"),
                    train_data=data, device="cpu")
    fresh.train(resume=True)  # nothing to resume from
    again = Trainer(_port_of(_jax_model(seed=7)), _args(TrainingArgs, tmp_path, "run", "off"),
                    train_data=data, device="cpu")
    again.train(resume=True)
    assert fresh.step == again.step == STEPS
    assert again.log_history == fresh.log_history and len(fresh.log_history) == STEPS
    got = dict(again.model.named_parameters())
    for name, p in fresh.model.named_parameters():
        if p.requires_grad:
            assert torch.equal(got[name], p), name

    kw = dict(eval_steps=1, load_best_model_at_end=True)
    best = Trainer(_port_of(_jax_model(seed=6)),
                   dataclasses.replace(_args(TrainingArgs, tmp_path, "best", "off"), **kw),
                   train_data=data, eval_data=evals, device="cpu")
    best.train()
    os.remove(tmp_path / "best" / "completed")  # as if the run had stopped after its last step
    later = Trainer(_port_of(_jax_model(seed=7)),
                    dataclasses.replace(_args(TrainingArgs, tmp_path, "best", "off"), **kw),
                    train_data=data, eval_data=evals, device="cpu")
    later._maybe_resume()
    assert later.step == STEPS
    assert (later.best_metric, later.best_ckpt) == (best.best_metric, best.best_ckpt)
    assert later.best_ckpt == str(tmp_path / "best" / "checkpoint-best")
    assert later.log_history == best.log_history and later.log_history


def test_torch_trainer_auto_merges_nothing(tmp_path):
    """merged_training "auto" is "off" in the port; the JAX rule merges
    nothing at this size either."""
    jm = _jax_model()
    args = dataclasses.replace(_args(TrainingArgs, tmp_path, "port", "auto"))
    jtr = JaxTrainer(jm, _args(JaxTrainingArgs, tmp_path, "jax", "auto"), train_data=_data())
    ttr = Trainer(_port_of(jm), args, train_data=_data(), device="cpu")
    assert ttr._n_merged == jtr._n_merged == 0
    assert {f.name: f.default for f in dataclasses.fields(TrainingArgs)} == {
        f.name: f.default for f in dataclasses.fields(JaxTrainingArgs)}


@pytest.mark.parametrize("stored", ["bfloat16", "raw_bits"])
def test_torch_trainable_npz_reads_bf16(tmp_path, stored):
    """A bf16 trainable.npz as numpy stores it with ml_dtypes ("bfloat16")
    and as a machine without ml_dtypes reads it back (2-byte void)."""
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    surgery.init_monarch(tm, PEFT)
    surgery.trainable_filter(tm, ())
    rng = np.random.default_rng(6)
    want = {n: rng.standard_normal(tuple(p.shape)).astype(np.float32)
            for n, p in tm.named_parameters() if p.requires_grad}
    arrays = {}
    for name, value in want.items():
        bf16 = np.asarray(jnp.asarray(value, jnp.bfloat16))
        want[name] = bf16.astype(np.float32)
        arrays[name.replace(".", "/") + "/value"] = bf16 if stored == "bfloat16" else bf16.view("V2")
    path = str(tmp_path / "trainable.npz")
    np.savez(path, **arrays)
    assert len(read_jax_trainable(path, tm)) == 28
    for name, p in tm.named_parameters():
        if p.requires_grad:
            np.testing.assert_array_equal(to_numpy(p), want[name])


def test_torch_trainer_watches_layers_with_the_logger(tmp_path):
    """Every ``log_param_steps`` steps the trainer hands ``watch_layers``'s
    adapter statistics to its logger, as the JAX trainer does
    (training/trainer.py:509-513), and they equal the JAX statistics of the
    same trained factors."""
    jm = _jax_model(seed=3)
    tm = _port_of(jm)
    data = _data()
    args = dataclasses.replace(_args(TrainingArgs, tmp_path, "port", "off"), log_param_steps=2)
    logger = RunLogger(str(tmp_path / "log"))
    Trainer(tm, args, train_data=data, logger=logger, device="cpu").train()
    logger.finish()
    jargs = dataclasses.replace(_args(JaxTrainingArgs, tmp_path, "jax", "off"), log_param_steps=0)
    JaxTrainer(jm, jargs, train_data=data).train()
    with open(tmp_path / "log" / "metrics.jsonl") as f:
        watched = [r for r in map(json.loads, f) if any(k.startswith("watch/") for k in r)]
    assert len(watched) == 1  # at step 2 of 3
    want = jax_watch_layers(jm)
    got = watch_layers(tm)
    assert sorted(got) == sorted(want) == sorted(k for k in watched[0] if k != "_ts")
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-5, key
