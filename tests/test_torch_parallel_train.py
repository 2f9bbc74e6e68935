"""Sharded training of the port (``parallel/``) in one 4-rank gloo world on
the CPU, against the port's unsharded run and the JAX package's mesh.

The method of the JAX ``tests/parallel/test_multihost.py``: each rank
trains on its data rank's rows (``shard_data_for_process``) and the
unsharded run is fed the same global batch compositions (each step's batch
is every data rank's rows of that step, in data-rank order).  Meshes: fsdp
4, dp 2 x fsdp 2 (remat "dots"), fsdp 2 x tp 2 with sequence parallelism
off and on (remat "nothing"), and fsdp 4 with merged training (the merged
operand built from the gathered dense).
The model is JAX ``tests/parallel/test_tp.py``'s flagship (vocab 128,
hidden 256, 2 layers, 4 heads, 2 kv heads, MLP 512, blk_r 4 adapters on all
seven projections), its ``blkdiag2`` drawn nonzero so that both factors
learn from the first step.  Tolerances: JAX's own (test_tp.py), rtol 2e-4
on eval losses and 5e-4 on train losses; the adapters after two AdamW steps
within 1e-5 (float32 sums in another order, about lr * 1e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import _torch_parallel_worker as w
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam
from sparse_matrix_fine_tuning_tpu.models import LlamaConfig as JLlamaConfig
from sparse_matrix_fine_tuning_tpu.models import LlamaForCausalLM as JLlama
from sparse_matrix_fine_tuning_tpu.parallel import make_mesh as jax_make_mesh
from sparse_matrix_fine_tuning_tpu.peft import init_monarch as jax_init_monarch
from sparse_matrix_fine_tuning_tpu.training import Trainer as JTrainer
from sparse_matrix_fine_tuning_tpu.training import TrainingArgs as JTrainingArgs
from sparse_matrix_fine_tuning_tpu.utils.testing import fresh_model
from sparse_matrix_fine_tuning_torch.parallel.multihost import split_rows
from sparse_matrix_fine_tuning_torch.training.trainer import Trainer

# tag: (dp, fsdp, tp), sequence_parallel, merged_training, remat policy (the
# unsharded runs without remat: its recompute repeats the forward exactly)
MESHES = {"fsdp4": ((1, 4, 1), "auto", "off", None),
          "dp2_fsdp2": ((2, 2, 1), "auto", "off", "dots"),
          "fsdp2_tp2": ((1, 2, 2), "off", "off", None),
          "fsdp2_tp2_sp": ((1, 2, 2), "on", "off", "nothing"),
          "fsdp4_merged": ((1, 4, 1), "auto", "on", None)}
GLOBAL_BS = 8  # test_tp.py's per_device_train_batch_size on its one process
EVAL_RTOL, TRAIN_RTOL, ADAPTER_ATOL = 2e-4, 5e-4, 1e-5


def jax_flagship():
    """test_tp.py's ``_flagship`` with seeded nonzero ``blkdiag2``."""
    model = fresh_model(JLlama, JLlamaConfig(**w.FLAGSHIP))
    jax_init_monarch(model, w.PEFT, rngs=nnx.Rngs(1))
    rng = np.random.default_rng(7)
    for path, v in nnx.to_flat_state(nnx.state(model, AdapterParam)):
        if path[-1] == "blkdiag2":
            v.set_value(jnp.array(rng.normal(0.0, 0.05, v[...].shape).astype(np.float32)))
    return model


def flat_state(model) -> dict:
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def data(n=16, t=16):
    """test_tp.py's ``_data``."""
    ids = np.random.default_rng(0).integers(2, 128, size=(n, t))
    return {"input_ids": ids, "attention_mask": np.ones_like(ids, dtype=np.int32),
            "labels": ids.copy()}


def jax_lm_loss(model, batch, train):
    logits = model(batch["input_ids"], attention_mask=batch["attention_mask"])
    return model.loss(logits, batch["labels"], weights=batch.get("_valid"))


def jax_mesh_eval(tmp, shape, sp) -> float:
    """The JAX package's own eval loss under its mesh on 4 of its virtual
    devices."""
    args = JTrainingArgs(output_dir=str(tmp), learning_rate=1e-3, max_steps=2,
                         per_device_train_batch_size=GLOBAL_BS, logging_steps=0,
                         log_param_steps=0, sequence_parallel=sp)
    mesh = jax_make_mesh(*shape, devices=jax.devices()[:4])
    return JTrainer(jax_flagship(), args, train_data=data(), eval_data=data(),
                    loss_fn=jax_lm_loss, mesh=mesh).evaluate()["eval_loss"]


def unsharded(state, parts: int, tmp, merged: str = "off") -> dict:
    """The port without a mesh, fed the global batches of ``parts`` data
    ranks: eval, the two steps, eval."""
    full = data()
    bs = GLOBAL_BS // parts
    shards = [split_rows(full, parts, r) for r in range(parts)]
    idx = np.arange(len(shards[0]["input_ids"]))
    np.random.default_rng(42).shuffle(idx)  # each rank's epoch-0 order (TrainingArgs.seed)
    order = {k: np.concatenate([s[k][idx[i * bs:(i + 1) * bs]] for i in range(2)
                                for s in shards]) for k in full}
    model = w.port_model(state)
    args = dataclasses.replace(w.train_args(str(tmp), GLOBAL_BS), per_device_eval_batch_size=32,
                               merged_training=merged)
    tr = Trainer(model, args, train_data=order, eval_data=full, loss_fn=w.lm_loss, device="cpu")
    e0 = tr.evaluate()["eval_loss"]
    tr.model.train()
    losses = [float(tr.train_step(b)) for b, _ in tr._batches(order, GLOBAL_BS, shuffle=False)]
    e1 = tr.evaluate()["eval_loss"]
    adapters = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    return {"eval": (e0, e1), "losses": losses, "adapters": adapters}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One world for every case of the file; the JAX mesh runs and the
    unsharded references while it runs."""
    tmp = tmp_path_factory.mktemp("parallel_train")
    procs = w.spawn("train", str(tmp))
    try:
        state = flat_state(jax_flagship())
        w.put_inputs(str(tmp), {"state": state, "data": data(), "meshes": MESHES,
                                "global_bs": GLOBAL_BS})
        ref = {(parts, merged): unsharded(state, parts, tmp / f"ref{parts}{merged}", merged)
               for parts, merged in ((4, "off"), (2, "off"), (4, "on"))}
        jax_eval = {tag: jax_mesh_eval(tmp / f"jax_{tag}", shape, sp)
                    for tag, (shape, sp, _, _) in MESHES.items()
                    if tag in ("fsdp4", "fsdp2_tp2_sp")}
    finally:
        ranks = w.collect(procs, str(tmp))
    return ranks, ref, jax_eval


def _ref(ref, tag):
    (dp, fsdp, _), _, merged, _ = MESHES[tag]
    return ref[(dp * fsdp, merged)]


@pytest.mark.parametrize("tag", list(MESHES))
def test_torch_parallel_losses_match_unsharded(runs, tag):
    ranks, ref, _ = runs
    want = _ref(ref, tag)
    for rec in ranks:  # every rank reports the global batch's losses
        got = rec[tag]
        np.testing.assert_allclose(got["eval"][0], want["eval"][0], rtol=EVAL_RTOL)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TRAIN_RTOL)
        np.testing.assert_allclose(got["eval"][1], want["eval"][1], rtol=TRAIN_RTOL)
        assert got["eval"][1] < got["eval"][0]
        assert not got["mesh_left"]  # the activation mesh never leaks out of the trainer


@pytest.mark.parametrize("tag", list(MESHES))
def test_torch_parallel_adapters_match_unsharded(runs, tag):
    """Every adapter parameter after the two steps, on every rank (they stay
    replicated: the ranks agree bit for bit)."""
    ranks, ref, _ = runs
    want = _ref(ref, tag)["adapters"]
    first = ranks[0][tag]["adapters"]
    assert set(first) == set(want)
    for name, value in want.items():
        torch.testing.assert_close(first[name], value, rtol=0, atol=ADAPTER_ATOL)
        for rec in ranks[1:]:
            assert torch.equal(rec[tag]["adapters"][name], first[name])


@pytest.mark.parametrize("tag", ["fsdp4", "fsdp2_tp2_sp"])
def test_torch_parallel_eval_matches_jax_mesh(runs, tag):
    ranks, _, jax_eval = runs
    np.testing.assert_allclose(ranks[0][tag]["eval"][0], jax_eval[tag], rtol=EVAL_RTOL)


@pytest.mark.parametrize("tag", list(MESHES))
def test_torch_parallel_placement_is_param_spec(runs, tag):
    """The frozen parameters sit where ``param_spec`` puts them (FSDP2's
    shard and the tp DTensor's); the adapters are plain replicated tensors."""
    ranks, _, _ = runs
    rec = ranks[0][tag]
    assert rec["placed"] == rec["specs"]
    assert rec["adapters_plain"]
    # 128 x 256 is below 2^16 elements: replicated; 512 x 256 takes fsdp
    assert rec["specs"]["model.embed_tokens.weight"] == ()
    assert "fsdp" in rec["specs"]["model.layers.0.mlp.up_proj.dense"]
    if MESHES[tag][0][2] > 1:  # column-parallel out features, row-parallel in features
        assert rec["specs"]["model.layers.0.self_attn.q_proj.dense"][0] == "tp"
        assert rec["specs"]["model.layers.0.mlp.down_proj.dense"][1] == "tp"
