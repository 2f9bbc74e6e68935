"""The port's sharded decoding, chunked loss under a column-parallel head,
adapter variants under tensor parallelism, checkpoints, refusals and
activation layout, in one 4-rank gloo world on the CPU.

Greedy and beam tokens of the model placed by ``shard_model`` at fsdp 4 and
at fsdp 2 x tp 2 (the frozen head column-parallel, the cache holding the
rank's kv heads) equal the unsharded model's (JAX
``tests/parallel/test_sharded_generate.py:57-76``).  The chunked loss under
the column-parallel head, eval and two steps at fsdp 2 x tp 2, matches the
unsharded materialised loss within JAX's rtol 2e-4 / 5e-4 (JAX
``test_tp_chunked_loss_matches_replicated``).  The model is JAX
``test_tp.py``'s flagship with nonzero ``blkdiag2``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import _torch_parallel_worker as w
from sparse_matrix_fine_tuning_torch.models.generate import GenerationConfig, generate
from sparse_matrix_fine_tuning_torch.parallel.multihost import split_rows
from sparse_matrix_fine_tuning_torch.training.trainer import Trainer
from test_torch_parallel_train import data, flat_state, jax_flagship

EVAL_RTOL, TRAIN_RTOL = 2e-4, 5e-4


def prompts():
    """test_sharded_generate.py's prompts: 4 rows of 12, the first
    left-padded by 3."""
    ids = np.random.default_rng(0).integers(2, 128, size=(4, 12))
    mask = np.ones((4, 12), np.int64)
    mask[0, :3] = 0
    ids[0, :3] = 0
    return ids, mask


def global_order(parts: int = 2, bs: int = 4) -> dict:
    """The rows of the first two global batches of ``parts`` data ranks of
    ``bs`` rows, in order (each rank's epoch-0 shuffle, seed 42)."""
    full = data()
    shards = [split_rows(full, parts, r) for r in range(parts)]
    idx = np.arange(len(shards[0]["input_ids"]))
    np.random.default_rng(42).shuffle(idx)
    return {k: np.concatenate([s[k][idx[i * bs:(i + 1) * bs]] for i in range(2) for s in shards])
            for k in full}


def unsharded_variant(peft, tmp) -> dict:
    """``variant_steps`` without a mesh on fsdp 2 x tp 2's global batches;
    the eval over the whole data."""
    order = global_order()
    model = w.variant_model(peft)
    args = dataclasses.replace(w.train_args(str(tmp), 8), per_device_eval_batch_size=32)
    tr = Trainer(model, args, train_data=order, eval_data=data(), loss_fn=w.lm_loss,
                 device="cpu")
    torch.manual_seed(0)
    e0 = tr.evaluate()["eval_loss"]
    tr.model.train()
    losses = [float(tr.train_step(b)) for b, _ in tr._batches(order, 8, shuffle=False)]
    return {"eval": (e0, tr.evaluate()["eval_loss"]), "losses": losses,
            "adapters": {n: p.detach().clone() for n, p in model.named_parameters()
                         if p.requires_grad}}


def unsharded_chunk_reference(state, tmp) -> dict:
    """The materialised loss without a mesh on fsdp 2 x tp 2's global
    batches (2 data ranks of 4 rows a step), the head frozen as there."""
    full, order = data(), global_order()
    model = w.port_model(state)
    args = dataclasses.replace(w.train_args(str(tmp), 8), per_device_eval_batch_size=32)
    tr = Trainer(model, args, train_data=order, eval_data=full, loss_fn=w.lm_loss,
                 extra_trainable_paths=(), device="cpu")
    e0 = tr.evaluate()["eval_loss"]
    tr.model.train()
    losses = [float(tr.train_step(b)) for b, _ in tr._batches(order, 8, shuffle=False)]
    return {"eval": (e0, tr.evaluate()["eval_loss"]), "losses": losses}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_decode")
    procs = w.spawn("decode", str(tmp))
    try:
        state = flat_state(jax_flagship())
        ids, mask = prompts()
        w.put_inputs(str(tmp), {"state": state, "data": data(), "ids": ids, "mask": mask})
        plain = w.port_model(state)
        tokens = {beams: generate(plain, torch.from_numpy(ids), torch.from_numpy(mask),
                                  GenerationConfig(max_new_tokens=8, eos_token_id=None,
                                                   pad_token_id=0, num_beams=beams))
                  for beams in (1, 2)}
        chunk = unsharded_chunk_reference(state, tmp / "ref")
        variants = {tag: unsharded_variant(peft, tmp / f"ref_{tag}")
                    for tag, peft in w.VARIANTS.items()}
    finally:
        ranks = w.collect(procs, str(tmp))
    return ranks, tokens, {"chunk": chunk, "variants": variants}, tmp


@pytest.mark.parametrize("beams", [1, 2])
@pytest.mark.parametrize("tag", ["fsdp4", "fsdp2_tp2"])
def test_torch_parallel_decoding_matches_unsharded(world, tag, beams):
    ranks, tokens, _, _ = world
    for rec in ranks:
        assert torch.equal(rec[f"tokens/{tag}/{beams}"], tokens[beams])
    assert ranks[0][f"kv_shards/{tag}"] == (2 if tag == "fsdp2_tp2" else 1)
    assert ranks[0][f"head/{tag}"] == ("DTensor" if tag == "fsdp2_tp2" else "Parameter")


def test_torch_parallel_chunked_loss_column_parallel_head(world):
    ranks, _, refs, _ = world
    want = refs["chunk"]
    got = ranks[0]["chunked"]
    assert got["head_tp"] == "head"
    np.testing.assert_allclose(got["eval"][0], want["eval"][0], rtol=EVAL_RTOL)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TRAIN_RTOL)
    np.testing.assert_allclose(got["eval"][1], want["eval"][1], rtol=TRAIN_RTOL)
    assert all(r["chunked"]["losses"] == got["losses"] for r in ranks)


@pytest.mark.parametrize("tag", list(w.VARIANTS))
def test_torch_parallel_adapter_variants_under_tp(world, tag):
    """A Scaler (the row-parallel layers gather their input) and the
    multiplicative factor (the column-parallel layers take their blocks of
    it) at fsdp 2 x tp 2: losses and adapters as unsharded."""
    ranks, _, refs, _ = world
    want, got = refs["variants"][tag], ranks[0]["variants"][tag]
    np.testing.assert_allclose(got["eval"][0], want["eval"][0], rtol=EVAL_RTOL)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TRAIN_RTOL)
    np.testing.assert_allclose(got["eval"][1], want["eval"][1], rtol=TRAIN_RTOL)
    assert set(got["adapters"]) == set(want["adapters"])
    for name, value in want["adapters"].items():
        torch.testing.assert_close(got["adapters"][name], value, rtol=0, atol=1e-5)


def test_torch_parallel_dropout_masks_agree_over_tp(world):
    """Adapter dropout under tensor parallelism: every tp peer draws the
    whole layer's mask, so a column-parallel layer's gathered output and a
    row-parallel layer's summed partial outputs are the whole layer's with
    the same random state (float32 sums in another order)."""
    ranks, _, _, _ = world
    for rec in ranks:
        assert max(rec["dropout_layers"].values()) < 1e-5, rec["dropout_layers"]


def test_torch_parallel_checkpoints_primary_writes_and_resume_agrees(world):
    """Rank 0 alone writes, every rank returns its path and loads it; a
    resume from the shared directory ends where a straight run ends."""
    ranks, _, _, tmp = world
    path = ranks[0]["ckpt_path"]
    assert all(r["ckpt_path"] == path for r in ranks)
    assert os.path.exists(os.path.join(path, "trainable.npz"))
    assert ranks[0]["ckpt_writes"] and all(r["ckpt_writes"] == [] for r in ranks[1:])
    for rec in ranks:
        step, params = rec["resumed"]
        assert step == 2
        for name, value in rec["straight"].items():
            torch.testing.assert_close(params[name], value, rtol=0, atol=1e-6)


def test_torch_parallel_resume_divergence_raises_on_every_rank(world):
    ranks, _, _, _ = world
    for rec in ranks:
        assert rec["divergence"] is not None and "divergence" in rec["divergence"]


def test_torch_parallel_refusals_in_a_world(world):
    """tp not dividing the kv heads; a DTensor sent to a kernel's dispatch
    (never to its plain version)."""
    ranks, _, _, _ = world
    refusals = ranks[0]["refusals"]
    assert "does not divide the 2 kv heads" in refusals["kv_heads"]
    assert "DTensor" in refusals["dtensor"]


def test_torch_parallel_shard_tokens_layout_and_guards(world):
    """JAX test_sp.py's layout and guards: the rank's slice of the sequence,
    a tensor already in the layout, a sequence tp does not divide, a 2-D
    tensor, a tp = 1 mesh, and the scope restored."""
    ranks, _, _, _ = world
    for rec in ranks:
        assert all(rec["layout"].values()), rec["layout"]


def test_torch_parallel_meshes_and_batch_contract(world):
    """``make_mesh`` in the world, data ranks, ``global_batch`` and
    ``group_by_length``'s trim agreed over the ranks."""
    ranks, _, _, _ = world
    assert ranks[0]["mesh_shapes"] == {"fsdp4": ((1, 4, 1), ("dp", "fsdp", "tp")),
                                       "fsdp2_tp2": ((1, 2, 2), ("dp", "fsdp", "tp"))}
    assert [r["data_rank"]["fsdp4"] for r in ranks] == [(4, r) for r in range(4)]
    assert [r["data_rank"]["fsdp2_tp2"] for r in ranks] == [(2, 0), (2, 0), (2, 1), (2, 1)]
    full = data()
    want = {k: np.concatenate([split_rows(full, 2, r)[k][:2] for r in range(2)]) for k in full}
    for rec in ranks:
        for k, v in want.items():
            np.testing.assert_array_equal(rec["global_batch"][k], v)
    shapes = ranks[0]["gbl_shapes"]
    assert all(r["gbl_shapes"] == shapes for r in ranks)
    assert any(s[1] < 16 for s in shapes)
