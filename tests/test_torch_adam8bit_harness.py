"""The 8-bit AdamW through the port's harness layers on the CPU:
``GroupedAdamW(optim="adamw8bit")``'s three groups against the JAX
``build_optimizer(optim="adamw8bit")`` over three steps (parameters within
``TOLERANCES["f32_op"]``), its state through ``state_arrays`` /
``load_state_arrays``, and a ``Trainer`` run resumed from a checkpoint equal
to a straight one bit for bit (as ``test_torch_trainer.py``'s AdamW case).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparse_matrix_fine_tuning_torch.training import optim as topt
from sparse_matrix_fine_tuning_torch.training.adam8bit import AdamW8bit
from sparse_matrix_fine_tuning_torch.training.trainer import Trainer
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu.training import optim as jopt
from test_torch_optim import _tree
from test_torch_trainer import _data, _ragged_lengths, _resume_args, _resume_model

F32 = TOLERANCES["f32_op"]


@pytest.mark.parametrize("kw", [
    {},
    {"large_lr": True, "weight_decay": 0.1},
    {"large_lr": True, "use_scaler": True, "weight_decay": 0.1, "lr_scheduler_type": "cosine"},
], ids=["default", "large_lr", "large_lr_scaler"])
def test_torch_grouped_adamw8bit_steps_match_jax(kw):
    """Three steps over the three groups with warmup and clipping."""
    args = dict(learning_rate=1e-2, total_steps=10, warmup_ratio=0.2, new_lr=5e-2, **kw)
    params = _tree(2)
    jparams = {k: jnp.array(v) for k, v in params.items()}
    tx = jopt.build_optimizer(jparams, optim="adamw8bit", **args)
    state = tx.init(jparams)
    named = [(k, to_torch(v).requires_grad_()) for k, v in params.items()]
    opt = topt.build_optimizer(named, optim="adamw8bit", **args)
    assert isinstance(opt.opt, AdamW8bit)
    want_groups = {jopt.param_group_label((k,), use_scaler=kw.get("use_scaler", False))
                   for k in params}
    assert {g["label"] for g in opt.opt.param_groups} == want_groups
    for step in range(3):
        grads = _tree(10 + step, 10.0 if step == 1 else 0.01)
        updates, state = tx.update({k: jnp.array(v) for k, v in grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        for (_, p), g in zip(named, grads.values()):
            p.grad = to_torch(g)
        opt.step()
    for name, p in named:
        np.testing.assert_allclose(to_numpy(p), np.asarray(jparams[name]), **F32, err_msg=name)


def test_torch_adamw8bit_state_arrays_round_trip():
    """Codes stay uint8, scales float32, the count int32; a fresh optimizer
    loaded from the arrays holds the same state; a wrong shape raises."""
    named = [(k, to_torch(v).requires_grad_()) for k, v in _tree(3).items()]
    opt = topt.build_optimizer(named, learning_rate=1e-2, total_steps=10, optim="adamw8bit")
    for (_, p), g in zip(named, _tree(4).values()):
        p.grad = to_torch(g)
    opt.step()
    arrays = {k: v.clone() for k, v in opt.state_arrays().items()}
    assert len(arrays) == 1 + 5 * len(named)
    name = named[0][0]
    assert arrays[f"{name}/mq"].dtype == torch.uint8 and arrays[f"{name}/ms"].dtype == torch.float32
    assert arrays[f"{name}/count"].dtype == torch.int32
    blocks = [-(-p.numel() // 256) for _, p in named]  # each moment: a code a value, padded
    assert opt.state_bytes() == sum(4 + 2 * (256 + 4) * n for n in blocks)
    fresh = topt.build_optimizer([(k, p.detach().clone().requires_grad_()) for k, p in named],
                                 learning_rate=1e-2, total_steps=10, optim="adamw8bit")
    fresh.load_state_arrays({k: v.numpy() for k, v in arrays.items()})
    assert fresh.count == 1
    for k, v in fresh.state_arrays().items():
        assert v.dtype == arrays[k].dtype and torch.equal(v, arrays[k]), k
    arrays[f"{name}/mq"] = arrays[f"{name}/mq"][:, :128]
    with pytest.raises(ValueError, match="has shape"):
        fresh.load_state_arrays(arrays)


def test_torch_trainer_resume_with_adamw8bit_matches_a_straight_run(tmp_path):
    """3 steps, then a fresh trainer resumed to 6, against 6 straight: the
    same losses, factors and 8-bit optimizer state, bit for bit."""
    data = _ragged_lengths(_data(n=2 * 2 * 4))

    def args(name, steps):
        return dataclasses.replace(_resume_args(tmp_path, name, steps, False), optim="adamw8bit")

    torch.manual_seed(9)
    Trainer(_resume_model(), args("cut", 3), train_data=data, device="cpu").train()
    torch.manual_seed(10)
    resumed = Trainer(_resume_model(), args("cut", 6), train_data=data, device="cpu")
    resumed.train(resume=True)
    torch.manual_seed(9)
    straight = Trainer(_resume_model(), args("straight", 6), train_data=data, device="cpu")
    straight.train()
    assert isinstance(straight.optimizer.opt, AdamW8bit)
    assert resumed.step == straight.step == 6
    losses = [[r["loss"] for r in t.log_history if "loss" in r] for t in (resumed, straight)]
    assert losses[0] == losses[1] and len(losses[0]) == 6
    got = dict(resumed.model.named_parameters())
    for name, p in straight.model.named_parameters():
        if p.requires_grad:
            assert torch.equal(got[name], p), name
    want_opt, got_opt = straight.optimizer.state_arrays(), resumed.optimizer.state_arrays()
    assert sorted(got_opt) == sorted(want_opt)
    for k, v in want_opt.items():
        assert got_opt[k].dtype == v.dtype and torch.equal(got_opt[k], v), k
