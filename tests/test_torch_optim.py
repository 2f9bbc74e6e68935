"""The port's optimizer (``training/optim.py``) against the JAX
``build_optimizer`` on the CPU: the schedules, the group labels, global-norm
clipping (optax's rule: scale by max_norm / norm from norm >= max_norm on)
and AdamW steps over the three groups.

Tolerances: schedules 1e-6 relative and 1e-7 of the peak rate absolute
(python floats against float32 optax, whose cosine loses relative
precision near its end);
updated parameters float32 1e-5 (utils/testing.TOLERANCES["f32_op"]).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparse_matrix_fine_tuning_torch.training import optim as topt
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu.training import optim as jopt

F32 = TOLERANCES["f32_op"]
# name -> shape; the names pick each of the three groups
PARAMS = {"layer.q_proj.blkdiag1": (4, 2, 8), "layer.q_proj.blkdiag2": (4, 8, 2),
          "layer.q_proj.scaler.scaler": (1,), "layer.norm.weight": (8,),
          "head.bias": (5,), "head.weight": (5, 8)}


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("warmup_ratio", [0.0, 0.2])
def test_torch_schedules_match_optax(kind, warmup_ratio):
    want = jopt.build_schedule(1e-3, 20, warmup_ratio, kind)
    got = topt.build_schedule(1e-3, 20, warmup_ratio, kind)
    for count in range(0, 24):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("use_scaler", [False, True])
def test_torch_group_labels_match_jax(use_scaler):
    for name in PARAMS:
        path = tuple(name.split("."))
        assert (topt.param_group_label(name, use_scaler=use_scaler)
                == jopt.param_group_label(path, use_scaler=use_scaler))


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal(shape) * scale).astype(np.float32)
            for name, shape in PARAMS.items()}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_torch_clip_by_global_norm_matches_optax(grad_scale):
    grads = _tree(1, grad_scale)
    want, _ = optax.clip_by_global_norm(1.0).update({k: jnp.array(v) for k, v in grads.items()},
                                                    optax.EmptyState())
    params = [torch.zeros(v.shape, requires_grad=True) for v in grads.values()]
    for p, g in zip(params, grads.values()):
        p.grad = to_torch(g)
    norm = topt.clip_by_global_norm_(params, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(sum((g ** 2).sum() for g in grads.values())),
                               rtol=1e-5)
    for p, name in zip(params, grads):
        np.testing.assert_allclose(to_numpy(p.grad), np.asarray(want[name]), **F32)


@pytest.mark.parametrize("kw", [
    {},
    {"large_lr": True, "weight_decay": 0.1},
    {"large_lr": True, "use_scaler": True, "weight_decay": 0.1, "lr_scheduler_type": "cosine"},
], ids=["default", "large_lr", "large_lr_scaler"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_torch_grouped_adamw_steps_match_jax(kw, grad_scale):
    """Three AdamW steps over the three groups with warmup, against optax."""
    args = dict(learning_rate=1e-2, total_steps=10, warmup_ratio=0.2, new_lr=5e-2, **kw)
    params = _tree(2)
    jparams = {k: jnp.array(v) for k, v in params.items()}
    tx = jopt.build_optimizer(jparams, **args)
    state = tx.init(jparams)
    named = [(k, to_torch(v).requires_grad_()) for k, v in params.items()]
    opt = topt.build_optimizer(named, **args)
    for step in range(3):
        grads = _tree(10 + step, grad_scale)
        updates, state = tx.update({k: jnp.array(v) for k, v in grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        for (_, p), g in zip(named, grads.values()):
            p.grad = to_torch(g)
        opt.step()
    assert opt.count == 3
    for name, p in named:
        np.testing.assert_allclose(to_numpy(p), np.asarray(jparams[name]), **F32)


def test_torch_optimizer_state_arrays_round_trip():
    named = [(k, to_torch(v).requires_grad_()) for k, v in _tree(3).items()]
    opt = topt.build_optimizer(named, learning_rate=1e-2, total_steps=10)
    for (_, p), g in zip(named, _tree(4).values()):
        p.grad = to_torch(g)
    opt.step()
    arrays = {k: v.clone() for k, v in opt.state_arrays().items()}
    assert int(arrays["count"]) == 1 and len(arrays) == 1 + 3 * len(named)
    fresh = topt.build_optimizer([(k, p.detach().clone().requires_grad_()) for k, p in named],
                                 learning_rate=1e-2, total_steps=10)
    fresh.load_state_arrays(arrays)
    assert fresh.count == 1
    for k, v in fresh.state_arrays().items():
        torch.testing.assert_close(v, arrays[k])
