"""Remat (``config.remat``) in the port on the CPU.

The tiny Llama (2 layers, hidden 64, GQA 4/2, Monarch adapters on all seven
projections, random nonzero) computes the same ``training_loss`` and every
trainable gradient bit for bit with remat "nothing" and "dots" as without
remat: with adapter dropout (the recompute replays the random state, so
the masks repeat) and with merged training on.  "dots" keeps the outputs of
the products with no batch dimension: the backward runs no ``aten.mm`` of
the forward again, where "nothing" runs all 14.  Against the JAX model
with ``remat=True`` at both policies (weights bridged by
``utils/jax_bridge.load_jax_state``): the loss and every adapter gradient
within 1e-4 (``TOLERANCES["f32_logits"]``: two layers of fp32 sums in
another order).  An unknown policy raises in both; remat is a no-op in
eval and without gradients.
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from torch.utils._python_dispatch import TorchDispatchMode

from sparse_matrix_fine_tuning_torch.models import llama
from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam

MODEL = TOLERANCES["f32_logits"]
PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj"]}
B, T = 2, 12
POLICIES = ["nothing", "dots"]


def port_model(seed: int = 0, dropout: float = 0.0, **cfg) -> LlamaForCausalLM:
    tm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu",
                          generator=torch.Generator().manual_seed(seed))
    surgery.init_monarch(tm, {**PEFT, "dropout": dropout},
                         generator=torch.Generator().manual_seed(seed + 1))
    g = torch.Generator().manual_seed(seed + 2)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if "blkdiag2" in name:
                p.normal_(0.0, 0.1, generator=g)
    surgery.trainable_filter(tm)
    return tm


def batch(seed: int = 3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 256, (B, T)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    labels = np.where(mask > 0, ids, -100).astype(np.int32)
    return ids, mask, labels


def loss_and_grads(tm, seed: int = 5):
    ids, mask, labels = (to_torch(a, torch.long) for a in batch())
    torch.manual_seed(seed)  # the dropout masks
    tm.zero_grad()
    loss = tm.training_loss(ids, labels, attention_mask=mask)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in tm.named_parameters() if p.requires_grad}
    return loss.detach(), grads


def with_remat(tm, policy: str):
    tm.config = tm.model.config = dataclasses.replace(tm.config, remat=True,
                                                      remat_policy=policy)
    return tm


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("dropout,merged", [(0.1, False), (0.0, True)],
                         ids=["dropout", "merged"])
def test_torch_remat_is_bit_for_bit_on_cpu(policy, dropout, merged):
    runs = []
    for remat in (False, True):
        tm = port_model(dropout=dropout)
        if merged:
            assert surgery.enable_merged_training(tm) == 14
        runs.append(loss_and_grads(with_remat(tm, policy) if remat else tm))
    (want, want_g), (got, got_g) = runs
    assert torch.equal(got, want)
    assert sorted(got_g) == sorted(want_g) and len(want_g) == 29  # 28 factors, the head
    for name, g in want_g.items():
        assert torch.equal(got_g[name], g), name


def test_torch_remat_dropout_masks_are_drawn():
    """The dropout case above is not vacuous: another seed, another loss."""
    a, _ = loss_and_grads(port_model(dropout=0.1), seed=5)
    b, _ = loss_and_grads(port_model(dropout=0.1), seed=6)
    assert not torch.equal(a, b)


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,recomputed", [("nothing", 14), ("dots", 0)])
def test_torch_remat_dots_keeps_the_base_products(policy, recomputed):
    """Products with no batch dimension (the seven base projections a
    layer, ``aten.mm``) run again in the backward under "nothing" and not
    under "dots"; the batched products (attention, the plain Monarch
    version's ``bmm``) run again under both."""
    counted = []
    for tm in (port_model(), with_remat(port_model(), policy)):
        with CountOps() as mode:
            loss_and_grads(tm)
        counted.append(mode.ops)
    plain, remat = counted
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert remat[mm] - plain[mm] == recomputed
    assert remat[bmm] > plain[bmm]


def test_torch_remat_only_in_training_with_gradients(monkeypatch):
    calls = []
    real = llama.checkpoint

    def spy(*args, **kwargs):
        calls.append(kwargs["context_fn"])
        return real(*args, **kwargs)

    monkeypatch.setattr(llama, "checkpoint", spy)
    tm = with_remat(port_model(), "dots")
    ids = to_torch(batch()[0], torch.long)
    tm.eval()
    tm(ids)
    tm.train()
    with torch.no_grad():
        tm(ids)
    assert calls == []
    tm(ids)
    assert len(calls) == 2 and calls[0] is not llama.noop_context_fn


def jax_pair(policy: str, seed: int = 0):
    cfg = dict(remat=True, remat_policy=policy)
    jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(**cfg), rngs=nnx.Rngs(seed))
    jpeft.init_monarch(jm, PEFT, rngs=nnx.Rngs(seed + 1))
    rng = np.random.default_rng(seed)
    for _, v in nnx.to_flat_state(nnx.state(jm, AdapterParam)):
        v.set_value(jnp.array(rng.normal(0.0, 0.1, v[...].shape).astype(np.float32)))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    surgery.init_monarch(tm, PEFT)
    load_jax_state(tm, {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
                        for path, v in nnx.to_flat_state(nnx.state(jm, nnx.Param))})
    return jm, tm


@pytest.mark.parametrize("policy", POLICIES)
def test_torch_remat_matches_jax_remat(policy):
    jm, tm = jax_pair(policy)
    ids, mask, labels = batch(seed=4)
    jids, jmask, jlabels = jnp.array(ids), jnp.array(mask), jnp.array(labels)

    def jloss(m):
        return m.training_loss(jids, jlabels, attention_mask=jmask)

    want, jgrads = nnx.value_and_grad(jloss, argnums=nnx.DiffState(0, AdapterParam))(jm)
    jgrads = {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(v[...])
              for path, v in nnx.to_flat_state(jgrads)}
    got = tm.training_loss(*(to_torch(a, torch.long) for a in (ids, labels)),
                           attention_mask=to_torch(mask, torch.long))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **MODEL)
    assert len(jgrads) == 28
    for name, g in jgrads.items():
        np.testing.assert_allclose(to_numpy(tm.get_parameter(name).grad), g, **MODEL)


def test_torch_remat_refuses_an_unknown_policy():
    ids = jnp.array(batch()[0])
    jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(remat=True, remat_policy="all"),
                                  rngs=nnx.Rngs(0))
    with pytest.raises(ValueError, match="remat_policy"):
        jm(ids)
    with pytest.raises(ValueError, match="remat_policy"):
        LlamaForCausalLM(LlamaConfig.tiny(remat=True, remat_policy="all"), device="cpu")
    # off, the policy is not read, as in JAX
    LlamaForCausalLM(LlamaConfig.tiny(remat_policy="all"), device="cpu")
