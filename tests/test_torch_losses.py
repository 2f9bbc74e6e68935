"""The port's causal-LM losses against the JAX package on the CPU: the
chunked CE (``ops/losses.py``) against the full-logits CE and against the
JAX chunked CE, with ``ignore_index`` and row weights, values and
gradients; and the Llama ``loss``/``training_loss`` with their adapter
gradients against ``nnx.grad`` of the JAX model.

Tolerances: float32, 1e-5 for the losses of one op (the frameworks sum in
another order); 1e-4 for a tiny model's loss and gradients
(utils/testing.TOLERANCES["f32_logits"]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.ops.losses import chunked_causal_lm_loss
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam
from sparse_matrix_fine_tuning_tpu.ops.losses import chunked_causal_lm_loss as jax_chunked

F32 = TOLERANCES["f32_op"]
MODEL = TOLERANCES["f32_logits"]
PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj"]}


def _batch(seed=0, b=3, t=9, h=16, v=40):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((b, t, h)).astype(np.float32)
    head = (rng.standard_normal((v, h)) / 4).astype(np.float32)
    labels = rng.integers(0, v, (b, t)).astype(np.int64)
    labels[0, 2:5] = -100
    labels[2, :] = -100
    weights = np.array([1, 0, 1], np.int32)
    return hidden, head, labels, weights


def _full_ce(hidden, w, labels, weights=None, ignore_index=-100):
    logits = (hidden @ w.T)[:, :-1].float()
    sl = labels[:, 1:]
    mask = sl != ignore_index
    if weights is not None:
        mask = mask & (weights[:, None] != 0)
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, torch.where(mask, sl, 0)[..., None]).squeeze(-1)
    return (nll * mask).sum() / mask.sum().clamp_min(1)


@pytest.mark.parametrize("chunk", [1, 5, 7, 24, 1024])
@pytest.mark.parametrize("weighted", [False, True])
def test_torch_chunked_ce_matches_full_logits(chunk, weighted):
    hidden, head, labels, weights = _batch()
    th = to_torch(hidden).requires_grad_()
    tw = to_torch(head).requires_grad_()
    tl, tweights = to_torch(labels), (to_torch(weights) if weighted else None)
    got = chunked_causal_lm_loss(th, lambda x: x @ tw.T, tl, weights=tweights, chunk_size=chunk)
    gg = torch.autograd.grad(got, (th, tw))
    want = _full_ce(th, tw, tl, tweights)
    gw = torch.autograd.grad(want, (th, tw))
    np.testing.assert_allclose(float(got), float(want), **F32)
    for a, b in zip(gg, gw):
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), **F32)


@pytest.mark.parametrize("chunk", [4, 1024])
def test_torch_chunked_ce_matches_jax(chunk):
    hidden, head, labels, weights = _batch(seed=1)

    def jloss(h, w):
        return jax_chunked(h, lambda x: x @ w.T, jnp.array(labels), weights=jnp.array(weights),
                           chunk_size=chunk)

    want = jloss(jnp.array(hidden), jnp.array(head))
    wgrads = jax.grad(jloss, argnums=(0, 1))(jnp.array(hidden), jnp.array(head))
    th, tw = to_torch(hidden).requires_grad_(), to_torch(head).requires_grad_()
    got = chunked_causal_lm_loss(th, lambda x: x @ tw.T, to_torch(labels),
                                 weights=to_torch(weights), chunk_size=chunk)
    np.testing.assert_allclose(float(got), float(want), **F32)
    for a, b in zip(torch.autograd.grad(got, (th, tw)), wgrads):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), **F32)


def test_torch_chunked_ce_all_masked_is_zero():
    hidden, head, labels, _ = _batch(seed=2)
    labels[:] = -100
    got = chunked_causal_lm_loss(to_torch(hidden), lambda x: x @ to_torch(head).T,
                                 to_torch(labels), chunk_size=4)
    assert float(got) == 0.0


@pytest.fixture(scope="module")
def pair():
    jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(), rngs=nnx.Rngs(0))
    jpeft.init_monarch(jm, PEFT, rngs=nnx.Rngs(1))
    rng = np.random.default_rng(3)
    for _, v in nnx.to_flat_state(nnx.state(jm, AdapterParam)):
        v.set_value(jnp.array(rng.normal(0.0, 0.1, v[...].shape).astype(np.float32)))
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    surgery.init_monarch(tm, PEFT)
    load_jax_state(tm, {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
                        for path, v in nnx.to_flat_state(nnx.state(jm, nnx.Param))})
    return jm, tm


def _lm_batch(seed=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 256, (3, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    labels = np.where(mask > 0, ids, -100).astype(np.int32)
    weights = np.array([1, 1, 0], np.int32)
    return ids, mask, labels, weights


@pytest.mark.parametrize("chunk", [0, 8])
def test_torch_llama_training_loss_matches_jax(pair, chunk):
    """training_loss (full logits for chunk 0, chunked otherwise) and its
    adapter gradients against the JAX model's."""
    jm, tm = pair
    ids, mask, labels, weights = _lm_batch()
    jm.config = jmodels.LlamaConfig.tiny(loss_chunk=chunk)
    tm.config = LlamaConfig.tiny(loss_chunk=chunk)

    def jloss(m):
        return m.training_loss(jnp.array(ids), jnp.array(labels),
                               attention_mask=jnp.array(mask), weights=jnp.array(weights))

    want, jgrads = nnx.value_and_grad(jloss, argnums=nnx.DiffState(0, AdapterParam))(jm)
    jgrads = {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(v[...])
              for path, v in nnx.to_flat_state(jgrads)}
    tm.zero_grad()
    got = tm.training_loss(to_torch(ids, torch.long), to_torch(labels, torch.long),
                           attention_mask=to_torch(mask, torch.long),
                           weights=to_torch(weights))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), **MODEL)
    assert len(jgrads) == 28
    for name, g in jgrads.items():
        np.testing.assert_allclose(to_numpy(tm.get_parameter(name).grad), g, **MODEL)


def test_torch_llama_loss_matches_jax(pair):
    jm, tm = pair
    ids, mask, labels, weights = _lm_batch(seed=5)
    logits = np.random.default_rng(5).standard_normal((3, 10, 256)).astype(np.float32)
    want = jm.loss(jnp.array(logits), jnp.array(labels), weights=jnp.array(weights))
    got = tm.loss(to_torch(logits), to_torch(labels, torch.long), weights=to_torch(weights))
    np.testing.assert_allclose(float(got), float(want), **F32)


@pytest.mark.parametrize("kw", [{"layer_hooks": {0: lambda hidden: hidden * 1.25,
                                                 (1, "mlp_output"): lambda h: h - 0.1}},
                                {"layer_hooks": {}}])
def test_torch_training_loss_refuses_unported_options(pair, kw):
    """``training_loss`` with layer hooks (a block output and an MLP
    output), and with none, against the JAX model's; packing's
    ``segment_ids`` are in tests/test_torch_packing.py."""
    jm, tm = pair
    ids, mask, labels, _ = _lm_batch()
    want = jm.training_loss(jnp.array(ids), jnp.array(labels), attention_mask=jnp.array(mask),
                            **kw)
    got = tm.training_loss(to_torch(ids, torch.long), to_torch(labels, torch.long),
                           attention_mask=to_torch(mask, torch.long), **kw)
    np.testing.assert_allclose(float(got), float(want), **MODEL)
    if kw["layer_hooks"]:
        assert abs(float(want) - float(jm.training_loss(
            jnp.array(ids), jnp.array(labels), attention_mask=jnp.array(mask)))) > 1e-3