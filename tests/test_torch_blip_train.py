"""Monarch adapters and ReFT interventions on the port's BLIP, held against
the JAX package on the CPU in float32.

``peft/surgery.init_monarch`` with the BLIP target list (every linear of
the vision tower, the text encoder and the text decoder; the LM head's
``transform_dense`` and ``decoder`` stay as they are) adapts the same
linears in both packages; the adapted VQA and ITM outputs agree within
``TOLERANCES["f32_logits"]``, and after a cross entropy of the decoder
logits against answer tokens every adapter gradient agrees within
``TOLERANCES["f32_op"]`` of the gradient's norm (``test_torch_blip_reft.py``
puts ReFT interventions on these models).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear
from sparse_matrix_fine_tuning_torch.models import blip as port_blip
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import _port_name, load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam
from sparse_matrix_fine_tuning_tpu.models import blip as jax_blip
from test_torch_blip import batch, close, randomize
from test_torch_reft import state_of

OP = TOLERANCES["f32_op"]
TARGETS = ["qkv", "projection", "fc1", "fc2", "query", "key", "value", "dense",
           "intermediate", "output"]
PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True, "dropout": 0.0,
        "target_modules": TARGETS}


def adapted_pair(kind: str, seed: int = 0):
    """(JAX, port) models of ``kind`` with Monarch adapters on ``TARGETS``,
    the JAX factors random and nonzero, the port's bridged."""
    jcls, tcls = {"qa": (jax_blip.BlipForQuestionAnswering, port_blip.BlipForQuestionAnswering),
                  "itm": (jax_blip.BlipForImageTextRetrieval,
                          port_blip.BlipForImageTextRetrieval)}[kind]
    jm = jcls(jax_blip.BlipModelConfig.tiny(), rngs=nnx.Rngs(seed))
    jadapted = jpeft.init_monarch(jm, PEFT, rngs=nnx.Rngs(seed + 1))
    randomize(jm, seed + 2)
    rng = np.random.default_rng(seed + 3)
    for _, v in nnx.to_flat_state(nnx.state(jm, AdapterParam)):
        v.set_value(jnp.array(rng.normal(0.0, 0.1, v[...].shape).astype(np.float32)))
    tm = tcls(port_blip.BlipModelConfig.tiny(), device="cpu")
    adapted = surgery.init_monarch(tm, PEFT)
    assert [a[0] for a in adapted] == [a[0] for a in jadapted]
    load_jax_state(tm, state_of(jm, nnx.Param))
    return jm, tm, adapted


def answers(b: int, seed: int = 9) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, 99, b).astype(np.int32)


def check_grads(grads, model, prefix=()) -> set:
    """Every JAX gradient against the port parameter of its name, within
    ``f32_op`` of the gradient's norm; returns the names."""
    params = dict(model.named_parameters())
    seen = set()
    for path, g in nnx.to_flat_state(grads):
        name, transpose = _port_name(tuple(prefix) + tuple(getattr(p, "key", p) for p in path))
        want = np.asarray(g[...], np.float32)
        want = want.T if transpose else want
        np.testing.assert_allclose(to_numpy(params[name].grad), want, rtol=0,
                                   atol=OP["atol"] * max(float(np.linalg.norm(want)), 1e-3),
                                   err_msg=name)
        seen.add(name)
    return seen


def test_torch_blip_monarch_adapters_match_jax():
    """48 adapted linears at the tiny size (8 vision, 20 encoder, 20
    decoder; 288 at BLIP-base), the head untouched; the VQA outputs and
    every adapter gradient of the answer loss."""
    jm, tm, adapted = adapted_pair("qa")
    assert len(adapted) == 2 * 4 + 2 * 2 * 10
    assert not isinstance(tm.lm_head.transform_dense, MonarchLinear)
    assert not isinstance(tm.lm_head.decoder, MonarchLinear)
    ids, mask, pixels = batch(seed=11)
    labels = answers(len(ids))

    def jax_loss(m):
        out = jax_blip.BlipWrapper(m)(jnp.array(ids), jnp.array(pixels),
                                      attention_mask=jnp.array(mask))
        logp = jax.nn.log_softmax(out["decoder_logits"][:, 0], axis=-1)
        return -jnp.take_along_axis(logp, jnp.array(labels)[:, None], 1).mean(), out

    (jloss, jout), grads = nnx.jit(nnx.value_and_grad(
        jax_loss, argnums=nnx.DiffState(0, AdapterParam), has_aux=True))(jm)
    names = surgery.trainable_filter(tm, ())
    tout = port_blip.BlipWrapper(tm)(to_torch(ids, torch.long), to_torch(pixels),
                                     attention_mask=to_torch(mask, torch.long))
    loss = F.cross_entropy(tout["decoder_logits"][:, 0], to_torch(labels, torch.long))
    loss.backward()
    close(tout["decoder_logits"].detach(), jout["decoder_logits"], "decoder_logits")
    close(loss.detach(), jloss, "loss")
    assert check_grads(grads, tm) == set(names)
    assert len(names) == 2 * 48  # blkdiag1, blkdiag2 of each adapter


@pytest.mark.parametrize("itm", [True, False], ids=["itm_head", "contrastive"])
def test_torch_blip_itm_adapters_match_jax(itm):
    jm, tm, adapted = adapted_pair("itm", seed=3)
    assert len(adapted) == 2 * 4 + 2 * 10
    ids, mask, pixels = batch(seed=12)
    want = jax_blip.BlipITMWrapper(jm, itm)(jnp.array(ids), jnp.array(pixels),
                                            attention_mask=jnp.array(mask))
    with torch.no_grad():
        got = port_blip.BlipITMWrapper(tm, itm)(to_torch(ids, torch.long), to_torch(pixels),
                                                attention_mask=to_torch(mask, torch.long))
    close(got["itm_score"], want["itm_score"], "itm_score")
