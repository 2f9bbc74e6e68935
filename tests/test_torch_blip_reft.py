"""ReFT interventions on the port's BLIP, held against the JAX package on
the CPU in float32: a ``ReftModel`` over the VQA wrapper (``test_torch_blip.py``'s
models; ``test_torch_blip_train.py`` holds the adapters), with LoReFT at a text-encoder block
output and at a cross-attention output and ``pixel_values`` through its
keywords, collects the same activations (``TOLERANCES["f32_logits"]``) and
gives the same answer loss and intervention gradients (``f32_op`` of each
gradient's norm); over the ITM wrapper the cross-attention site fires with
the ITM head only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F
from flax import nnx

from sparse_matrix_fine_tuning_torch.interventions import reft as treft
from sparse_matrix_fine_tuning_torch.models import blip as port_blip
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import to_torch
from sparse_matrix_fine_tuning_tpu.interventions import reft as jreft
from sparse_matrix_fine_tuning_tpu.models import blip as jax_blip
from test_torch_blip import batch, close, pair
from test_torch_blip_train import answers, check_grads
from test_torch_reft import state_of

LOREFT = [{"layer": 1, "component": "block_output", "intervention": "LoreftIntervention",
           "low_rank_dimension": 2},
          {"layer": 0, "component": "cross_attention_output",
           "intervention": "LoreftIntervention", "low_rank_dimension": 2}]


def reft_pair(seed: int = 0):
    """JAX and port ReftModels with ``LOREFT`` over the VQA wrapper, the
    interventions random and nonzero, the port's bridged."""
    jm, tm = pair("qa", seed)
    jr = jreft.ReftModel(jax_blip.BlipWrapper(jm), jreft.ReftConfig(representations=LOREFT),
                         rngs=nnx.Rngs(seed + 5))
    rng = np.random.default_rng(seed + 6)
    for _, v in nnx.to_flat_state(nnx.state(jr.interventions, nnx.Param)):
        v.set_value(v[...] + jnp.array(rng.normal(0, 0.1, v[...].shape), v[...].dtype))
    tr = treft.ReftModel(port_blip.BlipWrapper(tm), treft.ReftConfig(representations=LOREFT))
    load_jax_state(tr, state_of(jr, nnx.Param))
    return jr, tr


def test_torch_blip_reft_collects_and_trains_like_jax():
    """``collect_activations`` at both sites, then the intervened forward,
    its answer loss and the gradients of every intervention parameter (the
    model frozen)."""
    jr, tr = reft_pair()
    ids, mask, pixels = batch(seed=13)
    locs = np.array([[[0, 2], [1, 3]], [[1, 4], [0, 2]], [[2, 1], [2, 2]]], np.int32)
    labels = answers(len(ids), seed=14)
    jargs = dict(attention_mask=jnp.array(mask), pixel_values=jnp.array(pixels))
    targs = dict(attention_mask=to_torch(mask, torch.long), pixel_values=to_torch(pixels))
    want = jr.collect_activations(jnp.array(ids), jnp.array(locs), **jargs)
    with torch.no_grad():
        got = tr.collect_activations(to_torch(ids, torch.long), to_torch(locs, torch.long),
                                     **targs)
    assert sorted(got) == sorted(want) == [0, 1]
    for i in got:
        assert got[i].shape == (3, 2, 32)
        close(got[i], want[i], f"collected {i}")

    def jax_loss(m):
        out = m(jnp.array(ids), intervention_locations=jnp.array(locs), **jargs)
        logp = jax.nn.log_softmax(out["decoder_logits"][:, 0], axis=-1)
        return -jnp.take_along_axis(logp, jnp.array(labels)[:, None], 1).mean()

    jloss, grads = nnx.value_and_grad(
        jax_loss, argnums=nnx.DiffState(0, nnx.All(nnx.Param, nnx.PathContains(
            "interventions"))))(jr)
    names = surgery.trainable_filter(tr.interventions, ())
    out = tr(to_torch(ids, torch.long), intervention_locations=to_torch(locs, torch.long),
             **targs)
    loss = F.cross_entropy(out["decoder_logits"][:, 0], to_torch(labels, torch.long))
    loss.backward()
    close(loss.detach(), jloss, "loss")
    seen = check_grads(grads, tr)
    assert seen == {f"interventions.{n}" for n in names} and len(seen) == 2 * 3


def test_torch_blip_reft_over_the_itm_wrapper():
    """The ITM wrapper under a ``ReftModel``: a block-output site collects
    in both modes; the cross-attention site fires with the ITM head only."""
    _, tm = pair("itm", seed=5)
    ids, mask, pixels = batch(seed=15)
    locs = torch.zeros(3, 2, 1, dtype=torch.long)
    kw = dict(attention_mask=to_torch(mask, torch.long), pixel_values=to_torch(pixels))
    for itm, sites in ((True, [0, 1]), (False, [0])):
        tr = treft.ReftModel(port_blip.BlipITMWrapper(tm, itm),
                             treft.ReftConfig(representations=LOREFT))
        with torch.no_grad():
            got = tr.collect_activations(to_torch(ids, torch.long), locs, **kw)
        assert sorted(got) == sites
