"""Layer hooks of the port's models against the JAX models' on the CPU, in
float32: a ``ReftModel`` with interventions at every Llama hook component
(block input and output, attention and MLP outputs; Loreft, Noreft and
Consreft, two of them on one site) over the tiny Monarch-adapted Llama,
with remat off, "dots" and "nothing": the loss, the gradient of every
adapter and intervention parameter (``TOLERANCES["f32_logits"]``); the
encoders' block-output and block-input sites (logits); unknown components
refused.  The JAX weights cross by ``utils/jax_bridge.load_jax_state``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.interventions import reft as treft
from sparse_matrix_fine_tuning_torch.models import deberta as tdeb
from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig, RobertaConfig
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu.interventions import reft as jreft
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam
from sparse_matrix_fine_tuning_tpu.models import deberta as jdeb
from test_torch_llama import PEFT, jax_llama
from test_torch_reft import state_of

LOGITS = TOLERANCES["f32_logits"]
REPS = [{"layer": 0, "component": "block_input", "intervention": "LoreftIntervention"},
        {"layer": 0, "component": "attention_output", "intervention": "NoreftIntervention"},
        {"layer": 1, "component": "mlp_output", "intervention": "ConsreftIntervention"},
        {"layer": 1, "component": "block_output", "intervention": "LoreftIntervention"},
        {"layer": 1, "component": "block_output", "intervention": "NoreftIntervention"}]
LOCS = np.array([[[0, 3, 5], [1, 1, 2], [4, -1, -1], [2, 6, 6], [0, 7, -1]],
                 [[2, 2, 4], [0, -1, -1], [1, 3, 5], [7, 6, 5], [3, -1, -1]]], np.int32)


def reft_pair(reps, remat=None):
    """JAX and port ReftModels over the tiny Llama, the interventions'
    values made nonzero and random, the port's bridged from the JAX one."""
    cfg = dict(remat=remat is not None, remat_policy=remat or "nothing")
    jr = jreft.get_reft_model(jax_llama(**cfg), jreft.ReftConfig(representations=reps),
                              rngs=nnx.Rngs(4))
    rng = np.random.default_rng(6)
    for _, v in nnx.to_flat_state(nnx.state(jr.interventions, nnx.Param)):
        v.set_value(v[...] + jnp.array(rng.normal(0, 0.1, v[...].shape), v[...].dtype))
    base = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    surgery.init_monarch(base, PEFT)
    tr = treft.get_reft_model(base, treft.ReftConfig(representations=reps))
    load_jax_state(tr, state_of(jr))
    return jr, tr


def lm_batch(seed=2, b=2, t=8):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 256, (b, t)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 6:] = 0
    return ids, mask, np.where(mask > 0, ids, -100).astype(np.int32)


def jax_loss_and_grads(jr, ids, mask, labels, locs):
    def f(m):
        logits = m(jnp.array(ids), attention_mask=jnp.array(mask),
                   intervention_locations=jnp.array(locs))
        return m.loss(logits, jnp.array(labels))

    loss, grads = nnx.value_and_grad(f, argnums=nnx.DiffState(0, AdapterParam))(jr)
    return float(loss), {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(v[...])
                         for path, v in nnx.to_flat_state(grads)}


@pytest.mark.parametrize("remat", [None, "dots", "nothing"])
def test_torch_llama_hooks_at_every_component_match_jax(remat):
    jr, tr = reft_pair(REPS, remat)
    ids, mask, labels = lm_batch()
    want, jgrads = jax_loss_and_grads(jr, ids, mask, labels, LOCS)
    surgery.trainable_filter(tr, ())
    tr.train()
    logits = tr(to_torch(ids, torch.long), attention_mask=to_torch(mask, torch.long),
                intervention_locations=to_torch(LOCS, torch.long))
    loss = tr.loss(logits, to_torch(labels, torch.long))
    loss.backward()
    np.testing.assert_allclose(float(loss), want, **LOGITS)
    got = {n: p.grad for n, p in tr.named_parameters() if p.requires_grad}
    assert set(got) == set(jgrads) and any(n.startswith("interventions.4") for n in got)
    for name, g in jgrads.items():
        np.testing.assert_allclose(to_numpy(got[name]), g, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(g).max())))


def test_torch_llama_remat_with_hooks_gives_the_gradients_of_no_remat():
    """The hooks run inside the checkpointed layer: "dots" and "nothing"
    give the gradients that no remat gives, bit for bit."""
    ids, mask, labels = lm_batch(5)
    grads = {}
    for remat in (None, "dots", "nothing"):
        _, tr = reft_pair(REPS, remat)
        surgery.trainable_filter(tr, ())
        tr.train()
        logits = tr(to_torch(ids, torch.long), attention_mask=to_torch(mask, torch.long),
                    intervention_locations=to_torch(LOCS, torch.long))
        tr.loss(logits, to_torch(labels, torch.long)).backward()
        grads[remat] = {n: p.grad.clone() for n, p in tr.named_parameters() if p.requires_grad}
    for remat in ("dots", "nothing"):
        for name, g in grads[None].items():
            assert torch.equal(grads[remat][name], g), (remat, name)


def test_torch_llama_refuses_unknown_hook_components():
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(ValueError, match="hook component"):
        model(torch.ones(1, 4, dtype=torch.long), layer_hooks={(0, "mlp_input"): lambda h: h})


def encoder_pair(family, reps, seed=0):
    if family == "roberta":
        jm = jmodels.RobertaForSequenceClassification(jmodels.RobertaConfig.tiny(),
                                                      rngs=nnx.Rngs(seed))
        tm = RobertaForSequenceClassification(RobertaConfig.tiny(), device="cpu")
    else:
        jm = jdeb.DebertaV2ForSequenceClassification(jdeb.DebertaV2Config.tiny(),
                                                     rngs=nnx.Rngs(seed))
        tm = tdeb.DebertaV2ForSequenceClassification(tdeb.DebertaV2Config.tiny(),
                                                     device="cpu")
    jr = jreft.get_reft_model(jm, jreft.ReftConfig(representations=reps), rngs=nnx.Rngs(1))
    tr = treft.get_reft_model(tm, treft.ReftConfig(representations=reps))
    load_jax_state(tr, state_of(jr))
    jr.eval()
    return jr, tr.eval()


def check_encoder_hooks(family):
    """The encoder's hidden states under a ReftModel's hooks: block outputs
    on both packages; block inputs of layer 1 on the port against the JAX
    model's block output of layer 0 (the same tensor: the JAX DeBERTa takes
    block outputs alone)."""
    out_reps = [{"layer": 0, "intervention": "LoreftIntervention"},
                {"layer": 1, "intervention": "MoReIntervention"}]
    in_reps = [{"layer": 1, "component": "block_input", "intervention": "LoreftIntervention"},
               {"layer": 1, "intervention": "MoReIntervention"}]
    jr, tr = encoder_pair(family, out_reps)
    _, tr_in = encoder_pair(family, in_reps)
    rng = np.random.default_rng(4)
    ids = rng.integers(3, 100, (3, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[2, 5:] = 0
    locs = np.array([[[0, 2]], [[1, 1]], [[4, -1]]], np.int32).repeat(2, axis=1)
    jenc, tenc, tenc_in = (getattr(m.model, family) for m in (jr, tr, tr_in))
    want = np.asarray(jenc(jnp.array(ids), jnp.array(mask),
                           layer_hooks=jr._hooks(jnp.array(locs))))
    with torch.no_grad():
        args = (to_torch(ids, torch.long), to_torch(mask, torch.long))
        locs_t = to_torch(locs, torch.long)
        got = tenc(*args, layer_hooks=tr._hooks(locs_t))
        got_in = tenc_in(*args, layer_hooks=tr_in._hooks(locs_t))
    np.testing.assert_allclose(to_numpy(got), want, **LOGITS)
    np.testing.assert_allclose(to_numpy(got_in), want, **LOGITS)
    assert np.abs(want - np.asarray(jenc(jnp.array(ids), jnp.array(mask)))).max() > 1e-3


@pytest.mark.parametrize("family", ["roberta", "deberta"])
def test_torch_encoder_refuses_unknown_hook_components(family):
    _, tr = encoder_pair(family, [])
    with pytest.raises(ValueError, match="hook component"):
        tr.model(torch.ones(1, 4, dtype=torch.long),
                 layer_hooks={(0, "attention_output"): lambda h: h})
