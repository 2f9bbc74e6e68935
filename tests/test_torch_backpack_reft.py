"""Backpack's ``sense_network_output`` ReFT site in the port's ``ReftModel``
against the JAX package's on the CPU: JAX's three sense-site cases
(tests/interventions/test_backpack_sense_site.py:38, :63, :74) on a
``ReftModel`` pair over the tiny Backpack (``test_torch_gpt2.family_pair``),
the port's bridged from the JAX one: the interchange equals a hand-made
splice of the source's senses (all senses, the intervened positions) and
matches JAX, identical sources are a no-op; the collected (b, nv, p, d)
activations; a trainable Loreft's loss and gradients, nonzero.  Float32,
JAX within ``TOLERANCES["f32_logits"]``, the port's own identities within
``TOLERANCES["f32_op"]``."""

import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.interventions import reft as treft
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu.interventions import reft as jreft
from test_torch_gpt2 import family_pair
from test_torch_reft import state_of

LOGITS = TOLERANCES["f32_logits"]
POS = (3, 7)


def reft_pair(intervention: str, **kw):
    jm, tm = family_pair("backpack", seed=7)
    reps = [{"layer": 0, "component": "sense_network_output", "intervention": intervention,
             **kw}]
    jr = jreft.ReftModel(jm, jreft.ReftConfig(representations=reps), rngs=nnx.Rngs(1))
    rng = np.random.default_rng(8)
    for _, v in nnx.to_flat_state(nnx.state(jr.interventions, nnx.Param)):
        v.set_value(v[...] + jnp.array(rng.normal(0, 0.1, v[...].shape), v[...].dtype))
    tr = treft.ReftModel(tm, treft.ReftConfig(representations=reps))
    load_jax_state(tr, state_of(jr))
    return jr, tr


def sense_batch():
    rng = np.random.default_rng(2)
    base = rng.integers(3, 256, (2, 10)).astype(np.int32)
    src = rng.integers(3, 256, (2, 10)).astype(np.int32)
    locs = np.broadcast_to(np.array(POS, np.int32)[None, None], (2, 1, 2)).copy()
    return base, src, locs


def test_torch_backpack_sense_interchange_matches_jax():
    jr, tr = reft_pair("VanillaIntervention")
    base, src, locs = sense_batch()
    want = np.asarray(jr.swap_forward(jnp.array(base), jnp.array(src),
                                      base_locations=jnp.array(locs),
                                      source_locations=jnp.array(locs)))
    tb, ts, tl = (to_torch(a, torch.long) for a in (base, src, locs))
    with torch.no_grad():
        got = to_numpy(tr.swap_forward(tb, ts, base_locations=tl, source_locations=tl))
        src_senses = tr.model.backpack.senses(ts)

        def splice(s):
            s = s.clone()
            s[:, :, list(POS)] = src_senses[:, :, list(POS)]
            return s

        manual = to_numpy(tr.model(tb, layer_hooks={"sense_network_output": splice}))
        same = to_numpy(tr.swap_forward(tb, tb, base_locations=tl, source_locations=tl))
        plain = to_numpy(tr.model(tb))
    np.testing.assert_allclose(got, want, **LOGITS)
    np.testing.assert_allclose(got, manual, **TOLERANCES["f32_op"])
    np.testing.assert_allclose(same, plain, **TOLERANCES["f32_op"])
    assert np.abs(got - plain).max() > 1e-3


def test_torch_backpack_sense_collect_matches_jax():
    jr, tr = reft_pair("VanillaIntervention")
    base, _, locs = sense_batch()
    want = np.asarray(jr.collect_activations(jnp.array(base), jnp.array(locs))[0])
    with torch.no_grad():
        got = tr.collect_activations(to_torch(base, torch.long), to_torch(locs, torch.long))[0]
        senses = to_numpy(tr.model.backpack.senses(to_torch(base, torch.long)))
    assert tuple(got.shape) == (2, 4, 2, 64)
    np.testing.assert_allclose(to_numpy(got), want, **LOGITS)
    np.testing.assert_array_equal(to_numpy(got), senses[:, :, list(POS)])


def test_torch_backpack_sense_loreft_grads_match_jax():
    jr, tr = reft_pair("LoreftIntervention", low_rank_dimension=2)
    ids, _, locs = sense_batch()

    def jloss(m):
        return m.loss(m(jnp.array(ids), intervention_locations=jnp.array(locs)), jnp.array(ids))

    want, grads = nnx.value_and_grad(jloss, argnums=nnx.DiffState(0, nnx.Param))(jr)
    jgrads = {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(v[...])
              for path, v in nnx.to_flat_state(grads) if "interventions" in str(path[0])}
    tids, tlocs = to_torch(ids, torch.long), to_torch(locs, torch.long)
    got = tr.loss(tr(tids, intervention_locations=tlocs), tids)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LOGITS)
    assert jgrads and any(np.abs(g).max() > 0 for g in jgrads.values())
    for name, g in jgrads.items():
        np.testing.assert_allclose(to_numpy(tr.get_parameter(name).grad), g, err_msg=name,
                                   **LOGITS)
