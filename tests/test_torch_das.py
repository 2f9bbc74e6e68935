"""DAS on the port against the JAX package on the CPU, in float32: the
numpy ``CausalModel`` bit for bit (datasets, live paths, samplers, the
structure); the toy MLP and GRU (logits and every gradient, weights
bridged, ``TOLERANCES["f32_logits"]``); a ``train_das`` run of a
low-rank rotated-space intervention over a bridged MLP (each step's loss
within 1e-4 relative, torch's Adam against ``optax.adam``) and its
``interchange_accuracy`` equal; then ``scripts/das_demo.py``'s port, cut
short."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch import interventions as tiv
from sparse_matrix_fine_tuning_torch.models import toy as ttoy
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import _port_name, load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import interventions as jiv
from sparse_matrix_fine_tuning_tpu.models import toy as jtoy
from test_torch_reft import state_of

LOGITS = TOLERANCES["f32_logits"]


def causal_model(package, seed=0):
    vals = [0, 1, 2]
    return package.CausalModel(
        variables=["X", "Y", "Z", "W", "P", "Q", "O"],
        values={"X": vals, "Y": vals, "Z": vals, "W": vals,
                "P": [0, 1, 2, 3, 4], "Q": [0, 1, 2, 3, 4], "O": [0, 1]},
        parents={"X": [], "Y": [], "Z": [], "W": [],
                 "P": ["X", "Y"], "Q": ["Z", "W"], "O": ["P", "Q"]},
        functions={"X": lambda: 0, "Y": lambda: 0, "Z": lambda: 0, "W": lambda: 0,
                   "P": lambda x, y: x + y, "Q": lambda z, w: z + w,
                   "O": lambda p, q: int(p >= q)},
        seed=seed)


def counterfactual(cm, n=64):
    return cm.generate_counterfactual_dataset(
        n, intervention_id=lambda iv: 0, batch_size=8,
        intervention_sampler=lambda: {"P": cm._rng.choice(cm.values["P"])})


def test_torch_causal_model_matches_jax_bit_for_bit():
    t, j = causal_model(tiv), causal_model(jiv)
    assert t.format_structure() == j.format_structure()
    assert (t.variables, t.inputs, t.outputs, t.timesteps, t.equiv_classes) == \
        (j.variables, j.inputs, j.outputs, j.timesteps, j.equiv_classes)
    setting = {"X": 1, "Y": 2, "Z": 0, "W": 2}
    assert t.find_live_paths(setting) == j.find_live_paths(setting)
    for got, want in ((t.generate_factual_dataset(40), j.generate_factual_dataset(40)),
                      (counterfactual(t), counterfactual(j)),
                      (t.generate_counterfactual_dataset(24, lambda iv: len(iv)),
                       j.generate_counterfactual_dataset(24, lambda iv: len(iv)))):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    filt = (t.get_path_maxlen_filter([3]), j.get_path_maxlen_filter([3]))
    assert t.generate_factual_dataset(10, filter=filt[0], return_arrays=False) == \
        j.generate_factual_dataset(10, filter=filt[1], return_arrays=False)
    assert [t.sample_input_tree_balanced() for _ in range(20)] == \
        [j.sample_input_tree_balanced() for _ in range(20)]
    assert [t.sample_intervention() for _ in range(20)] == \
        [j.sample_intervention() for _ in range(20)]


@pytest.mark.parametrize("cls,cfg", [
    ("MLPModel", dict(max_positions=4)),
    ("MLPModel", dict(vocab_size=12, num_classes=1, squeeze_output=True)),
    ("GRUModel", dict(input_dim=2)),
    ("GRUModel", dict(vocab_size=12)),
], ids=["mlp-features", "mlp-tokens-squeezed", "gru-features", "gru-tokens"])
def test_torch_toy_models_match_jax(cls, cfg):
    jm = getattr(jtoy, cls)(jtoy.ToyConfig(**cfg), rngs=nnx.Rngs(1))
    tm = getattr(ttoy, cls)(ttoy.ToyConfig(**cfg), device="cpu")
    load_jax_state(tm, state_of(jm))
    rng = np.random.default_rng(2)
    if cfg.get("vocab_size"):
        x = rng.integers(0, 12, (5, 4)).astype(np.int32)
    else:
        x = rng.standard_normal((5, 4, cfg.get("input_dim", 1))).astype(np.float32)
    mask = np.ones((5, 4), np.int32)
    mask[1, 3:] = mask[4, 2:] = 0
    hook = (1, "block_output")
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)

    def f(params):
        out = nnx.merge(graphdef, params, rest)(jnp.array(x), attention_mask=jnp.array(mask),
                                                 layer_hooks={hook: lambda h: h * 0.5})
        return jnp.sum(out ** 2), out

    (_, want), grads = jax.value_and_grad(f, has_aux=True)(params)
    got = tm(to_torch(x), attention_mask=to_torch(mask), layer_hooks={hook: lambda h: h * 0.5})
    (got ** 2).sum().backward()
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **LOGITS)
    for path, g in nnx.to_flat_state(grads):
        name, transpose = _port_name(tuple(getattr(p, "key", p) for p in path))
        grad = to_numpy(tm.get_parameter(name).grad)
        np.testing.assert_allclose(grad.T if transpose else grad, np.asarray(g[...]), **LOGITS)


def test_torch_das_training_matches_jax():
    reps = [{"layer": 1, "intervention": "LowRankRotatedSpaceIntervention",
             "low_rank_dimension": 4}]
    cfg = dict(hidden_size=32, num_hidden_layers=3, num_classes=2, max_positions=4)
    jr = jiv.get_reft_model(jtoy.MLPModel(jtoy.ToyConfig(**cfg), rngs=nnx.Rngs(0)),
                            jiv.ReftConfig(representations=reps), rngs=nnx.Rngs(7))
    tr = tiv.get_reft_model(ttoy.MLPModel(ttoy.ToyConfig(**cfg), device="cpu"),
                            tiv.ReftConfig(representations=reps))
    load_jax_state(tr, state_of(jr))
    cds = counterfactual(causal_model(jiv), 64)
    base, source = cds["input_ids"], cds["source_input_ids"][:, 0]
    labels = cds["labels"][:, 0].astype(np.int32)
    locs = np.broadcast_to(np.array([0, 1], np.int32), (len(base), 1, 2))
    jkw = dict(base_locations=jnp.array(locs), source_locations=jnp.array(locs))
    tkw = dict(base_locations=to_torch(locs, torch.long), source_locations=to_torch(locs,
                                                                                    torch.long))
    jargs = (jnp.array(base), jnp.array(source), jnp.array(labels))
    targs = (to_torch(base), to_torch(source), to_torch(labels, torch.long))
    want = jiv.train_das(jr, *jargs, steps=15, learning_rate=1e-2, **jkw)
    got = tiv.train_das(tr, *targs, steps=15, learning_rate=1e-2, **tkw)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert got[-1] < got[0]
    assert tiv.interchange_accuracy(tr, *targs, **tkw) == \
        jiv.interchange_accuracy(jr, *jargs, **jkw)
    frozen = [p for n, p in tr.named_parameters() if not n.startswith("interventions.")]
    assert frozen and not any(p.requires_grad for p in frozen)


def test_torch_das_demo_runs():
    from sparse_matrix_fine_tuning_torch.scripts import das_demo

    out = das_demo.main(["--platform", "cpu"], train_steps=60, das_steps=20)
    assert out["base_accuracy"] > 0.8 and len(out["losses"]) == 20
    assert out["losses"][-1] < out["losses"][0]
