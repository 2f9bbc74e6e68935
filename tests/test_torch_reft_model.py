"""The port's ``ReftModel`` against the JAX package's on the CPU, in
float32, over the tiny Monarch-adapted Llama (``test_torch_llama.py``'s):
two ``Trainer`` steps of a ReFT model (gradient accumulation 2, length
grouping trimming the rows, untied interventions with -1 pads): the logged losses and the
trained interventions within ``TOLERANCES["f32_logits"]``; the trainable
sets with and without the classifier (MoReFT GLUE); SkipIntervention's
capture order and its refusal under remat; ``collect_activations`` and
``swap_forward`` with subspaces; the ``interventions.npz`` files crossing
between the packages both ways; the bridge's names for a ``ReftModel``
and the toy models."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.interventions import reft as treft
from sparse_matrix_fine_tuning_torch.models import toy as ttoy
from sparse_matrix_fine_tuning_torch.models.config import RobertaConfig
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.training.trainer import Trainer, TrainingArgs
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import _port_name, load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu.interventions import reft as jreft
from sparse_matrix_fine_tuning_tpu.models import toy as jtoy
from sparse_matrix_fine_tuning_tpu.peft import trainable_filter as jax_trainable_filter
from sparse_matrix_fine_tuning_tpu.training import Trainer as JaxTrainer
from sparse_matrix_fine_tuning_tpu.training import TrainingArgs as JaxTrainingArgs
from test_torch_llama_hooks import lm_batch, reft_pair
from test_torch_reft import state_of

LOGITS = TOLERANCES["f32_logits"]
TRAIN_REPS = [{"layer": layer, "intervention": kind, "low_rank_dimension": 4}
              for kind in ("LoreftIntervention", "NoreftIntervention") for layer in (0, 1)]


def reft_batch(n=8, t=12, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 256, (n, t)).astype(np.int32)
    lens = rng.integers(5, 9, n)  # every batch trimmed from 12 to 8 columns: one shape
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.int32)
    locs = np.stack([np.stack([np.array([0, 1]), np.array([L - 1, L - 2])] * 2)
                     for L in lens]).astype(np.int32)
    locs[0, :, 1] = -1
    return {"input_ids": ids * mask, "attention_mask": mask,
            "labels": np.where(mask > 0, ids, -100).astype(np.int32),
            "intervention_locations": locs}


def test_torch_reft_trainer_steps_match_jax(tmp_path):
    jr, tr = reft_pair(TRAIN_REPS)
    data = reft_batch()
    kw = dict(learning_rate=1e-2, max_steps=2, per_device_train_batch_size=2,
              gradient_accumulation_steps=2, logging_steps=1, log_param_steps=0,
              group_by_length=True, length_bucket=4, warmup_ratio=0.0)

    def jloss(m, batch, train):
        return m.loss(m(batch["input_ids"], attention_mask=batch["attention_mask"],
                        intervention_locations=batch["intervention_locations"]),
                      batch["labels"], weights=batch.get("_valid"))

    jt = JaxTrainer(jr, JaxTrainingArgs(output_dir=str(tmp_path / "jax"), **kw),
                    train_data=data, loss_fn=jloss, extra_trainable_paths=())
    jt.train()
    tt = Trainer(tr, TrainingArgs(output_dir=str(tmp_path / "port"), **kw), train_data=data,
                 loss_fn=jloss, extra_trainable_paths=(), device="cpu")
    tt.train()
    want = [r["loss"] for r in jt.log_history if "loss" in r]
    got = [r["loss"] for r in tt.log_history if "loss" in r]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, **LOGITS)
    trained = state_of(jr.interventions)
    assert {".".join(map(str, k)) for k in trained} == \
        {n for n, _ in tr.interventions.named_parameters()}
    for path, value in trained.items():
        np.testing.assert_allclose(to_numpy(tr.interventions.get_parameter(
            ".".join(map(str, path)))), value, **LOGITS)


@pytest.mark.parametrize("extra", [(), ("classifier",)], ids=["interventions", "with-cls"])
def test_torch_reft_trainable_set_matches_jax(extra):
    """MoReFT GLUE's trainable set: the interventions, and the classifier
    with ``--allow_cls_grad``; the encoder frozen."""
    reps = [{"layer": 0, "intervention": "MoReIntervention"},
            {"layer": 1, "intervention": "LoreftIntervention"}]
    jr = jreft.get_reft_model(
        jmodels.RobertaForSequenceClassification(jmodels.RobertaConfig.tiny(), rngs=nnx.Rngs(0)),
        jreft.ReftConfig(representations=reps), rngs=nnx.Rngs(1))
    tr = treft.get_reft_model(RobertaForSequenceClassification(RobertaConfig.tiny(),
                                                               device="cpu"),
                              treft.ReftConfig(representations=reps))
    want = {_port_name(tuple(getattr(p, "key", p) for p in path))[0]
            for path, _ in nnx.to_flat_state(nnx.state(jr, jax_trainable_filter(extra)))}
    assert surgery.trainable_filter(tr, extra) == sorted(want)
    assert {n for n, p in tr.named_parameters() if p.requires_grad} == want


def test_torch_skip_intervention_matches_jax():
    """Skips at layers 0 and 1 (the embeddings captured at layer 0's block
    input, layer 0's output after its own Loreft edit), against the JAX
    model; at layer 0 of a remat'd model both packages refuse."""
    reps = [{"layer": 1, "intervention": "SkipIntervention"},
            {"layer": 0, "intervention": "LoreftIntervention"},
            {"layer": 0, "intervention": "SkipIntervention", "subspace_partition": None}]
    jr, tr = reft_pair(reps)
    ids, mask, _ = lm_batch(7)
    locs = np.array([[[1, 4]] * 3, [[0, 2]] * 3], np.int32)
    want = np.asarray(jr(jnp.array(ids), attention_mask=jnp.array(mask),
                         intervention_locations=jnp.array(locs)))
    with torch.no_grad():
        got = tr(to_torch(ids, torch.long), attention_mask=to_torch(mask, torch.long),
                 intervention_locations=to_torch(locs, torch.long))
    np.testing.assert_allclose(to_numpy(got), want, **LOGITS)
    jr, tr = reft_pair(reps[2:], remat="nothing")
    with pytest.raises(NotImplementedError, match="layer 0 of a remat"):
        jr(jnp.array(ids), attention_mask=jnp.array(mask), intervention_locations=jnp.array(locs))
    with pytest.raises(NotImplementedError, match="layer 0 of a remat"):
        tr(to_torch(ids, torch.long), attention_mask=to_torch(mask, torch.long),
           intervention_locations=to_torch(locs, torch.long))


def test_torch_swap_forward_and_collect_match_jax():
    reps = [{"layer": 0, "intervention": "VanillaIntervention"},
            {"layer": 1, "intervention": "RotatedSpaceIntervention"}]
    jr, tr = reft_pair(reps)
    base, mask, _ = lm_batch(8)
    source, _, _ = lm_batch(9)
    b_locs = np.array([[[1, 3]] * 2, [[0, -1]] * 2], np.int32)
    s_locs = np.array([[[2, 5]] * 2, [[4, 4]] * 2], np.int32)
    args = dict(base_locations=b_locs, source_locations=s_locs)
    jargs = {k: jnp.array(v) for k, v in args.items()}
    targs = {k: to_torch(v, torch.long) for k, v in args.items()}
    for sub in (None, [[0, 5, 7], None]):
        want = np.asarray(jr.swap_forward(jnp.array(base), jnp.array(source), subspaces=sub,
                                          base_mask=jnp.array(mask), **jargs))
        with torch.no_grad():
            got = tr.swap_forward(to_torch(base, torch.long), to_torch(source, torch.long),
                                  subspaces=sub, base_mask=to_torch(mask, torch.long), **targs)
        np.testing.assert_allclose(to_numpy(got), want, **LOGITS)
    want = jr.collect_activations(jnp.array(source), jnp.array(s_locs))
    with torch.no_grad():
        got = tr.collect_activations(to_torch(source, torch.long), to_torch(s_locs, torch.long))
    assert set(got) == set(want) == {0, 1}
    for i in want:
        np.testing.assert_allclose(to_numpy(got[i]), np.asarray(want[i]), **LOGITS)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_torch_interventions_npz_crosses_between_packages(tmp_path, direction):
    reps = [{"layer": 0, "intervention": kind} for kind in
            ("LoreftIntervention", "NoreftIntervention", "ConsreftIntervention",
             "MoReIntervention", "BoundlessRotatedSpaceIntervention", "NoIntervention")]
    jr, tr = reft_pair(reps)
    jr.interventions[4].set_temperature(3.5)
    if direction == "jax-to-port":
        jr.save_interventions(str(tmp_path))
        tr = treft.get_reft_model(tr.model, treft.ReftConfig(representations=reps),
                                  generator=torch.Generator().manual_seed(9))
        tr.load_interventions(str(tmp_path))
    else:
        load_jax_state(tr, state_of(jr))
        tr.save_interventions(str(tmp_path))
        jr = jreft.get_reft_model(jr.model, jreft.ReftConfig(representations=reps),
                                  rngs=nnx.Rngs(21))
        jr.load_interventions(str(tmp_path))
    assert (tmp_path / "intervenable_config.json").exists()
    want = state_of(jr.interventions)
    got = {n: t for i in range(len(tr.interventions)) for n, t in
           {**{f"{i}.{k}": v for k, v in tr.interventions[i].named_parameters()},
            **{f"{i}.{k}": v for k, v in tr.interventions[i].named_buffers()}}.items()}
    assert set(got) == {".".join(map(str, k)) for k in want}
    for path, value in want.items():
        np.testing.assert_array_equal(to_numpy(got[".".join(map(str, path))]), value)


def test_torch_bridge_names_reft_and_toy_models():
    """``load_jax_state`` places every array of a JAX ReftModel (base and
    interventions, buffers too) and of the toy models, and leaves none of
    the port's parameters and buffers unset (it raises otherwise)."""
    reps = [{"layer": 1, "intervention": kind} for kind in treft.INTERVENTION_TYPES
            if kind not in ("PCARotatedSpaceIntervention", "Nothing")]
    jr, tr = reft_pair(reps)
    assert len(state_of(jr)) == len(tr.state_dict())
    for cls, cfg in ((("MLPModel",) * 2, dict(vocab_size=20, max_positions=4)),
                     (("MLPModel",) * 2, dict(input_dim=3)), (("GRUModel",) * 2, {})):
        jm = getattr(jtoy, cls[0])(jtoy.ToyConfig(**cfg), rngs=nnx.Rngs(0))
        tm = getattr(ttoy, cls[1])(ttoy.ToyConfig(**cfg), device="cpu")
        load_jax_state(tm, state_of(jm))
        assert len(state_of(jm)) == len(tm.state_dict())
