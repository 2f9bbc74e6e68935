"""Checkpoints in the reference's formats crossing between the packages,
both ways, on the CPU, each built in-process: the pyvene ``intkey_*.bin``
files of Loreft, Noreft, Consreft and MoRe interventions
(``interventions/pyvene_io.py``), and the reference's trainable-only
adapter dict (``peft/import_reference.py``) of a Monarch-adapted Llama and
RoBERTa (with the affine Scaler), as ``.bin`` and ``.safetensors``.  The
loaded values equal the writer's bit for bit (Consreft's rotation, which
goes through torch's orthogonal parametrisation, within 1e-6), and the
two packages' exports are equal key for key."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.interventions import pyvene_io as tio
from sparse_matrix_fine_tuning_torch.interventions import reft as treft
from sparse_matrix_fine_tuning_torch.models.config import RobertaConfig
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.peft import import_reference as timp
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import to_numpy
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu.interventions import pyvene_io as jio
from sparse_matrix_fine_tuning_tpu.interventions import reft as jreft
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam
from sparse_matrix_fine_tuning_tpu.peft import import_reference as jimp
from test_torch_llama import PEFT, jax_llama, port_of
from test_torch_llama_hooks import reft_pair
from test_torch_reft import state_of

KINDS = ("LoreftIntervention", "NoreftIntervention", "ConsreftIntervention",
         "MoReIntervention", "NoIntervention")
REPS = [{"layer": i % 2, "intervention": kind, "low_rank_dimension": 4}
        for i, kind in enumerate(KINDS + ("LoreftIntervention",))]


def pair():
    """``reft_pair`` over REPS, Consreft's rotation made orthonormal again
    (the random change broke it; a trained one is kept orthonormal)."""
    jr, tr = reft_pair(REPS)
    rotate = jr.interventions[2].rotate
    rotate.set_value(jnp.linalg.qr(rotate[...])[0])
    load_jax_state(tr, state_of(jr))
    return jr, tr


def intervention_values(reft_model) -> dict:
    if hasattr(reft_model, "named_parameters"):
        return {n: to_numpy(p) for n, p in reft_model.interventions.named_parameters()}
    return {".".join(map(str, k)): v for k, v in state_of(reft_model.interventions).items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torch_pyvene_files_cross_between_packages(tmp_path, writer):
    jr, tr = pair()
    source = jr if writer == "jax" else tr
    written = (jio if writer == "jax" else tio).save_pyvene_interventions(source, str(tmp_path))
    assert written == jio.save_pyvene_interventions(jr, str(tmp_path / "names"))
    assert len(written) == 5 and all(f.startswith("intkey_layer.") for f in written)
    fresh_j = jreft.get_reft_model(jr.model, jreft.ReftConfig(representations=REPS),
                                   rngs=nnx.Rngs(30))
    fresh_t = treft.get_reft_model(tr.model, treft.ReftConfig(representations=REPS),
                                   generator=torch.Generator().manual_seed(30))
    loaded_j = jio.load_pyvene_interventions(fresh_j, str(tmp_path))
    loaded_t = tio.load_pyvene_interventions(fresh_t, str(tmp_path))
    assert loaded_t == loaded_j == (sorted(written, key=written.index), [])
    want, got, got_j = (intervention_values(m) for m in (source, fresh_t, fresh_j))
    assert got.keys() == want.keys() == got_j.keys()
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], got_j[name])
        if name.startswith("2.rotate"):
            np.testing.assert_allclose(got[name], value, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[name], value)


def test_torch_pyvene_load_refuses_stray_files(tmp_path):
    _, tr = pair()
    tio.save_pyvene_interventions(tr, str(tmp_path))
    short = treft.get_reft_model(tr.model, treft.ReftConfig(representations=REPS[:2]))
    with pytest.raises(KeyError, match="no matching intervention"):
        tio.load_pyvene_interventions(short, str(tmp_path))
    assert len(tio.load_pyvene_interventions(short, str(tmp_path), strict=False)[1]) == 3


ROBERTA_PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True, "scaler": True,
                "affine": True, "target_modules": ["query", "value", "key"]}


def adapted_pair(family):
    if family == "llama":
        jm = jax_llama(3)
        return jm, port_of(jm)
    jm = jmodels.RobertaForSequenceClassification(jmodels.RobertaConfig.tiny(),
                                                  rngs=nnx.Rngs(2))
    jpeft.init_monarch(jm, ROBERTA_PEFT, rngs=nnx.Rngs(3))
    rng = np.random.default_rng(4)
    for _, v in nnx.to_flat_state(nnx.state(jm, AdapterParam)):
        v.set_value(jnp.array(rng.normal(0.0, 0.1, v[...].shape).astype(np.float32)))
    tm = RobertaForSequenceClassification(RobertaConfig.tiny(), device="cpu")
    surgery.init_monarch(tm, ROBERTA_PEFT)
    load_jax_state(tm, state_of(jm, nnx.Param))
    return jm, tm


def fresh(family):
    if family == "llama":
        return jax_llama(8), port_of(jax_llama(9))
    jm = jmodels.RobertaForSequenceClassification(jmodels.RobertaConfig.tiny(),
                                                  rngs=nnx.Rngs(5))
    jpeft.init_monarch(jm, ROBERTA_PEFT, rngs=nnx.Rngs(6))
    tm = RobertaForSequenceClassification(RobertaConfig.tiny(), device="cpu")
    surgery.init_monarch(tm, ROBERTA_PEFT)
    return jm, tm


@pytest.mark.parametrize("family", ["llama", "roberta"])
@pytest.mark.parametrize("fmt", [".bin", ".safetensors"])
def test_torch_reference_adapters_cross_between_packages(tmp_path, family, fmt):
    """Each package's file loaded by both.  The port's files give the
    writer's values in both packages.  The JAX package's ``.safetensors``
    holds its transposed heads (``lm_head``, the classifier) in their
    untransposed storage order (``safetensors.numpy`` ignores strides:
    ROADMAP.md C.16), so there the port is held to what the JAX loader
    reads from the same file."""
    jm, tm = adapted_pair(family)
    want = jimp.export_reference_adapters(jm)
    got = timp.export_reference_adapters(tm)
    assert got.keys() == want.keys() and \
        any(".scaler." in k for k in got) == (family == "roberta")
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(value))
    jpath, tpath = str(tmp_path / f"jax{fmt}"), str(tmp_path / f"port{fmt}")
    jimp.save_reference_adapters(jm, jpath)
    timp.save_reference_adapters(tm, tpath)
    for path in (jpath, tpath):
        fj, ft = fresh(family)
        loaded_t = timp.load_reference_adapters(ft, path)
        loaded_j = jimp.load_reference_adapters(fj, path)
        assert sorted(loaded_t[0]) == sorted(loaded_j[0]) == sorted(want)
        assert loaded_t[1] == loaded_j[1] == []
        read_j = jimp.export_reference_adapters(fj)
        np.testing.assert_equal(timp.export_reference_adapters(ft), read_j)
        if path == tpath or fmt == ".bin":
            np.testing.assert_equal(read_j, want)


def test_torch_reference_adapters_refuse_unknown_keys():
    _, tm = fresh("roberta")
    sd = {"roberta.encoder.layer.0.attention.self.query.blkdiag1":
          torch.zeros(tm.roberta.layer[0].attention.self.query.blkdiag1.shape),
          "roberta.encoder.layer.0.attention.self.query.lora_x": torch.zeros(2)}
    with pytest.raises(KeyError, match="lora_x"):
        timp.load_reference_adapters(tm, sd)
    assert timp.load_reference_adapters(tm, sd, strict=False) == \
        ([next(iter(sd))], ["roberta.encoder.layer.0.attention.self.query.lora_x"])
    with pytest.raises(ValueError, match="shape mismatch"):
        timp.load_reference_adapters(tm, {next(iter(sd)): torch.zeros(3)})
