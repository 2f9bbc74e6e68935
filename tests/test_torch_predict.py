"""The port's batched prediction (``evaluation/predict.py``) against the JAX
package's on a tiny RoBERTa with adapters, weights carried by
``utils/jax_bridge.load_jax_state``: ragged tails filled by repeating the
last row (their outputs dropped), batch sizes above and below the split,
an empty split, the regression head's raw scores, and intervened
classification (a ReftModel with its locations, MoReFT GLUE).  Logits within
``TOLERANCES["f32_logits"]``, classes equal.
"""

import numpy as np
import pytest
import torch

from sparse_matrix_fine_tuning_torch.evaluation import predict_classes, predict_logits
from sparse_matrix_fine_tuning_torch.models.config import RobertaConfig
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu.evaluation import predict as jpredict
from test_torch_roberta import pair, padded_batch

LOGITS = TOLERANCES["f32_logits"]


def split(n: int, seed: int = 5) -> dict:
    lens = np.random.default_rng(seed).integers(1, 14, n)
    ids, mask = padded_batch(128, lens=tuple(int(x) for x in lens), seed=seed)
    return {"input_ids": ids, "attention_mask": mask}


@pytest.fixture(scope="module", params=[3, 1], ids=["classes", "regression"])
def models(request):
    kw = dict(num_labels=request.param)
    return pair(jmodels.RobertaForSequenceClassification, RobertaForSequenceClassification,
                jmodels.RobertaConfig.tiny(**kw), RobertaConfig.tiny(**kw), True)


@pytest.mark.parametrize("n,batch_size", [(23, 8), (5, 8), (16, 8), (1, 4)],
                         ids=["ragged", "short", "whole", "single"])
def test_torch_predict_matches_jax(models, n, batch_size):
    jm, tm = models
    data = split(n)
    want = jpredict.predict_logits(jm, data, batch_size)
    got = predict_logits(tm, data, batch_size)
    assert got.dtype == np.float32 and got.shape == want.shape == (n, tm.config.num_labels)
    np.testing.assert_allclose(got, want, **LOGITS)
    classes = predict_classes(tm, data, batch_size)
    if tm.config.num_labels == 1:
        np.testing.assert_allclose(classes, got[:, 0], rtol=0, atol=0)
    else:
        assert np.array_equal(classes, jpredict.predict_classes(jm, data, batch_size))
    # the filled rows change nothing: each row alone gives its logits
    with torch.no_grad():
        rows = [to_numpy(tm(torch.tensor(data["input_ids"][i:i + 1]).long(),
                            torch.tensor(data["attention_mask"][i:i + 1]).long()))
                for i in range(n)]
    np.testing.assert_allclose(got, np.concatenate(rows), **LOGITS)
    assert not tm.training


def test_torch_predict_empty_split_keeps_the_width(models):
    jm, tm = models
    empty = {"input_ids": np.zeros((0, 8), np.int32), "attention_mask": np.zeros((0, 8), np.int32)}
    got = predict_logits(tm, empty)
    assert got.shape == jpredict.predict_logits(jm, empty).shape == (0, tm.config.num_labels)
    assert predict_classes(tm, empty).shape == (0,)


def test_torch_predict_refuses_intervention_locations(models):
    """``locations``: a ReftModel's intervened forward (MoRe at both block
    outputs, bridged), its rows filled like the inputs, against the JAX
    package's."""
    from flax import nnx
    from test_torch_reft import state_of

    from sparse_matrix_fine_tuning_torch.interventions import reft as treft
    from sparse_matrix_fine_tuning_tpu.interventions import reft as jreft

    jm, tm = models
    reps = [{"layer": layer, "intervention": "MoReIntervention"} for layer in (0, 1)]
    jr = jreft.get_reft_model(jm, jreft.ReftConfig(representations=reps), rngs=nnx.Rngs(3))
    for _, v in nnx.to_flat_state(nnx.state(jr.interventions, nnx.Param)):
        v.set_value(v[...] * 3.0)
    tr = treft.get_reft_model(tm, treft.ReftConfig(representations=reps))
    load_jax_state(tr, state_of(jr))
    data = split(11)
    locs = np.random.default_rng(2).integers(-1, 2, (11, 2, 3)).astype(np.int32)
    want = jpredict.predict_logits(jr, data, 4, locations=locs)
    got = predict_logits(tr, data, 4, locations=locs)
    np.testing.assert_allclose(got, want, **LOGITS)
    assert np.abs(want - jpredict.predict_logits(jm, data, 4)).max() > 1e-4