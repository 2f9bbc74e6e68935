"""The port's RoBERTa sequence classifier held against the JAX model on the
CPU: logits, the CE, MSE (STS-B, ``num_labels == 1``) and row-weighted
losses, and after one backward the gradient of every trainable parameter
(the Monarch factors on query/key/value and the classification head), in
float32 and at the bfloat16 compute dtype; plain and with the GLUE peft
config's adapters.

The JAX model is ``RobertaConfig.tiny`` (2 layers, hidden 32, 4 heads); its
adapters, biases and LayerNorms get random nonzero values, and every weight
crosses by ``utils/jax_bridge.load_jax_state``.  Both run in eval mode (no
dropout).  Tolerances: float32 logits and losses 1e-4
(``TOLERANCES["f32_logits"]``), gradients 1e-4 of their largest element;
bfloat16 two ulps of the output's scale (``bf16_atol``) for logits and
losses, and for the gradients 2**-4 of their largest element: a
gradient sums bf16 products over every row, and the two frameworks round
their bf16 intermediates in other places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.models.config import RobertaConfig
from sparse_matrix_fine_tuning_torch.models.roberta import (
    RobertaForSequenceClassification,
    create_position_ids,
)
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import _port_name, load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, bf16_atol, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam
from sparse_matrix_fine_tuning_tpu.models.roberta import (
    create_position_ids as jax_create_position_ids,
)

LOGITS = TOLERANCES["f32_logits"]
BF16_GRAD_SHARE = 2.0 ** -4
PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True, "dropout": 0.0,
        "target_modules": ["query", "value", "key"]}
PAD = 1


def flat_params(model) -> dict:
    return {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def randomize(model, seed: int) -> None:
    """Nonzero adapters, biases and LayerNorm scales and offsets."""
    rng = np.random.default_rng(seed)
    for _, v in nnx.to_flat_state(nnx.state(model, AdapterParam)):
        v.set_value(jnp.array(rng.normal(0.0, 0.1, v[...].shape).astype(np.float32)))
    for _, v in nnx.to_flat_state(nnx.state(model, nnx.Param)):
        if v[...].ndim == 1:
            v.set_value(v[...] + jnp.array(rng.normal(0.0, 0.1, v[...].shape), jnp.float32))


def pair(jax_cls, port_cls, cfg_jax, cfg_port, adapters: bool, seed: int = 0,
         peft_targets=None):
    """The JAX model (adapted with ``PEFT``, or its targets replaced) and the
    port's, carrying its weights, both in eval mode."""
    jm = jax_cls(cfg_jax, rngs=nnx.Rngs(seed))
    tm = port_cls(cfg_port, device="cpu")
    if adapters:
        peft = dict(PEFT, target_modules=peft_targets or PEFT["target_modules"])
        jpeft.init_monarch(jm, peft, rngs=nnx.Rngs(seed + 1))
        surgery.init_monarch(tm, peft)
    randomize(jm, seed + 2)
    load_jax_state(tm, flat_params(jm))
    return jm, tm.eval()


def padded_batch(vocab: int, lens=(9, 5, 12, 2), seed: int = 3, pad: int = PAD):
    rng = np.random.default_rng(seed)
    t = max(lens)
    ids = rng.integers(3, vocab, (len(lens), t)).astype(np.int32)
    mask = np.zeros_like(ids)
    for row, n in enumerate(lens):
        mask[row, :n] = 1
    return np.where(mask > 0, ids, pad).astype(np.int32), mask


def labels_for(num_labels: int, n: int, seed: int = 4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if num_labels == 1:
        return rng.uniform(0, 5, n).astype(np.float32)
    return rng.integers(0, num_labels, n).astype(np.int32)


def check(got: torch.Tensor, want, bf16: bool, what: str) -> None:
    want = np.asarray(want, np.float32)
    if bf16:
        np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=bf16_atol(want),
                                   err_msg=what)
    else:
        np.testing.assert_allclose(to_numpy(got), want, **LOGITS, err_msg=what)


def check_forward_and_grads(jm, tm, ids, mask, labels, bf16: bool) -> None:
    """Logits, the loss unweighted and row-weighted, and the trainable
    gradients of the weighted loss."""
    weights = np.array([1, 1, 0, 1][:len(ids)], np.int32)
    jids, jmask = jnp.array(ids), jnp.array(mask)
    want = jm(jids, jmask)
    tids, tmask = to_torch(ids, torch.long), to_torch(mask, torch.long)
    with torch.no_grad():
        got = tm(tids, tmask)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    check(got, want, bf16, "logits")
    tl = to_torch(labels)
    for w in (None, weights):
        jw = None if w is None else jnp.array(w)
        tw = None if w is None else to_torch(w, torch.long)
        check(tm.loss(got, tl, tw), jm.loss(want, jnp.array(labels), jw), bf16, f"loss {w}")

    def jax_loss(model):
        return model.loss(model(jids, jmask), jnp.array(labels), jnp.array(weights))

    grads = nnx.grad(jax_loss, argnums=nnx.DiffState(0, jpeft.trainable_filter()))(jm)
    names = surgery.trainable_filter(tm)
    tm.loss(tm(tids, tmask), tl, to_torch(weights, torch.long)).backward()
    params = dict(tm.named_parameters())
    seen = set()
    for path, g in nnx.to_flat_state(grads):
        name, transpose = _port_name(tuple(getattr(p, "key", p) for p in path))
        want_g = np.asarray(g[...], np.float32)
        want_g = want_g.T if transpose else want_g
        got_g = to_numpy(params[name].grad)
        scale = float(np.abs(want_g).max())
        share = BF16_GRAD_SHARE if bf16 else LOGITS["atol"]
        np.testing.assert_allclose(got_g, want_g, rtol=0, atol=max(scale * share, 1e-7),
                                   err_msg=name)
        seen.add(name)
    assert seen == set(names) and seen


def test_torch_roberta_position_ids_match_jax():
    ids, _ = padded_batch(128)
    want = np.asarray(jax_create_position_ids(jnp.array(ids), PAD))
    assert np.array_equal(to_numpy(create_position_ids(to_torch(ids, torch.long), PAD)), want)


@pytest.mark.parametrize("adapters", [False, True], ids=["plain", "monarch"])
@pytest.mark.parametrize("num_labels", [2, 3, 1], ids=["binary", "mnli", "stsb"])
@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_torch_roberta_matches_jax(adapters, num_labels, dtype):
    kw = dict(num_labels=num_labels, dtype=dtype)
    jm, tm = pair(jmodels.RobertaForSequenceClassification, RobertaForSequenceClassification,
                  jmodels.RobertaConfig.tiny(**kw), RobertaConfig.tiny(**kw), adapters)
    ids, mask = padded_batch(128)
    labels = labels_for(num_labels, len(ids))
    check_forward_and_grads(jm, tm, ids, mask, labels, dtype == "bfloat16")
    if adapters:
        assert type(tm.roberta.layer[0].attention.self.query).__name__ == "MonarchLinear"


def test_torch_roberta_large_preset_matches_jax():
    want = jmodels.RobertaConfig.large(num_labels=3)
    got = RobertaConfig.large(num_labels=3)
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == \
        {f: getattr(want, f) for f in got.__dataclass_fields__}


def test_torch_roberta_refuses_layer_hooks():
    """``layer_hooks`` at block outputs and block inputs, under a
    ReftModel's interventions, against the JAX model
    (``test_torch_llama_hooks.check_encoder_hooks``)."""
    from test_torch_llama_hooks import check_encoder_hooks

    check_encoder_hooks("roberta")


def test_torch_roberta_dropout_follows_train_mode():
    """Dropout acts in train() only, as nnx.Module.train() switches it."""
    tm = RobertaForSequenceClassification(RobertaConfig.tiny(), device="cpu")
    ids, mask = (to_torch(a, torch.long) for a in padded_batch(128))
    with torch.no_grad():
        a, b = tm.eval()(ids, mask), tm(ids, mask)
        assert torch.equal(a, b)
        assert not torch.equal(tm.train()(ids, mask), a)
