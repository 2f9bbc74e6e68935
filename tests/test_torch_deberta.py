"""The port's DeBERTa-v2/v3 sequence classifier held against the JAX model on
the CPU, as ``test_torch_roberta.py`` holds RoBERTa: logits, losses and the
trainable gradients (Monarch factors on query_proj/key_proj/value_proj, the
pooler and the classifier), float32 and bfloat16, over the config's
variants (shared or separate position projections, one or both
disentangled terms, no relative attention, absolute positions, no rel
LayerNorm).  ``make_log_bucket_position`` and ``build_relative_position``
equal the JAX functions bit for bit, past both ends of the log buckets.

Tolerances as ``test_torch_roberta.py``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_matrix_fine_tuning_torch.models import deberta as tdeb
from sparse_matrix_fine_tuning_torch.utils.testing import to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu.models import deberta as jdeb
from test_torch_roberta import check_forward_and_grads, labels_for, padded_batch, pair

PEFT_TARGETS = ["query_proj", "value_proj", "key_proj"]


@pytest.mark.parametrize("bucket,max_position", [(8, 64), (16, 128), (256, 512), (4, 6)])
def test_torch_deberta_log_buckets_match_jax_bit_for_bit(bucket, max_position):
    rel = np.arange(-2 * max_position, 2 * max_position + 1, dtype=np.int32)
    want = np.asarray(jdeb.make_log_bucket_position(jnp.array(rel), bucket, max_position))
    got = tdeb.make_log_bucket_position(to_torch(rel, torch.long), bucket, max_position)
    assert got.dtype == torch.int32 and np.array_equal(to_numpy(got), want)


@pytest.mark.parametrize("q,k,bucket,max_position", [
    (7, 7, -1, -1), (5, 9, -1, 64), (40, 40, 8, 64), (130, 130, 16, 128), (64, 33, 256, 512)])
def test_torch_deberta_relative_positions_match_jax_bit_for_bit(q, k, bucket, max_position):
    want = np.asarray(jdeb.build_relative_position(q, k, bucket, max_position))
    got = to_numpy(tdeb.build_relative_position(q, k, bucket, max_position))
    assert got.shape == want.shape == (1, q, k) and np.array_equal(got, want.astype(got.dtype))


VARIANTS = {
    "v3": {},
    "separate_pos_proj": {"share_att_key": False},
    "c2p_only": {"pos_att_type": ("c2p",), "share_att_key": False},
    "p2c_only": {"pos_att_type": ("p2c",)},
    "no_relative": {"relative_attention": False, "position_biased_input": True},
    "abs_pos_no_rel_norm": {"position_biased_input": True, "norm_rel_ebd": "none"},
}


# every variant adapted; the plain model at the first two
CASES = [(v, True) for v in VARIANTS] + [("v3", False), ("separate_pos_proj", False)]


@pytest.mark.parametrize("variant,adapters", CASES,
                         ids=[f"{v}-{'monarch' if a else 'plain'}" for v, a in CASES])
@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_torch_deberta_matches_jax(variant, adapters, dtype):
    num_labels = 1 if variant == "p2c_only" else 2
    kw = dict(num_labels=num_labels, dtype=dtype, **VARIANTS[variant])
    jm, tm = pair(jdeb.DebertaV2ForSequenceClassification, tdeb.DebertaV2ForSequenceClassification,
                  jdeb.DebertaV2Config.tiny(**kw), tdeb.DebertaV2Config.tiny(**kw), adapters,
                  peft_targets=PEFT_TARGETS)
    ids, mask = padded_batch(128, lens=(9, 5, 12, 2), pad=0)
    check_forward_and_grads(jm, tm, ids, mask, labels_for(num_labels, len(ids)),
                            dtype == "bfloat16")
    if adapters:
        layer = tm.deberta.layer[0].attention_self
        assert type(layer.query_proj).__name__ == "MonarchLinear"


def test_torch_deberta_config_matches_jax():
    want, got = jdeb.DebertaV2Config(), tdeb.DebertaV2Config()
    fields = list(got.__dataclass_fields__)
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    assert got.pos_ebd_size == want.pos_ebd_size == 256
    tiny = tdeb.DebertaV2Config.tiny(position_buckets=0)
    assert tiny.pos_ebd_size == jdeb.DebertaV2Config.tiny(position_buckets=0).pos_ebd_size == 64


def test_torch_deberta_refuses_layer_hooks():
    """``layer_hooks`` at block outputs and block inputs, under a
    ReftModel's interventions, against the JAX model
    (``test_torch_llama_hooks.check_encoder_hooks``)."""
    from test_torch_llama_hooks import check_encoder_hooks

    check_encoder_hooks("deberta")


@pytest.mark.parametrize("family", ["roberta", "deberta"])
def test_torch_encoder_trainable_npz_crosses_between_packages(tmp_path, family):
    """Full fine-tuning's ``trainable.npz`` (every parameter: embeddings,
    LayerNorm scales and offsets, linears, the adapters) written by each
    package loads in the other, value for value."""
    from flax import nnx

    from sparse_matrix_fine_tuning_torch.models.config import RobertaConfig
    from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
    from sparse_matrix_fine_tuning_torch.peft import surgery
    from sparse_matrix_fine_tuning_torch.utils.jax_bridge import (
        _port_name,
        read_jax_trainable,
        write_jax_trainable,
    )
    from sparse_matrix_fine_tuning_tpu import models as jmodels
    from sparse_matrix_fine_tuning_tpu import peft as jpeft
    from sparse_matrix_fine_tuning_tpu.training import checkpoint as jckpt

    if family == "roberta":
        classes = (jmodels.RobertaForSequenceClassification, RobertaForSequenceClassification,
                   jmodels.RobertaConfig.tiny(), RobertaConfig.tiny())
        targets = None
    else:
        classes = (jdeb.DebertaV2ForSequenceClassification, tdeb.DebertaV2ForSequenceClassification,
                   jdeb.DebertaV2Config.tiny(), tdeb.DebertaV2Config.tiny())
        targets = PEFT_TARGETS
    jm, tm = pair(*classes, True, seed=5, peft_targets=targets)
    filt = jpeft.trainable_filter(("__all__",))
    names = surgery.trainable_filter(tm, ("__all__",))
    params = dict(tm.named_parameters())

    def assert_same():
        for path, v in nnx.to_flat_state(nnx.state(jm, filt)):
            name, transpose = _port_name(tuple(getattr(p, "key", p) for p in path))
            want = np.asarray(v[...])
            got = to_numpy(params[name])
            assert np.array_equal(got.T if transpose else got, want), name

    jfile = str(tmp_path / "jax_trainable.npz")
    jckpt._save_tree(jfile, nnx.state(jm, filt))
    with torch.no_grad():
        for p in tm.parameters():
            p.mul_(-0.5)
    assert read_jax_trainable(jfile, tm) == names
    assert_same()
    with torch.no_grad():
        for p in tm.parameters():
            p.mul_(-0.5)
    tfile = str(tmp_path / "port_trainable.npz")
    assert write_jax_trainable(tfile, tm) == sorted(np.load(jfile).files)
    nnx.update(jm, jckpt._load_tree(tfile, nnx.state(jm, filt), strict=True))
    assert_same()
