"""The port's encoder loaders (``models/hf_convert.py``: ``load_roberta``,
``from_pretrained_roberta``, ``load_deberta``, ``from_pretrained_deberta``)
on tiny HF-format directories that ``transformers`` writes here
(``save_pretrained``, safetensors and ``pytorch_model.bin``).

A loaded model's logits on a padded batch match HF's
``RobertaForSequenceClassification`` and ``DebertaV2ForSequenceClassification``
and the JAX package's loaders' on the same directory within
``TOLERANCES["f32_logits"]`` (float32 sums in another order through two
layers); every tensor of the checkpoint lands in the port's parameter of
the same role, bit for bit; a checkpoint without a head keeps the random
head the generator draws.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from sparse_matrix_fine_tuning_torch.models import hf_convert
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy
from sparse_matrix_fine_tuning_tpu.models import hf_convert as jhf

LOGITS = TOLERANCES["f32_logits"]
ROBERTA = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=66, type_vocab_size=1,
               pad_token_id=1, layer_norm_eps=1e-5, num_labels=3)
DEBERTA = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=64, type_vocab_size=0,
               relative_attention=True, position_buckets=8, pos_att_type=["p2c", "c2p"],
               share_att_key=True, norm_rel_ebd="layer_norm", position_biased_input=False,
               pooler_dropout=0.0, num_labels=3, pad_token_id=0, layer_norm_eps=1e-7)


def write(path, family: str, safe: bool = True, seed: int = 0):
    """A random HF classifier of ``family`` saved into ``path``; its biases
    and LayerNorms (HF starts them at 0 and 1) drawn too.  Returns it in
    eval mode."""
    cfg_cls, model_cls, kw = {
        "roberta": (transformers.RobertaConfig, transformers.RobertaForSequenceClassification,
                    ROBERTA),
        "deberta": (transformers.DebertaV2Config, transformers.DebertaV2ForSequenceClassification,
                    DEBERTA)}[family]
    torch.manual_seed(seed)
    model = model_cls(cfg_cls(**kw)).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "LayerNorm" in name:
                p.add_(0.1 * torch.randn_like(p))
    model.save_pretrained(str(path), safe_serialization=safe)
    return model


def batch(pad: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 128, size=(3, 12))
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    return np.where(mask > 0, ids, pad), mask


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
@pytest.mark.parametrize("family", ["roberta", "deberta"])
def test_torch_encoder_loaders_match_hf_and_jax(tmp_path, family, safe):
    hf = write(tmp_path, family, safe)
    ids, mask = batch(hf.config.pad_token_id)
    load = hf_convert.from_pretrained_deberta if family == "deberta" \
        else hf_convert.from_pretrained_roberta
    model = load(str(tmp_path), num_labels=3, device="cpu").eval()
    with torch.no_grad():
        got = to_numpy(model(torch.tensor(ids), torch.tensor(mask)))
        want_hf = hf(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask)).logits
    np.testing.assert_allclose(got, want_hf.numpy(), **LOGITS)
    jload = jhf.from_pretrained_deberta if family == "deberta" else jhf.from_pretrained_roberta
    jm = jload(str(tmp_path), num_labels=3)
    jm.eval()
    np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(ids), jnp.asarray(mask))), **LOGITS)


@pytest.mark.parametrize("family", ["roberta", "deberta"])
def test_torch_encoder_loaders_copy_every_tensor(tmp_path, family):
    """Each HF tensor equals the port parameter of its role, and every port
    parameter is given by the checkpoint."""
    hf = write(tmp_path, family)
    sd = hf.state_dict()
    if family == "roberta":
        model = hf_convert.from_pretrained_roberta(str(tmp_path), num_labels=3, device="cpu")
        names = {k: k.replace("roberta.encoder.layer.", "roberta.layer.") for k in sd}
    else:
        model = hf_convert.from_pretrained_deberta(str(tmp_path), num_labels=3, device="cpu")
        names = {}
        for k in sd:
            n = (k.replace("deberta.embeddings.LayerNorm", "deberta.emb_LayerNorm")
                 .replace("deberta.embeddings.", "deberta.")
                 .replace("deberta.encoder.rel_embeddings", "deberta.rel_embeddings")
                 .replace("deberta.encoder.LayerNorm", "deberta.rel_LayerNorm")
                 .replace("deberta.encoder.layer.", "deberta.layer.")
                 .replace("attention.self.", "attention_self.")
                 .replace("attention.output.", "attention_output.")
                 .replace("intermediate.dense", "intermediate")
                 .replace(".output.dense", ".output_dense")
                 .replace(".output.LayerNorm", ".output_LayerNorm")
                 .replace("pooler.dense", "pooler"))
            names[k] = n
    params = dict(model.named_parameters())
    names = {k: v for k, v in names.items() if not k.endswith("position_ids")}
    assert set(names.values()) == set(params)
    for hf_name, name in names.items():
        assert torch.equal(params[name], sd[hf_name]), hf_name


def test_torch_encoder_loader_keeps_a_drawn_head(tmp_path):
    """A RoBERTa checkpoint without the classification head: the loaded
    encoder equals HF's, the head is the generator's draw."""
    hf = write(tmp_path, "roberta")
    encoder_only = {k: v for k, v in hf.state_dict().items() if not k.startswith("classifier")}
    cfg = hf_convert.roberta_config_from_hf(hf.config.to_dict(), num_labels=3)
    heads = []
    for _ in range(2):
        model = RobertaForSequenceClassification(cfg, device="cpu",
                                                 generator=torch.Generator().manual_seed(7))
        hf_convert.load_roberta(model, encoder_only)
        heads.append(model.classifier.out_proj.weight)
        assert torch.equal(model.roberta.layer[1].output.dense.weight,
                           hf.roberta.encoder.layer[1].output.dense.weight)
    assert torch.equal(*heads)
    assert not torch.equal(heads[0], hf.classifier.out_proj.weight)
