"""The port's BLIP loaders and outputs held against the JAX package and
against ``transformers`` on the CPU.

Tiny HF ``BlipForQuestionAnswering`` / ``BlipForImageTextRetrieval`` models
(``transformers`` imported here only; biases and LayerNorms made nonzero)
are written in-process as HF-format directories (``save_pretrained``).
``from_pretrained_blip`` loads the same parameters as the JAX
``load_blip_qa`` / ``load_blip_itm`` given the model's state dict, bit for
bit.  On an unpadded batch both packages give HF's own modules' outputs
within 2e-4 (the JAX BLIP tests' bound against HF): VQA decoder logits,
image embeds and every encoder hidden state, the ITM head's scores and the
contrastive cosines.  On a padded batch the text encoder still agrees, and
the decoder parts from HF on the padded row alone: transformers 4.57 drops
the decoder's cross-attention padding mask, which both packages apply (the
JAX module's docstring, :36-45).  The directory that ``save_pretrained``
writes leaves out the LM head's tied decoder weight; the port's loader
takes the decoder's word embeddings there, where the JAX loader, given
that directory's tensors, raises (ROADMAP C.20).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.models import blip as port_blip
from sparse_matrix_fine_tuning_torch.models.hf_convert import load_state_dict
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import _port_name
from sparse_matrix_fine_tuning_torch.utils.testing import to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu.models import blip as jax_blip
from test_torch_blip import batch
from test_torch_reft import state_of

transformers = pytest.importorskip("transformers")

HF_TOL = dict(rtol=2e-4, atol=2e-4)
TINY_TEXT = dict(vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=4, encoder_hidden_size=32, max_position_embeddings=64,
                 bos_token_id=97, sep_token_id=98, pad_token_id=0, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0)
TINY_VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                   num_attention_heads=4, image_size=24, patch_size=8, attention_dropout=0.0,
                   dropout=0.0)
KINDS = {"qa": ("BlipForQuestionAnswering", jax_blip.BlipForQuestionAnswering,
                jax_blip.load_blip_qa),
         "itm": ("BlipForImageTextRetrieval", jax_blip.BlipForImageTextRetrieval,
                 jax_blip.load_blip_itm)}


def build(kind: str, root) -> tuple:
    """(HF model, JAX model loaded from its state dict, port model loaded
    from its HF-format directory, the directory)."""
    hf_name, jcls, jload = KINDS[kind]
    cfg = transformers.BlipConfig(text_config=TINY_TEXT, vision_config=TINY_VISION,
                                  image_text_hidden_size=16)
    torch.manual_seed(0)
    hf = getattr(transformers, hf_name)(cfg).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in hf.parameters():
            if p.ndim == 1:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    path = root / f"blip_{kind}"
    hf.save_pretrained(path)
    jm = jcls(jax_blip.blip_config_from_hf(cfg.to_dict()), rngs=nnx.Rngs(0))
    jload(jm, dict(hf.state_dict()))
    tm = port_blip.from_pretrained_blip(str(path), kind, device="cpu")
    return hf, jm, tm, path


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("blip_hf")
    return {kind: build(kind, root) for kind in KINDS}


@pytest.mark.parametrize("kind", list(KINDS))
def test_torch_blip_loaders_match_jax(models, kind):
    _, jm, tm, _ = models[kind]
    params = dict(tm.named_parameters())
    seen = set()
    for path, value in state_of(jm, nnx.Param).items():
        name, transpose = _port_name(path)
        assert np.array_equal(to_numpy(params[name]), value.T if transpose else value), name
        seen.add(name)
    assert seen == set(params)
    assert tm.config == port_blip.blip_config_from_hf(
        transformers.BlipConfig(text_config=TINY_TEXT, vision_config=TINY_VISION,
                                image_text_hidden_size=16).to_dict())


def test_torch_blip_jax_loader_needs_the_tied_decoder_weight(models):
    """C.20: the directory holds no ``decoder.weight`` (tied to the
    decoder's word embeddings); the port loads it, the JAX loader raises."""
    _, _, tm, path = models["qa"]
    sd = load_state_dict(str(path))
    assert "text_decoder.cls.predictions.decoder.weight" not in sd
    assert torch.equal(tm.lm_head.decoder.weight,
                       sd["text_decoder.bert.embeddings.word_embeddings.weight"])
    jm = jax_blip.BlipForQuestionAnswering(
        jax_blip.BlipModelConfig.tiny(image_text_hidden_size=16), rngs=nnx.Rngs(0))
    with pytest.raises(KeyError, match="decoder.weight"):
        jax_blip.load_blip_qa(jm, sd)


def hf_outputs(kind: str, hf, ids, mask, pixels, itm: bool = True) -> dict:
    """HF's modules composed as the reference wrappers compose them."""
    ids, mask, pixels = to_torch(ids, torch.long), to_torch(mask, torch.long), to_torch(pixels)
    with torch.no_grad():
        img = hf.vision_model(pixels)[0]
        ones = torch.ones(img.shape[:-1], dtype=torch.long)
        if kind == "itm" and not itm:
            txt = hf.text_encoder(ids, attention_mask=mask)[0]
            unit = torch.nn.functional.normalize
            return {"itm_score": unit(hf.vision_proj(img[:, 0]), dim=-1)
                    @ unit(hf.text_proj(txt[:, 0]), dim=-1).T}
        enc = hf.text_encoder(ids, attention_mask=mask, encoder_hidden_states=img,
                              encoder_attention_mask=ones, output_hidden_states=True,
                              return_dict=True)
        out = {"image_embeds": img, "encoder_last_hidden_state": enc.last_hidden_state,
               "encoder_hidden_states": enc.hidden_states}
        if kind == "itm":
            out["itm_score"] = hf.itm_head(enc.last_hidden_state[:, 0])
            return out
        bos = torch.full((ids.shape[0], 1), hf.config.text_config.bos_token_id)
        dec = hf.text_decoder(input_ids=bos, encoder_hidden_states=enc.last_hidden_state,
                              encoder_attention_mask=mask, return_dict=True, reduction="none")
        out["decoder_logits"] = dec.logits
        return out


def both_outputs(kind, jm, tm, ids, mask, pixels, itm: bool = True):
    if kind == "qa":
        jw, tw = jax_blip.BlipWrapper(jm), port_blip.BlipWrapper(tm)
    else:
        jw, tw = jax_blip.BlipITMWrapper(jm, itm), port_blip.BlipITMWrapper(tm, itm)
    want = jw(jnp.array(ids), jnp.array(pixels), attention_mask=jnp.array(mask))
    with torch.no_grad():
        got = tw(to_torch(ids, torch.long), to_torch(pixels),
                 attention_mask=to_torch(mask, torch.long))
    return {"jax": want, "port": got}


def as_numpy(a) -> np.ndarray:
    return to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _close(a, b, what):
    np.testing.assert_allclose(as_numpy(a), as_numpy(b), **HF_TOL, err_msg=what)


@pytest.mark.parametrize("kind,itm", [("qa", True), ("itm", True), ("itm", False)],
                         ids=["vqa", "itm_head", "contrastive"])
def test_torch_blip_matches_transformers_unpadded(models, kind, itm):
    hf, jm, tm, _ = models[kind]
    ids, mask, pixels = batch(seed=21, padded=False)
    want = hf_outputs(kind, hf, ids, mask, pixels, itm)
    for pkg, got in both_outputs(kind, jm, tm, ids, mask, pixels, itm).items():
        for key, value in want.items():
            if key == "encoder_hidden_states":
                assert len(got[key]) == len(value) == 3
                for i, (g, w) in enumerate(zip(got[key], value)):
                    _close(g, w, f"{pkg} {key}[{i}]")
            else:
                _close(got[key], value, f"{pkg} {key}")


def test_torch_blip_padded_decoder_parts_from_transformers(models):
    """Padded rows: the encoder agrees with HF; the decoder agrees on the
    unpadded row and parts on the padded ones, in both packages alike."""
    hf, jm, tm, _ = models["qa"]
    ids, mask, pixels = batch(seed=22)
    want = hf_outputs("qa", hf, ids, mask, pixels)
    outs = both_outputs("qa", jm, tm, ids, mask, pixels)
    _close(outs["port"]["decoder_logits"], outs["jax"]["decoder_logits"], "port against JAX")
    for pkg, got in outs.items():
        _close(got["encoder_last_hidden_state"], want["encoder_last_hidden_state"],
               f"{pkg} encoder")
        logits, ref = as_numpy(got["decoder_logits"]), as_numpy(want["decoder_logits"])
        np.testing.assert_allclose(logits[0], ref[0], **HF_TOL, err_msg=pkg)
        for row in (1, 2):
            assert np.abs(logits[row] - ref[row]).max() > 1e-5, (pkg, row)
