"""The port's BLIP held against the JAX model on the CPU: the vision tower,
the text encoder at every hook component, the VQA wrapper's dict outputs
(decoder logits, image embeds, every encoder and decoder hidden state) and
the ITM wrapper in both modes, on a padded batch.

The JAX models are the ``tiny()`` configs (2 layers a tower, width 32, 4
heads, 24-pixel images in 8-pixel patches); their biases, LayerNorms and
class and position embeddings get random nonzero values, and every weight
crosses by ``utils/jax_bridge.load_jax_state``.  Tolerance: float32
outputs and hidden states 1e-4 (``TOLERANCES["f32_logits"]``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.models import blip as port_blip
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu.models import blip as jax_blip

LOGITS = TOLERANCES["f32_logits"]


def flat_params(model) -> dict:
    return {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(nnx.state(model, nnx.Param))}


def randomize(model, seed: int) -> None:
    """Nonzero biases, LayerNorm scales and offsets (every 1-D parameter)."""
    rng = np.random.default_rng(seed)
    for _, v in nnx.to_flat_state(nnx.state(model, nnx.Param)):
        if v[...].ndim == 1:
            v.set_value(v[...] + jnp.array(rng.normal(0.0, 0.1, v[...].shape), jnp.float32))


def pair(kind: str, seed: int = 0):
    """(JAX model, port model) of ``kind`` "qa" or "itm", the port's carrying
    the JAX weights."""
    cfg = jax_blip.BlipModelConfig.tiny()
    jcls, tcls = {"qa": (jax_blip.BlipForQuestionAnswering, port_blip.BlipForQuestionAnswering),
                  "itm": (jax_blip.BlipForImageTextRetrieval,
                          port_blip.BlipForImageTextRetrieval)}[kind]
    jm = jcls(cfg, rngs=nnx.Rngs(seed))
    randomize(jm, seed + 1)
    tm = tcls(port_blip.BlipModelConfig.tiny(), device="cpu")
    load_jax_state(tm, flat_params(jm))
    return jm, tm


def batch(seed: int = 0, b: int = 3, t: int = 7, padded: bool = True):
    """(ids, mask, pixels): ids in [1, 97), one row padded by two, one by
    four, (b, 3, 24, 24) pixels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 97, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    if padded:
        mask[1, -2:] = 0
        mask[2, -4:] = 0
    ids = np.where(mask > 0, ids, 0).astype(np.int32)
    pixels = rng.normal(size=(b, 3, 24, 24)).astype(np.float32)
    return ids, mask, pixels


def close(got, want, what: str) -> None:
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), **LOGITS,
                               err_msg=what)


def run_both(jfn, tfn, ids, mask, pixels):
    want = jfn(jnp.array(ids), jnp.array(pixels), attention_mask=jnp.array(mask))
    with torch.no_grad():
        got = tfn(to_torch(ids, torch.long), to_torch(pixels), attention_mask=to_torch(mask,
                                                                                      torch.long))
    return got, want


def dataclass_dict(cfg) -> dict:
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


@pytest.mark.parametrize("name", ["BlipVisionConfig", "BlipTextConfig"])
def test_torch_blip_configs_match_jax(name):
    """Defaults (HF's) and ``tiny()``, field by field."""
    for make in (lambda cls: cls(), lambda cls: cls.tiny()):
        assert dataclass_dict(make(getattr(port_blip, name))) \
            == dataclass_dict(make(getattr(jax_blip, name)))


def test_torch_blip_vision_tower_matches_jax():
    jm, tm = pair("qa")
    _, _, pixels = batch()
    want_last, want_pooled = jm.vision_model(jnp.array(pixels))
    with torch.no_grad():
        got_last, got_pooled = tm.vision_model(to_torch(pixels))
    assert got_last.shape == (3, 10, 32)  # 9 patches and the class token
    close(got_last, want_last, "last hidden")
    close(got_pooled, want_pooled, "pooled")


def test_torch_blip_vqa_wrapper_matches_jax():
    """Every entry of the dict on a padded batch: the decoder's
    cross-attention masks the question's padding in both packages."""
    jm, tm = pair("qa")
    ids, mask, pixels = batch()
    got, want = run_both(jax_blip.BlipWrapper(jm), port_blip.BlipWrapper(tm), ids, mask, pixels)
    assert sorted(got) == sorted(want)
    assert got["decoder_logits"].shape == (3, 1, 99)
    for key in ("decoder_logits", "image_embeds", "encoder_last_hidden_state"):
        close(got[key], want[key], key)
    for key in ("encoder_hidden_states", "decoder_hidden_states"):
        assert len(got[key]) == len(want[key]) == 3  # the embeddings and 2 layers
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            close(g, w, f"{key}[{i}]")


@pytest.mark.parametrize("itm", [True, False], ids=["itm_head", "contrastive"])
def test_torch_blip_itm_wrapper_matches_jax(itm):
    jm, tm = pair("itm", seed=4)
    ids, mask, pixels = batch(seed=2)
    got, want = run_both(jax_blip.BlipITMWrapper(jm, itm), port_blip.BlipITMWrapper(tm, itm),
                         ids, mask, pixels)
    assert sorted(got) == sorted(want)
    assert got["itm_score"].shape == ((3, 2) if itm else (3, 3))
    for key in ("itm_score", "image_embeds", "encoder_last_hidden_state"):
        close(got[key], want[key], key)
    for i, (g, w) in enumerate(zip(got["encoder_hidden_states"], want["encoder_hidden_states"])):
        close(g, w, f"encoder_hidden_states[{i}]")


def _roll(seen, key):
    def fn(x):
        seen.append(key)
        # not uniform: a post-LN block cancels a uniform scale or shift
        return x.roll(1, -1) if isinstance(x, torch.Tensor) else jnp.roll(x, 1, axis=-1)
    return fn


@pytest.mark.parametrize("key", [1, (0, "block_output"), (1, "block_input"),
                                 (0, "attention_output"), (1, "cross_attention_output"),
                                 (0, "mlp_output")], ids=str)
def test_torch_blip_text_encoder_hooks_match_jax(key):
    """Each hook component of the text encoder, under the VQA wrapper: the
    hook runs once in each package and the outputs agree and move."""
    jm, tm = pair("qa", seed=6)
    ids, mask, pixels = batch(seed=5)
    jseen, tseen = [], []
    jw, tw = jax_blip.BlipWrapper(jm), port_blip.BlipWrapper(tm)
    want = jw(jnp.array(ids), jnp.array(pixels), attention_mask=jnp.array(mask),
              layer_hooks={key: _roll(jseen, key)})
    with torch.no_grad():
        got = tw(to_torch(ids, torch.long), to_torch(pixels),
                 attention_mask=to_torch(mask, torch.long), layer_hooks={key: _roll(tseen, key)})
        base = tw(to_torch(ids, torch.long), to_torch(pixels),
                  attention_mask=to_torch(mask, torch.long))
    assert tseen == jseen == [key]
    close(got["decoder_logits"], want["decoder_logits"], f"{key} logits")
    for i, (g, w) in enumerate(zip(got["encoder_hidden_states"], want["encoder_hidden_states"])):
        close(g, w, f"{key} encoder_hidden_states[{i}]")
    assert not torch.allclose(got["decoder_logits"], base["decoder_logits"])


def test_torch_blip_contrastive_path_has_no_cross_attention_site():
    """Without image embeds the cross-attention block and its site do not
    run, in either package; an unknown component raises in the port."""
    jm, tm = pair("itm")
    ids, mask, pixels = batch()
    jseen, tseen = [], []
    key = (0, "cross_attention_output")
    jax_blip.BlipITMWrapper(jm, False)(jnp.array(ids), jnp.array(pixels),
                                       attention_mask=jnp.array(mask),
                                       layer_hooks={key: _roll(jseen, key)})
    wrapper = port_blip.BlipITMWrapper(tm, False)
    args = (to_torch(ids, torch.long), to_torch(pixels))
    with torch.no_grad():
        wrapper(*args, attention_mask=to_torch(mask, torch.long),
                layer_hooks={key: _roll(tseen, key)})
        assert jseen == tseen == []
        with pytest.raises(ValueError, match="unsupported BLIP text hook component"):
            wrapper(*args, layer_hooks={(0, "sense_network_output"): _roll(tseen, key)})


def test_torch_blip_decoder_masks_question_padding():
    """The decoder's cross-attention reads the question's mask: more
    padding on a row moves that row's logits and no other's."""
    _, tm = pair("qa")
    ids, mask, pixels = batch()
    wrapper = port_blip.BlipWrapper(tm)
    more = mask.copy()
    more[1, -3:] = 0
    with torch.no_grad():
        a = wrapper(to_torch(ids, torch.long), to_torch(pixels),
                    attention_mask=to_torch(mask, torch.long))["decoder_logits"]
        b = wrapper(to_torch(ids, torch.long), to_torch(pixels),
                    attention_mask=to_torch(more, torch.long))["decoder_logits"]
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert (a[1] - b[1]).abs().max() > 1e-5
