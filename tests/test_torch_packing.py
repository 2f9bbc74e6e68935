"""Sequence packing in the port against the JAX package on the CPU.

The packers of ``data/alpaca.py`` (``_bin_pack_decreasing``,
``_fill_bins``, ``pack_tokenized``, ``pack_causal_lm``) against the JAX
originals bit for bit (arrays, dtypes and the efficiency), on seeded ragged
rows, one longer than ``max_len``.  Then the tiny Llama (2 layers, hidden
64, GQA 4/2, Monarch adapters on all seven projections, random nonzero,
bridged by ``utils/jax_bridge.load_jax_state``) on a packed batch, under
"einsum" and "dpa": its logits against the JAX model's packed logits and
against each example run alone (as JAX tests/models/test_packing.py:30),
and the packed ``training_loss`` and every adapter gradient against JAX's.
"splash" and decode refuse ``segment_ids``.

Tolerances: 1e-4 (``TOLERANCES["f32_logits"]``): two layers of fp32 sums in
another order; a packed segment against the example alone, 2e-4 as the JAX
test (the same sums over a longer, masked row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.data import alpaca as talpaca
from sparse_matrix_fine_tuning_torch.data.tokenizer import SimpleTokenizer
from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.llama import (
    LlamaForCausalLM,
    init_caches,
    segment_positions,
)
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu.data import alpaca as jalpaca
from sparse_matrix_fine_tuning_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam

MODEL = TOLERANCES["f32_logits"]
ALONE = dict(rtol=2e-4, atol=2e-4)
PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj"]}
MAX_LEN = 24
T = 32
# a packed batch: each row's segments (lengths), then padding to T
SEGMENTS = ((7, 11, 5), (13, 2, 9, 4))


def _same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _ragged(seed: int, n: int = 23):
    """Right-padded rows of lengths 1..MAX_LEN + 9 (one past MAX_LEN at
    least), labels -100 on a random prefix, pad id 0."""
    rng = np.random.default_rng(seed)
    width = MAX_LEN + 9
    lengths = rng.integers(1, width + 1, n)
    lengths[3] = width
    ids = np.zeros((n, width), np.int32)
    mask = (np.arange(width)[None, :] < lengths[:, None]).astype(np.int32)
    ids[mask > 0] = rng.integers(3, 200, int(mask.sum()))
    labels = np.where(mask > 0, ids, -100).astype(np.int32)
    for row, k in enumerate(rng.integers(0, 5, n)):
        labels[row, :k] = -100
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}, lengths


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_bin_pack_and_fill_match_jax(seed):
    data, lengths = _ragged(seed)
    assert lengths.max() > MAX_LEN
    bins = talpaca._bin_pack_decreasing(list(lengths), MAX_LEN)
    assert bins == jalpaca._bin_pack_decreasing(list(lengths), MAX_LEN)
    rows = [(data["input_ids"][i][:min(n, MAX_LEN)], data["labels"][i][:min(n, MAX_LEN)])
            for i, n in enumerate(lengths)]
    got, got_eff = talpaca._fill_bins(rows, bins, MAX_LEN, 5)
    want, want_eff = jalpaca._fill_bins(rows, bins, MAX_LEN, 5)
    _same(got, want)
    assert got_eff == want_eff


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_pack_tokenized_matches_jax(seed):
    data, _ = _ragged(seed)
    got, got_eff = talpaca.pack_tokenized(data, MAX_LEN)
    want, want_eff = jalpaca.pack_tokenized(data, MAX_LEN)
    _same(got, want)
    assert got_eff == want_eff and len(got["input_ids"]) < len(data["input_ids"])


@pytest.mark.parametrize("train_on_source", [False, True])
def test_torch_pack_causal_lm_matches_jax(train_on_source):
    """Alpaca items of ragged lengths, some past ``max_len`` (truncated)."""
    rng = np.random.default_rng(7)
    words = [f"w{i}" for i in range(40)]
    items = [{"instruction": " ".join(rng.choice(words, int(rng.integers(1, 30)))),
              "input": " ".join(rng.choice(words, int(rng.integers(0, 8)))),
              "output": " ".join(rng.choice(words, int(rng.integers(1, 12))))}
             for _ in range(30)]
    kw = dict(max_len=64, source_max_len=48, target_max_len=16,
              train_on_source=train_on_source)
    got, got_eff = talpaca.pack_causal_lm(items, SimpleTokenizer(512), **kw)
    want, want_eff = jalpaca.pack_causal_lm(items, JaxTokenizer(512), **kw)
    _same(got, want)
    assert got_eff == want_eff
    assert sum(len(set(row[row > 0])) for row in got["segment_ids"]) == len(items)


def pair(impl: str, seed: int = 0, **cfg):
    jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(attention_impl=impl, **cfg),
                                  rngs=nnx.Rngs(seed))
    jpeft.init_monarch(jm, PEFT, rngs=nnx.Rngs(seed + 1))
    rng = np.random.default_rng(seed)
    for _, v in nnx.to_flat_state(nnx.state(jm, AdapterParam)):
        v.set_value(jnp.array(rng.normal(0.0, 0.1, v[...].shape).astype(np.float32)))
    tm = LlamaForCausalLM(LlamaConfig.tiny(attention_impl=impl, **cfg), device="cpu")
    surgery.init_monarch(tm, PEFT)
    load_jax_state(tm, {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
                        for path, v in nnx.to_flat_state(nnx.state(jm, nnx.Param))})
    return jm, tm


def packed_batch(seed: int = 1):
    """Rows of ``SEGMENTS``: ids, attention mask, segment ids, labels (each
    segment's first label -100, as the packers write them, pads -100)."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(SEGMENTS), T), np.int32)
    seg = np.zeros_like(ids)
    for row, lengths in enumerate(SEGMENTS):
        pos = 0
        for s, n in enumerate(lengths, start=1):
            ids[row, pos:pos + n] = rng.integers(3, 256, n)
            seg[row, pos:pos + n] = s
            pos += n
    labels = np.where(seg > 0, ids, -100).astype(np.int32)
    first = np.concatenate([np.ones((len(ids), 1), bool), seg[:, 1:] != seg[:, :-1]], axis=1)
    labels[first] = -100
    return ids, (seg > 0).astype(np.int32), seg, labels


def test_torch_segment_positions_restart_at_each_segment():
    _, _, seg, _ = packed_batch()
    pos = segment_positions(to_torch(seg, torch.long)).numpy()
    for row, lengths in enumerate(SEGMENTS):
        want = np.concatenate([np.arange(n) for n in (*lengths, T - sum(lengths))])
        np.testing.assert_array_equal(pos[row], want)


@pytest.mark.parametrize("impl", ["einsum", "dpa"])
def test_torch_packed_forward_matches_jax_and_each_example(impl):
    jm, tm = pair(impl)
    ids, mask, seg, _ = packed_batch()
    want = np.asarray(jm(jnp.array(ids), attention_mask=jnp.array(mask),
                         segment_ids=jnp.array(seg)))
    with torch.no_grad():
        got = to_numpy(tm(to_torch(ids, torch.long), attention_mask=to_torch(mask, torch.long),
                          segment_ids=to_torch(seg, torch.long)))
        np.testing.assert_allclose(got, want, **MODEL)
        for row, lengths in enumerate(SEGMENTS):
            pos = 0
            for n in lengths:
                alone = to_numpy(tm(to_torch(ids[row:row + 1, pos:pos + n], torch.long)))
                np.testing.assert_allclose(got[row, pos:pos + n], alone[0], **ALONE)
                pos += n
        # without segment ids the examples attend across the seams
        unpacked = to_numpy(tm(to_torch(ids, torch.long),
                               attention_mask=to_torch(mask, torch.long)))
    assert np.abs(unpacked[0, 7:18] - got[0, 7:18]).max() > 1e-3


@pytest.mark.parametrize("impl", ["einsum", "dpa"])
def test_torch_packed_loss_and_gradients_match_jax(impl):
    jm, tm = pair(impl, seed=2)
    ids, mask, seg, labels = packed_batch(seed=3)
    jargs = [jnp.array(a) for a in (ids, labels, mask, seg)]

    def jloss(m):
        return m.training_loss(jargs[0], jargs[1], attention_mask=jargs[2],
                               segment_ids=jargs[3])

    want, jgrads = nnx.value_and_grad(jloss, argnums=nnx.DiffState(0, AdapterParam))(jm)
    jgrads = {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(v[...])
              for path, v in nnx.to_flat_state(jgrads)}
    t_ids, t_labels, t_mask, t_seg = (to_torch(a, torch.long) for a in (ids, labels, mask, seg))
    got = tm.training_loss(t_ids, t_labels, attention_mask=t_mask, segment_ids=t_seg)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **MODEL)
    assert len(jgrads) == 28
    for name, g in jgrads.items():
        np.testing.assert_allclose(to_numpy(tm.get_parameter(name).grad), g, **MODEL)


def test_torch_packing_refused_by_splash_and_decode():
    """Splash builds its own pure-causal mask and would attend across the
    seams: both models raise (JAX llama.py:283-288).  Decode over a cache
    never packs: the port raises there too."""
    ids, mask, seg, _ = packed_batch()
    jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(attention_impl="splash"),
                                  rngs=nnx.Rngs(0))
    with pytest.raises(ValueError, match="segment_ids"):
        jm(jnp.array(ids), attention_mask=jnp.array(mask), segment_ids=jnp.array(seg))
    tm = LlamaForCausalLM(LlamaConfig.tiny(attention_impl="splash"), device="cpu")
    t_ids, t_seg = to_torch(ids, torch.long), to_torch(seg, torch.long)
    with pytest.raises(ValueError, match="segment_ids"):
        tm(t_ids, segment_ids=t_seg)
    with pytest.raises(ValueError, match="segment_ids"):
        tm.training_loss(t_ids, t_ids, segment_ids=t_seg)
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    caches = init_caches(tm.config, len(ids), T, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="never packs"):
        tm(t_ids, attention_mask=to_torch(mask, torch.long), caches=caches, cache_index=0,
           segment_ids=t_seg)
