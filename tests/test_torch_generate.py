"""The port's greedy ``generate`` against the JAX one on the CPU in float32:
left-padded prompts of different real lengths, with and without EOS.  The
tokens must be identical.  One JAX model serves the whole module (JAX
compiles its decode loop once per config).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.generate import GenerationConfig, generate
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import to_torch
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam
from sparse_matrix_fine_tuning_tpu.models import generate as jgen

PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj"]}
LENS = (12, 7, 4, 1)
NEW = 10


@pytest.fixture(scope="module")
def pair():
    jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(), rngs=nnx.Rngs(5))
    jpeft.init_monarch(jm, PEFT, rngs=nnx.Rngs(6))
    rng = np.random.default_rng(5)
    for _, v in nnx.to_flat_state(nnx.state(jm, AdapterParam)):
        v.set_value(jnp.array(rng.normal(0.0, 0.1, v[...].shape).astype(np.float32)))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny())
    init_monarch(tm, PEFT)
    load_jax_state(tm, {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
                        for path, v in nnx.to_flat_state(nnx.state(jm, nnx.Param))})
    return jm, tm.eval()


def prompts():
    rng = np.random.default_rng(7)
    t = max(LENS)
    ids = rng.integers(3, 256, (len(LENS), t)).astype(np.int32)
    mask = np.zeros_like(ids)
    for row, n in enumerate(LENS):
        mask[row, t - n:] = 1
    return ids * mask, mask


def both(pair, ids_mask=None, **cfg):
    jm, tm = pair
    ids, mask = prompts() if ids_mask is None else ids_mask
    want = np.asarray(jgen.generate(jm, jnp.array(ids), jnp.array(mask),
                                    jgen.GenerationConfig(max_new_tokens=NEW, **cfg)))
    got = generate(tm, to_torch(ids, torch.long), to_torch(mask, torch.long),
                   GenerationConfig(max_new_tokens=NEW, **cfg))
    return got.numpy(), want


def test_torch_greedy_matches_jax_without_eos(pair):
    got, want = both(pair, eos_token_id=None)
    assert got.shape == (len(LENS), max(LENS) + NEW)
    np.testing.assert_array_equal(got, want)


def test_torch_greedy_matches_jax_with_eos(pair):
    """EOS is the token row 0 emits at its third step, so that row finishes
    early and is padded after it, while the other rows go on."""
    free, _ = both(pair, eos_token_id=None)
    eos = int(free[0, max(LENS) + 2])
    got, want = both(pair, eos_token_id=eos, pad_token_id=0)
    np.testing.assert_array_equal(got, want)
    row = got[0, max(LENS):]
    first = int(np.argmax(row == eos))
    assert row[first] == eos and (row[first + 1:] == 0).all()


def test_torch_greedy_early_exit_when_all_rows_finish(pair):
    """Rows with the same prompt emit the same tokens; with EOS their second
    token, every row finishes at once and the loop stops, all pad after."""
    ids, mask = prompts()
    same = (np.repeat(ids[:1], 3, axis=0), np.repeat(mask[:1], 3, axis=0))
    free, _ = both(pair, same, eos_token_id=None)
    eos = int(free[0, max(LENS) + 1])
    got, want = both(pair, same, eos_token_id=eos, pad_token_id=0)
    np.testing.assert_array_equal(got, want)
    tail = got[:, max(LENS):]
    assert (tail[:, 1] == eos).all() and (tail[:, 2:] == 0).all()


@pytest.mark.parametrize("cfg", [{"num_beams": 4}, {"do_sample": True},
                                 {"repetition_penalty": 1.1}, {"no_repeat_ngram_size": 3}])
def test_torch_generate_refuses_unported_decoding(pair, cfg):
    _, tm = pair
    ids, mask = prompts()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        generate(tm, to_torch(ids, torch.long), to_torch(mask, torch.long),
                 GenerationConfig(**cfg))
