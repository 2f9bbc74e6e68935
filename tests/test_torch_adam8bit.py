"""The port's 8-bit AdamW (``training/adam8bit.py``) against the JAX
``adamw8bit`` on the CPU.

The codebooks bit for bit; a quantize-dequantize round trip with equal
codes and scales; five steps on the same gradients (ragged tensors, one
"embed" leaf with float32 moments, weight decay): the codes equal after
every step except where the block-normalised value lies within 4 float32
ulps of a codebook midpoint (where the frameworks' float32 sums may fall on
either side), the scales and float32 moments within 1e-6, and the
parameters within ``TOLERANCES["f32_op"]``; a linear's weight whose JAX
leaf is a ``kernel`` quantized in that leaf's layout, its codes and scales
equal; the set of leaves that keep float32 moments equal over the tiny
Llama and GPT-2 with every parameter trainable (the JAX predicate reads
``.../embedding``, the port's parameter names through
``adam8bit.jax_paths``).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.training import adam8bit as t8
from sparse_matrix_fine_tuning_torch.training import optim as topt
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu.training import adam8bit as j8

F32 = TOLERANCES["f32_op"]
SHAPES = {"layer.q_proj.blkdiag1": (4, 3, 70), "layer.q_proj.blkdiag2": (4, 70, 3),
          "tok_embeddings.weight": (50, 8), "head.bias": (5,), "head.weight": (300, 7)}
B1, B2, EPS, WD, LR = 0.9, 0.999, 1e-8, 0.01, 1e-2
ULPS = 4


def test_torch_adam8bit_codebooks_match_jax():
    assert t8.SIGNED_CB.dtype == t8.UNSIGNED_CB.dtype == np.float32
    assert np.array_equal(t8.SIGNED_CB, np.asarray(j8._SIGNED_CB))
    assert np.array_equal(t8.UNSIGNED_CB, np.asarray(j8._UNSIGNED_CB))
    assert len(t8.SIGNED_CB) == 255 and len(t8.UNSIGNED_CB) == 256
    assert t8.default_fp32_predicate("model/embed_tokens/embedding")
    assert not t8.default_fp32_predicate("lm_head/kernel")


@pytest.mark.parametrize("kind", ["m", "v"])
@pytest.mark.parametrize("shape", [(1000,), (4, 300), (256,)], ids=str)
def test_torch_adam8bit_quantize_matches_jax(kind, shape):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32) * np.float32(1e-3)
    x[..., :3] = 0.0
    if kind == "v":
        x = x * x
    jbook = j8._SIGNED_CB if kind == "m" else j8._UNSIGNED_CB
    jq, js = j8._quantize(jnp.array(x), jbook)
    book = t8._Codebook(t8.SIGNED_CB if kind == "m" else t8.UNSIGNED_CB, torch.device("cpu"))
    q, s = t8.quantize(to_torch(x), book)
    assert q.dtype == torch.uint8 and s.dtype == torch.float32
    assert q.shape == (-(-x.size // 256), 256) and s.shape == (q.shape[0], 1)
    assert np.array_equal(q.numpy(), np.asarray(jq)) and np.array_equal(s.numpy(), np.asarray(js))
    back = t8.dequantize(q, s, book, torch.Size(shape))
    assert np.array_equal(back.numpy(), np.asarray(j8._dequantize(jq, js, jbook, shape)))


def _grads(step: int) -> dict:
    rng = np.random.default_rng(100 + step)
    return {k: (rng.standard_normal(v) * 10.0 ** rng.integers(-3, 1)).astype(np.float32)
            for k, v in SHAPES.items()}


def _near_midpoint(y: np.ndarray, book: np.ndarray) -> np.ndarray:
    """Whether each of ``y`` lies within ``ULPS`` float32 ulps of a midpoint."""
    mids = (book[1:] + book[:-1]) / 2
    dist = np.abs(y[..., None] - mids).min(-1)
    return dist <= ULPS * np.spacing(np.abs(y).astype(np.float32))


def _normalised(moment: np.ndarray) -> np.ndarray:
    """The block-normalised values that ``_quantize`` codes."""
    flat = moment.reshape(-1)
    blocks = np.pad(flat, (0, -flat.size % 256)).reshape(-1, 256)
    return blocks / np.maximum(np.abs(blocks).max(1, keepdims=True), np.float32(1e-30))


def _jax_moments(state, key, g, shape):
    """The float32 m and v that the JAX step makes from its previous state."""
    rec = state[0].moments[key]
    m = np.asarray(j8._dequantize(rec["mq"], rec["ms"], j8._SIGNED_CB, shape))
    v = np.asarray(j8._dequantize(rec["vq"], rec["vs"], j8._UNSIGNED_CB, shape))
    m = np.float32(B1) * m + np.float32(1.0 - B1) * g
    v = np.float32(B2) * v + np.float32(1.0 - B2) * g * g
    return m, v


def test_torch_adam8bit_five_steps_match_jax():
    params = {k: np.random.default_rng(7).standard_normal(v).astype(np.float32)
              for k, v in SHAPES.items()}
    jparams = {k.replace(".", "/"): jnp.array(v) for k, v in params.items()}
    tx = j8.adamw8bit(LR, b1=B1, b2=B2, eps=EPS, weight_decay=WD)
    state = tx.init(jparams)
    named = {k: to_torch(v).requires_grad_() for k, v in params.items()}
    opt = t8.AdamW8bit([{"params": list(named.values()),
                         "paths": [k.replace(".", "/").lower() for k in named]}],
                       lr=LR, betas=(B1, B2), eps=EPS, weight_decay=WD)
    fp32 = {k for k, p in named.items() if "m" in opt.state[p]}
    assert fp32 == {"tok_embeddings.weight"}
    assert {k.replace("/", ".") for k, rec in state[0].moments.items() if "m" in rec} == fp32
    flips = 0
    for step in range(5):
        grads = _grads(step)
        jgrads = {k.replace(".", "/"): jnp.array(v) for k, v in grads.items()}
        pre = {k: _jax_moments(state, k.replace(".", "/"), grads[k], SHAPES[k])
               for k in SHAPES if k not in fp32}
        updates, state = tx.update(jgrads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in named.items():
            p.grad = to_torch(grads[k])
        opt.step()
        for k, p in named.items():
            got, want = opt.state[p], state[0].moments[k.replace(".", "/")]
            assert int(got["count"]) == step + 1
            if k in fp32:
                for mk in ("m", "v"):
                    np.testing.assert_allclose(to_numpy(got[mk]), np.asarray(want[mk]),
                                               rtol=1e-6, atol=0, err_msg=f"{k} {mk}")
                continue
            for mk, book, value in (("m", t8.SIGNED_CB, pre[k][0]),
                                    ("v", t8.UNSIGNED_CB, pre[k][1])):
                codes, jcodes = got[f"{mk}q"].numpy(), np.asarray(want[f"{mk}q"])
                differ = codes != jcodes
                assert np.all(_near_midpoint(_normalised(value)[differ], book)), (k, mk, step)
                flips += int(differ.sum())
                np.testing.assert_allclose(got[f"{mk}s"].numpy(), np.asarray(want[f"{mk}s"]),
                                           rtol=1e-6, atol=0, err_msg=f"{k} {mk} scales")
    assert flips <= 8
    for k, p in named.items():
        np.testing.assert_allclose(to_numpy(p), np.asarray(jparams[k.replace(".", "/")]), **F32,
                                   err_msg=k)


def _jax_moments_of(model) -> dict:
    return j8.scale_by_adam8bit().init(nnx.state(model, nnx.Param)).moments


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_torch_adam8bit_fp32_leaves_match_jax(family):
    """Every parameter trainable: the leaves with float32 moments are the
    same in both packages (GPT-2's ``wte`` by the JAX ``embedding`` leaf,
    not by its name)."""
    if family == "llama":
        jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(), rngs=nnx.Rngs(0))
        tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    else:
        jm = jmodels.GPT2LMHeadModel(jmodels.GPT2Config.tiny(), rngs=nnx.Rngs(0))
        tm = GPT2LMHeadModel(GPT2Config.tiny(), device="cpu")
    moments = _jax_moments_of(jm)
    want = {k for k, rec in moments.items() if "m" in rec}
    named = list(tm.named_parameters())
    paths = t8.jax_paths(tm)
    opt = topt.GroupedAdamW(named, learning_rate=1e-3, total_steps=1, optim="adamw8bit",
                            jax_paths=paths)
    got = {paths[n] for n, p in named if "m" in opt.opt.state[p]}
    assert got == want and got
    assert sorted(paths.values()) == sorted(moments)


def test_torch_adam8bit_kernel_blocks_follow_jax():
    """A linear's weight (out, in) whose JAX leaf is ``.../kernel`` (in, out):
    its codes and scales are the JAX leaf's blocks, and it moves alike."""
    rng = np.random.default_rng(3)
    kernel = rng.standard_normal((300, 7)).astype(np.float32)  # (in, out)
    tx = j8.adamw8bit(LR, b1=B1, b2=B2, eps=EPS, weight_decay=WD)
    jparams = {"lin": {"kernel": jnp.array(kernel)}}
    state = tx.init(jparams)
    weight = to_torch(kernel.T.copy()).requires_grad_()
    opt = t8.AdamW8bit([{"params": [weight], "paths": ["lin/kernel"]}], lr=LR, betas=(B1, B2),
                       eps=EPS, weight_decay=WD)
    for step in range(2):
        g = (rng.standard_normal(kernel.shape) * 0.01).astype(np.float32)
        updates, state = tx.update({"lin": {"kernel": jnp.array(g)}}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        weight.grad = to_torch(g.T.copy())
        opt.step()
    want = state[0].moments["lin/kernel"]
    for key in ("mq", "ms", "vq", "vs"):
        assert np.array_equal(opt.state[weight][key].numpy(), np.asarray(want[key])), key
    np.testing.assert_allclose(to_numpy(weight).T, np.asarray(jparams["lin"]["kernel"]), **F32)
