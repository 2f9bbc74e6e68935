"""The port's ``quant`` module against the JAX package's on the CPU.

Quantizers are held bit for bit: the numpy host quantizers run the same
numpy code, and the torch device quantizers must give the bits of the JAX
ones as ``quantize_frozen_base`` runs them (jitted: XLA multiplies the
absmax by the f32 reciprocal of 127 or 7).  Dequantization is exact in
float32 and bit for bit in bfloat16 (one rounding of the same f32 value).
Layer and head outputs: float32, 1e-5 (``TOLERANCES["f32_op"]``).
``requantize_merge_adapters`` requantizes ``W + delta``, where the delta is
a float32 Monarch product summed in another order, so a code may land one
step apart where ``W + delta`` sits on a rounding boundary: codes within 1,
at most 1 in 1000 apart, scales within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch import quant as tq
from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear
from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import quant as jq
from sparse_matrix_fine_tuning_tpu.layers import monarch_linear as jml
from sparse_matrix_fine_tuning_tpu.layers.monarch_linear import AdapterParam

F32 = TOLERANCES["f32_op"]


def _w(shape, seed=0, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def flat_state(module) -> dict:
    """{path: numpy copy} of an NNX module's parameters and quantization scales."""
    state = nnx.state(module, nnx.Any(nnx.Param, jq.QuantScales))
    return {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(state)}


def layer_pair(bits, in_f=128, out_f=96, group=64, seed=0):
    """A JAX MonarchLinear with random nonzero factors, quantized, and the
    port's layer quantized the same way with the JAX state loaded into it."""
    jl = jml.MonarchLinear(in_f, out_f, weights=jnp.array(_w((out_f, in_f), seed)),
                           rngs=nnx.Rngs(seed))
    rng = np.random.default_rng(seed + 1)
    for _, v in nnx.to_flat_state(nnx.state(jl, AdapterParam)):
        v.set_value(jnp.array(rng.normal(0.0, 0.05, v[...].shape).astype(np.float32)))
    assert jq.quantize_frozen_base(jl, bits=bits, group_size=group) == 1
    tl = MonarchLinear(in_f, out_f, weights=torch.zeros(out_f, in_f), device="cpu")
    assert tq.quantize_frozen_base(tl, bits=bits, group_size=group) == 1
    assert (tl.quant_bits, tl.quant_group) == (jl.quant_bits, jl.quant_group)
    load_jax_state(tl, flat_state(jl))
    return jl, tl


@pytest.mark.parametrize("shape", [(16, 64), (96, 256), (40, 480)])
def test_torch_host_quantizers_bit_identical(shape):
    w = _w(shape, seed=shape[0], scale=1.0)
    for got, want in zip(tq.quantize_int8(w), jq.quantize_int8(w)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    group = 60 if shape[1] == 480 else 32
    for got, want in zip(tq.quantize_int4(w, group), jq.quantize_int4(w, group)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="multiple of 64"):
        tq.quantize_int4(_w((8, 96)), 64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_device_quantizers_bit_identical(seed):
    w = _w((96, 2560), seed, scale=float(np.random.default_rng(seed).uniform(0.01, 3.0)))
    got = tq._quantize_int8_device(to_torch(w))
    want = jq._quantize_int8_device(jnp.array(w))
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(x))
    got = tq._quantize_int4_device(to_torch(w), 64)
    want = jax.jit(jq._quantize_int4_device, static_argnums=(1,))(jnp.array(w), 64)
    for g, x in zip(got, want):
        assert g.dtype == torch.uint8 or g.dtype == torch.float32
        assert np.array_equal(g.numpy(), np.asarray(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_dequantize_matches_jax(dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    w = _w((96, 256), 3, scale=1.0)
    q8, s8 = jq.quantize_int8(w)
    got = tq.dequantize_int8(to_torch(q8), to_torch(s8), tdt)
    assert got.dtype == tdt and got.shape == (96, 256)
    assert np.array_equal(to_numpy(got), np.asarray(jq.dequantize_int8(q8, s8, jdt), np.float32))
    p4, s4 = jq.quantize_int4(w, 64)
    got = tq.dequantize_int4(to_torch(p4), to_torch(s4), 64, tdt)
    assert np.array_equal(to_numpy(got),
                          np.asarray(jq.dequantize_int4(jnp.array(p4), jnp.array(s4), 64, jdt),
                                     np.float32))
    for g, x in zip(tq.dequantize_int4_halves(to_torch(p4), to_torch(s4), 64, tdt),
                    jq.dequantize_int4_halves(jnp.array(p4), jnp.array(s4), 64, jdt)):
        assert np.array_equal(to_numpy(g), np.asarray(x, np.float32))
    for g, x in zip(tq.unpack_int4(to_torch(p4)), jq.unpack_int4(jnp.array(p4))):
        assert g.dtype == torch.int8 and np.array_equal(g.numpy(), np.asarray(x))


def test_torch_fit_group_matches_jax():
    for in_f, group in [(8640, 64), (480, 64), (4096, 64), (5632, 64), (97, 64), (134, 64),
                        (2048, 32)]:
        assert tq._fit_group(in_f, group) == jq._fit_group(in_f, group)
    assert tq._fit_group(8640, 64) == 60 and tq._fit_group(97, 64) is None


@pytest.mark.parametrize("impl", ["dequant", "w8a8"])
def test_torch_int8_lm_head_matches_jax(impl):
    from sparse_matrix_fine_tuning_tpu import models as jmodels

    jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(), rngs=nnx.Rngs(0))
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_jax_state(tm, flat_state(jm))
    assert jq.quantize_lm_head(jm, impl=impl) and tq.quantize_lm_head(tm, impl=impl)
    head = tm.lm_head
    assert isinstance(head, tq.Int8LMHead) and head.impl == impl
    assert [n for n, _ in head.named_parameters()] == []
    assert sorted(n for n, _ in head.named_buffers()) == ["kernel_q", "scales"]
    assert np.array_equal(head.kernel_q.numpy(), np.asarray(jm.lm_head.kernel_q[...]))
    assert np.array_equal(head.scales.numpy(), np.asarray(jm.lm_head.scales[...]))
    x = _w((3, 5, 64), 4, scale=1.0)
    want = np.asarray(jm.lm_head(jnp.array(x)))
    got = head(to_torch(x))
    np.testing.assert_allclose(to_numpy(got), want, **F32)
    ids = np.random.default_rng(5).integers(3, 256, (2, 7))
    np.testing.assert_allclose(to_numpy(tm(to_torch(ids, torch.long))),
                               np.asarray(jm(jnp.array(ids))), **TOLERANCES["f32_logits"])
    tied = LlamaForCausalLM(LlamaConfig.tiny(tie_word_embeddings=True), device="cpu")
    assert not tq.quantize_lm_head(tied) and tied.lm_head is None


@pytest.mark.parametrize("bits", [8, 4])
def test_torch_requantize_merge_matches_jax(bits):
    jl, tl = layer_pair(bits, seed=6)
    assert jq.requantize_merge_adapters(jl) == tq.requantize_merge_adapters(tl) == 1
    assert tl.merged and jl.merged
    codes, want = tl.dense.numpy().astype(np.int32), np.asarray(jl.dense[...]).astype(np.int32)
    if bits == 4:  # compare the nibbles
        codes = np.concatenate([codes & 15, codes >> 4])
        want = np.concatenate([want & 15, want >> 4])
    assert np.abs(codes - want).max() <= 1 and np.mean(codes != want) <= 1e-3
    np.testing.assert_allclose(tl.dense_scales.numpy(), np.asarray(jl.dense_scales[...]),
                               rtol=1e-6, atol=0)
    # the merged layer adds no adapter: its output is the requantized base alone
    x = _w((4, 128), 7, scale=1.0)
    with torch.no_grad():
        got, base = tl(to_torch(x)), tl._dense_forward(to_torch(x))
    assert torch.equal(got, base)
    assert tq.requantize_merge_adapters(tl) == 0  # already merged


def test_torch_enable_w8a8_serving_matches_jax():
    jl, tl = layer_pair(8, seed=8)
    assert jq.enable_w8a8_serving(jl) == tq.enable_w8a8_serving(tl) == 1
    x = _w((2, 3, 128), 9, scale=1.0)
    with torch.no_grad():
        got = tl(to_torch(x))
    np.testing.assert_allclose(to_numpy(got), np.asarray(jl(jnp.array(x))), **F32)
    _, t4 = layer_pair(4, seed=8)
    assert tq.enable_w8a8_serving(t4) == 0 and not t4.serve_w8a8


@pytest.mark.parametrize("bits", [8, 4])
def test_torch_merge_on_quantized_base_raises(bits):
    _, tl = layer_pair(bits)
    with pytest.raises(ValueError, match="quantized base"):
        tl.merge_adapter()
    with pytest.raises(ValueError, match="quantized base"):
        surgery.merge_all_adapters(tl)
    assert not tl.can_merge_train()
    with pytest.raises(ValueError):
        tl.enable_merged_training()


@pytest.mark.parametrize("bits", [8, 4])
def test_torch_dtype_cast_keeps_codes_and_scales(bits):
    """``.to(torch.bfloat16)`` casts the factors and leaves the codes and the
    f32 scales bit for bit, on a layer, a head and a model; a device move
    keeps them too."""
    _, tl = layer_pair(bits)
    codes, scales = tl.dense.clone(), tl.dense_scales.clone()
    tl.to(torch.bfloat16)
    assert tl.blkdiag1.dtype == torch.bfloat16
    assert tl.dense.dtype == codes.dtype and torch.equal(tl.dense, codes)
    assert tl.dense_scales.dtype == torch.float32 and torch.equal(tl.dense_scales, scales)
    tl.to("cpu").half().float()
    assert torch.equal(tl.dense_scales, scales) and torch.equal(tl.dense, codes)

    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    surgery.init_monarch(tm, {"nblocks": 4, "blk_r": 4, "target_modules": ["q_proj"]})
    assert tq.quantize_frozen_base(tm, bits=bits, group_size=16) == 2
    assert tq.quantize_lm_head(tm)
    before = {k: v.clone() for k, v in tm.state_dict().items()
              if "dense" in k or "lm_head" in k}
    tm.to(torch.bfloat16)
    for k, v in tm.state_dict().items():
        if k in before:
            assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k


def test_torch_quantize_frozen_base_counts_and_skips():
    """Every adapted linear is quantized once; a layer whose in_features has
    no halves-compatible group stays float under int4, as in JAX."""
    odd = MonarchLinear(134, 16, weights=torch.randn(16, 134), device="cpu")  # half 67, prime
    assert tq.quantize_frozen_base(odd, bits=4) == 0 and odd.quant_bits == 0
    assert odd.dense.dtype == torch.float32 and odd.dense_scales is None
    jodd = jml.MonarchLinear(134, 16, weights=jnp.ones((16, 134)), rngs=nnx.Rngs(0))
    assert jq.quantize_frozen_base(jodd, bits=4) == 0
    layer = MonarchLinear(480, 32, weights=torch.randn(32, 480), device="cpu")
    assert tq.quantize_frozen_base(layer, bits=4) == 1 and layer.quant_group == 60
    assert tuple(layer.dense.shape) == (240, 32) and layer.dense.dtype == torch.uint8
    assert tuple(layer.dense_scales.shape) == (8, 32)
    assert tq.quantize_frozen_base(layer, bits=8) == 0  # already quantized
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_frozen_base(layer, bits=2)
