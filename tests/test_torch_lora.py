"""The port's LoRA baseline (``peft/surgery.ScaledLoRA`` and ``init_lora``)
against the JAX package's on the CPU: the layer's output and the gradients
of A, B and the input on weights carried across (float32 and bfloat16, with
and without ``lora_alpha``), the laws of A's two inits, and ``init_lora``
on the tiny RoBERTa and the tiny Llama (the adapted and trainable names,
the logits, ``param_stats``, the loss's gradients).

Inputs come from seeded numpy generators; B is set to random nonzero values
(its init is zero, which would hide a broken branch).  A and B are drawn by
other RNGs in the two packages, so the inits are held by their laws and
everything else on bridged weights.  Tolerances: float32
``TOLERANCES["f32_logits"]`` (1e-4); bfloat16 outputs two ulps of their scale
(``bf16_atol``) and gradients 2**-4 of their largest element.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig, RobertaConfig
from sparse_matrix_fine_tuning_torch.models.llama import Linear, LlamaForCausalLM
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import _port_name, load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, bf16_atol, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu.peft.surgery import ScaledLoRA as JaxScaledLoRA

LOGITS = TOLERANCES["f32_logits"]
BF16_GRAD_SHARE = 2.0 ** -4


def flat_params(module) -> dict:
    return {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(nnx.state(module, nnx.Param))}


def set_b(module, rng) -> None:
    for path, v in nnx.to_flat_state(nnx.state(module, nnx.LoRAParam)):
        if path[-1] == "lora_b":
            v.set_value(jnp.array(rng.normal(0, 0.2, v[...].shape), jnp.float32))


def layer_pair(alpha, dtype, seed=0):
    rng = np.random.default_rng(seed)
    jdt = "bfloat16" if dtype == "bfloat16" else None
    base = nnx.Linear(48, 40, dtype=jdt, rngs=nnx.Rngs(0))
    jl = JaxScaledLoRA(48, 4, 40, base_module=base, alpha=alpha, rngs=nnx.Rngs(1))
    set_b(jl, rng)
    tbase = Linear(48, 40, True, dtype=getattr(torch, dtype) if jdt else None, device="cpu")
    tl = surgery.ScaledLoRA(48, 4, 40, base_module=tbase, alpha=alpha)
    load_jax_state(tl, flat_params(jl))
    return jl, tl, rng.standard_normal((3, 5, 48)).astype(np.float32)


@pytest.mark.parametrize("alpha", [None, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_scaled_lora_output_and_grads_match_jax(alpha, dtype):
    jl, tl, x = layer_pair(alpha, dtype)
    bf16 = dtype == "bfloat16"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    assert tl.scaling == (16 / 4 if alpha else 1.0)
    g = np.random.default_rng(1).standard_normal((3, 5, 40)).astype(np.float32)
    xj = jnp.array(x).astype(jdt)
    xt = to_torch(x).to(tdt).requires_grad_(True)
    assert surgery.trainable_filter(tl, ()) == ["lora_a", "lora_b"]
    out = tl(xt)
    want = np.asarray(jl(xj).astype(jnp.float32))
    assert out.dtype == tdt
    tol = dict(rtol=0, atol=bf16_atol(want)) if bf16 else LOGITS
    np.testing.assert_allclose(to_numpy(out), want, **tol)

    def loss(model, xin):
        return jnp.sum(model(xin).astype(jnp.float32) * jnp.array(g))

    grads, dx = nnx.grad(loss, argnums=(nnx.DiffState(0, nnx.LoRAParam), 1))(jl, xj)
    (out.float() * to_torch(g)).sum().backward()
    for got_g, want_g in [(tl.lora_a.grad, grads.lora_a[...]),
                          (tl.lora_b.grad, grads.lora_b[...]), (xt.grad, dx)]:
        want_g = np.asarray(want_g, np.float32)
        share = BF16_GRAD_SHARE if bf16 else LOGITS["atol"]
        np.testing.assert_allclose(to_numpy(got_g), want_g, rtol=0,
                                   atol=max(float(np.abs(want_g).max()) * share, 1e-7))
    assert tl.base_module.weight.grad is None


def test_torch_scaled_lora_init_laws_match_jax():
    """A: U(+-1/sqrt(in)) by default, N(0, (1/r)^2) for "gaussian", as JAX's
    draws (mean, std and bound over 65,536 entries); B zero; the dropout
    only on the branch's input, only in train()."""
    rng = nnx.Rngs(0)
    for init in (True, "gaussian"):
        jl = JaxScaledLoRA(1024, 64, 8, base_module=nnx.Linear(1024, 8, rngs=rng),
                           init_lora_weights=init, rngs=rng)
        tl = surgery.ScaledLoRA(1024, 64, 8, base_module=torch.nn.Linear(1024, 8),
                                init_lora_weights=init,
                                generator=torch.Generator().manual_seed(5))
        want, got = np.asarray(jl.lora_a[...]), to_numpy(tl.lora_a)
        law = 1 / 32 / np.sqrt(3) if init is True else 1 / 64
        for a in (want, got):
            assert abs(a.std() - law) < 0.02 * law and abs(a.mean()) < 0.02 * law
        if init is True:
            assert np.abs(got).max() <= 1 / 32 and np.abs(want).max() <= 1 / 32
        assert not to_numpy(tl.lora_b).any() and not np.asarray(jl.lora_b[...]).any()
    tl = surgery.ScaledLoRA(16, 2, 4, base_module=torch.nn.Linear(16, 4), dropout=0.5)
    with torch.no_grad():
        tl.lora_b.normal_()
        x = torch.randn(64, 16)
        base = tl.base_module(x)
        full = base + x @ tl.lora_a @ tl.lora_b
        assert torch.allclose(tl.eval()(x), full)
        assert not torch.allclose(tl.train()(x), full)


ROBERTA_PEFT = {"monarch": False, "target_modules": ["query", "key", "value"], "r": 8,
                "lora_alpha": 16, "init_lora_weights": "gaussian", "lora_dropout": 0.0}
LLAMA_PEFT = {"target_modules": ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                                 "up_proj", "down_proj"], "r": 4}


def model_pair(family: str):
    if family == "roberta":
        cfg = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        jm = jmodels.RobertaForSequenceClassification(jmodels.RobertaConfig.tiny(**cfg),
                                                      rngs=nnx.Rngs(0))
        tm = RobertaForSequenceClassification(RobertaConfig.tiny(**cfg), device="cpu")
        return jm, tm, ROBERTA_PEFT
    jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(), rngs=nnx.Rngs(0))
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    return jm, tm, LLAMA_PEFT


@pytest.mark.parametrize("family", ["roberta", "llama"])
def test_torch_init_lora_on_models_matches_jax(family):
    """The adapted names, the trainable names (JAX's filter), the parameter
    counts (JAX's total less its dropouts' random state, ROADMAP C.14), the
    logits and every trainable gradient of the loss."""
    jm, tm, peft = model_pair(family)
    assert surgery.init_lora(tm, peft) == jpeft.init_lora(jm, peft, rngs=nnx.Rngs(1))
    set_b(jm, np.random.default_rng(2))
    load_jax_state(tm, flat_params(jm))
    tm.eval()
    want = {_port_name(tuple(getattr(p, "key", p) for p in path))[0]
            for path, _ in nnx.to_flat_state(nnx.state(jm, jpeft.trainable_filter()))}
    names = surgery.trainable_filter(tm)
    assert set(names) == want
    assert sum(n.endswith(("lora_a", "lora_b")) for n in names) == 2 * len(
        [m for m in tm.modules() if isinstance(m, surgery.ScaledLoRA)]) > 0
    rng_elements = sum(v[...].size for _, v in nnx.to_flat_state(nnx.state(jm, nnx.RngState)))
    j_total, j_trainable = jpeft.param_stats(jm, verbose=False)
    assert surgery.param_stats(tm, verbose=False) == (j_total - rng_elements, j_trainable)
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 128, (2, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    if family == "roberta":
        labels = rng.integers(0, 2, 2).astype(np.int32)

        def jax_loss(model):
            return model.loss(model(jnp.array(ids), jnp.array(mask)), jnp.array(labels))

        logits = tm(to_torch(ids, torch.long), to_torch(mask, torch.long))
        loss = tm.loss(logits, to_torch(labels))
        want_logits = jm(jnp.array(ids), jnp.array(mask))
    else:
        def jax_loss(model):
            return model.training_loss(jnp.array(ids), jnp.array(ids),
                                       attention_mask=jnp.array(mask))

        logits = tm(to_torch(ids, torch.long), attention_mask=to_torch(mask, torch.long))
        loss = tm.training_loss(to_torch(ids, torch.long), to_torch(ids, torch.long),
                                attention_mask=to_torch(mask, torch.long))
        want_logits = jm(jnp.array(ids), attention_mask=jnp.array(mask))
    np.testing.assert_allclose(to_numpy(logits), np.asarray(want_logits), **LOGITS)
    np.testing.assert_allclose(loss.item(), float(jax_loss(jm)), **LOGITS)
    grads = nnx.grad(jax_loss, argnums=nnx.DiffState(0, jpeft.trainable_filter()))(jm)
    loss.backward()
    params = dict(tm.named_parameters())
    seen = set()
    for path, g in nnx.to_flat_state(grads):
        name, transpose = _port_name(tuple(getattr(p, "key", p) for p in path))
        want_g = np.asarray(g[...], np.float32)
        want_g = want_g.T if transpose else want_g
        np.testing.assert_allclose(to_numpy(params[name].grad), want_g, rtol=0,
                                   atol=max(float(np.abs(want_g).max()) * 1e-4, 1e-7),
                                   err_msg=name)
        seen.add(name)
    assert seen == set(names)
