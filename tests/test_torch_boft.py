"""The port's BOFT baseline (``peft/boft.py``) against the JAX package's on
the CPU: the Cayley transform, the butterfly permutations bit for bit,
``BOFTLinear``'s output and every gradient (``boft_R``, ``boft_s``, the
trainable bias, the input) at 1, 2 and 4 butterfly factors in float32 and
bfloat16, ``init_boft`` on the tiny RoBERTa under each bias mode (the
trainable names, the logits and ``param_stats`` against JAX's), and the
multiplicative dropout by its law.

Inputs come from seeded numpy generators; ``boft_R`` is set to random
nonzero values so that the rotations are not the identity, and the port's
layers take the JAX ones' parameters through ``utils/jax_bridge``.  Dropout
is 0 wherever the two are compared (the frameworks draw other masks).
Tolerances: float32 ``TOLERANCES["f32_logits"]`` (1e-4: a solve and two
products in another order); bfloat16 outputs two ulps of their scale
(``bf16_atol``) and gradients 2**-4 of their largest element, as the
encoders' tests hold them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sparse_matrix_fine_tuning_torch.models.config import RobertaConfig
from sparse_matrix_fine_tuning_torch.models.roberta import RobertaForSequenceClassification
from sparse_matrix_fine_tuning_torch.peft import boft as tboft
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import _port_name, load_jax_state
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, bf16_atol, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import models as jmodels
from sparse_matrix_fine_tuning_tpu import peft as jpeft
from sparse_matrix_fine_tuning_tpu.peft import boft as jboft

LOGITS = TOLERANCES["f32_logits"]
BF16_GRAD_SHARE = 2.0 ** -4
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def flat_params(module) -> dict:
    return {tuple(getattr(p, "key", p) for p in path): np.array(v[...])
            for path, v in nnx.to_flat_state(nnx.state(module, nnx.Param))}


def test_torch_cayley_matches_jax():
    R = np.random.default_rng(0).standard_normal((2, 3, 6, 6)).astype(np.float32)
    got = tboft.cayley(to_torch(R))
    np.testing.assert_allclose(to_numpy(got), np.asarray(jboft.cayley(jnp.array(R))),
                               **TOLERANCES["f32_op"])
    eye = np.broadcast_to(np.eye(6, dtype=np.float32), got.shape)
    np.testing.assert_allclose(to_numpy(got @ got.transpose(-1, -2)), eye, atol=1e-5)
    assert torch.equal(tboft.cayley(torch.zeros(2, 4, 4)), torch.eye(4).expand(2, 4, 4))


@pytest.mark.parametrize("n,b,r,f", [(32, 4, 4, 1), (32, 2, 4, 1), (64, 16, 2, 3),
                                     (64, 4, 2, 3), (1024, 128, 4, 1), (48, 6, 4, 0)])
def test_torch_butterfly_perm_matches_jax(n, b, r, f):
    assert tboft._butterfly_perm(n, b, r, f) == jboft._butterfly_perm(n, b, r, f)
    with pytest.raises(ValueError):
        tboft._butterfly_perm(16, 8, 2, 1)


def layer_pair(factors: int, seed: int = 0, bias_mode: str = "boft_only"):
    n_in, n_out, size = 64, 48, 4
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_out, n_in)) / 8).astype(np.float32)
    bias = rng.standard_normal(n_out).astype(np.float32)
    jl = jboft.BOFTLinear(n_in, n_out, weights=jnp.array(w), bias=jnp.array(bias),
                          block_size=size, n_butterfly_factor=factors, bias_mode=bias_mode,
                          rngs=nnx.Rngs(0))
    jl.boft_R.set_value(jnp.array(rng.normal(0, 0.5, jl.boft_R[...].shape), jnp.float32))
    jl.boft_s.set_value(jnp.array(rng.normal(1, 0.2, n_out), jnp.float32))
    tl = tboft.BOFTLinear(n_in, n_out, weights=to_torch(w), bias=to_torch(bias),
                          block_size=size, n_butterfly_factor=factors, bias_mode=bias_mode)
    load_jax_state(tl, flat_params(jl))
    return jl, tl, rng.standard_normal((3, 5, n_in)).astype(np.float32)


@pytest.mark.parametrize("factors", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_boft_linear_output_and_grads_match_jax(factors, dtype):
    jl, tl, x = layer_pair(factors)
    bf16 = dtype == "bfloat16"
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    g = np.random.default_rng(1).standard_normal((3, 5, 48)).astype(np.float32)
    xj = jnp.array(x).astype(jdt)
    xt = to_torch(x).to(tdt).requires_grad_(True)
    assert surgery.trainable_filter(tl, ()) == ["bias", "boft_R", "boft_s"]
    out = tl(xt)
    want = np.asarray(jl(xj).astype(jnp.float32))
    assert out.dtype == tdt
    if bf16:
        np.testing.assert_allclose(to_numpy(out), want, rtol=0, atol=bf16_atol(want))
    else:
        np.testing.assert_allclose(to_numpy(out), want, **LOGITS)

    def loss(model, xin):
        return jnp.sum(model(xin).astype(jnp.float32) * jnp.array(g))

    grads, dx = nnx.grad(loss, argnums=(nnx.DiffState(0, jpeft.trainable_filter(())), 1))(
        jl, xj)
    (out.float() * to_torch(g)).sum().backward()
    pairs = [(tl.boft_R.grad, grads.boft_R[...]), (tl.boft_s.grad, grads.boft_s[...]),
             (tl.bias.grad, grads.bias[...]), (xt.grad, dx)]
    for got_g, want_g in pairs:
        want_g = np.asarray(want_g, np.float32)
        share = BF16_GRAD_SHARE if bf16 else LOGITS["atol"]
        np.testing.assert_allclose(to_numpy(got_g), want_g, rtol=0,
                                   atol=max(float(np.abs(want_g).max()) * share, 1e-7))
    assert tl.dense.grad is None


def test_torch_boft_linear_checks_its_blocks_as_jax():
    w = torch.zeros(8, 24)
    for kw in (dict(block_size=8, block_num=3), dict(), dict(block_size=5),
               dict(block_size=3, n_butterfly_factor=2), dict(block_num=3, n_butterfly_factor=2)):
        with pytest.raises(ValueError):
            tboft.BOFTLinear(24, 8, weights=w, **kw)
        with pytest.raises(AssertionError):
            jboft.BOFTLinear(24, 8, weights=jnp.zeros((8, 24)), rngs=nnx.Rngs(0), **kw)
    layer = tboft.BOFTLinear(24, 8, weights=w, block_num=3)
    assert (layer.block_size, layer.n_blocks, layer.n_factors) == (8, 3, 1)


def test_torch_boft_dropout_follows_its_law():
    """In ``train()`` exactly int(p * D) blocks of one factor are the
    identity; in ``eval()`` none, and the output is the undropped one.  One
    seed draws the same masks again."""
    _, tl, x = layer_pair(2, seed=3)
    tl.dropout_p = 0.3
    Q = tboft.cayley(tl.boft_R.detach())
    eye = torch.eye(4)
    for _ in range(5):
        dropped = tl.train()._dropped(Q, None)
        is_eye = torch.tensor([[torch.equal(b, eye) for b in f] for f in dropped])
        changed = (dropped != Q).flatten(2).any(-1)
        assert int(is_eye.sum()) == int(0.3 * 16) == int(changed.sum())
        assert int(changed.any(-1).sum()) == 1
    assert torch.equal(tl.eval()._dropped(Q, None), Q)
    assert torch.equal(tl.train()._dropped(Q, True), Q)
    with torch.no_grad():
        kept = tl.eval()(to_torch(x))
        tl.dropout_p = 0.0
        assert torch.equal(tl.train()(to_torch(x)), kept)
    a, b = (tboft.BOFTLinear(32, 8, weights=torch.ones(8, 32), block_size=4, dropout=0.5,
                             generator=torch.Generator().manual_seed(9)) for _ in range(2))
    assert torch.equal(a._dropped(Q[:1, :8], False), b._dropped(Q[:1, :8], False))


PEFT = {"monarch": False, "boft": True, "boft_block_size": 8, "boft_block_num": 0,
        "boft_n_butterfly_factor": 2, "boft_dropout": 0.0,
        "target_modules": ["query", "value", "key"]}


@pytest.mark.parametrize("bias", ["none", "boft_only", "all"])
def test_torch_init_boft_on_the_encoder_matches_jax(bias):
    """The adapted names, the trainable names (JAX's filter, its paths in the
    port's names), the logits with random rotations, and ``param_stats``'s
    counts: the trainable equal, the total JAX's less its random state
    (the dropouts' and the BOFT layers', ROADMAP C.14)."""
    peft = dict(PEFT, bias=bias, boft_dropout=0.1)
    jm = jmodels.RobertaForSequenceClassification(jmodels.RobertaConfig.tiny(**NO_DROPOUT),
                                                  rngs=nnx.Rngs(0))
    tm = RobertaForSequenceClassification(RobertaConfig.tiny(**NO_DROPOUT), device="cpu")
    assert jpeft.init_boft(jm, peft, rngs=nnx.Rngs(1)) == tboft.init_boft(tm, peft)
    rng = np.random.default_rng(2)
    for path, v in nnx.to_flat_state(nnx.state(jm, nnx.Param)):
        if path[-1] == "boft_R":
            v.set_value(jnp.array(rng.normal(0, 0.3, v[...].shape), jnp.float32))
    load_jax_state(tm, flat_params(jm))
    want = {_port_name(tuple(getattr(p, "key", p) for p in path))[0]
            for path, _ in nnx.to_flat_state(nnx.state(jm, jpeft.trainable_filter()))}
    assert set(surgery.trainable_filter(tm)) == want
    n_bias = sum(1 for n in want if n.endswith(".bias"))
    assert n_bias == {"none": 2, "boft_only": 2 + 6, "all": len(
        [n for n, _ in tm.named_parameters() if n.endswith("bias")])}[bias]
    rng_elements = sum(v[...].size for _, v in nnx.to_flat_state(nnx.state(jm, nnx.RngState)))
    total, trainable = surgery.param_stats(tm, verbose=False)
    j_total, j_trainable = jpeft.param_stats(jm, verbose=False)
    assert trainable == j_trainable and total == j_total - rng_elements
    ids = rng.integers(3, 128, (2, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    with torch.no_grad():
        got = tm.eval()(to_torch(ids, torch.long), to_torch(mask, torch.long))
    jm.eval()
    np.testing.assert_allclose(to_numpy(got), np.asarray(jm(jnp.array(ids), jnp.array(mask))),
                               **LOGITS)
    assert jax.tree.leaves(nnx.state(jm, nnx.Param))  # the JAX model kept its state
