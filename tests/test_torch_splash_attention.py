"""The port's splash attention (``models/llama._splash_attention``, on the CPU
the plain versions of K17-K19 in ``ops/attention.py`` behind the autograd
Function of ``kernels/attention_cuda.py``) against the JAX model's
``_splash_attention``, whose splash-attention Pallas kernels run here in
interpret mode: the output and, through ``jax.vjp`` against torch autograd,
dq, dk and dv.  Then the plain versions against a direct fp32 softmax at a
ragged t, and the kernels' wrappers refusing CPU tensors.

The JAX function needs t % 128 == 0 (splash's blocks).  It builds its
kernel through ``splash_attention_kernel.make_splash_mha``, imported inside
the function, so the test patches that name with ``interpret=True`` and the
JAX package is run unchanged.

Tolerances: float32 1e-5 (TOLERANCES["f32_op"]; fp32 sums in another order,
splash's online softmax against one pass); bfloat16 two ulps of each
output's scale (``bf16_atol``): both sides round the output once, and ds
(and the dkv kernel's p) to bf16 before their products.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.splash_attention import splash_attention_kernel as sk

from sparse_matrix_fine_tuning_torch.kernels import attention_cuda
from sparse_matrix_fine_tuning_torch.models.llama import _splash_attention
from sparse_matrix_fine_tuning_torch.ops import attention as attn_ref
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, bf16_atol, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu.models.llama import _splash_attention as jax_splash

F32 = TOLERANCES["f32_op"]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(sk, "make_splash_mha",
                        functools.partial(sk.make_splash_mha, interpret=True))


def _qkv(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 128, 4, 16), (1, 256, 4, 64)])
def test_torch_splash_attention_matches_jax(interpret, shape, dtype):
    q, k, v, cot = _qkv(shape, seed=sum(shape))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jin = [jnp.asarray(a, jdt) for a in (q, k, v)]
    want, vjp = jax.vjp(jax_splash, *jin)
    wgrads = vjp(jnp.asarray(cot, jdt))
    tin = [to_torch(a, tdt).requires_grad_() for a in (q, k, v)]
    got = _splash_attention(*tin)
    grads = torch.autograd.grad(got, tin, to_torch(cot, tdt))
    for g, w in ((got, want), *zip(grads, wgrads)):
        assert g.dtype == tdt and tuple(g.shape) == w.shape
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(to_numpy(g), w, **F32)
        else:
            np.testing.assert_allclose(to_numpy(g), w, rtol=0, atol=bf16_atol(w))


def _direct(q, k, v):
    """softmax(q k^T, causal) v in fp32, and the logsumexp (b, h, t)."""
    t = q.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q, k)
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v), torch.logsumexp(s, -1)


@pytest.mark.parametrize("t", [1, 37])
def test_torch_attention_plain_versions_match_direct_softmax(t):
    """K17-K19's plain versions in fp32 at a ragged t: o and lse against a
    direct softmax, dq/dk/dv (from di = rowsum(o dout)) against autograd of
    it, and the Function's CPU path against both."""
    q, k, v, cot = (to_torch(a) for a in _qkv((2, t, 3, 8), seed=t))
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    want, want_lse = _direct(*leaves)
    wgrads = torch.autograd.grad(want, leaves, cot)
    o, lse = attn_ref.causal_attention_reference(q, k, v)
    di = attn_ref.attention_di(o, cot)
    got = (o, lse, attn_ref.attention_dq_reference(q, k, v, cot, lse, di),
           *attn_ref.attention_dkv_reference(q, k, v, cot, lse, di))
    for g, w in zip(got, (want, want_lse, *wgrads)):
        np.testing.assert_allclose(to_numpy(g), to_numpy(w), **F32)
    fn_leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    out = attention_cuda.splash_attention(*fn_leaves)
    fgrads = torch.autograd.grad(out, fn_leaves, cot)
    for g, w in zip((out, *fgrads), (want, *wgrads)):
        np.testing.assert_allclose(to_numpy(g), to_numpy(w), **F32)


def test_torch_attention_plain_versions_round_as_the_kernels():
    """In bf16 the plain dq rounds ds to bf16 before ds k, and dk/dv round
    ds and p: they equal the fp32 formulas fed the rounded terms."""
    q, k, v, cot = (to_torch(a, torch.bfloat16) for a in _qkv((1, 20, 2, 8), seed=3))
    o, lse = attn_ref.causal_attention_reference(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    di = attn_ref.attention_di(o, cot)
    p = torch.exp(attn_ref._scores(q, k) - lse[..., None])
    ds = p * (torch.einsum("bthd,bshd->bhts", cot.float(), v.float()) - di[..., None])
    dq = attn_ref.attention_dq_reference(q, k, v, cot, lse, di)
    dk, dv = attn_ref.attention_dkv_reference(q, k, v, cot, lse, di)
    rb = lambda a: a.bfloat16().float()  # noqa: E731
    torch.testing.assert_close(
        dq, torch.einsum("bhts,bshd->bthd", rb(ds), k.float()).bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(
        dk, torch.einsum("bhts,bthd->bshd", rb(ds), q.float()).bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(
        dv, torch.einsum("bhts,bthd->bshd", rb(p), cot.float()).bfloat16(), rtol=0, atol=0)


def test_torch_attention_kernels_refuse_cpu_tensors():
    """K17-K19's wrappers raise on CPU tensors and launch (and build)
    nothing; the dispatch sends CPU tensors to the plain versions."""
    from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda

    q, k, v, cot = (to_torch(a) for a in _qkv((1, 8, 2, 64), seed=4))
    lse, di = torch.zeros(1, 2, 8), torch.zeros(1, 2, 8)
    before = dict(attention_cuda.LAUNCHES)
    for call in (lambda: attention_cuda.splash_fwd(q, k, v),
                 lambda: attention_cuda.splash_dq(q, k, v, cot, lse, di),
                 lambda: attention_cuda.splash_dkv(q, k, v, cot, lse, di)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert attention_cuda.LAUNCHES == before and monarch_cuda._ops is None
    with torch.no_grad():
        torch.testing.assert_close(attention_cuda.splash_attention(q, k, v),
                                   attn_ref.causal_attention_reference(q, k, v)[0],
                                   rtol=0, atol=0)
    assert attention_cuda.LAUNCHES == before
