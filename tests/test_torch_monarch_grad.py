"""Gradients of the port's Monarch ops and the plain versions of the backward
kernels K3 and K4, held against the JAX package on the CPU.

The JAX side takes ``jax.grad`` of the XLA path (``ops/monarch.py``) and of
the Pallas kernels ``monarch_kernel``/``monarch_add`` in interpret mode, and
runs ``monarch_dw_fused(..., interpret=True)``, as
tests/kernels/test_monarch_pallas.py runs them.  Inputs come from numpy;
the cases include ragged row counts and L != K.

Tolerances (utils/testing.TOLERANCES): float32 1e-5 relative and absolute
for one op (the frameworks sum in another order), 1e-4 where a gradient
sums over the rows of a Pallas tile grid; bfloat16 two ulps of the
output's scale (``bf16_atol``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda
from sparse_matrix_fine_tuning_torch.ops import activations as tact
from sparse_matrix_fine_tuning_torch.ops import blockdiag as tbd
from sparse_matrix_fine_tuning_torch.ops import monarch as tm
from sparse_matrix_fine_tuning_torch.utils.testing import (
    TOLERANCES,
    bf16_atol,
    to_numpy,
    to_torch,
)
from sparse_matrix_fine_tuning_tpu.kernels import monarch_pallas as jpallas
from sparse_matrix_fine_tuning_tpu.ops import activations as jact
from sparse_matrix_fine_tuning_tpu.ops import blockdiag as jbd
from sparse_matrix_fine_tuning_tpu.ops import monarch as jm

F32 = TOLERANCES["f32_op"]
F32_SUMS = TOLERANCES["f32_logits"]

# (batch, K, Q, P, L, S, R); the last two have L != K and ragged rows.
CASES = [
    (16, 4, 4, 32, 4, 32, 4),
    (65, 4, 8, 16, 4, 24, 8),
    (9, 4, 2, 16, 2, 12, 4),
    (33, 2, 6, 8, 3, 10, 4),
]


def _inputs(case, seed):
    batch, K, Q, P, L, S, R = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, K * P)).astype(np.float32)
    w1 = (rng.standard_normal((K, Q, P)) / np.sqrt(P)).astype(np.float32)
    w2 = (rng.standard_normal((L, S, R)) / np.sqrt(R)).astype(np.float32)
    dout = rng.standard_normal((batch, S * L)).astype(np.float32)
    base = rng.standard_normal((batch, S * L)).astype(np.float32)
    return x, w1, w2, dout, base


def _close(got: torch.Tensor, want, tol):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    if tol == "bf16":
        np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=bf16_atol(want))
    else:
        np.testing.assert_allclose(to_numpy(got), want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_torch_monarch_grads_match_jax_grad(case, dtype):
    """jax.grad of the XLA path against autograd of the port's Function."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x, w1, w2, dout, _ = _inputs(case, seed=1)
    jx, jw1, jw2, jd_out = (jnp.array(a, dtype=jd) for a in (x, w1, w2, dout))

    def loss(a, b, c):
        return jnp.sum(jm.blockdiag_butterfly_multiply(a, b, c).astype(jnp.float32)
                       * jd_out.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(jx, jw1, jw2)
    tx, tw1, tw2 = (to_torch(a, td).requires_grad_() for a in (x, w1, w2))
    out = tm.blockdiag_butterfly_multiply(tx, tw1, tw2)
    got = torch.autograd.grad(out, (tx, tw1, tw2), to_torch(dout, td))
    for g, w in zip(got, want):
        assert g.dtype == td
        _close(g, w, F32 if dtype == "float32" else "bf16")


@pytest.mark.parametrize("case", CASES)
def test_torch_monarch_dw_matches_jax(case):
    """monarch_dw: (dw1, dw2, dout1_kq), with and without the saved out1."""
    x, w1, w2, dout, _ = _inputs(case, seed=2)
    want = jm.monarch_dw(jnp.array(x), jnp.array(dout), jnp.array(w1), jnp.array(w2))
    tx, tw1, tw2 = to_torch(x), to_torch(w1), to_torch(w2)
    got = tm.monarch_dw(tx, to_torch(dout), tw1, tw2)
    for g, w in zip(got, want):
        _close(g, w, F32)
    out1 = tm._forward_with_out1(tx, tw1, tw2)[1]
    for g, w in zip(tm.monarch_dw(tx, to_torch(dout), tw1, tw2, out1=out1), want):
        _close(g, w, F32)


@pytest.mark.parametrize("case", CASES)
def test_torch_k3_plain_matches_pallas_grads(case):
    """The plain K3 against the gradients of the Pallas monarch_kernel (its
    backward kernel in interpret mode); dw come out in fp32."""
    x, w1, w2, dout, _ = _inputs(case, seed=3)
    jd_out = jnp.array(dout)
    want = jax.grad(lambda a, b, c: jnp.sum(jpallas.monarch_kernel(a, b, c, True) * jd_out),
                    argnums=(0, 1, 2))(jnp.array(x), jnp.array(w1), jnp.array(w2))
    got = monarch_cuda.monarch_bwd_reference(to_torch(x), to_torch(w1), to_torch(w2),
                                             to_torch(dout))
    assert got[1].dtype == got[2].dtype == torch.float32
    for g, w in zip(got, want):
        _close(g, w, F32_SUMS)


@pytest.mark.parametrize("case", CASES[:3])
def test_torch_k2_plain_grads_match_pallas(case):
    """Autograd of the plain K2 against the gradients of the Pallas
    monarch_add in interpret mode: d_base is dout, the rest is K3's."""
    x, w1, w2, dout, base = _inputs(case, seed=4)
    jd_out = jnp.array(dout)
    want = jax.grad(
        lambda b0, a, b, c: jnp.sum(jpallas.monarch_add(b0, a, b, c, True) * jd_out),
        argnums=(0, 1, 2, 3))(jnp.array(base), jnp.array(x), jnp.array(w1), jnp.array(w2))
    leaves = [to_torch(a).requires_grad_() for a in (base, x, w1, w2)]
    out = monarch_cuda.monarch_add_reference(*leaves)
    got = torch.autograd.grad(out, leaves, to_torch(dout))
    for g, w in zip(got, want):
        _close(g, w, F32_SUMS)


@pytest.mark.parametrize("case", CASES)
def test_torch_k4_plain_matches_pallas_dw_fused(case):
    x, w1, w2, dout, _ = _inputs(case, seed=5)
    want = jpallas.monarch_dw_fused(jnp.array(x), jnp.array(dout), jnp.array(w1),
                                    jnp.array(w2), interpret=True)
    got = monarch_cuda.monarch_dw_fused_reference(to_torch(x), to_torch(dout), to_torch(w1),
                                                  to_torch(w2))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, F32_SUMS)


def test_torch_monarch_dispatch_on_cpu_is_plain():
    """On the CPU the layer's dispatch takes the plain versions, with their
    plain backward, and launches nothing."""
    x, w1, w2, dout, _ = _inputs(CASES[2], seed=6)
    before = dict(monarch_cuda.LAUNCHES)
    tx, tw1, tw2 = (to_torch(a).requires_grad_() for a in (x, w1, w2))
    out = monarch_cuda.monarch_mm(tx, tw1, tw2)
    got = torch.autograd.grad(out, (tx, tw1, tw2), to_torch(dout))
    want = monarch_cuda.monarch_bwd_reference(to_torch(x), to_torch(w1), to_torch(w2),
                                              to_torch(dout))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w)
    dw = monarch_cuda.monarch_dw_any(to_torch(x), to_torch(dout), to_torch(w1), to_torch(w2))
    for g, w in zip(dw, want[1:]):
        torch.testing.assert_close(g, w)
    assert monarch_cuda.LAUNCHES == before


def test_torch_blockdiag_grad_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 24)).astype(np.float32)
    w = rng.standard_normal((3, 4, 8)).astype(np.float32)
    g = rng.standard_normal((5, 12)).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(jbd.blockdiag_multiply(a, b) * jnp.array(g)),
                    argnums=(0, 1))(jnp.array(x), jnp.array(w))
    tx, tw = to_torch(x).requires_grad_(), to_torch(w).requires_grad_()
    got = torch.autograd.grad(tbd.blockdiag_multiply(tx, tw), (tx, tw), to_torch(g))
    for a, b in zip(got, want):
        _close(a, b, F32)


@pytest.mark.parametrize("name", ["swiglu", "geglu"])
def test_torch_activation_grads_match_jax(name):
    """Autograd through the plain ops against the JAX hand-written VJPs."""
    rng = np.random.default_rng(8)
    a, b, g = (rng.standard_normal((6, 32)).astype(np.float32) * 3 for _ in range(3))
    want = jax.grad(lambda p, q: jnp.sum(getattr(jact, name)(p, q) * jnp.array(g)),
                    argnums=(0, 1))(jnp.array(a), jnp.array(b))
    ta, tb = to_torch(a).requires_grad_(), to_torch(b).requires_grad_()
    got = torch.autograd.grad(getattr(tact, name)(ta, tb), (ta, tb), to_torch(g))
    # The JAX VJP evaluates the derivative's formula, autograd chains the
    # forward's ops: they round apart where terms cancel, so the absolute
    # tolerance is 1e-5 of the gradient's scale.
    for x, y in zip(got, want):
        y = np.asarray(y)
        np.testing.assert_allclose(to_numpy(x), y, rtol=1e-5, atol=1e-5 * np.abs(y).max())


def test_torch_monarch_refuses_complex():
    """Only the plain ops take complex tensors: the CUDA kernels' wrappers
    refuse them here (a CPU tensor), and the layers' device dispatch sends a
    complex CPU input to the plain multiply, whose output is the einsum
    oracle's."""
    rng = np.random.default_rng(9)
    x, w1, w2 = (torch.from_numpy(_complex(rng, s)) for s in ((4, 16), (4, 2, 4), (2, 8, 4)))
    before = dict(monarch_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        monarch_cuda.monarch_kernel(x, w1, w2)
    with pytest.raises(ValueError, match="CUDA"):
        monarch_cuda.monarch_bwd(x, w1, w2, torch.zeros(4, 16, dtype=torch.complex64))
    got = monarch_cuda.monarch_mm(x, w1, w2)
    assert got.dtype == torch.complex64 and monarch_cuda.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(),
                               tm.blockdiag_butterfly_multiply_reference(x, w1, w2).numpy(), **F32)


def _complex(rng, shape) -> np.ndarray:
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


@pytest.mark.parametrize("dtype", ["float32", "complex64"])
@pytest.mark.parametrize("case", CASES)
def test_torch_complex_monarch_grads_match_jax(case, dtype):
    """JAX tests/ops/test_monarch.py:62-84 (float32 and complex64) on the
    port: the loss sum(Re(out * conj(cot))) through the fast path, against
    ``jax.grad`` of the JAX fast path.  For a real loss PyTorch's gradient
    of a complex tensor is the conjugate of ``jax.grad``'s, so the complex
    gradients are compared with ``conj`` of JAX's; real ones as they are.
    1e-4: the sums run over the batch in another order."""
    batch, K, Q, P, L, S, R = case
    rng = np.random.default_rng(batch)
    make = _complex if dtype == "complex64" else (
        lambda r, s: r.standard_normal(s).astype(np.float32))
    x, w1, w2, cot = (make(rng, s) for s in ((batch, K * P), (K, Q, P), (L, S, R),
                                              (batch, S * L)))

    def loss(a, b, c):
        return jnp.sum(jnp.real(jm.blockdiag_butterfly_multiply(a, b, c) * jnp.conj(cot)))

    want_out = jm.blockdiag_butterfly_multiply(jnp.array(x), jnp.array(w1), jnp.array(w2))
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.array(x), jnp.array(w1), jnp.array(w2))
    tx, tw1, tw2 = (torch.from_numpy(a).requires_grad_() for a in (x, w1, w2))
    out = tm.blockdiag_butterfly_multiply(tx, tw1, tw2)
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **F32)
    (out * torch.from_numpy(cot).conj()).real.sum().backward()
    for g, w in zip((tx.grad, tw1.grad, tw2.grad), want):
        np.testing.assert_allclose(g.numpy(), np.conj(np.asarray(w)), **F32_SUMS)


@pytest.mark.parametrize("case", CASES)
def test_torch_complex_monarch_dw_matches_jax(case):
    """``monarch_dw`` on complex64: the port's gradients for the conjugate
    cotangent are the conjugates of JAX's pure-transpose ones, dout1 too;
    ``monarch_forward_f32`` keeps complex64."""
    batch, K, Q, P, L, S, R = case
    rng = np.random.default_rng(batch + 1)
    x, w1, w2, dout = (_complex(rng, s) for s in ((batch, K * P), (K, Q, P), (L, S, R),
                                                   (batch, S * L)))
    want = jm.monarch_dw(jnp.array(x), jnp.array(dout), jnp.array(w1), jnp.array(w2))
    got = tm.monarch_dw(torch.from_numpy(x), torch.from_numpy(dout).conj(), torch.from_numpy(w1),
                        torch.from_numpy(w2))
    for g, w in zip(got, want):
        assert g.dtype == torch.complex64
        np.testing.assert_allclose(g.resolve_conj().numpy(), np.conj(np.asarray(w)), **F32_SUMS)
    f32 = tm.monarch_forward_f32(torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2))
    assert f32.dtype == torch.complex64
