"""The plain versions of K7 and K8 (``int8_matmul_reference``,
``int8_matmul_dx_reference``), which the card holds the int8 wgmma kernel
(``kernels/csrc/quant_wgmma.cu`` ``qwgmma_rs_kernel``) against, held
against the JAX package on the CPU at that kernel's edge shapes.

Shapes: rows 17 (the first forward row count on the wgmma kernel), 65 and
200; in 960 and 1088, which its k stage of 64 divides (1000 and 1096,
which it does not, are ``tests/test_torch_kernels_cuda.py``'s card cases
and ``tests/test_torch_quant_decode.py``'s); out 272, no multiple of its
128-column tile, and 256 (two tiles: the forward's split reduction);
float32 and bfloat16; forward and dx.

Reference: the JAX Pallas kernel in interpret mode
(``int8_matmul(..., interpret=True)`` and ``jax.grad`` of it) where
``int8_matmul_supported`` takes the shape (out 256); elsewhere (out 272: no
multiple of 128) the JAX layer's int8 path
(``layers/monarch_linear.py:405-439``: ``dequantize_int8`` in the compute
dtype, then the dot with fp32 sums; dx the same dot against dy, as the
kernel's own fallback, ``kernels/quant_matmul.py:372-380``).  Tolerances:
``test_torch_quant_matmul._tol`` and its reasons.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_quant_matmul import _tol

from sparse_matrix_fine_tuning_torch.kernels import quant_cuda as qc
from sparse_matrix_fine_tuning_torch.utils.testing import to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu import quant as jq
from sparse_matrix_fine_tuning_tpu.kernels import quant_matmul as jqm

INS = (960, 1088)
OUTS = (272, 256)
ROWS = (17, 65, 200)
DTYPES = ("float32", "bfloat16")
CASES = [(n_in, n_out, rows, dtype) for n_in in INS for n_out in OUTS for rows in ROWS
         for dtype in DTYPES]


def _operands(n_in, n_out, rows):
    rng = np.random.default_rng(n_in + n_out + rows)
    w = (rng.standard_normal((n_out, n_in)) * 0.1).astype(np.float32)
    codes, scales = jq.quantize_int8(w)
    x = rng.standard_normal((rows, n_in)).astype(np.float32)
    dy = rng.standard_normal((rows, n_out)).astype(np.float32)
    return codes, scales, x, dy


def _jax_layer(x, dy, codes, scales, dtype):
    """The JAX layer's int8 path: W dequantized in the compute dtype, then
    the forward and its dx with fp32 sums."""
    # W (out, in)
    w = jq.dequantize_int8(jnp.asarray(codes), jnp.asarray(scales), getattr(jnp, dtype))
    hp = jax.lax.Precision.HIGHEST
    jx, jdy = jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(dy, getattr(jnp, dtype))
    y = jax.lax.dot_general(jx, w, (((1,), (1,)), ((), ())), precision=hp,
                            preferred_element_type=jnp.float32).astype(jx.dtype)
    dx = jax.lax.dot_general(jdy, w, (((1,), (0,)), ((), ())), precision=hp,
                             preferred_element_type=jnp.float32).astype(jdy.dtype)
    return np.asarray(y, np.float32), np.asarray(dx, np.float32)


def _jax_pallas(x, dy, codes, scales, dtype):
    """The JAX Pallas kernel in interpret mode, and dx through its VJP."""
    jc, js = jnp.asarray(codes), jnp.asarray(scales)
    jx, jdy = jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(dy, getattr(jnp, dtype))

    def mm(v):
        return jqm.int8_matmul(v, jc, js, interpret=True)

    dx = jax.grad(lambda v: jnp.sum((mm(v) * jdy).astype(jnp.float32)))(jx)
    return np.asarray(mm(jx), np.float32), np.asarray(dx, np.float32)


@pytest.mark.parametrize("n_in,n_out,rows,dtype", CASES,
                         ids=[f"in{i}-out{o}-m{m}-{d}" for i, o, m, d in CASES])
def test_torch_int8_gemm_plain_matches_jax(n_in, n_out, rows, dtype):
    codes, scales, x, dy = _operands(n_in, n_out, rows)
    itemsize = jnp.dtype(dtype).itemsize
    pallas = jqm.int8_matmul_supported((rows, n_in), codes.shape, itemsize)
    assert pallas == (n_out == 256)  # out 272 is no multiple of 128
    ref = _jax_pallas if pallas else _jax_layer
    want_y, want_dx = ref(x, dy, codes, scales, dtype)

    t = getattr(torch, dtype)
    tx, tdy, tc, ts = to_torch(x).to(t), to_torch(dy).to(t), to_torch(codes), to_torch(scales)
    got_y = qc.int8_matmul_reference(tx, tc, ts)
    got_dx = qc.int8_matmul_dx_reference(tdy, tc, ts)
    assert got_y.dtype == got_dx.dtype == t
    assert tuple(got_y.shape) == (rows, n_out) and tuple(got_dx.shape) == (rows, n_in)
    assert np.abs(to_numpy(got_y) - want_y).max() <= _tol(want_y, dtype, rows)
    assert np.abs(to_numpy(got_dx) - want_dx).max() <= _tol(want_dx, dtype, rows, dx=True)
