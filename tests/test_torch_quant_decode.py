"""The plain versions of K5 and K7 (``int4_matmul_reference``,
``int8_matmul_reference``), which the card holds the decode kernel
(``kernels/csrc/quant_matmul.cu`` ``qgemv_kernel``, the forward at M <= 16
rows) against, held against the JAX package on the CPU at that kernel's
edge shapes.

Shapes: rows 1 and 5 (one n8 tile of the mma product), 9 and 16 (two);
int8 in 1000 and 1096 (a k16 tail of 8 code rows; no multiple of the 64
rows of the tile path's stage) and 1056 (no multiple of 64), int4 in 1040
(h = 520: a k16 tail of 8, group 8, whose scale row changes inside a k16
step), 1000 (h = 500: a tail of 4, group 20) and 1088 (group 32); out 272
and 336, ragged against the kernel's 64-column tile, and 256 (whole
tiles); float32 and bfloat16.

Reference: the JAX Pallas kernel in interpret mode
(``int8_matmul``/``int4_matmul(..., interpret=True)``) where its tile
picker takes the shape (out 256); elsewhere the JAX layer's path
(``layers/monarch_linear.py:375-439``: the weight dequantized in the
compute dtype, then dots with fp32 sums), as ``tests/test_torch_int8_gemm.py``
and ``tests/test_torch_int4_gemm.py`` do.  Tolerances:
``test_torch_quant_matmul._tol`` and its reasons (bf16 at these rows 2**-5
of the output's scale: the JAX int4 kernel keeps f32 cells at b <= 64).
"""

import functools

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

ROWS = (1, 5, 9, 16)
DTYPES = ("float32", "bfloat16")
# (bits, in, out, group); group unused for int8
WEIGHTS = [(8, 1000, 272, 0), (8, 1096, 336, 0), (8, 1056, 256, 0),
           (4, 1040, 272, 8), (4, 1000, 336, 20), (4, 1088, 256, 32)]
CASES = [(w, rows, dtype) for w in WEIGHTS for rows in ROWS for dtype in DTYPES]


@functools.lru_cache(maxsize=None)
def _weight(bits, n_in, n_out, group):
    rng = np.random.default_rng(n_in + n_out + group + bits)
    w = (rng.standard_normal((n_out, n_in)) * 0.1).astype(np.float32)
    return jq.quantize_int4(w, group) if bits == 4 else jq.quantize_int8(w)


def _pallas_takes(bits, rows, n_in, n_out, dtype) -> bool:
    itemsize = jnp.dtype(dtype).itemsize
    if bits == 8:
        return jqm.int8_matmul_supported((rows, n_in), (n_in, n_out), itemsize)
    return (n_out % 128 == 0 and
            jqm._pick_fwd_tiles(rows, n_in, n_in // 2, n_out, itemsize) is not None)


def _jax_layer(bits, x, codes, scales, group, dtype):
    """The JAX layer's path: W dequantized in the compute dtype, dots with
    fp32 sums (int4: one a half)."""
    hp = jax.lax.Precision.HIGHEST
    jx = jnp.asarray(x, getattr(jnp, dtype))

    def dot(a, b, contract):
        return jax.lax.dot_general(a, b, (contract, ((), ())), precision=hp,
                                   preferred_element_type=jnp.float32)

    if bits == 8:
        w = jq.dequantize_int8(jnp.asarray(codes), jnp.asarray(scales), getattr(jnp, dtype))
        y = dot(jx, w, ((1,), (1,)))  # W (out, in)
    else:
        h = codes.shape[0]
        lo, hi = jq.dequantize_int4_halves(jnp.asarray(codes), jnp.asarray(scales), group,
                                           getattr(jnp, dtype))
        y = dot(jx[:, :h], lo, ((1,), (0,))) + dot(jx[:, h:], hi, ((1,), (0,)))
    return np.asarray(y.astype(jx.dtype), np.float32)


def _jax_pallas(bits, x, codes, scales, group, dtype):
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jc, js = jnp.asarray(codes), jnp.asarray(scales)
    y = (jqm.int8_matmul(jx, jc, js, interpret=True) if bits == 8
         else jqm.int4_matmul(jx, jc, js, group, interpret=True))
    return np.asarray(y, np.float32)


@pytest.mark.parametrize("weight,rows,dtype", CASES,
                         ids=[f"int{b}-in{i}-out{o}-g{g}-m{m}-{d}"
                              for (b, i, o, g), m, d in CASES])
def test_torch_quant_decode_plain_matches_jax(weight, rows, dtype):
    bits, n_in, n_out, group = weight
    codes, scales = _weight(*weight)
    x = np.random.default_rng(rows + n_in).standard_normal((rows, n_in)).astype(np.float32)
    pallas = _pallas_takes(bits, rows, n_in, n_out, dtype)
    assert pallas == (n_out == 256)  # out 272 and 336 have no Pallas tile
    want = (_jax_pallas if pallas else _jax_layer)(bits, x, codes, scales, group, dtype)

    t = getattr(torch, dtype)
    tx, tc, ts = to_torch(x).to(t), to_torch(codes), to_torch(scales)
    got = (qc.int8_matmul_reference(tx, tc, ts) if bits == 8
           else qc.int4_matmul_reference(tx, tc, ts, group))
    assert got.dtype == t and tuple(got.shape) == (rows, n_out)
    assert np.abs(to_numpy(got) - want).max() <= _tol(want, dtype, rows)


def test_torch_quant_decode_cases_are_ragged():
    """The shapes reach the decode kernel's edges: a k16 step past the end
    of the code rows, a column tile past out, int4 groups that change the
    scale row inside a k16 step, and both of the mma product's row tiles."""
    steps = {(b, i): (i // 2 if b == 4 else i) % 16 for b, i, _, _ in WEIGHTS}
    assert steps[(8, 1000)] == 8 and steps[(8, 1096)] == 8 and steps[(4, 1040)] == 8
    assert steps[(4, 1000)] == 4
    assert {o % 64 for _, _, o, _ in WEIGHTS} == {16, 0}
    assert any(g % 16 for b, _, _, g in WEIGHTS if b == 4)
    assert {r <= 8 for r in ROWS} == {True, False} and max(ROWS) == 16
