"""The plain versions of K5 and K6 (``int4_matmul_reference``,
``int4_matmul_dx_reference``), which the card holds the int4 wgmma kernel
(``kernels/csrc/quant_wgmma.cu``) against, held against the JAX package on
the CPU at that kernel's edge shapes.

Shapes: rows 17 (the first forward row count on the wgmma kernel), 65 and
200; in 960 and 1088, whose h = in/2 (480, 544) is no multiple of the
kernel's 64-row stage; groups 8, 32 and 60 wherever (in/2) % group == 0
(group 8 spans the most scale rows a stage); out 272, no multiple of its
128-column tile; float32 and bfloat16; forward and dx.

Reference: the JAX Pallas kernel in interpret mode
(``int4_matmul(..., interpret=True)`` and ``jax.grad`` of it) where its tile
picker takes the shape; elsewhere (out 272: no out tile of 128-512 divides
it) the JAX layer's split-dot path (``layers/monarch_linear.py:395-403``:
``dequantize_int4_halves`` and two dots with fp32 sums; dx as the kernel's
own fallback, ``kernels/quant_matmul.py:205-214``).  Two out-256 cases take
the Pallas kernel.  Tolerances: ``test_torch_quant_matmul._tol`` and its
reasons.
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

OUT = 272
# (in, group): each group of 8, 32, 60 that divides h = in / 2
WIDTHS = [(n_in, g) for n_in in (960, 1088) for g in (8, 32, 60) if (n_in // 2) % g == 0]
ROWS = (17, 65, 200)
DTYPES = ("float32", "bfloat16")
CASES = [(n_in, OUT, g, rows, dtype) for n_in, g in WIDTHS for rows in ROWS for dtype in DTYPES]
# out 256: the Pallas kernel's tile picker takes these
PALLAS_CASES = [(960, 256, 32, 65, "bfloat16"), (1088, 256, 8, 200, "float32")]


def _operands(n_in, n_out, group, rows, dtype):
    rng = np.random.default_rng(n_in + n_out + group + rows)
    w = (rng.standard_normal((n_out, n_in)) * 0.1).astype(np.float32)
    codes, scales = jq.quantize_int4(w, group)
    x = rng.standard_normal((rows, n_in)).astype(np.float32)
    dy = rng.standard_normal((rows, n_out)).astype(np.float32)
    return codes, scales, x, dy


def _pallas_takes(rows, n_in, n_out, dtype) -> bool:
    return jqm._pick_fwd_tiles(rows, n_in, n_in // 2, n_out, jnp.dtype(dtype).itemsize) is not None


def _jax_split_dot(x, dy, codes, scales, group, dtype):
    """The JAX layer's split-dot forward and its dx, fp32 sums."""
    h = codes.shape[0]
    lo, hi = jq.dequantize_int4_halves(jnp.asarray(codes), jnp.asarray(scales), group,
                                       getattr(jnp, dtype))
    hp = jax.lax.Precision.HIGHEST

    def dot(a, b, contract):
        return jax.lax.dot_general(a, b, (contract, ((), ())), precision=hp,
                                   preferred_element_type=jnp.float32)

    jx, jdy = jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(dy, getattr(jnp, dtype))
    y = (dot(jx[:, :h], lo, ((1,), (0,))) + dot(jx[:, h:], hi, ((1,), (0,)))).astype(jx.dtype)
    dx = jnp.concatenate([dot(jdy, lo, ((1,), (1,))), dot(jdy, hi, ((1,), (1,)))],
                         -1).astype(jdy.dtype)
    return np.asarray(y, np.float32), np.asarray(dx, np.float32)


def _jax_pallas(x, dy, codes, scales, group, dtype):
    """The JAX Pallas kernel in interpret mode, and dx through its VJP."""
    jc, js = jnp.asarray(codes), jnp.asarray(scales)
    jx, jdy = jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(dy, getattr(jnp, dtype))

    def mm(v):
        return jqm.int4_matmul(v, jc, js, group, interpret=True)

    dx = jax.grad(lambda v: jnp.sum((mm(v) * jdy).astype(jnp.float32)))(jx)
    return np.asarray(mm(jx), np.float32), np.asarray(dx, np.float32)


@pytest.mark.parametrize("n_in,n_out,group,rows,dtype", CASES + PALLAS_CASES,
                         ids=[f"in{i}-out{o}-g{g}-m{m}-{d}"
                              for i, o, g, m, d in CASES + PALLAS_CASES])
def test_torch_int4_gemm_plain_matches_jax(n_in, n_out, group, rows, dtype):
    codes, scales, x, dy = _operands(n_in, n_out, group, rows, dtype)
    pallas = _pallas_takes(rows, n_in, n_out, dtype)
    assert pallas == (n_out != OUT)  # out 272 has no Pallas tile
    ref = _jax_pallas if pallas else _jax_split_dot
    want_y, want_dx = ref(x, dy, codes, scales, group, dtype)

    t = getattr(torch, dtype)
    tx, tdy, tc, ts = to_torch(x).to(t), to_torch(dy).to(t), to_torch(codes), to_torch(scales)
    got_y = qc.int4_matmul_reference(tx, tc, ts, group)
    got_dx = qc.int4_matmul_dx_reference(tdy, tc, ts, group)
    assert got_y.dtype == got_dx.dtype == t
    assert tuple(got_y.shape) == (rows, n_out) and tuple(got_dx.shape) == (rows, n_in)
    assert np.abs(to_numpy(got_y) - want_y).max() <= _tol(want_y, dtype, rows)
    assert np.abs(to_numpy(got_dx) - want_dx).max() <= _tol(want_dx, dtype, rows, dx=True)
