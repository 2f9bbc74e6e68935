"""The row-grouped factor-gradient pass of the port (K13,
``monarch_cuda.monarch_dw_tile``; K14, ``monarch_dw_merged``) and the port
of ``scripts/exp_dw_kernel.py``, on the CPU.

K13's plain version, ``monarch_dw_fused_reference``, is held against the
JAX script's own Pallas kernel (``dw_kernel_v2(ts, False, "arbitrary")``,
imported from the unedited script, on the factors expanded by the JAX
package, its result read back with ``_extract_dw``) in interpret mode, at
several sequence tiles ts: the plain version has no row tile, so every ts
must agree with the one plain result.  B is a multiple of every ts there:
the script's kernel does not mask the rows past B, and at a ragged B its
last tile sums the padding (at B = 40 it returns NaN).  At a ragged B the
plain version is held instead against JAX's own ``monarch_dw_fused`` (K4,
which masks), in interpret mode, and against ``jax.grad`` of
``blockdiag_butterfly_multiply``.  Tolerances (``utils/testing``): float32
``f32_op`` (sums in another order); bfloat16 ``bf16_atol``, 2**-6 of the
fp32 gradient's scale, as the port holds K4 in bf16 (an intermediate one
bf16 ulp apart enters every row's product).
The pure-Python parts: the sweep's row groups and shapes are the JAX
scripts', the bounds, the source's cluster-kernel instantiations, and the
wrappers refusing CPU tensors and bad row groups before any build.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda
from sparse_matrix_fine_tuning_torch.scripts import exp_dw_kernel
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, bf16_atol, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu.kernels import monarch_pallas as jpallas
from sparse_matrix_fine_tuning_tpu.kernels.monarch_pallas import _extract_dw, expand_monarch_factors
from sparse_matrix_fine_tuning_tpu.ops.monarch import blockdiag_butterfly_multiply

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "sparse_matrix_fine_tuning_torch" / "kernels" / "csrc" / "monarch_bwd.cu"
# (B, n, m, nblocks): B = 64 a multiple of every ts; 40 ragged
WIDTHS = (128, 96, 4)
ROW_TILES = (16, 32, 64)


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"{name}_jax", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_SCRIPT = _jax_script("exp_dw_kernel")


def _arrays(b, n, m, nblocks, rank, seed=0):
    """x (b, n), dout (b, m), w1 (nblocks, rank, n / nblocks), w2 (nblocks,
    m / nblocks, rank), scaled so that the gradients are of order one."""
    rng = np.random.default_rng(seed)
    p = n // nblocks
    return (rng.standard_normal((b, n)).astype(np.float32),
            rng.standard_normal((b, m)).astype(np.float32),
            (rng.standard_normal((nblocks, rank, p)) / np.sqrt(p)).astype(np.float32),
            (rng.standard_normal((nblocks, m // nblocks, rank)) / np.sqrt(rank)).astype(np.float32))


def _close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(to_numpy(got), want, **TOLERANCES["f32_op"])
    else:
        assert np.abs(to_numpy(got) - want).max() <= bf16_atol(want)


def _dtypes(dtype: str):
    return (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [4, 16])
@pytest.mark.parametrize("ts", ROW_TILES)
def test_torch_dw_tile_plain_matches_jax_kernel(ts, rank, dtype):
    arrays = _arrays(64, *WIDTHS, rank, seed=ts + rank)
    jdt, tdt = _dtypes(dtype)
    jx, jd, jw1, jw2 = (jnp.asarray(a, jdt) for a in arrays)
    with pltpu.force_tpu_interpret_mode():
        dw1bd, dw2hat = JAX_SCRIPT.dw_kernel_v2(ts, False, "arbitrary")(
            jx, jd, *expand_monarch_factors(jw1, jw2))
    want = _extract_dw(dw1bd, dw2hat, jw1.shape, jw2.shape)
    got = monarch_cuda.monarch_dw_fused_reference(*(to_torch(a, tdt) for a in arrays))
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [4, 16])
def test_torch_dw_tile_plain_at_ragged_rows(rank, dtype):
    """B = 40, ragged against every ts above: against JAX's K4, which masks
    the rows past B, and (float32) against ``jax.grad`` of the Monarch
    multiply with dout as the cotangent."""
    arrays = _arrays(40, *WIDTHS, rank, seed=7 + rank)
    jdt, tdt = _dtypes(dtype)
    jx, jd, jw1, jw2 = (jnp.asarray(a, jdt) for a in arrays)
    got = monarch_cuda.monarch_dw_fused_reference(*(to_torch(a, tdt) for a in arrays))
    want = jpallas.monarch_dw_fused(jx, jd, jw1, jw2, interpret=True)
    for g, w in zip(got, want):
        _close(g, w, dtype)
    if dtype == "float32":
        grads = jax.grad(
            lambda a, b: jnp.sum(blockdiag_butterfly_multiply(jx, a, b) * jd),
            argnums=(0, 1))(jw1, jw2)
        for g, w in zip(got, grads):
            _close(g, w, dtype)


def test_torch_dw_tile_rows_and_shapes_are_the_jax_scripts():
    src = (ROOT / "scripts" / "exp_dw_kernel.py").read_text()
    sweep = re.search(r"for ts in \(([\d, ]+)\):", src).group(1)
    assert monarch_cuda.DW_TILE_ROWS == tuple(int(v) for v in sweep.split(","))
    b, n, m, k, r = (int(v) for v in re.search(
        r"B, n, m, K, r = (\d+), (\d+), (\d+), (\d+), (\d+)", src).groups())
    (_, *script), (_, *adapter) = exp_dw_kernel.SHAPES
    assert script == [b, n, m, k, r * k] == [2664, 4096, 4096, 4, 16]
    assert adapter == [b, n, m, k, 4]
    merged = _jax_script("exp_merged_v3")
    assert merged.dw_call_v2.__defaults__ == (monarch_cuda.MERGED_DW_ROWS,) == (256,)


def test_torch_exp_dw_kernel_bounds():
    """Bytes bound both shapes: x and dout, 43.6 MB, the bf16 factors read and
    the fp32 gradients written, over 3.35 TB/s.  The operations, 1.40 GFLOP
    at rank 16, take 1.4 us at 989 TFLOP/s and 20.8 us on the CUDA cores."""
    (_, *script), (_, *adapter) = exp_dw_kernel.SHAPES
    ms, by = exp_dw_kernel.bound_ms(*script)
    assert by == "bytes" and round(ms, 4) == 0.0133
    nbytes, ops = exp_dw_kernel.cost(*script)
    assert nbytes == 2 * 2664 * 8192 + 6 * 16 * 8192 and round(ops / 1e9, 2) == 1.40
    assert round(exp_dw_kernel.cuda_core_ms(*script) * 1e3, 1) == 20.8
    ms, by = exp_dw_kernel.bound_ms(*adapter)
    assert by == "bytes" and round(ms, 4) == 0.0131


def test_torch_dw_tile_source_instantiates_fast_blk_r():
    """The cluster kernel is instantiated at every blk_r of ``FAST_BLK_R``,
    for bf16 and f32, K3 and K4 (12 kernels), and the shape test admits
    the same; its row tiles (16 and 32 rows in bf16, the mma's 16-row M
    steps) are multiples of the row group's step."""
    src = SOURCE.read_text()
    inst = set(re.findall(r"bwd_cluster_kernel<(bf16|float), (\d+), (true|false)>", src))
    assert len(inst) == 12
    assert tuple(sorted({int(q) for _, q, _ in inst})) == monarch_cuda.FAST_BLK_R == (4, 8, 16)
    assert "(Q == 4 || Q == 8 || Q == 16)" in src  # the shape test admits the same
    tiles = re.search(r"constexpr int kTiles\[\]\[2\] = \{(.*?)\};", src).group(1)
    rows = {int(r) for r in re.findall(r"\{(\d+), \d+\}", tiles)}
    assert rows == {8, 16, 32}  # 8 only in f32: "Rows of 8 only for float32"
    assert "(ts[0] >= 16 || itemsize == 4)" in src
    assert "constexpr int kMaxTile = 32;" in src
    assert monarch_cuda.DW_ROW_STEP == 16 and all(r % 16 == 0 for r in rows - {8})


def test_torch_dw_tile_wrappers_refuse_before_building():
    x, dout, w1, w2 = (torch.randn(4, 16), torch.randn(4, 8), torch.randn(4, 2, 4),
                       torch.randn(4, 2, 2))
    before = dict(monarch_cuda.LAUNCHES)
    for rows in (0, -16, 24, 256.0):
        with pytest.raises(ValueError, match="multiple of 16"):
            monarch_cuda.monarch_dw_tile(x, dout, w1, w2, rows)
    with pytest.raises(ValueError, match="multiple of 16"):
        monarch_cuda.monarch_bwd_plan(4, w1.shape, w2.shape, rows=8)
    for call in (lambda: monarch_cuda.monarch_dw_tile(x, dout, w1, w2, 256),
                 lambda: monarch_cuda.monarch_dw_merged(x, dout, w1, w2)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert monarch_cuda.LAUNCHES == before and monarch_cuda._ops is None
