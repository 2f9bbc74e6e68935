"""The row-tiled Monarch forward of the port (K12,
``monarch_cuda.monarch_fwd_tile``) and the port of ``scripts/exp_fwd_tile.py``,
on the CPU.

K12's plain version, ``monarch_kernel_reference``, is held against the JAX
script's own Pallas kernel (``fwd_call(ts, x, W1bd, W2hat)``, imported from
the unedited script, on the factors expanded by the JAX package) in
interpret mode, at a ragged row count and several row tiles ts: the plain
version has no row tile, so every ts must agree with the one plain result.
Tolerances (``utils/testing``): float32 ``f32_op`` (sums in another
order); bfloat16 ``bf16_atol``, two bf16 ulps at the output's scale (the
intermediate may round one ulp apart, and the output rounds once more).
The pure-Python parts: the source offers exactly ``FWD_TILE_ROWS`` as K12's
row tiles and holds one kernel, whose plan K1, K2 and K12 share; the bound
at the bench shapes, and the wrapper refusing CPU tensors.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda
from sparse_matrix_fine_tuning_torch.scripts import exp_fwd_tile
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, bf16_atol, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu.kernels.monarch_pallas import expand_monarch_factors

ROOT = Path(__file__).resolve().parents[1]
# (B, n, m, nblocks, rank a block): B ragged against every ts; the script's
# rank r*K = 16 and the adapters' rank 4
CASES = [(37, 64, 96, 4, 16), (37, 128, 64, 4, 4)]
ROW_TILES = (8, 16, 64)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "exp_fwd_tile_jax", ROOT / "scripts" / "exp_fwd_tile.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_SCRIPT = _jax_script()


def _arrays(b, n, m, nblocks, rank, seed=0):
    """x (b, n), w1 (nblocks, rank, n / nblocks), w2 (nblocks, m / nblocks,
    rank), scaled so that the outputs are of order one."""
    rng = np.random.default_rng(seed)
    p = n // nblocks
    return (rng.standard_normal((b, n)).astype(np.float32),
            (rng.standard_normal((nblocks, rank, p)) / np.sqrt(p)).astype(np.float32),
            (rng.standard_normal((nblocks, m // nblocks, rank)) / np.sqrt(rank)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ts", ROW_TILES)
@pytest.mark.parametrize("case", CASES)
def test_torch_fwd_tile_plain_matches_jax_kernel(case, ts, dtype):
    x, w1, w2 = _arrays(*case, seed=ts)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    jx, jw1, jw2 = (jnp.asarray(a, jdt) for a in (x, w1, w2))
    with pltpu.force_tpu_interpret_mode():
        want = JAX_SCRIPT.fwd_call(ts, jx, *expand_monarch_factors(jw1, jw2))
    want = np.asarray(want.astype(jnp.float32))
    got = monarch_cuda.monarch_kernel_reference(*(to_torch(a, tdt) for a in (x, w1, w2)))
    assert got.dtype == tdt and tuple(got.shape) == (case[0], case[2])
    if dtype == "float32":
        np.testing.assert_allclose(to_numpy(got), want, **TOLERANCES["f32_op"])
    else:
        assert np.abs(to_numpy(got) - want).max() <= bf16_atol(want)


def test_torch_fwd_tile_source_instantiates_rows():
    """K12's row tiles are a runtime parameter of K1's one kernel: the
    source offers exactly ``FWD_TILE_ROWS`` (and refuses others), and K1,
    K2 and K12 all launch ``monarch_fwd_kernel`` through one plan."""
    src = (ROOT / "sparse_matrix_fine_tuning_torch" / "kernels" / "csrc" /
           "monarch_fwd.cu").read_text()
    offered = re.search(r"constexpr int kFwdTileRows\[\] = \{([\d, ]+)\};", src)
    assert offered is not None
    found = tuple(sorted(int(r) for r in offered.group(1).split(",")))
    assert found == monarch_cuda.FWD_TILE_ROWS
    # one kernel design (and the empty kernel that times its launch floor)
    assert re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))? (\w+)", src) == [
        "monarch_fwd_kernel", "monarch_fwd_empty_kernel"]
    assert src.count("make_plan(itemsize, B, K, Q, P, L, S, R, rows, chunks, &pl)") == 2


def test_torch_exp_fwd_tile_bounds():
    """Bytes bound both shapes: x and the output, 43.6 MB, plus the factors
    (256 KB at the script's rank 16, 64 KB at rank 4) over 3.35 TB/s."""
    (_, *script), (_, *adapter) = exp_fwd_tile.SHAPES
    assert script == [2664, 4096, 4096, 4, 16] and adapter == [2664, 4096, 4096, 4, 4]
    ms, by = exp_fwd_tile.bound_ms(*adapter)
    assert by == "bytes" and round(ms, 4) == 0.0130
    assert exp_fwd_tile.cost(*adapter)[1] == 2 * 2664 * 4 * 8192  # 175 MFLOP
    ms, by = exp_fwd_tile.bound_ms(*script)
    assert by == "bytes" and round(ms, 4) == 0.0131
    assert exp_fwd_tile.cost(*script)[0] == 2 * (2664 * 8192 + 16 * 8192)


def test_torch_fwd_tile_refuses_cpu_tensors():
    x, w1, w2 = (torch.randn(4, 16), torch.randn(4, 2, 4), torch.randn(2, 8, 4))
    before = dict(monarch_cuda.LAUNCHES)
    for rows in (8, 12):
        with pytest.raises(ValueError, match="CUDA"):
            monarch_cuda.monarch_fwd_tile(x, w1, w2, rows)
    assert monarch_cuda.LAUNCHES == before and monarch_cuda._ops is None
