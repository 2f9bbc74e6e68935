"""The tiled bf16 matmul of the port (K15, ``kernels/experimental/tiled_matmul``)
and the port of ``scripts/exp_matmul_tiles.py``, on the CPU.

The plain version ``tiled_matmul_reference`` is held against the JAX
script's own Pallas kernel (``make_mm(bm, bn, bk)``, imported from the
unedited script) in interpret mode, at a ragged row count and at several
tiles: the plain version has no tile, so every tile of the JAX kernel must
agree with the one plain result.  Tolerances (``utils/testing``): float32
``f32_op`` (both sum in fp32, in another order); bfloat16 ``bf16_atol``,
two bf16 ulps at the output's scale (both round once from fp32 sums taken
in another order).  The pure-Python parts: every tile fits in 227 KB of
shared memory, the source instantiates exactly ``TILES``, the bound at the
bench shape, and the wrapper refusing CPU tensors.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sparse_matrix_fine_tuning_torch.kernels.experimental import tiled_matmul as tm
from sparse_matrix_fine_tuning_torch.scripts import exp_matmul_tiles
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, bf16_atol, to_numpy, to_torch

ROOT = Path(__file__).resolve().parents[1]
# (M, K, N): M ragged against every tile's bm
SHAPE = (200, 256, 384)
# (bm, bn, bk) of the JAX kernel; the last covers K and N in one block
JAX_TILES = [(64, 128, 128), (128, 128, 256), (64, 384, 64), (256, 384, 256)]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "exp_matmul_tiles_jax", ROOT / "scripts" / "exp_matmul_tiles.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_SCRIPT = _jax_script()


def _arrays(m, k, n, seed=0):
    """x (m, k) and w (k, n), scaled as the script's (:59-60)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            (rng.standard_normal((k, n)) * 0.02).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile", JAX_TILES)
def test_torch_tiled_matmul_plain_matches_jax_kernel(tile, dtype):
    x, w = _arrays(*SHAPE, seed=sum(tile))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = JAX_SCRIPT.make_mm(*tile)(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    want = np.asarray(want.astype(jnp.float32))
    got = tm.tiled_matmul_reference(to_torch(x, tdt), to_torch(w, tdt))
    assert got.dtype == tdt and tuple(got.shape) == (SHAPE[0], SHAPE[2])
    if dtype == "float32":
        np.testing.assert_allclose(to_numpy(got), want, **TOLERANCES["f32_op"])
    else:
        assert np.abs(to_numpy(got) - want).max() <= bf16_atol(want)


def test_torch_tiled_matmul_tiles_fit_shared_memory():
    assert 1 <= len(tm.TILES) <= 6 and len(set(tm.TILES)) == len(tm.TILES)
    for bm, bn, stages in tm.TILES:
        assert bm in (64, 128) and bn in (128, 256) and stages in (3, 4, 5)
        assert tm.tile_smem_bytes(bm, bn, stages) <= tm.SMEM_LIMIT
    # the largest: four stages of (128 + 256) x 64 bf16, eight barriers, 1 KB slack
    assert tm.tile_smem_bytes(128, 256, 4) == 4 * 384 * 128 + 64 + 1024
    assert tm.tile_smem_bytes(128, 256, 5) > tm.SMEM_LIMIT


def test_torch_tiled_matmul_source_instantiates_tiles():
    csrc = ROOT / "sparse_matrix_fine_tuning_torch" / "kernels" / "csrc"
    src = (csrc / "tiled_matmul.cu").read_text()
    found = [tuple(map(int, t)) for t in re.findall(r"launch<(\d+), (\d+), (\d+)>", src)]
    assert sorted(found) == sorted(tm.TILES)
    # the TMA loads and the wgmma MMAs, through the shared Hopper helpers
    helpers = (csrc / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in src
    assert "tma_load_2d(" in src and "wgmma_m64n128k16<1>(" in src and "wgmma_m64n256k16<1>(" in src
    assert "wgmma.mma_async" in helpers and "cp.async.bulk.tensor.2d" in helpers


def test_torch_exp_matmul_tiles_bound():
    m, k, n = exp_matmul_tiles.SHAPE
    assert (m, k, n) == (2664, 4096, 4096)
    nbytes, ops = exp_matmul_tiles.cost(m, k, n)
    assert ops == 2 * 2664 * 4096 * 4096 and nbytes == 2 * (2 * 2664 * 4096 + 4096 * 4096)
    ms, by = exp_matmul_tiles.bound_ms(m, k, n)
    assert by == "operations" and round(ms, 4) == 0.0904
    assert round(nbytes / 3.35e12 * 1e3, 3) == 0.023


def test_torch_tiled_matmul_refuses_cpu_tensors():
    x, w = (torch.randn(16, 32).bfloat16(), torch.randn(32, 16).bfloat16())
    before = dict(tm.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tm.tiled_matmul(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        tm.tiled_matmul(x.float(), w.float(), tm.TILES[0])
    assert tm.LAUNCHES == before
