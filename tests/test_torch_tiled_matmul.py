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
shared memory, the source instantiates exactly ``TILES`` in its one
persistent design, the kernel's schedule (its Python mirror) covers every
tile once at the schedule's edges, the bound at the bench shape, and the
wrapper refusing CPU tensors.
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
        # the epilogue stages the whole tile where it fits beside the ring
        whole = stages * (bm + bn) * 128 + bm * bn * 2 + 16 * stages + 1024
        assert tm.tile_out_cols(bm, bn, stages) == (bn if whole <= tm.SMEM_LIMIT else bn // 2)
    # the largest: four stages of (128 + 256) x 64 bf16, half the output tile
    # (128 x 128 bf16) staged at a time, eight barriers, 1 KB slack
    assert tm.tile_out_cols(128, 256, 4) == 128 and tm.tile_out_cols(128, 256, 3) == 256
    assert tm.tile_smem_bytes(128, 256, 4) == 4 * 384 * 128 + 128 * 128 * 2 + 64 + 1024
    assert tm.tile_smem_bytes(128, 256, 5) > tm.SMEM_LIMIT


def test_torch_tiled_matmul_source_instantiates_tiles():
    csrc = ROOT / "sparse_matrix_fine_tuning_torch" / "kernels" / "csrc"
    src = (csrc / "tiled_matmul.cu").read_text()
    found = [tuple(map(int, t)) for t in re.findall(r"return f\(Tile<(\d+), (\d+), (\d+)>\{\}\)", src)]
    assert sorted(found) == sorted(tm.TILES)
    # the schedule's constants are the Python mirror's
    assert f"constexpr int kCluster = {tm.CLUSTER};" in src
    assert f"constexpr int kGroupRows = {tm.GROUP_ROWS};" in src
    # one persistent design: a grid of clusters sized by the occupancy API,
    # launched with cudaLaunchKernelEx; no one-CTA-a-tile <<<grid>>> launch
    assert "cudaOccupancyMaxActiveClusters" in src and "cudaLaunchKernelEx" in src
    assert "<<<" not in src
    # the TMA loads (w's multicast to the cluster), the wgmma MMAs and the
    # TMA-store epilogue, through the shared Hopper helpers
    helpers = (csrc / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in src
    assert "tma_load_2d(" in src and ".multicast::cluster" in src and "tma_store_2d(" in src
    assert "wgmma_m64n128k16<1>(" in src and "wgmma_m64n256k16<1>(" in src
    assert "wgmma.mma_async" in helpers and "cp.async.bulk.tensor.2d" in helpers
    assert "bulk_group" in helpers and "__trap()" in helpers
    # the helper K9/K10 and K15 share lives in hopper.cuh alone
    assert "void tma_store_2d(" in helpers
    assert "void tma_store_2d(" not in (csrc / "more_linear.cu").read_text()


# (M, K, N) of the schedule's edges at 128 x 256 tiles on 132 resident CTAs
# (66 clusters of two): the bench shape (176 units, 2.67 waves, 21 row tiles:
# the last unit's second row tile lies past M), under one wave (64 units),
# exactly one wave (66), one unit past it (67), and K under one k step
SCHEDULE_SHAPES = {"bench": (2664, 4096, 4096), "under a wave": (2048, 5632, 2048),
                   "one wave": (2816, 1024, 1536), "one past a wave": (17147, 520, 256),
                   "K under a step": (300, 8, 264)}


@pytest.mark.parametrize("label", sorted(SCHEDULE_SHAPES))
def test_torch_tiled_matmul_schedule_covers_every_tile_once(label):
    """The kernel's schedule (mirrored by ``tiled_matmul_schedule``) at each
    tile: every output tile is computed once, by one CTA with all its k
    steps (no tile is split, so each output is summed in one fixed order);
    the CTAs' units differ by one at most; the two CTAs of a cluster take
    the same units (the same column tile: w's tile is shared) on
    neighbouring row tiles; a row tile past the last occurs only where the
    row tiles are odd, once a column, in the last unit row."""
    m, k, n = SCHEDULE_SHAPES[label]
    for tile in tm.TILES:
        plan = tm.schedule_plan(m, n, k, tile, 132)
        schedule = tm.tiled_matmul_schedule(m, n, k, tile, 132)
        assert len(schedule) == plan["grid"] == 2 * min(66, plan["units"])
        assert plan["k_steps"] == -(-k // 64) and plan["units"] == (
            -(-plan["m_tiles"] // 2) * plan["n_tiles"])
        seen = [(p["m"], p["n"]) for cta in schedule for p in cta]
        real = [t for t in seen if t[0] < plan["m_tiles"]]
        assert sorted(real) == [(i, j) for i in range(plan["m_tiles"])
                                for j in range(plan["n_tiles"])]
        phantom = [t for t in seen if t[0] >= plan["m_tiles"]]
        assert sorted(phantom) == ([(plan["m_tiles"], j) for j in range(plan["n_tiles"])]
                                   if plan["m_tiles"] % 2 else [])
        counts = [len(cta) for cta in schedule]
        assert max(counts) - min(counts) <= 1 and sum(counts) == 2 * plan["units"]
        for c in range(0, len(schedule), 2):
            a, b = schedule[c], schedule[c + 1]
            assert [(p["unit"], p["n"]) for p in a] == [(p["unit"], p["n"]) for p in b]
            assert all(q["m"] == p["m"] + 1 and p["m"] % 2 == 0 for p, q in zip(a, b))


def test_torch_tiled_matmul_schedule_at_the_bench_shape():
    """At 2664 x 4096 -> 4096 and 128 x 256 tiles on 132 CTAs: 21 x 16 tiles,
    176 units of two row tiles on 66 clusters (2.67 waves: 44 clusters take
    three units, 22 take two), 64 k steps a tile; the first wave's units
    walk 8 unit rows (16 row tiles) down each column before the next, so the
    clusters at work at once share w's columns 0-8."""
    plan = tm.schedule_plan(2664, 4096, 4096, (128, 256, 4), 132)
    assert {k: plan[k] for k in tm.PLAN_KEYS} == {
        "resident": 132, "grid": 132, "cluster": 2, "m_tiles": 21, "n_tiles": 16,
        "k_steps": 64, "units": 176, "out_cols": 128, "smem": 230464}
    schedule = tm.tiled_matmul_schedule(2664, 4096, 4096, (128, 256, 4), 132)
    assert sorted(len(cta) for cta in schedule[::2]) == [2] * 22 + [3] * 44
    first = [cta[0] for cta in schedule[::2]]
    assert {p["n"] for p in first} == set(range(9))
    assert [p["m"] for p in first[:8]] == [0, 2, 4, 6, 8, 10, 12, 14]
    assert [p["n"] for p in first[:9]] == [0] * 8 + [1]


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
