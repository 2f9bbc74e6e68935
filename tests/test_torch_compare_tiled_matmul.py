"""The pure-Python parts of ``scripts/compare_tiled_matmul`` (the port's
comparison of two trees' tiled bf16 matmul, K15, on the card), on the CPU:
its bounds against ``exp_matmul_tiles``'s, its shapes, the schedule edges
its checks reach, the old grid's waves, a library without a plan, and its
refusal to run without a card."""

import types

import pytest
import torch

from sparse_matrix_fine_tuning_torch.kernels.experimental import tiled_matmul as tm
from sparse_matrix_fine_tuning_torch.scripts import compare_monarch_bwd
from sparse_matrix_fine_tuning_torch.scripts import compare_tiled_matmul as cmp
from sparse_matrix_fine_tuning_torch.scripts import exp_matmul_tiles
from sparse_matrix_fine_tuning_torch.utils import benchlib


def test_torch_compare_tiled_matmul_shapes_and_bounds():
    """The bench shape first, then TinyLlama-1.1B's gate/up and down
    projections at a 2048-row micro-batch; the cost is exp_matmul_tiles's,
    and every shape is bound by its operations (bench 0.0904 ms, 1.1B 0.0478
    ms at 989 TFLOP/s)."""
    assert cmp.SHAPES[0] == exp_matmul_tiles.SHAPE
    mlp = {(n_in, n_out) for name, n_in, n_out in compare_monarch_bwd.PROJECTIONS
           if name in ("gate", "up", "down")}
    assert {(k, n) for m, k, n in cmp.SHAPES[1:]} == mlp and {m for m, _, _ in cmp.SHAPES[1:]} == {2048}
    bounds = []
    for m, k, n in cmp.SHAPES:
        assert cmp.cost(m, k, n) == exp_matmul_tiles.cost(m, k, n)
        bounds.append(benchlib.roofline_ms(*cmp.cost(m, k, n), torch.bfloat16))
    assert [round(ms, 4) for ms, _ in bounds] == [0.0904, 0.0478, 0.0478]
    assert {by for _, by in bounds} == {"operations"}


@pytest.mark.parametrize("tile", tm.TILES)
def test_torch_compare_tiled_matmul_checks_reach_the_edges(tile):
    """The checked shapes take K and N multiples of 8, K under one k step
    and of one, N past the tile's columns and rows past its rows; at 128 x
    256 tiles on 132 CTAs they hold a whole wave of units, one unit past it
    and a last unit with a row tile past M."""
    shapes = cmp.RAGGED + cmp.SHAPES
    assert all(k % 8 == 0 and n % 8 == 0 for _, k, n in shapes)
    assert any(k < 64 for _, k, _ in shapes) and any(k == 64 for _, k, _ in shapes)
    assert any(n % tile[1] for _, _, n in shapes) and any(m % tile[0] for m, _, _ in shapes)
    units = {tm.schedule_plan(m, n, k, (128, 256, 4), 132)["units"] for m, k, n in shapes}
    assert {66, 67} <= units
    assert any(tm.schedule_plan(m, n, k, (128, 256, 4), 132)["m_tiles"] % 2
               for m, k, n in shapes)


def test_torch_compare_tiled_matmul_old_waves():
    """The one-CTA-a-tile grid at the three shapes and 128 x 256 tiles:
    2.55, 2.67 and 0.97 waves on 132 SMs."""
    got = [round(cmp.old_waves(m, n, (128, 256, 4)), 2) for m, _, n in cmp.SHAPES]
    assert got == [2.55, 2.67, 0.97]


def test_torch_compare_tiled_matmul_plan_of_an_old_library():
    """A library without smft_tiled_matmul_plan (the one-CTA-a-tile design)
    has no plan."""
    assert cmp.plan_of(types.SimpleNamespace(), 64, 64, 64, tm.TILES[0]) is None


def test_torch_compare_tiled_matmul_tolerance():
    ref = torch.tensor([[0.5, -2.0], [1.0, 0.25]], dtype=torch.bfloat16)
    assert cmp.tolerance(ref) == 2.0 * 2.0 ** -6


def test_torch_compare_tiled_matmul_needs_a_card():
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        cmp.main(["--old", "."])
