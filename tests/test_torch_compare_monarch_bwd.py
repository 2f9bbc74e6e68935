"""The pure-Python parts of ``scripts/compare_monarch_bwd`` (the port's
comparison of two trees' Monarch backward kernels, K3 and K4, on the card),
on the CPU: its bounds against chip_smoke.py's, its shapes and sweeps, its
sliced views, its reading of ptxas's log and its refusal to run without a
card."""

import sys

import pytest
import torch

import chip_smoke
from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda
from sparse_matrix_fine_tuning_torch.scripts import compare_monarch_bwd as cmp
from sparse_matrix_fine_tuning_torch.utils import benchlib


@pytest.mark.parametrize("with_dx,name", [(True, "monarch_bwd"), (False, "monarch_dw_fused")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_torch_compare_monarch_bwd_bounds(with_dx, name, dtype):
    """The script's cost of every projection and row count equals
    chip_smoke.py's for K3 (``monarch_bwd``) and K4 (``monarch_dw_fused``)."""
    item = 2 if dtype == torch.bfloat16 else 4
    for m_rows in cmp.ROWS:
        for _, n_in, n_out in cmp.PROJECTIONS:
            assert cmp.cost(m_rows, n_in, n_out, with_dx, item) == \
                chip_smoke.cost(name, m_rows, n_in, n_out, dtype)


def test_torch_compare_monarch_bwd_layer_bounds():
    """The bound a decoder layer at a training micro-batch, bf16: K3 0.0660
    ms, K4 0.0441 ms (x, dout, dx and the factors over 3.35 TB/s)."""
    k3, k4 = (sum(benchlib.roofline_ms(*cmp.cost(2048, i, o, dx), torch.bfloat16)[0]
                  for _, i, o in cmp.PROJECTIONS) for dx in (True, False))
    assert (round(k3, 4), round(k4, 4)) == (0.0660, 0.0441)


def test_torch_compare_monarch_bwd_cases():
    """The script's shapes: chip_smoke.py's projections and backward rows;
    ragged cases whose factors fit (L R = K Q), on both designs; sweeps of
    tiles and stages the kernel takes, and row groups of 16-row steps."""
    assert cmp.PROJECTIONS == chip_smoke.PROJECTIONS and cmp.ROWS == chip_smoke.BWD_ROWS
    assert cmp.DW_ROWS == monarch_cuda.MERGED_DW_ROWS
    fast = []
    for m_rows, K, Q, P, L, S, R, off in cmp.RAGGED:
        assert L * R == K * Q and off in (0, 1) and m_rows > 0
        fast.append(K == L == 4 and Q == R and Q in monarch_cuda.FAST_BLK_R and P % 8 == 0
                    and S % 2 == 0 and off == 0)
    assert any(fast) and not all(fast)
    assert {q for (_, _, q, *_), f in zip(cmp.RAGGED, fast) if f} == set(monarch_cuda.FAST_BLK_R)
    for rows, tile, stages in cmp.SWEEP:
        assert rows % monarch_cuda.DW_ROW_STEP == 0
        assert (tile, stages) == (0, 0) or (tile in (16, 32) and 1 <= stages <= 3)
    assert {(t, s) for r, t, s in cmp.SWEEP if r == 0} == {
        (t, s) for t in (16, 32) for s in (1, 2, 3)}


def test_torch_compare_monarch_bwd_offset_view():
    t = torch.arange(12.0).view(3, 4)
    v = cmp.offset_view(t, 1)
    assert v.is_contiguous() and torch.equal(v, t)
    assert v.data_ptr() - v.untyped_storage().data_ptr() == 4


def test_torch_compare_monarch_bwd_reads_ptxas():
    log = """ptxas info    : Compiling entry function '_Z3fooi' for 'sm_90a'
ptxas info    : Function properties for _Z3fooi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3bari' for 'sm_90a'
ptxas info    : Function properties for _Z3bari
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, 380 bytes cmem[0]
"""
    lines = cmp.ptxas_lines(log)
    assert len(lines) == 2
    assert lines[0].startswith("_Z3fooi: 96 registers;") and "0 bytes spill stores" in lines[0]
    assert lines[1].startswith("_Z3bari: 255 registers;") and "4 bytes spill stores" in lines[1]


def test_torch_compare_monarch_bwd_needs_a_card(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["compare_monarch_bwd", "--old", "elsewhere"])
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        cmp.main()
