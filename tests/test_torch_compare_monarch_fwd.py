"""The pure-Python parts of ``scripts/compare_monarch_fwd`` (the port's
comparison of two trees' Monarch forward kernels, K1 and K2, on the card),
on the CPU: its bound against chip_smoke.py's, its shapes, its sliced views
and its refusal to run without a card."""

import sys

import pytest
import torch

import chip_smoke
from sparse_matrix_fine_tuning_torch.scripts import compare_monarch_fwd as cmp
from sparse_matrix_fine_tuning_torch.utils import benchlib


def test_torch_compare_monarch_fwd_bounds():
    """The script's bound a decoder layer at the 1.1B projections, bf16,
    equals chip_smoke.py's (K1: x, the factors and out; K2: base too)."""
    for m_rows in cmp.ROWS:
        for add, name in ((False, "monarch_kernel"), (True, "monarch_add")):
            ours = sum(benchlib.roofline_ms(*cmp.cost(m_rows, n_in, n_out, add),
                                            torch.bfloat16)[0]
                       for _, n_in, n_out in cmp.PROJECTIONS)
            smoke = sum(chip_smoke.bound(name, m_rows, n_in, n_out, torch.bfloat16)[0]
                        for _, n_in, n_out in chip_smoke.PROJECTIONS)
            assert ours == pytest.approx(smoke, rel=1e-12)
    k1 = sum(benchlib.roofline_ms(*cmp.cost(2048, i, o, False), torch.bfloat16)[0]
             for _, i, o in cmp.PROJECTIONS)
    k2 = sum(benchlib.roofline_ms(*cmp.cost(2048, i, o, True), torch.bfloat16)[0]
             for _, i, o in cmp.PROJECTIONS)
    assert (round(k1, 4), round(k2, 4)) == (0.0439, 0.0658)


def test_torch_compare_monarch_fwd_cases():
    """The script's shapes: the 1.1B projections of chip_smoke.py, Monarch
    factors that fit (L R = K Q), and a sweep of two forced plan fields
    (row tile, chunks) at every row count."""
    assert cmp.PROJECTIONS == chip_smoke.PROJECTIONS and cmp.ROWS == chip_smoke.ROWS
    for b, K, Q, P, L, S, R, off in cmp.RAGGED:
        assert L * R == K * Q and off in (0, 1)
    assert set(cmp.SWEEP) == set(cmp.ROWS)
    assert all(len(plan) == 2 for plans in cmp.SWEEP.values() for plan in plans)
    for b, K, Q, P, L, S, R, off in chip_smoke.FWD_RAGGED:
        assert L * R == K * Q


def test_torch_compare_monarch_fwd_offset_view():
    t = torch.arange(12.0).view(3, 4)
    v = cmp.offset_view(t, 1)
    assert v.is_contiguous() and torch.equal(v, t)
    assert v.data_ptr() - v.untyped_storage().data_ptr() == 4


def test_torch_compare_monarch_fwd_needs_a_card(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["compare_monarch_fwd", "--old", "elsewhere"])
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        cmp.main()
