"""The pure-Python parts of ``scripts/compare_more_linear`` (the port's
comparison of two trees' fused dense + Monarch kernels, K9 and K10, on the
card), on the CPU: its bounds against chip_smoke.py's, its shapes, its
sliced views and its refusal to run without a card."""

import sys

import pytest
import torch

import chip_smoke
from sparse_matrix_fine_tuning_torch.kernels.experimental import more_linear as ml
from sparse_matrix_fine_tuning_torch.scripts import bench_more_linear as bench
from sparse_matrix_fine_tuning_torch.scripts import compare_more_linear as cmp
from sparse_matrix_fine_tuning_torch.utils import benchlib


@pytest.mark.parametrize("name", cmp.NAMES)
def test_torch_compare_more_linear_bounds(name):
    """The script's cost of K9 and K10 at the bench's three shapes equals
    chip_smoke.py's."""
    for _, rows, n, m, nb, r in bench.SHAPES:
        assert cmp.cost(name, rows, n, m, r) == chip_smoke.cost(name, rows, n, m,
                                                                torch.bfloat16, r)


def test_torch_compare_more_linear_bench_bounds():
    """The bound a call at qkv, micro and gate, bf16: 0.0906, 0.0022 and
    0.2492 ms (the operations over 989 TFLOP/s), K9 and K10 alike."""
    for name in cmp.NAMES:
        got = [benchlib.roofline_ms(*cmp.cost(name, rows, n, m, r), torch.bfloat16)
               for _, rows, n, m, nb, r in bench.SHAPES]
        assert [round(ms, 4) for ms, _ in got] == [0.0906, 0.0022, 0.2492]
        assert {by for _, by in got} == {"operations"}


def test_torch_compare_more_linear_cases():
    """The script's shapes: the bench's, under chip_smoke.py's labels; ragged
    cases the kernels take (widths multiples of 8, J = K Q = L R <= 64) with
    P no multiple of 8, K != L, J below 16 and above 32, rows past 128 x 256
    tiles, and factors off 16 bytes; identity checks at both tile plans."""
    assert cmp.LABELS == chip_smoke.MORE_LABELS and len(cmp.LABELS) == len(bench.SHAPES)
    assert cmp.PLAN_KEYS == ml.PLAN_KEYS
    for rows, n, m, K, Q, L, off in cmp.CASES:
        assert n % 8 == 0 and m % 8 == 0 and n % K == 0 and m % L == 0
        assert (K * Q) % L == 0 and K * Q <= 64 and rows > 0 and off in (0, 1)
        assert ml.more_linear_supported(n, m, (K, Q, n // K), (L, m // L, K * Q // L))
    assert any((n // K) % 8 for _, n, _, K, *_ in cmp.CASES)
    assert any(K != L for _, _, _, K, _, L, _ in cmp.CASES)
    assert {K * Q for _, _, _, K, Q, _, _ in cmp.CASES} >= {8, 12, 16, 32, 64}
    assert any(rows % 128 and rows > 2048 and n % 256 for rows, n, *_ in cmp.CASES)
    assert any(off for *_, off in cmp.CASES)
    for n, m in cmp.IDENTITY:
        assert n % 16 == 0 and m % 16 == 0


def test_torch_compare_more_linear_offset_view():
    t = torch.arange(12.0).view(3, 4)
    v = cmp.offset_view(t, 1)
    assert v.is_contiguous() and torch.equal(v, t)
    assert v.data_ptr() - v.untyped_storage().data_ptr() == 4


def test_torch_compare_more_linear_tolerance():
    """2**-6 of the output's scale in bf16, 1e-5 in f32, as chip_smoke.py."""
    ref = torch.tensor([[-3.0, 1.5]])
    assert cmp.tolerance(ref, torch.bfloat16) == chip_smoke.tolerance(torch.bfloat16, ref)
    assert cmp.tolerance(ref, torch.float32) == chip_smoke.tolerance(torch.float32, ref)


def test_torch_compare_more_linear_needs_a_card(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["compare_more_linear", "--old", "elsewhere"])
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        cmp.main()
