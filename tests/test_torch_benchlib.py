"""The port's timing helpers (``utils/benchlib``) and its scripts' refusal
to measure without a card, on the CPU.  Where a card is visible the
refusal tests check the other side: the helper names the card."""

import pytest
import torch

from sparse_matrix_fine_tuning_torch.scripts import (
    bench_more_linear,
    exp_fwd_tile,
    exp_matmul_tiles,
)
from sparse_matrix_fine_tuning_torch.utils import benchlib


def test_torch_benchlib_roofline():
    # 1 GB at 3.35 TB/s against 1 TFLOP of bf16 at 989 TFLOP/s
    ms, by = benchlib.roofline_ms(1e9, 1e12, torch.bfloat16)
    assert by == "operations" and ms == pytest.approx(1e3 / 989)
    ms, by = benchlib.roofline_ms(1e9, 1e9, torch.bfloat16)
    assert by == "bytes" and ms == pytest.approx(1e3 / 3350)
    assert benchlib.roofline_ms(0, 67e9, torch.float32) == (pytest.approx(1.0), "operations")


def test_torch_benchlib_calls_per_timing():
    """time_ms warms up with 3 calls, then times `rounds` rounds of `reps`
    calls twice: with the queue empty and held."""
    calls = []
    if torch.cuda.is_available():
        benchlib.time_ms(lambda: calls.append(torch.zeros(1, device="cuda")), reps=4, rounds=2)
        assert len(calls) == benchlib.calls_per_timing(4, 2)
    assert benchlib.calls_per_timing(4, 2) == 3 + 16
    assert benchlib.calls_per_timing() == 503


@pytest.mark.parametrize("main", [bench_more_linear.main, exp_matmul_tiles.main,
                                  exp_fwd_tile.main])
def test_torch_scripts_need_a_card(main):
    if torch.cuda.is_available():
        assert benchlib.require_card("x") == torch.cuda.get_device_name(0)
        return
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        main()
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        benchlib.require_card("benchlib")
