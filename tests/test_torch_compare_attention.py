"""The pure-Python parts of ``scripts/compare_attention`` (this tree's
K17-K19 against another tree's, on the card), on the CPU: its shapes and
bounds, that its checks reach every edge of the persistent kernels' tiles
and schedule, its bounds' handling of an exact zero, argument parsing, a
library without a plan, and its refusal to run without a card."""

import types

import pytest
import torch

from sparse_matrix_fine_tuning_torch.kernels import attention_cuda as ac
from sparse_matrix_fine_tuning_torch.ops import attention as attn_ref
from sparse_matrix_fine_tuning_torch.ops.attention import attention_cost
from sparse_matrix_fine_tuning_torch.scripts import compare_attention as cmp
from sparse_matrix_fine_tuning_torch.utils import benchlib


def test_torch_compare_attention_shapes_and_bounds():
    """The 1.1B micro-batch first, then the bench's shape; bounds by bytes
    at 1.1B (K17 0.0101, K18 0.0127, K19 0.0152 ms) and, at the bench
    shape, K17 by bytes and K18, K19 by operations."""
    import chip_smoke

    assert [s for _, s in cmp.SHAPES] == [(chip_smoke.TRAIN_BS, chip_smoke.TRAIN_SEQ, 32, 64),
                                          (4, 1024, 32, 128)]
    got = {(label, k): benchlib.roofline_ms(*attention_cost(k, shape, torch.bfloat16),
                                            torch.bfloat16)
           for label, shape in cmp.SHAPES for k in cmp.KERNELS}
    assert [round(got[("1.1B", k)][0], 4) for k in cmp.KERNELS] == [0.0101, 0.0127, 0.0152]
    assert {got[("1.1B", k)][1] for k in cmp.KERNELS} == {"bytes"}
    assert [got[("bench", k)][1] for k in cmp.KERNELS] == ["bytes", "operations", "operations"]


def test_torch_compare_attention_checks_chip_smokes_shapes():
    import chip_smoke

    assert [shape for _, shape in chip_smoke.ATTN_SHAPES] == cmp.SMOKE_SHAPES


@pytest.mark.parametrize("kernel", ["splash_fwd", "splash_dq", "splash_dkv"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_torch_compare_attention_checks_reach_the_edges(kernel, head_dim):
    """At each head_dim the checked shapes hold t = 1 (the exact zero), t
    under one 128-row tile, t ragged against the tiles and the kernel's
    step (K17's and K18's kv tile, K19's q step), t a whole number of tiles,
    and on 132 SMs items under a wave, a wave and one, and several waves."""
    shapes = [s for s in cmp.CHECKS if s[3] == head_dim]
    step = {"splash_fwd": ac.FWD_KV_ROWS[head_dim], "splash_dq": ac.DQ_KV_ROWS,
            "splash_dkv": ac.DKV_Q_ROWS}[kernel]
    assert any(t == 1 for _, t, _, _ in shapes) and any(1 < t < 128 for _, t, _, _ in shapes)
    assert any(t % 128 and t > 128 for _, t, _, _ in shapes)
    assert any(t % step for _, t, _, _ in shapes) and any(t % 128 == 0 for _, t, _, _ in shapes)
    items = {ac.schedule_plan(kernel, *s, 132, 1)["items"] for s in cmp.CHECKS}
    assert min(items) < 132 and 133 in items and max(items) > 2 * 132


def test_torch_compare_attention_check_outputs():
    """Sound outputs pass; a wrong row block fails; an exact zero is held
    to ``ZERO_ATOL``, not to a tolerance relative to its scale."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 130, 2, 64, generator=g) for _ in range(3))
    ref = attn_ref.causal_attention_reference(q / 8, k, v)
    assert cmp.check_outputs(ref, ref, torch.float32)["ok"]
    bad = ref[0].clone()
    bad[:, 100:] *= 1.01
    assert not cmp.check_outputs((bad, ref[1]), ref, torch.float32)["ok"]
    zero = torch.zeros(1, 1, 2, 64)
    assert cmp.check_outputs((zero + 5e-5,), (zero,), torch.float32)["ok"]
    assert not cmp.check_outputs((zero + 1e-3,), (zero,), torch.float32)["ok"]


def test_torch_compare_attention_plan_of_an_old_library():
    """A library without smft_flash_attn_plan (the one-CTA-a-tile design)
    has no plan."""
    assert cmp.plan_of(types.SimpleNamespace(), "splash_fwd", (1, 64, 1, 64)) is None


def test_torch_compare_attention_arguments_and_card():
    with pytest.raises(SystemExit):
        cmp.main([])  # --old is required
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        cmp.main(["--old", "."])
