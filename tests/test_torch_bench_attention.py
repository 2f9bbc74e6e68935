"""The port of ``scripts/bench_attention.py`` on the CPU at a small shape: its
three attention paths agree with a direct fp32 softmax and with each other
(the value and the gradients of its loss), its FLOP count is the JAX
script's, its bound counts what a step must move and compute, and its
entry point refuses to run without a card.  Then ``chip_smoke.py``'s
attention costs and its check of K17-K19 (``attention_check``, with
``utils/testing.attention_block_error``) against its planted faults.

Tolerances: bfloat16 inputs; each path's output within 2**-6 of its scale
of a direct fp32 softmax (two bf16 ulps: the einsum path rounds its scores
and probabilities to bf16); the differences the bench prints within 2**-5
of that scale; the losses within 2**-6 of each other and the gradients
within 2**-5 of their scale (a loss of squared outputs doubles the
outputs' error).
"""

import numpy as np
import pytest
import torch

from sparse_matrix_fine_tuning_torch.scripts import bench_attention as bench
from sparse_matrix_fine_tuning_torch.utils import benchlib
from sparse_matrix_fine_tuning_torch.utils.testing import (ATTN_BLOCK_RTOL, attention_block_error,
                                                           to_numpy)

SMALL = (1, 72, 2, 64)  # ragged against the kernels' 64-row tile


def _direct(q, k, v):
    t, d = q.shape[1], q.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / d ** 0.5
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v.float())


def test_torch_bench_attention_paths_agree_on_cpu():
    q, k, v = bench.make_inputs(SMALL, device="cpu")
    want = _direct(q, k, v)
    diffs = bench.max_diffs(q, k, v)
    assert set(diffs) == {"dpa", "splash"}
    for name, fn in bench.PATHS.items():
        with torch.no_grad():
            got = fn(q, k, v)
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=0,
                                   atol=2.0 ** -6 * float(want.abs().max()))
        assert diffs.get(name, 0.0) <= 2.0 ** -5 * float(want.abs().max())
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    results = {name: bench.value_and_grad(fn, *leaves) for name, fn in bench.PATHS.items()}
    ref = results["einsum"]
    want_loss = float(ref[0].detach())
    for name, (loss, *grads) in results.items():
        assert abs(float(loss.detach()) - want_loss) <= 2.0 ** -6 * abs(want_loss)
        for g, w in zip(grads, ref[1:]):
            assert g.shape == q.shape and bool(torch.isfinite(g).all())
            assert float((g.float() - w.float()).abs().max()) <= 2.0 ** -5 * float(
                w.float().abs().max()), name


def test_torch_bench_attention_counts():
    b, t, h, d = bench.SHAPE
    assert bench.SHAPE == (4, 1024, 32, 128)
    assert bench.jax_flops(b, t, h, d) == 4 * b * h * t * t * d * 2 * 1.5
    ms, by = bench.bound_ms(b, t, h, d)
    nbytes = 6 * b * t * h * d * 2
    ops = 12 * b * h * d * t * (t + 1) / 2
    assert (ms, by) == benchlib.roofline_ms(nbytes, ops, torch.bfloat16)
    assert by == "operations"


def test_torch_bench_attention_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        bench.main()


def test_torch_chip_smoke_attention_costs():
    """``chip_smoke.attention_cost`` (``ops/attention.attention_cost``, which
    the bench's bound uses too) at the 1.1B micro-batch: K17 moves q, k, v
    and o (8.39 MB each in bf16) and the fp32 lse, K18 one tensor and di
    more, K19 two tensors more than K18; their products are two, three and
    four causal q k^T-sized products; a step moves q, k, v, dq, dk, dv."""
    import chip_smoke

    from sparse_matrix_fine_tuning_torch.ops.attention import attention_cost

    assert chip_smoke.attention_cost is attention_cost
    shape = (4, 512, 32, 64)
    act, rows = 4 * 512 * 32 * 64 * 2, 4 * 4 * 32 * 512
    pair_ops = 2 * 64 * 4 * 32 * 512 * 513 / 2
    got = {name: chip_smoke.attention_cost(name, shape, torch.bfloat16)
           for name in chip_smoke.ATTN_KERNELS}
    assert got == {"splash_fwd": (4 * act + rows, 2 * pair_ops),
                   "splash_dq": (5 * act + 2 * rows, 3 * pair_ops),
                   "splash_dkv": (6 * act + 2 * rows, 4 * pair_ops)}
    assert attention_cost("step", shape, torch.bfloat16) == (6 * act, 6 * pair_ops)
    ms, by = benchlib.roofline_ms(*got["splash_fwd"], torch.bfloat16)
    assert by == "bytes" and 0.0100 < ms < 0.0102


def test_torch_attention_block_error():
    """``utils/testing.attention_block_error``: 0 for equal tensors, the
    relative error of a block scaled by 1 + e, a fault in the last (ragged)
    block of one head seen at its own size however small the block is
    against the tensor's largest value, and infinity where the reference is
    0 and the value is not."""
    g = torch.Generator().manual_seed(0)
    ref = torch.randn(2, 200, 3, 64, generator=g)
    ref[:, 192:] *= 1e-3  # a ragged last block far below the scale
    assert attention_block_error(ref, ref) == 0.0
    got = ref.clone()
    got[1, 192:, 2] *= 1.1
    assert abs(attention_block_error(got, ref) - 0.1) < 1e-5
    assert float((got - ref).abs().max()) < 2.0 ** -6 * float(ref.abs().max())
    zero = torch.zeros(1, 70, 1, 64)
    assert attention_block_error(zero, zero) == 0.0
    off = zero.clone()
    off[0, 65, 0, 0] = 1e-6
    assert attention_block_error(off, zero) == float("inf")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_torch_chip_smoke_attention_check_rejects_planted_faults(dtype):
    """``chip_smoke.attention_check`` passes each plain version against
    itself and rejects both planted faults (``skipped_kv_tile``: the last q
    tile skips kv tile 0; ``narrowed``: the operands one type narrower) in
    every output set of K17, K18 and K19, at a t ragged against the tile."""
    import chip_smoke

    from sparse_matrix_fine_tuning_torch.ops import attention as attn_ref

    g = torch.Generator().manual_seed(1)
    shape = (2, 200, 4, 64)
    q, k, v, dout = (torch.randn(shape, generator=g) for _ in range(4))
    q, k, v, dout = (x.to(dtype) for x in (q / 8.0, k, v, dout))
    o, lse = attn_ref.causal_attention_reference(q, k, v)
    di = attn_ref.attention_di(o, dout)
    scores = attn_ref._scores
    plains = (lambda q, k, v, dout: attn_ref.causal_attention_reference(q, k, v),
              lambda q, k, v, dout: (attn_ref.attention_dq_reference(q, k, v, dout, lse, di),),
              lambda q, k, v, dout: attn_ref.attention_dkv_reference(q, k, v, dout, lse, di))
    for plain in plains:
        ref = plain(q, k, v, dout)
        assert chip_smoke.attention_check(ref, ref, dtype)["ok"]
        with chip_smoke.skipped_kv_tile():
            tile = plain(q, k, v, dout)
        narrow = plain(*chip_smoke.narrowed(dtype, q, k, v, dout))
        for fault in (tile, narrow):
            check = chip_smoke.attention_check(fault, ref, dtype)
            assert not check["ok"] and check["block"] > ATTN_BLOCK_RTOL[dtype]
    assert attn_ref._scores is scores  # the fault is planted only inside the context
