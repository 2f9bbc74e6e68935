"""The persistent bf16 K17-K19's schedule (``kernels/attention_cuda``'s
Python mirror of ``csrc/flash_attention.cu``'s ``ws_item``, ``dq_unit`` and
plan), on the CPU: every (batch * head, 128-row tile) is taken exactly
once, each CTA's items (K17, K19) never grow longer, K18's units pair the
longest and the shortest q tile of one head, each item's length is the
causal work it holds, and the plan's fields agree with the schedule, at
the 1.1B micro-batch, the bench shape and shapes ragged against the tiles,
on 132 SMs and on one."""

import pytest

from sparse_matrix_fine_tuning_torch.kernels import attention_cuda as ac

SHAPES = [(4, 512, 32, 64), (4, 1024, 32, 128), (1, 1, 2, 64), (2, 100, 3, 128),
          (1, 129, 4, 64), (1, 65, 2, 128), (1, 833, 19, 64), (3, 700, 11, 128)]
KERNELS = ("splash_fwd", "splash_dq", "splash_dkv")


def _cdiv(a, b):
    return -(-a // b)


def _causal_steps(kernel, t, head_dim, tile):
    """The ring steps an item must take, counted from the causal mask: K17's
    and K18's kv tiles holding a key at or before some query of the q tile
    (and before t); K19's q steps holding a query at or after some key of the
    kv tile (and before t), once a pass."""
    step = {"splash_fwd": ac.FWD_KV_ROWS[head_dim], "splash_dq": ac.DQ_KV_ROWS,
            "splash_dkv": ac.DKV_Q_ROWS}[kernel]
    rows = range(tile * ac.TILE_ROWS, min(t, (tile + 1) * ac.TILE_ROWS))
    if kernel != "splash_dkv":
        return len({u // step for r in rows for u in range(0, r + 1)})
    return ac.DKV_PASSES[head_dim] * len({q // step for q in range(rows[0], t)})


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_torch_attention_schedule_takes_every_item_once_longest_first(kernel, shape, sms):
    b, t, h, d = shape
    plan = ac.schedule_plan(kernel, b, t, h, d, sms, 1)
    sched = ac.attention_schedule(kernel, b, t, h, d, plan["ctas"])
    assert len(sched) == plan["ctas"] == min(plan["items"], sms)
    items = [(bh, tile) for cta in sched for bh, tile, _ in cta]
    tiles = _cdiv(t, 128)
    assert sorted(items) == [(bh, tile) for bh in range(b * h) for tile in range(tiles)]
    for cta in sched:
        lengths = [n for _, _, n in cta]
        assert min(lengths) >= 1
        if kernel != "splash_dq":
            assert lengths == sorted(lengths, reverse=True)
    if kernel == "splash_dq":
        # units of one head: q tiles tiles - 1 - p and p, the longer first;
        # CTA c takes units c, c + ctas, ..., heads in order
        units = [[] for _ in range(plan["items"])]
        per = _cdiv(tiles, 2)
        for bh in range(b * h):
            for tile in range(tiles):
                units[bh * per + min(tile, tiles - 1 - tile)].append((bh, tile))
        for c, cta in enumerate(sched):
            want = [it for u in range(c, plan["items"], plan["ctas"])
                    for it in sorted(units[u], key=lambda x: -x[1])]
            assert [(bh, tile) for bh, tile, _ in cta] == want


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_torch_attention_schedule_lengths_are_the_causal_work(kernel, shape):
    b, t, h, d = shape
    for tile in range(_cdiv(t, 128)):
        assert ac.item_length(kernel, t, d, tile) == _causal_steps(kernel, t, d, tile)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("head_dim", [64, 128])
def test_torch_attention_plan_fields(kernel, head_dim):
    """At the 1.1B micro-batch's t: 512 items (K18: 256 units) on 132 CTAs, the steps of t,
    one CTA of 288 threads in at most 227 KB of shared memory."""
    plan = ac.schedule_plan(kernel, 4, 512, 32, head_dim, 132, 1)
    assert set(plan) == set(ac.PLAN_KEYS)
    units = 2 if kernel == "splash_dq" else 4  # K18: pairs of q tiles
    assert plan["items"] == 4 * 32 * units and plan["tiles"] == 4 and plan["ctas"] == 132
    assert plan["steps"] == 512 // plan["step_rows"] and plan["threads"] == ac.THREADS == 288
    assert plan["passes"] == (2 if kernel == "splash_dkv" and head_dim == 128 else 1)
    assert plan["stages"] == ac.STAGES[(kernel, head_dim)] and plan["smem"] <= 232448


@pytest.mark.parametrize("kernel", ["splash_fwd", "splash_dkv"])
def test_torch_attention_schedule_starts_with_the_longest_items(kernel):
    """K17's and K18's first wave holds the last q tile of every head (the
    most kv tiles), K19's kv tile 0 (the most q steps); the last items are
    the shortest."""
    sched = ac.attention_schedule(kernel, 4, 512, 32, 64, 132)
    first = [cta[0] for cta in sched]
    longest = 0 if kernel == "splash_dkv" else 3
    assert {tile for _, tile, _ in first[:128]} == {longest}
    lengths = [n for cta in sched for _, _, n in cta]
    assert max(lengths) == first[0][2] and min(lengths) == sched[-1][-1][2]


@pytest.mark.parametrize("shape", [(4, 512, 32, 64), (4, 1024, 32, 128)])
def test_torch_attention_dq_units_hold_equal_work(shape):
    """K18's units at the 1.1B micro-batch and the bench shape: every unit
    holds the same kv tiles (the longest q tile beside the shortest), and
    the CTAs that run at once take the units of a few heads (each head's k
    and v shared in L2)."""
    b, t, h, d = shape
    plan = ac.schedule_plan("splash_dq", b, t, h, d, 132, 1)
    tiles = plan["tiles"]
    assert plan["items"] == b * h * tiles // 2 and plan["ctas"] == 132
    sched = ac.attention_schedule("splash_dq", b, t, h, d, 132)
    first = [cta[:2] for cta in sched]
    assert {sum(n for _, _, n in unit) for unit in first} == {2 * (tiles + 1)}
    assert {bh for unit in first for bh, _, _ in unit} == set(range(132 * 2 // tiles))
