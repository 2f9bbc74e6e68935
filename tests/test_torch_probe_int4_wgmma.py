"""The int4 wgmma kernel's probe (``scripts/probe_int4_wgmma.py``) on the
CPU: every variant's source patch still applies to ``quant_wgmma.cu`` and
changes what it says, a missing anchor raises, and the trace's medians
read the spans they name.  The probe itself runs only on the card."""

import numpy as np
import pytest

from sparse_matrix_fine_tuning_torch.scripts import probe_int4_wgmma as probe

STAMPS = [f"TR({e}, kt)" for e in range(4, 10)] + [
    "TR(10, 0)", "TR(11, 0)", "TR(acts ? 0 : 2, kt)", "TR(acts ? 1 : 3, kt)"]


@pytest.mark.parametrize("variant", probe.VARIANTS)
def test_torch_probe_int4_wgmma_patches_apply(variant):
    src = probe.patched_source(variant)
    assert (probe._STORES_BEGIN in src) == (variant not in ("no_dequant", "loads_only"))
    for mma in probe._MMAS:
        assert (mma in src) == (variant not in ("no_mma", "loads_only"))
    if variant == "trace":
        assert all(src.count(stamp) == 1 for stamp in STAMPS)
    else:
        assert "TR(" not in src
    if variant == "base":
        assert src == probe.SOURCE.read_text()


def test_torch_probe_int4_wgmma_refuses_a_stale_patch():
    with pytest.raises(RuntimeError, match="anchor"):
        probe.patched_source("trace", probe.SOURCE.read_text().replace("wgmma_wait<0>();",
                                                                        "wgmma_wait<1>();"))
    with pytest.raises(ValueError):
        probe.patched_source("nothing")


def test_torch_probe_int4_wgmma_trace_medians():
    # every stage k of every CTA: the dequant sees its codes at 1000 k + 100,
    # a free B stage at + 150 and is done at + 600; the consumers see x at
    # + 200, B at + 700, and their MMAs end at + 950
    ctas, steps = 3, 6
    t = np.zeros((4, probe.TRACE_EVENTS, probe.TRACE_STAGES), dtype=np.uint64)
    for ev, off in ((4, 100), (5, 150), (6, 600), (7, 200), (8, 700), (9, 950)):
        t[:ctas, ev, :steps] = 1000 * np.arange(steps, dtype=np.uint64) + off
    assert probe.trace_medians(t, ctas, steps) == {
        "period": 1000, "mma": 250, "dequant work": 450, "dequant waits codes": 500,
        "dequant waits B": 50, "consumers wait x": 250, "consumers wait B": 500}


RS_STAMPS = [f"TR({e}, kt)" for e in (0, 1, 2, 3, 5)] + [
    "TR(4, done / 4 - 1)", "TR(10, 0)", "TR(11, 0)"]


@pytest.mark.parametrize("variant", probe.INT8_VARIANTS)
def test_torch_probe_int4_wgmma_int8_patches_apply(variant):
    src = probe.patched_source(variant, bits=8)
    assert (probe._RS_BUILD in src) == (variant not in ("no_build", "loads_only"))
    assert (probe._RS_MMA in src) == (variant not in ("no_mma", "loads_only"))
    assert (probe._RS_LOAD_AHEAD in src) == (variant != "scales_late")
    assert (probe._RS_LOAD_LATE in src) == (variant == "scales_late")
    if variant == "trace":
        assert all(src.count(stamp) == 1 for stamp in RS_STAMPS)
        assert src.count("TR(") == len(RS_STAMPS) + 1  # and the macro's definition
    else:
        assert "TR(" not in src
    group, bufs = probe.SCHEDULES.get(variant, (None, None))
    forward = src[src.index("struct RsSchedule<false>"):src.index("struct RsSchedule<true>")]
    dx = src[src.index("struct RsSchedule<true>"):src.index("struct RsParams")]
    assert (f"kGroup = {group or 1}, kBufs = {bufs or 4}") in forward
    assert (f"kGroup = {group or 4}, kBufs = {bufs or 1}") in dx
    if variant == "base":
        assert src == probe.SOURCE.read_text()


def test_torch_probe_int4_wgmma_refuses_a_variant_of_the_other_mode():
    with pytest.raises(ValueError):
        probe.patched_source("no_build")  # int8 only
    with pytest.raises(ValueError):
        probe.patched_source("no_dequant", bits=8)  # int4 only


def test_torch_probe_int4_wgmma_rs_trace_medians():
    # every stage k of every CTA: the producer waits for a slot from 1000 k
    # to + 30 and has issued it at + 40; the consumers wait for it from
    # + 100 to + 160 and release it at + 900
    ctas, steps = 3, 6
    t = np.zeros((4, probe.TRACE_EVENTS, probe.TRACE_STAGES), dtype=np.uint64)
    for ev, off in ((0, 0), (5, 30), (1, 40), (2, 100), (3, 160), (4, 900)):
        t[:ctas, ev, :steps] = 1000 * np.arange(steps, dtype=np.uint64) + off
    assert probe.rs_trace_medians(t, ctas, steps) == {
        "period": 1000, "consumers wait stage": 60, "producer waits slot": 30,
        "issue to use": 120}


def test_torch_probe_int4_wgmma_stage_counts():
    # int4: gate_proj's forward 16 stages of 64 code rows over 44 x 16
    # tiles, dx 44 stages of 128 columns of out over 16 x 16; int8: k = 64 a
    # stage over 256-token tiles, gate dx's 88 stages cut to the trace's 64
    assert probe.stage_counts(4, 0, 2048, 5632) == (16, 44 * 16)
    assert probe.stage_counts(4, 1, 2048, 5632) == (44, 16 * 16)
    assert probe.stage_counts(8, 0, 2048, 5632) == (32, 44 * 8)
    assert probe.stage_counts(8, 1, 2048, 5632) == (64, 16 * 8)
    assert probe.stage_counts(8, 0, 5632, 2048) == (64, 16 * 8)
