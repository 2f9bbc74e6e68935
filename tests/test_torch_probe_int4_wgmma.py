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
