"""``scripts/probe_tiled_matmul`` on the CPU: every variant's patches apply
once to this tree's ``csrc/tiled_matmul.cu`` and change it (each dropped
phase guarded by a condition that never holds), and the script refuses to
run without a card."""

import pytest
import torch

from sparse_matrix_fine_tuning_torch.kernels import build as kbuild
from sparse_matrix_fine_tuning_torch.scripts import probe_tiled_matmul as probe


@pytest.mark.parametrize("name", sorted(probe.VARIANTS))
def test_torch_probe_tiled_matmul_patches_apply(name):
    source = (kbuild.CSRC / probe.SOURCE).read_text()
    out = probe.patched(name, source)
    assert (out == source) == (name == "full")
    assert out.count("{") - out.count("}") == source.count("{") - source.count("}")
    if name not in probe.CHECKED:  # each dropped phase behind a condition that never holds
        assert "M < 0" not in source
        assert out.count("M < 0") == sum("M < 0" in new for _, new in probe.VARIANTS[name]) > 0


def test_torch_probe_tiled_matmul_refuses_a_stale_patch():
    with pytest.raises(RuntimeError, match="does not apply"):
        probe.patched("no output stores", "no such kernel")


def test_torch_probe_tiled_matmul_rejects_unknown_variants():
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        probe.main([])
    with pytest.raises(SystemExit):
        probe.main(["--variants", "no such variant"])
