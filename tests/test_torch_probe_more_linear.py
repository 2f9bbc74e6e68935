"""``scripts/probe_more_linear`` on the CPU: every variant's patches apply
once to this tree's ``csrc/more_linear.cu`` and change it (each dropped
phase guarded by a condition that never holds), and the script refuses to
run without a card."""

import sys

import pytest
import torch

from sparse_matrix_fine_tuning_torch.kernels import build as kbuild
from sparse_matrix_fine_tuning_torch.scripts import probe_more_linear as probe


@pytest.mark.parametrize("name", sorted(probe.VARIANTS))
def test_torch_probe_more_linear_patches_apply(name):
    source = (kbuild.CSRC / probe.SOURCE).read_text()
    out = probe.patched(name, source)
    assert (out == source) == (name == "full")
    assert out.count("{") - out.count("}") == source.count("{") - source.count("}")
    if name not in probe.CHECKED:  # each dropped phase behind a condition that never holds
        assert "p.M < 0" not in source and "p.M >= 0" not in source
        assert out.count("p.M < 0") + out.count("p.M >= 0") == len(probe.VARIANTS[name])


def test_torch_probe_more_linear_refuses_a_stale_patch():
    with pytest.raises(RuntimeError, match="does not apply"):
        probe.patched("no summary mma", "no such kernel")
    with pytest.raises(RuntimeError, match="does not apply"):
        probe.patched("no summary", "no such kernel", probe.OLD_VARIANTS)


def test_torch_probe_more_linear_needs_a_card(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["probe_more_linear"])
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        probe.main()
