"""``scripts/probe_monarch_bwd`` on the CPU: every variant's patches apply
once to this tree's ``csrc/monarch_bwd.cu`` and change it, and the script
refuses to run without a card."""

import sys

import pytest
import torch

from sparse_matrix_fine_tuning_torch.scripts import probe_monarch_bwd as probe


@pytest.mark.parametrize("name", sorted(probe.VARIANTS))
def test_torch_probe_monarch_bwd_patches_apply(name):
    source = probe.SOURCE.read_text()
    out = probe.patched(name, source)
    assert (out == source) == (name == "full")
    assert out.count("{") - out.count("}") == source.count("{") - source.count("}")


def test_torch_probe_monarch_bwd_refuses_a_stale_patch():
    with pytest.raises(RuntimeError, match="does not apply"):
        probe.patched("no dx", "no such kernel")


def test_torch_probe_monarch_bwd_needs_a_card(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["probe_monarch_bwd"])
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        probe.main()
