"""``scripts/probe_attention`` on the CPU: every variant's patches apply once
to this tree's ``csrc/flash_attention.cu`` and change it (each dropped phase
guarded by a condition that never holds), and the script refuses to run
without a card."""

import pytest
import torch

from sparse_matrix_fine_tuning_torch.kernels import build as kbuild
from sparse_matrix_fine_tuning_torch.scripts import probe_attention as probe


@pytest.mark.parametrize("name", sorted(probe.VARIANTS))
def test_torch_probe_attention_patches_apply(name):
    source = (kbuild.CSRC / probe.SOURCE).read_text()
    out = probe.patched(name, source)
    assert (out == source) == (name == "full")
    assert out.count("{") - out.count("}") == source.count("{") - source.count("}")
    never = sum("a.T < 0" in new for _, new in probe.VARIANTS[name])
    assert out.count("a.T < 0") == source.count("a.T < 0") + never


def test_torch_probe_attention_refuses_a_stale_patch():
    with pytest.raises(RuntimeError, match="does not apply"):
        probe.patched("fwd no P.V", "no such kernel")


def test_torch_probe_attention_needs_a_card():
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        probe.main([])
