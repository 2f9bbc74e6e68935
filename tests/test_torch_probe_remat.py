"""``scripts/probe_remat.py`` on the CPU: each of its variants, on the tiny
Llama, computes the gradients of no remat bit for bit (they differ only in
what is kept and checked), and puts the model and ``models/llama.py`` back
after it; ``run`` needs a card."""

import pytest
import torch

from sparse_matrix_fine_tuning_torch.models import llama
from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
from sparse_matrix_fine_tuning_torch.peft import surgery
from sparse_matrix_fine_tuning_torch.scripts import probe_remat


def tiny():
    model = llama.LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    surgery.init_monarch(model, probe_remat.PEFT, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "blkdiag2" in name:
                p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(2))
    surgery.trainable_filter(model, ())
    return model


@pytest.mark.parametrize("name", list(probe_remat.VARIANTS))
def test_torch_probe_remat_variants_keep_the_gradients(name):
    model = tiny()
    ids = torch.randint(3, 256, (2, 12), generator=torch.Generator().manual_seed(3))
    probe_remat.micro_batch(model, ids)
    want = {n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad}
    kept = (model.config, llama.checkpoint, llama.remat_context)
    calls = []
    real = llama.checkpoint

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    llama.checkpoint = spy
    try:
        kept = (model.config, llama.checkpoint, llama.remat_context)
        with probe_remat.variant(model, name):
            assert model.config.remat == (name != "none")
            probe_remat.micro_batch(model, ids)
        assert (model.config, llama.checkpoint, llama.remat_context) == kept
    finally:
        llama.checkpoint = real
    assert len(calls) == (0 if name == "none" else 2)  # one a decoder layer
    for n, p in model.named_parameters():
        if p.requires_grad:
            assert torch.equal(p.grad, want[n]), n


def test_torch_probe_remat_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        probe_remat.run(layers=1, rounds=1)
