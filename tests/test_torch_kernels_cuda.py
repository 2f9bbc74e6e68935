"""The port's CUDA kernels K1 and K2 against their plain versions, on the
card.  Marked ``cuda``: they skip where no card is visible, and run on the
card with ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.
This file imports no JAX, so it also runs where JAX is not installed.

Tolerances: float32 1e-5 of the output's scale (the kernel sums in another
order); bfloat16 two ulps of the output's scale (the intermediate may round
one ulp apart, and the output rounds once more).
"""

import numpy as np
import pytest
import torch

from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda

# (batch, K, Q, P, L, S, R); the last has L != K
CASES = [(16, 4, 4, 32, 4, 32, 4), (65, 4, 8, 16, 4, 24, 8), (8, 2, 16, 64, 2, 64, 16),
         (9, 4, 2, 16, 2, 12, 4), (4, 4, 4, 512, 4, 1408, 4), (65, 4, 4, 1408, 4, 512, 4)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(case, dtype, device):
    batch, K, Q, P, L, S, R = case
    rng = np.random.default_rng(sum(case))
    arrays = (rng.standard_normal((batch, K * P)), rng.standard_normal((K, Q, P)) / np.sqrt(P),
              rng.standard_normal((L, S, R)) / np.sqrt(R), rng.standard_normal((batch, S * L)))
    return [torch.tensor(a, dtype=torch.float32).to(device=device, dtype=dtype) for a in arrays]


def _tol(want: torch.Tensor) -> float:
    scale = float(want.float().abs().max())
    return scale * (1e-5 if want.dtype == torch.float32 else 2.0 ** -6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_torch_kernels_match_plain_on_card(cuda_device, case, dtype):
    x, w1, w2, base = _inputs(case, dtype, cuda_device)
    before = dict(monarch_cuda.LAUNCHES)
    with torch.no_grad():
        pairs = [(monarch_cuda.monarch_kernel(x, w1, w2),
                  monarch_cuda.monarch_kernel_reference(x, w1, w2)),
                 (monarch_cuda.monarch_add(base, x, w1, w2),
                  monarch_cuda.monarch_add_reference(base, x, w1, w2))]
    torch.cuda.synchronize()
    assert monarch_cuda.LAUNCHES["monarch_kernel"] == before["monarch_kernel"] + 1
    assert monarch_cuda.LAUNCHES["monarch_add"] == before["monarch_add"] + 1
    for got, want in pairs:
        assert got.shape == want.shape and got.dtype == want.dtype
        assert float((got.float() - want.float()).abs().max()) <= _tol(want)


@pytest.mark.cuda
def test_torch_tiny_llama_on_card_matches_cpu(cuda_device):
    """A tiny Llama with adapters on all seven projections: logits on the card
    (fused K2 on every adapted linear) against the same model on the CPU
    (plain, unfused), float32, tolerance 1e-4."""
    import copy

    from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
    from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
    from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch

    peft = {"nblocks": 4, "blk_r": 4, "target_modules": [
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"]}
    g = torch.Generator().manual_seed(0)
    cpu = LlamaForCausalLM(LlamaConfig.tiny(), generator=g)
    init_monarch(cpu, peft, generator=g)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if "blkdiag" in name:
                p.normal_(0.0, 0.1, generator=g)
    card = copy.deepcopy(cpu).to(cuda_device).eval()
    ids = torch.randint(3, 256, (3, 9), generator=g)
    before = monarch_cuda.LAUNCHES["monarch_add"]
    with torch.inference_mode():
        want = cpu.eval()(ids)
        got = card(ids.to(cuda_device)).cpu()
    assert monarch_cuda.LAUNCHES["monarch_add"] == before + 14
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_torch_kernels_refuse_grad_on_card(cuda_device):
    x, w1, w2, _ = _inputs(CASES[0], torch.float32, cuda_device)
    w1.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="K3"):
        monarch_cuda.monarch_kernel(x, w1, w2)
