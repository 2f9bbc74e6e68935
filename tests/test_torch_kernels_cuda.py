"""The port's CUDA kernels K1-K4 and the autograd Functions of K1 and K2
against their plain versions, on the card.  Marked ``cuda``: they skip where no card is visible, and run on the
card with ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.
This file imports no JAX, so it also runs where JAX is not installed.

Tolerances: float32 1e-5 of the output's scale (the kernel sums in another
order); bfloat16 two ulps of the output's scale (the intermediate may round
one ulp apart, and the output rounds once more).  The backward's fp32
factor gradients sum over the rows in another order: float32 1e-5 of their
scale; bfloat16 2**-6 of their scale, since an intermediate one ulp apart
enters every row's product.
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
    """(x, w1, w2, base), where base doubles as the backward's dout."""
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
    cpu = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", generator=g)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES + [(2047, 4, 4, 512, 4, 1408, 4)])
def test_torch_backward_kernels_match_plain_on_card(cuda_device, case, dtype):
    """K3 and K4 against monarch_bwd_reference / monarch_dw_fused_reference,
    on ragged row counts and L != K."""
    x, w1, w2, dout = _inputs(case, dtype, cuda_device)
    before = dict(monarch_cuda.LAUNCHES)
    got = monarch_cuda.monarch_bwd(x, w1, w2, dout)
    want = monarch_cuda.monarch_bwd_reference(x, w1, w2, dout)
    got_dw = monarch_cuda.monarch_dw_fused(x, dout, w1, w2)
    want_dw = monarch_cuda.monarch_dw_fused_reference(x, dout, w1, w2)
    torch.cuda.synchronize()
    assert monarch_cuda.LAUNCHES["monarch_bwd"] == before["monarch_bwd"] + 1
    assert monarch_cuda.LAUNCHES["monarch_dw_fused"] == before["monarch_dw_fused"] + 1
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    for g, w in zip(got + got_dw, want + want_dw):
        assert g.shape == w.shape
        assert float((g.float() - w.float()).abs().max()) <= _tol(w.to(dtype))
    again = monarch_cuda.monarch_bwd(x, w1, w2, dout)
    for a, b in zip(got, again):  # the row reduction is deterministic
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_autograd_functions_use_k3_on_card(cuda_device, dtype):
    """torch.autograd.grad through K1 and K2 (backward K3) against the plain
    Functions' gradients, for x, w1, w2 and base."""
    x, w1, w2, base = _inputs(CASES[1], dtype, cuda_device)
    cot = torch.randn(base.shape, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(1)).to(dtype)
    for name, kern, plain, leaves in [
            ("monarch_kernel", monarch_cuda.monarch_kernel, monarch_cuda.monarch_kernel_reference,
             (x, w1, w2)),
            ("monarch_add", monarch_cuda.monarch_add, monarch_cuda.monarch_add_reference,
             (base, x, w1, w2))]:
        got_leaves = [t.detach().clone().requires_grad_() for t in leaves]
        want_leaves = [t.detach().clone().requires_grad_() for t in leaves]
        before = dict(monarch_cuda.LAUNCHES)
        got = torch.autograd.grad(kern(*got_leaves), got_leaves, cot)
        want = torch.autograd.grad(plain(*want_leaves), want_leaves, cot)
        torch.cuda.synchronize()
        assert monarch_cuda.LAUNCHES[name] == before[name] + 1
        assert monarch_cuda.LAUNCHES["monarch_bwd"] == before["monarch_bwd"] + 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert float((g.float() - w.float()).abs().max()) <= _tol(w)


@pytest.mark.cuda
def test_torch_merged_apply_uses_k4_on_card(cuda_device):
    """merged_apply on the card: factor gradients through K4, with padding,
    against the same layer on the CPU (plain monarch_dw), float32."""
    import copy

    from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear

    g = torch.Generator().manual_seed(2)
    cpu = MonarchLinear(50, 40, weights=torch.randn(40, 50, generator=g) / 8, device="cpu")
    with torch.no_grad():
        cpu.blkdiag2.normal_(0.0, 0.3, generator=g)
    card = copy.deepcopy(cpu).to(cuda_device)
    x = torch.randn(3, 33, 50, generator=g)
    cot = torch.randn(3, 33, 40, generator=g)
    grads = []
    for layer, dev in ((cpu, "cpu"), (card, cuda_device)):
        layer.enable_merged_training()
        out = layer(x.to(dev))
        grads.append([t.cpu() for t in torch.autograd.grad(
            out, (layer.blkdiag1, layer.blkdiag2), cot.to(dev))] + [out.detach().cpu()])
    before = monarch_cuda.LAUNCHES["monarch_dw_fused"]
    out = card(x.to(cuda_device))
    torch.autograd.grad(out, (card.blkdiag1,), cot.to(cuda_device))
    assert monarch_cuda.LAUNCHES["monarch_dw_fused"] == before + 1
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_backward_kernels_take_unaligned_rows(cuda_device, dtype):
    """Inputs whose data does not start on 16 bytes take the generic kernel
    (the fast one loads 16 bytes at a time) and agree all the same."""
    x, w1, w2, dout = _inputs((33, 4, 4, 32, 4, 32, 4), dtype, cuda_device)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    want = monarch_cuda.monarch_bwd_reference(x, w1, w2, dout)
    for got in (monarch_cuda.monarch_bwd(shifted, w1, w2, dout),
                monarch_cuda.monarch_dw_fused(shifted, dout, w1, w2)):
        for g, w in zip(got, want[3 - len(got):]):
            assert float((g.float() - w.float()).abs().max()) <= _tol(w.to(dtype))
