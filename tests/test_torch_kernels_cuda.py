"""The port's CUDA kernels K1-K11 and their autograd Functions against their
plain versions, on the card.  Marked ``cuda``: they skip where no card is visible, and run on the
card with ``python -m pytest tests/test_torch_kernels_cuda.py -m cuda``.
This file imports no JAX, so it also runs where JAX is not installed.

Tolerances: float32 1e-5 of the output's scale (the kernel sums in another
order); bfloat16 two ulps of the output's scale (the intermediate may round
one ulp apart, and the output rounds once more).  The backward's fp32
factor gradients sum over the rows in another order: float32 1e-5 of their
scale; bfloat16 2**-6 of their scale, since an intermediate one ulp apart
enters every row's product.  K5-K8 (forward and dx of the quantized base):
the same two tolerances; both sides round each dequantized weight to the
working dtype once and sum in fp32 in another order.  K9-K11 (the fused
dense + Monarch linear): the same two tolerances; the output rounds once on
both sides, from intermediates that may round one ulp apart.
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


# -- the quantized base: K5-K8 ----------------------------------------------
# (in, out, group, rows): decode row counts (the three row tiles of the
# streaming kernel), ragged and whole training row counts, k/v's out 256,
# widths that are no multiple of the 128-wide tile (272, 1088), a k tail
# (dx over out 272), int4 groups of 32 and 60, which are no multiple of the
# forward's k step, and outputs of few tiles, whose reduction the bf16 tile
# kernel splits over CTAs: the forward of (512, 256), (1088, 272) with a
# ragged last slice and (960, 256), the dx of (256, 1024).
QUANT_CASES = [(256, 256, 64, 4), (512, 384, 64, 16), (768, 128, 32, 8), (256, 256, 64, 96),
               (512, 256, 64, 65), (2048, 256, 64, 5), (5632, 2048, 64, 4),
               (2048, 5632, 64, 2047), (1024, 512, 64, 11), (1088, 272, 32, 200),
               (960, 256, 60, 70), (256, 1024, 64, 70)]


def _quant_operands(case, bits, dtype, device):
    from sparse_matrix_fine_tuning_torch import quant

    in_f, out_f, group, rows = case
    rng = np.random.default_rng(sum(case) + bits)
    w = (rng.standard_normal((out_f, in_f)) * 0.05).astype(np.float32)
    codes, scales = quant.quantize_int4(w, group) if bits == 4 else quant.quantize_int8(w)
    x = rng.standard_normal((rows, in_f)).astype(np.float32)
    dy = rng.standard_normal((rows, out_f)).astype(np.float32)
    return ([torch.tensor(a).to(device) for a in (codes, scales)]
            + [torch.tensor(a).to(device=device, dtype=dtype) for a in (x, dy)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", QUANT_CASES)
def test_torch_quant_kernels_match_plain_on_card(cuda_device, case, bits, dtype):
    """K7/K5 and K8/K6 against their plain versions; dx twice gives the same
    bits (no atomics, a fixed order of sums)."""
    from sparse_matrix_fine_tuning_torch.kernels import quant_cuda as qc

    codes, scales, x, dy = _quant_operands(case, bits, dtype, cuda_device)
    group = case[2]
    if bits == 8:
        fwd, dx = (lambda: qc.int8_matmul(x, codes, scales)), (
            lambda: qc.int8_matmul_dx(dy, codes, scales))
        pairs = [(fwd, lambda: qc.int8_matmul_reference(x, codes, scales)),
                 (dx, lambda: qc.int8_matmul_dx_reference(dy, codes, scales))]
        names = ("int8_matmul", "int8_matmul_dx")
    else:
        fwd, dx = (lambda: qc.int4_matmul(x, codes, scales, group)), (
            lambda: qc.int4_matmul_dx(dy, codes, scales, group))
        pairs = [(fwd, lambda: qc.int4_matmul_reference(x, codes, scales, group)),
                 (dx, lambda: qc.int4_matmul_dx_reference(dy, codes, scales, group))]
        names = ("int4_matmul", "int4_matmul_dx")
    before = dict(qc.LAUNCHES)
    with torch.no_grad():
        results = [(kern(), plain()) for kern, plain in pairs]
        again = dx()
    torch.cuda.synchronize()
    assert qc.LAUNCHES[names[0]] == before[names[0]] + 1
    assert qc.LAUNCHES[names[1]] == before[names[1]] + 2
    for got, want in results:
        assert got.shape == want.shape and got.dtype == want.dtype == dtype
        assert bool(torch.isfinite(got).all())
        assert float((got.float() - want.float()).abs().max()) <= _tol(want)
    assert torch.equal(results[1][0], again)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_torch_quant_autograd_on_card(cuda_device, bits):
    """The gradient of x through int8_matmul / int4_matmul is one launch of
    K8 / K6 and matches the plain version's autograd; codes and scales get
    none, even when the scales ask for one."""
    from sparse_matrix_fine_tuning_torch.kernels import quant_cuda as qc

    codes, scales, x, dy = _quant_operands((512, 256, 64, 70), bits, torch.float32, cuda_device)
    scales.requires_grad_()
    kern = qc.int8_matmul if bits == 8 else (lambda a, c, s: qc.int4_matmul(a, c, s, 64))
    plain = qc.int8_matmul_reference if bits == 8 else (
        lambda a, c, s: qc.int4_matmul_reference(a, c, s, 64))
    name = "int8_matmul_dx" if bits == 8 else "int4_matmul_dx"
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    out = kern(xa.reshape(2, 35, 512), codes, scales)
    assert tuple(out.shape) == (2, 35, 256)
    before = qc.LAUNCHES[name]
    out.backward(dy.reshape(2, 35, 256))
    assert qc.LAUNCHES[name] == before + 1 and scales.grad is None
    (want,) = torch.autograd.grad(plain(xb, codes, scales.detach()), xb, dy)
    assert float((xa.grad - want).abs().max()) <= _tol(want)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_torch_quantized_tiny_llama_on_card_matches_cpu(cuda_device, bits):
    """A tiny Llama with adapters on all seven projections over a quantized
    base and an int8 head (w8a8): logits on the card (K7/K5 and K2 on every
    adapted linear, ``torch._int_mm`` for the head at 3 x 9 rows) against
    the same model on the CPU (plain), float32, tolerance 1e-4; the
    gradient of a factor through K8/K6 and K3 likewise."""
    import copy

    from sparse_matrix_fine_tuning_torch import quant
    from sparse_matrix_fine_tuning_torch.kernels import quant_cuda as qc
    from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
    from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
    from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch

    peft = {"nblocks": 4, "blk_r": 4, "target_modules": [
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"]}
    g = torch.Generator().manual_seed(3)
    cpu = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", generator=g)
    init_monarch(cpu, peft, generator=g)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if "blkdiag" in name:
                p.normal_(0.0, 0.1, generator=g)
    assert quant.quantize_frozen_base(cpu, bits=bits, group_size=16) == 14
    assert quant.quantize_lm_head(cpu, impl="w8a8")
    card = copy.deepcopy(cpu).to(cuda_device)
    ids = torch.randint(3, 256, (3, 9), generator=g)
    name = "int8_matmul" if bits == 8 else "int4_matmul"
    before = dict(qc.LAUNCHES)
    got = card(ids.to(cuda_device))
    want = cpu(ids)
    assert qc.LAUNCHES[name] == before[name] + 14
    torch.testing.assert_close(got.detach().cpu(), want.detach(), rtol=1e-4, atol=1e-4)
    layer_card = card.model.layers[0].mlp.down_proj
    layer_cpu = cpu.model.layers[0].mlp.down_proj
    (gc,) = torch.autograd.grad(got.square().mean(), layer_card.blkdiag1)
    (gw,) = torch.autograd.grad(want.square().mean(), layer_cpu.blkdiag1)
    assert qc.LAUNCHES[name + "_dx"] > before[name + "_dx"]
    torch.testing.assert_close(gc.cpu(), gw, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4, 17, 24, 2048])
def test_torch_int8_dot_on_card(cuda_device, rows):
    """``torch._int_mm`` through ``quant.int8_dot``: exact int32 sums at
    decode's row counts (padded to what cuBLAS takes) and at training's."""
    from sparse_matrix_fine_tuning_torch import quant

    gen = torch.Generator().manual_seed(rows)
    xq = torch.randint(-127, 128, (rows, 2048), generator=gen, dtype=torch.int32).to(torch.int8)
    q = torch.randint(-127, 128, (2048, 256), generator=gen, dtype=torch.int32).to(torch.int8)
    got = quant.int8_dot(xq.to(cuda_device), q.to(cuda_device)).cpu()
    assert got.dtype == torch.int32
    assert torch.equal(got, (xq.long() @ q.long()).to(torch.int32))


# -- the fused dense + Monarch linear: K9, K10 and K11 ------------------------
# (rows, n, m, K, Q, L), R = K*Q / L: aligned and ragged row counts, a width
# no multiple of the 128-wide tile (96, 192, 24), L != K, and blk_r 16
# (K*Q = 64, the most the kernels take).  The kernels take n and m that are
# multiples of 8 and K*Q <= 64; the binding refuses the rest.
MORE_CASES = [(256, 256, 384, 4, 4, 4), (200, 128, 96, 4, 8, 4), (65, 96, 192, 4, 4, 4),
              (9, 64, 24, 4, 2, 2), (300, 1024, 1024, 4, 16, 4)]


def _more_operands(case, dtype, device):
    """x, dense_w, w1, w2 and dout (or a cotangent)."""
    rows, n, m, K, Q, L = case
    R = K * Q // L
    rng = np.random.default_rng(sum(case))
    arrays = (rng.standard_normal((rows, n)), rng.standard_normal((m, n)) / np.sqrt(n),
              rng.standard_normal((K, Q, n // K)) / np.sqrt(n // K),
              rng.standard_normal((L, m // L, R)) / np.sqrt(R), rng.standard_normal((rows, m)))
    return [torch.tensor(a, dtype=torch.float32).to(device=device, dtype=dtype) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MORE_CASES)
def test_torch_more_linear_kernels_match_plain_on_card(cuda_device, case, dtype):
    """K9, K10 and K11 against their plain versions (the factor gradients in
    fp32, held to the tolerance of the inputs' dtype); K11 counts under its
    own key and leaves K4's count; K10 twice gives the same bits."""
    from sparse_matrix_fine_tuning_torch.kernels.experimental import more_linear as ml

    x, wd, w1, w2, dout = _more_operands(case, dtype, cuda_device)
    before, k4 = dict(ml.LAUNCHES), monarch_cuda.LAUNCHES["monarch_dw_fused"]
    with torch.no_grad():
        pairs = [(ml.more_linear_fwd(x, wd, w1, w2), ml.more_linear_fwd_reference(x, wd, w1, w2)),
                 (ml.more_linear_dx(dout, wd, w1, w2),
                  ml.more_linear_dx_reference(dout, wd, w1, w2)),
                 *zip(ml.more_linear_dw(x, dout, w1, w2),
                      ml.more_linear_dw_reference(x, dout, w1, w2))]
        again = ml.more_linear_dx(dout, wd, w1, w2)
    torch.cuda.synchronize()
    assert ml.LAUNCHES == {"more_linear_fwd": before["more_linear_fwd"] + 1,
                           "more_linear_dx": before["more_linear_dx"] + 2,
                           "more_linear_dw": before["more_linear_dw"] + 1}
    assert monarch_cuda.LAUNCHES["monarch_dw_fused"] == k4
    for got, want in pairs:
        assert got.shape == want.shape and got.dtype == want.dtype
        assert bool(torch.isfinite(got).all())
        assert float((got.float() - want.float()).abs().max()) <= _tol(want.to(dtype))
    assert torch.equal(pairs[1][0], again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torch_more_linear_autograd_on_card(cuda_device, dtype):
    """One forward and backward of ``more_linear`` on a 3-D input launches
    K9, K10 and K11 once each and matches the plain composition's autograd
    for x, w1 and w2; dense_w gets no gradient."""
    from sparse_matrix_fine_tuning_torch.kernels.experimental import more_linear as ml
    from sparse_matrix_fine_tuning_torch.ops.monarch import monarch_forward_f32

    x, wd, w1, w2, cot = _more_operands(MORE_CASES[1], dtype, cuda_device)
    got_leaves = [t.clone().requires_grad_() for t in (x, w1, w2)]
    want_leaves = [t.clone().requires_grad_() for t in (x, w1, w2)]
    wd.requires_grad_()
    before = dict(ml.LAUNCHES)
    y = ml.more_linear(got_leaves[0].reshape(2, 100, -1), wd, *got_leaves[1:])
    y.backward(cot.reshape(2, 100, -1))
    torch.cuda.synchronize()
    assert ml.LAUNCHES == {k: v + 1 for k, v in before.items()}
    assert wd.grad is None
    xb, w1b, w2b = want_leaves
    plain = (xb.float() @ wd.detach().float().T + monarch_forward_f32(xb, w1b, w2b)).to(dtype)
    want = [plain.detach()] + list(torch.autograd.grad(plain, want_leaves, cot))
    for g, w in zip([y.detach().reshape(plain.shape)] + [t.grad for t in got_leaves], want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert float((g.float() - w.float()).abs().max()) <= _tol(w)


@pytest.mark.cuda
def test_torch_more_linear_kernels_refuse_shapes_they_do_not_take(cuda_device):
    """A width that is no multiple of 8, and K*Q > 64, raise on the card and
    launch nothing: no CUDA input reaches the plain versions."""
    from sparse_matrix_fine_tuning_torch.kernels.experimental import more_linear as ml

    for case in ((8, 36, 64, 4, 4, 4), (8, 256, 256, 4, 32, 4)):
        x, wd, w1, w2, dout = _more_operands(case, torch.float32, cuda_device)
        before = dict(ml.LAUNCHES)
        for call in (lambda: ml.more_linear_fwd(x, wd, w1, w2),
                     lambda: ml.more_linear_dx(dout, wd, w1, w2),
                     lambda: ml.more_linear(x, wd, w1, w2)):
            with pytest.raises(RuntimeError, match="the kernels take"):
                call()
        assert ml.LAUNCHES == before
