"""The port's CUDA kernels K1-K16 and their autograd Functions against their
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
both sides, from intermediates that may round one ulp apart.  K12 (K1 at a
row tile) as K1, and equal to K1 bit for bit at every row tile (the order of
the kernel's sums does not depend on its plan); K15 (the tiled bf16 matmul)
two bf16 ulps: both sides round once from fp32 sums taken in another order.
K13 and K14 (K4 at a row group) as K4.  K16 (K5's decode kernel in the
seven int4 arithmetic variants): two bf16 ulps of the raw output's scale, as
K5; its f32mul variant equals K5 bit for bit at the decode rows.
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


# K1/K2's ragged cases, (batch, K, Q, P, L, S, R, offset of x and base in
# elements, 1: off 16 bytes): every row count the plan treats apart (0; 1,
# 4 and 16, one decode tile; 17, 65 and 2048, ragged against the 8-row
# tile and stage 1's 4-row batches); P and S*L no multiple of 8 (partial
# 16-byte chunks); K != L and Q != R; Q = 6 ragged against stage 1's
# 4-q groups; P of 65 and 176 chunks (two and three chunks a lane, the
# second segment ragged); m ragged against the decode range of 32 chunks;
# L = 4 with R = 16 (w2 in registers) ragged and off 16 bytes; a training
# tile of 8 rows whose threads take a chunk each and prefetch base 4 rows at
# a time (two passes), ragged against the tile; a wide J whose plan needs
# more than 48 KB of shared memory (J 512, 96 KB: K1's function raises its
# limit, then K2's must too), and one past 227 KB at a tile of 16 rows (J
# 2048: the plan halves the tile to 8 rows).
FWD_RAGGED_CASES = [(0, 4, 4, 32, 4, 8, 4, 0), (1, 4, 4, 13, 4, 7, 4, 1),
                    (4, 2, 8, 36, 4, 9, 4, 1), (16, 3, 5, 9, 5, 3, 3, 1),
                    (17, 4, 6, 520, 8, 33, 3, 0), (65, 4, 4, 1100, 4, 36, 4, 1),
                    (4, 4, 4, 512, 4, 1100, 4, 1), (2048, 4, 4, 1408, 4, 65, 4, 1),
                    (33, 2, 32, 20, 4, 13, 16, 1), (1030, 4, 4, 512, 4, 520, 4, 0),
                    (16, 4, 128, 520, 8, 40, 64, 0), (16, 8, 256, 64, 8, 24, 256, 1)]


def _offset(t: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous copy of ``t`` ``off`` elements into its buffer, as a
    sliced view would be."""
    buf = torch.empty(t.numel() + off, device=t.device, dtype=t.dtype)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FWD_RAGGED_CASES)
def test_torch_forward_kernels_take_ragged_unaligned_shapes(cuda_device, case, dtype):
    """K1 and K2 against their plain versions at the ragged cases, x and
    base sliced views where the case says so; one launch each."""
    *shape, off = case
    x, w1, w2, base = _inputs(tuple(shape), dtype, cuda_device)
    x, base = _offset(x, off), _offset(base, off)
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
        if want.numel():
            assert bool(torch.isfinite(got).all())
            assert float((got.float() - want.float()).abs().max()) <= _tol(want)


@pytest.mark.cuda
def test_torch_forward_plan_covers_the_call_on_card(cuda_device):
    """K1/K2's plan at the 1.1B model's projections and every row count of
    the main paths: one row tile at decode, its tiles and column ranges
    cover every row and output chunk, its shared memory fits, and K12's
    plan takes the row tile it is given.  At a J whose tile of 16 rows would
    not fit in shared memory the plan halves its row tile; K12's forced
    tile is refused there."""
    nb, r = 4, 4
    for m_rows in (1, 4, 16, 17, 65, 256, 2048):
        for n_in, n_out in ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)):
            for dtype, vec in ((torch.bfloat16, 8), (torch.float32, 4)):
                plan = monarch_cuda.monarch_fwd_plan(m_rows, (nb, r, n_in // nb),
                                                     (nb, n_out // nb, r), dtype)
                assert plan["rows"] * plan["row_tiles"] >= m_rows
                assert plan["row_tiles"] == (1 if m_rows <= 16 else -(-m_rows // plan["rows"]))
                assert plan["ranges"] * plan["chunks"] * vec >= n_out
                assert plan["ranges"] == -(-(-(-n_out // vec)) // plan["chunks"])
                assert 0 < plan["smem"] <= 232448
    for rows in monarch_cuda.FWD_TILE_ROWS:
        assert monarch_cuda.monarch_fwd_plan(2664, (4, 16, 1024), (4, 1024, 16),
                                             rows=rows)["rows"] == rows
    for dtype in (torch.bfloat16, torch.float32):
        plan = monarch_cuda.monarch_fwd_plan(16, (8, 256, 64), (8, 24, 256), dtype)
        assert (plan["rows"], plan["row_tiles"], plan["smem"]) == (8, 2, 8 * 4096 * 4)
        with pytest.raises(RuntimeError):
            monarch_cuda.monarch_fwd_plan(16, (8, 256, 64), (8, 24, 256), dtype, rows=16)


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


# The cluster kernel (csrc/monarch_bwd.cu's bwd_cluster_kernel), (M, K, Q,
# P, L, S, R): one row; M past its 16- and 32-row tiles and its stages (2049
# rows at gate_proj's widths: 16-row tiles, 2 stages); slices of dout uneven
# over the cluster's four CTAs (S = 6: 2, 2, 2, 0 values of s; S = 14: 4, 4,
# 4, 2); P = 520, no multiple of the 16-wide k step; down_proj's P = 1408;
# blk_r 4, 8 and 16; the fused linear bench's gate shape (2664 x 4096 ->
# 11264, blk_r 8), whose dw2 sums do not fit in shared memory beside a
# stage and live in the cluster's partial in device memory.
CLUSTER_CASES = [(1, 4, 8, 16, 4, 6, 8), (17, 4, 4, 520, 4, 14, 4), (33, 4, 8, 64, 4, 48, 8),
                 (100, 4, 16, 1024, 4, 256, 16), (70, 4, 4, 1408, 4, 512, 4),
                 (2049, 4, 4, 512, 4, 1408, 4), (2664, 4, 8, 1024, 4, 2816, 8)]


def _planned(x, dout, w1, w2, with_dx, tile, stages):
    """K3 (``with_dx``) or K4 on the cluster kernel at a forced (tile,
    stages), through the library's C interface."""
    import ctypes

    from sparse_matrix_fine_tuning_torch.kernels.build import build

    lib = ctypes.CDLL(str(build()))
    fn = lib.smft_monarch_bwd_planned
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int64]
                   + [ctypes.c_int] * 6 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p])
    K, Q, P = w1.shape
    L, S, R = w2.shape
    plan = monarch_cuda.monarch_bwd_plan_fields(x.shape[0], w1.shape, w2.shape, with_dx=with_dx,
                                                dtype=x.dtype, tile=tile, stages=stages)
    if not plan["fast"]:
        return None
    floats = plan["clusters"] * K * Q * (P + S) if plan["clusters"] > 1 else 0
    work = torch.empty(max(floats, 1), device=x.device)
    dx = torch.empty_like(x) if with_dx else None
    dw1 = torch.empty(K, Q, P, device=x.device)
    dw2 = torch.empty(L, S, R, device=x.device)
    err = fn(1 if x.dtype == torch.bfloat16 else 0, x.get_device(), x.data_ptr(), dout.data_ptr(),
             w1.data_ptr(), w2.data_ptr(), dx.data_ptr() if with_dx else None,
             work.data_ptr() if floats else None, dw1.data_ptr(), dw2.data_ptr(), x.shape[0],
             K, Q, P, L, S, R, 0, tile, stages, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return (dx, dw1, dw2) if with_dx else (dw1, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CLUSTER_CASES)
def test_torch_backward_cluster_kernel_on_card(cuda_device, case, dtype):
    """K3 and K4 on the cluster kernel (``monarch_bwd_plan_fields``: a plan
    whose tile, stages and slice are ragged against the case) against their
    plain versions, one launch counted each; a repeat gives the same bits,
    and so does every forced row tile and stage depth that fits."""
    batch = case[0]
    x, w1, w2, dout = _inputs(case, dtype, cuda_device)
    before = dict(monarch_cuda.LAUNCHES)
    with torch.no_grad():
        want = monarch_cuda.monarch_bwd_reference(x, w1, w2, dout)
        for with_dx, name in ((True, "monarch_bwd"), (False, "monarch_dw_fused")):
            plan = monarch_cuda.monarch_bwd_plan_fields(batch, w1.shape, w2.shape,
                                                        with_dx=with_dx, dtype=dtype)
            assert plan["fast"] == 1 and plan["clusters"] >= 1 and plan["tile"] in (8, 16, 32)
            assert plan["dw2_global"] == (case == CLUSTER_CASES[-1])
            call = (lambda: monarch_cuda.monarch_bwd(x, w1, w2, dout)) if with_dx else \
                (lambda: monarch_cuda.monarch_dw_fused(x, dout, w1, w2))
            got, again = call(), call()
            torch.cuda.synchronize()
            for g, a, w in zip(got, again, want if with_dx else want[1:]):
                assert g.shape == w.shape and g.dtype == w.dtype and bool(torch.isfinite(g).all())
                assert float((g.float() - w.float()).abs().max()) <= _tol(w.to(dtype)), name
                assert torch.equal(g, a), name
            for tile in (8, 16, 32):
                for stages in (1, 2, 3):
                    forced = _planned(x, dout, w1, w2, with_dx, tile, stages)
                    torch.cuda.synchronize()
                    if forced is not None:
                        assert all(torch.equal(f, g) for f, g in zip(forced, got)), \
                            (name, tile, stages)
    assert monarch_cuda.LAUNCHES["monarch_bwd"] == before["monarch_bwd"] + 2
    assert monarch_cuda.LAUNCHES["monarch_dw_fused"] == before["monarch_dw_fused"] + 2


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
    (the cluster kernel copies rows of 16-byte units) and agree all the same."""
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
# (in, out, group, rows): decode row counts (the decode kernel's n8 tiles:
# rows 1 to 8 one, 9 to 16 two), ragged and whole training row counts, k/v's out 256,
# widths that are no multiple of the 128-wide tile (272, 1088), a k tail
# (dx over out 272), int4 groups of 32 and 60, which are no multiple of the
# forward's k step, and outputs of few tiles, whose reduction the bf16 tile
# kernels split over CTAs: the forward of (512, 256), (1088, 272) with a
# ragged last slice and (960, 256), the dx of (256, 1024).  For the int4
# wgmma kernel (quant_wgmma.cu): M = 17, its first forward row count; group
# 8, whose 64-row stages span 8 scale rows; TinyLlama's down_proj at a
# training micro-batch (h = 2816), both directions.  For its int8 format:
# in 1088 at M = 17 and 129 (one row past a row tile); k_proj's out 256 at
# a training micro-batch (the forward's split reduction).  For the decode
# kernel (M <= 16; 64 output columns and k16 steps of code rows): rows 1
# and 9, in 1000 (int8: a k16 tail of 8 rows; int4: h = 500, a tail of 4,
# group 20) and 1040 (int4: h = 520, a tail of 8, group 8), out 272 and 336
# ragged against the 64-column tile, group 32 at 16 rows.
QUANT_CASES = [(256, 256, 64, 4), (512, 384, 64, 16), (768, 128, 32, 8), (256, 256, 64, 96),
               (512, 256, 64, 65), (2048, 256, 64, 5), (5632, 2048, 64, 4),
               (2048, 5632, 64, 2047), (1024, 512, 64, 11), (1088, 272, 32, 200),
               (960, 256, 60, 70), (256, 1024, 64, 70), (1024, 384, 64, 17),
               (768, 272, 8, 33), (5632, 2048, 64, 2048), (1088, 384, 32, 17),
               (1088, 272, 32, 129), (2048, 256, 64, 2048),
               (1000, 272, 20, 1), (1040, 336, 8, 9), (1088, 272, 32, 16), (1040, 272, 8, 1)]
# Ragged `in` at M = 17 and 129 (the tile paths), both formats: in 1000,
# 1032 and 1096, no multiple of int8's k stage of 64, so that its forward's
# last stage reads TMA's zeros past in; int4's h = in / 2 (500, 516, 548)
# no multiple of 8, where its tile forward reads an aligned copy of x (the
# high half's TMA box would start off 16 bytes; ROADMAP C.8).
RAGGED_IN_QUANT_CASES = [(1000, 272, 20, 17), (1000, 272, 20, 129), (1032, 272, 43, 17),
                         (1032, 272, 43, 129), (1096, 384, 548, 17), (1096, 384, 548, 129)]
# W seen whole through x = I and dy = I: (in, out, group); in 1088 is no
# multiple of int4's 64-code-row stage, out 272 of the 128-column tile
IDENTITY_CASE = (1088, 272, 32)
# int8's: in 1096 is no multiple of its k stage of 64 (nor of a k16 step)
INT8_IDENTITY_CASE = (1096, 272, 548)


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
@pytest.mark.parametrize("bits,case", [(8, IDENTITY_CASE), (8, INT8_IDENTITY_CASE),
                                       (4, IDENTITY_CASE)])
def test_torch_quant_kernels_show_w_whole_on_card(cuda_device, bits, case):
    """Before any random case: with x = I the bf16 forward is W itself, and
    with dy = I dx is W^T, bit for bit (one product a sum, exact in fp32),
    so a wrong layout, descriptor or mask in the wgmma kernel shows as a
    wrong cell rather than as a larger error."""
    from sparse_matrix_fine_tuning_torch.kernels import quant_cuda as qc

    n_in, n_out, group = case
    codes, scales, _, _ = _quant_operands((n_in, n_out, group, 1), bits, torch.bfloat16,
                                          cuda_device)
    if bits == 8:
        w = qc.dequant_int8_t(codes, scales, torch.bfloat16)
        fwd, dx = qc.int8_matmul, qc.int8_matmul_dx
        extra = ()
    else:
        w = torch.cat(qc.dequant_int4_t(codes, scales, group, torch.bfloat16))
        fwd, dx = qc.int4_matmul, qc.int4_matmul_dx
        extra = (group,)
    with torch.no_grad():
        y = fwd(torch.eye(n_in, device=cuda_device, dtype=torch.bfloat16), codes, scales, *extra)
        g = dx(torch.eye(n_out, device=cuda_device, dtype=torch.bfloat16), codes, scales, *extra)
    torch.cuda.synchronize()
    assert torch.equal(y, w)
    assert torch.equal(g, w.T)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,bits", [(c, b) for c in QUANT_CASES for b in (8, 4)]
                         + [(c, b) for c in RAGGED_IN_QUANT_CASES for b in (8, 4)])
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


# The decode kernel's identity cases: (bits, (in, out, group)); int4 at
# group 32 and at group 8 (a scale row every 8 code rows, h = 520 with a
# k16 tail of 8)
DECODE_IDENTITY_CASES = [(8, INT8_IDENTITY_CASE), (4, IDENTITY_CASE), (4, (1040, 336, 8))]
# The 1.1B model's seven projections (in, out), as the decode step runs them
DECODE_PROJECTIONS = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)]


def _quant_dense(bits, codes, scales, group, dtype):
    from sparse_matrix_fine_tuning_torch.kernels import quant_cuda as qc

    if bits == 8:
        return qc.dequant_int8_t(codes, scales, dtype)
    return torch.cat(qc.dequant_int4_t(codes, scales, group, dtype))


def _quant_forward(bits, x, codes, scales, group):
    from sparse_matrix_fine_tuning_torch.kernels import quant_cuda as qc

    if bits == 8:
        return qc.int8_matmul(x, codes, scales)
    return qc.int4_matmul(x, codes, scales, group)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,case", DECODE_IDENTITY_CASES)
def test_torch_quant_decode_shows_w_rows_on_card(cuda_device, bits, case, dtype, rows):
    """The decode kernel (K5/K7 at M <= 16) on one-hot rows of x gives rows
    of W bit for bit (one product a sum, exact in fp32), at the start of
    `in`, across int4's two halves and at its end, so that a wrong A
    fragment, scale row or mask shows as a wrong cell; the same call twice
    gives the same bits."""
    n_in, n_out, group = case
    codes, scales, _, _ = _quant_operands((n_in, n_out, group, 1), bits, dtype, cuda_device)
    w = _quant_dense(bits, codes, scales, group, dtype)
    with torch.no_grad():
        for start in (0, n_in // 2 - rows // 2, n_in - rows):
            x = torch.zeros(rows, n_in, device=cuda_device, dtype=dtype)
            x[torch.arange(rows), start + torch.arange(rows)] = 1
            y = _quant_forward(bits, x, codes, scales, group)
            again = _quant_forward(bits, x, codes, scales, group)
            torch.cuda.synchronize()
            assert torch.equal(y, w[start:start + rows]), (start, rows)
            assert torch.equal(y, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
def test_torch_quant_decode_repeats_bit_for_bit_on_card(cuda_device, bits, dtype):
    """At the decode step's shapes the forward is one launch a call, and
    twice the same call gives the same bits: the slices of a column tile
    are summed in rank order across the cluster, with no atomics."""
    from sparse_matrix_fine_tuning_torch.kernels import quant_cuda as qc

    name = f"int{bits}_matmul"
    for n_in, n_out in DECODE_PROJECTIONS:
        for rows in (4, 16):
            codes, scales, x, _ = _quant_operands((n_in, n_out, 64, rows), bits, dtype,
                                                  cuda_device)
            before = qc.LAUNCHES[name]
            with torch.no_grad():
                first = _quant_forward(bits, x, codes, scales, 64)
                second = _quant_forward(bits, x, codes, scales, 64)
            torch.cuda.synchronize()
            assert qc.LAUNCHES[name] == before + 2
            assert torch.equal(first, second), (n_in, n_out, rows)


@pytest.mark.cuda
def test_torch_quant_decode_plan_fits_one_wave_on_card(cuda_device):
    """The decode kernel's plan in bf16 (serving's) keeps its CTAs within
    one wave (the SMs times the CTAs an SM the occupancy gives at the
    plan's shared memory, at least two) with one block of rows at M <= 16;
    in f32 (the checks' path, blocks of 4 rows) it splits the code rows
    only where the blocks of rows and column tiles leave CTAs of that wave
    free; every plan has at most 8 slices (a cluster) and one chunk a
    slice.  Every instantiation runs with no local memory (no spill), at
    most 128 registers and two 256-thread CTAs an SM at the most shared
    memory a CTA takes."""
    from sparse_matrix_fine_tuning_torch.kernels import quant_cuda as qc

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bits in (8, 4):
        for dtype in (torch.bfloat16, torch.float32):
            for n_in, n_out in DECODE_PROJECTIONS + [(1000, 272), (1040, 336)]:
                group = 8 if n_in == 1040 else 20 if n_in == 1000 else 64
                for rows in (1, 4, 9, 16):
                    plan = qc.decode_plan(bits, dtype, rows, n_in, n_out, group)
                    assert plan["ctas_per_sm"] >= 2, plan
                    wave = sms * plan["ctas_per_sm"]
                    if dtype == torch.bfloat16 or plan["slices"] > 1:
                        assert plan["ctas"] <= wave, plan
                    assert 1 <= plan["slices"] <= 8 and plan["col_tile"] == 64, plan
                    assert plan["chunk_rows"] == plan["slice_rows"], plan
                    assert plan["mma"] == (dtype == torch.bfloat16), plan
                    if dtype == torch.bfloat16:
                        assert plan["row_blocks"] == 1 and plan["rows"] == (8 if rows <= 8 else 16)
    attrs = qc.decode_attrs()
    assert len(attrs) == 13
    for a in attrs:
        assert a["local_bytes"] == 0 and a["registers"] <= 128, a
        assert a["ctas_per_sm"] >= 2 and a["threads"] >= 256, a


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
# (K*Q = 64, the most the kernels take); P = 16, 24 and 32, where one
# 64-wide k step straddles factor blocks; the last three, 2664 rows at 1800
# -> 1800, take bf16's 128-row tile plans (J = 16: 256 columns; J = 32: K9
# 224, K10 192; J = 64: 192; the others its 64 x 128 one), ragged against
# them in M and N: with the 64 x 128 cases, every tile of the plan.
# The kernels take n and m that are multiples of 8 and K*Q <= 64; the
# binding refuses the rest.
MORE_CASES = [(256, 256, 384, 4, 4, 4), (200, 128, 96, 4, 8, 4), (65, 96, 192, 4, 4, 4),
              (9, 64, 24, 4, 2, 2), (300, 1024, 1024, 4, 16, 4), (2664, 1800, 1800, 4, 4, 4),
              (2664, 1800, 1800, 4, 8, 4), (2664, 1800, 1800, 4, 16, 4)]
# the repeat test's cases: MORE_CASES and the bench's gate shape (2664 x 4096
# -> 11264, J = 32)
REPEAT_CASES = MORE_CASES + [(2664, 4096, 11264, 4, 8, 4)]
REPEATS = 100


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
def test_torch_more_linear_plan_on_card(cuda_device):
    """bf16's tile plan: 128 rows where 128 x 256 tiles make a wave of CTAs
    (the last three MORE_CASES entries, the bench's qkv and gate shapes), 256
    columns wide at J <= 16, at J <= 32 K9 224 and K10 192, 192 above; else
    64 x 128; the summaries' width J rounded up to 16; the grid
    covers the output."""
    from sparse_matrix_fine_tuning_torch.kernels.experimental import more_linear as ml

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(rows, n, m, K * Q) for rows, n, m, K, Q, _ in MORE_CASES]
    shapes += [(2664, 4096, 4096, 16), (1024, 1024, 1024, 64), (2664, 4096, 11264, 32)]
    for rows, n, m, j in shapes:
        for dx in (False, True):
            plan = ml.more_linear_plan(rows, n, m, j, dx)
            width = n if dx else m
            big = -(-rows // 128) * -(-width // 256) >= sms
            wide = 256 if j <= 16 else 192 if dx or j > 32 else 224
            want = (128, wide) if big else (64, 128)
            assert (plan["bm"], plan["bn"]) == want, (rows, n, m, j)
            assert plan["jk"] == -(-j // 16) * 16 or (j > 32 and plan["jk"] == 64)
            assert plan["row_tiles"] * plan["bm"] >= rows > (plan["row_tiles"] - 1) * plan["bm"]
            assert plan["col_tiles"] * plan["bn"] >= width > (plan["col_tiles"] - 1) * plan["bn"]
            assert 2 <= plan["stages"] <= 4 and plan["smem"] <= 232448
    assert ml.more_linear_plan(*MORE_CASES[-3][:3], 16, False)["bn"] == 256
    assert ml.more_linear_plan(*MORE_CASES[-2][:3], 32, False)["bn"] == 224
    assert ml.more_linear_plan(*MORE_CASES[-1][:3], 64, True)["bn"] == 192
    assert ml.more_linear_plan(*MORE_CASES[-1][:3], 64, False)["bm"] == 128
    assert ml.more_linear_plan(1024, 1024, 1024, 64, True)["bm"] == 64


@pytest.mark.cuda
@pytest.mark.parametrize("case", REPEAT_CASES)
def test_torch_more_linear_bf16_repeat_on_card(cuda_device, case):
    """A bf16 K9 or K10 call repeated REPEATS times gives the same bits
    every time (a race in the ring or the factor slices would show as a
    call that differs)."""
    from sparse_matrix_fine_tuning_torch.kernels.experimental import more_linear as ml

    x, wd, w1, w2, dout = _more_operands(case, torch.bfloat16, cuda_device)
    with torch.no_grad():
        for name, call in (("K9", lambda: ml.more_linear_fwd(x, wd, w1, w2)),
                           ("K10", lambda: ml.more_linear_dx(dout, wd, w1, w2))):
            first = call()
            differ = [i for i in range(REPEATS) if not torch.equal(first, call())]
            assert not differ, f"{name}: calls {differ} of {REPEATS} gave other bits"


@pytest.mark.cuda
def test_torch_more_linear_bf16_one_launch_on_card(cuda_device):
    """Each bf16 K9 and K10 call at every MORE_CASES entry is one launch of
    the fused kernel, by the profiler's count of all the calls in one
    session (the profiler loses records in sessions after others in a
    process: ROADMAP C.10)."""
    from torch.profiler import ProfilerActivity, profile

    from sparse_matrix_fine_tuning_torch.kernels.experimental import more_linear as ml

    calls = []
    for case in MORE_CASES:
        x, wd, w1, w2, dout = _more_operands(case, torch.bfloat16, cuda_device)
        calls += [lambda x=x, wd=wd, w1=w1, w2=w2: ml.more_linear_fwd(x, wd, w1, w2),
                  lambda d=dout, wd=wd, w1=w1, w2=w2: ml.more_linear_dx(d, wd, w1, w2)]
    with torch.no_grad():
        for call in calls:  # build and warm up outside the session
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for call in calls:
                call()
            torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == len(calls) and all("fused_kernel" in k for k in kernels), kernels


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


# -- the forward-tile experiments: K15 (tiled matmul) and K12 (row tiles) -----
# K15: (M, K, N) at the bench shape and ragged in every dimension (M past
# every BM, K past the k step of 64, N past every BN; K, N multiples of 8).
TILED_SHAPES = [(2664, 4096, 4096), (200, 200, 392), (64, 64, 128)]
# K12: (batch, K, Q, P, L, S, R) at the bench shapes (the JAX script's rank
# r*K = 16 and the adapters' rank 4) and a ragged batch
FWD_TILE_CASES = [(2664, 4, 16, 1024, 4, 1024, 16), (2664, 4, 4, 1024, 4, 1024, 4),
                  (65, 4, 8, 16, 4, 24, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TILED_SHAPES)
def test_torch_tiled_matmul_matches_plain_on_card(cuda_device, shape):
    """K15 at every tile against ``tiled_matmul_reference`` (bf16: both round
    once from fp32 sums taken in another order); one launch a call."""
    from sparse_matrix_fine_tuning_torch.kernels.experimental import tiled_matmul as tm

    m, k, n = shape
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=cuda_device).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device=cuda_device) * 0.02).to(torch.bfloat16)
    want = tm.tiled_matmul_reference(x, w)
    before = tm.LAUNCHES["tiled_matmul"]
    for tile in tm.TILES:
        got = tm.tiled_matmul(x, w, tile)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got).all())
        assert float((got.float() - want.float()).abs().max()) <= _tol(want), tile
    assert tm.LAUNCHES["tiled_matmul"] == before + len(tm.TILES)


def _tiled_operands(m, k, n, device):
    g = torch.Generator(device=device).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=device).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device=device) * 0.02).to(torch.bfloat16)
    return x, w


@pytest.mark.cuda
def test_torch_tiled_matmul_schedule_edges_on_card(cuda_device):
    """K15's persistent schedule at its edges, at every tile, sized from the
    card's own resident clusters (the plan, which must equal the Python
    mirror ``schedule_plan``): under a wave of units, a whole wave, one unit
    past it (its second row tile past M), K of one k step, of 64 k + 8 and
    under one step, and N past BN; each within tolerance of the plain
    version, one launch a call."""
    from sparse_matrix_fine_tuning_torch.kernels.experimental import tiled_matmul as tm

    for tile in tm.TILES:
        bm, bn = tile[:2]
        resident = tm.tiled_matmul_plan(2664, 4096, 4096, tile)["resident"]
        rc = resident // tm.CLUSTER
        cases = {"under a wave": ((2 * (rc - 2)) * bm - 5, 200, bn - 8, rc - 2),
                 "a whole wave": (2 * rc * bm - 5, 64, bn, rc),
                 "one unit past a wave": ((2 * rc + 1) * bm - 5, 136, bn - 8, rc + 1),
                 "N past BN": (rc * bm - 5, 8, bn + 8, None)}
        for label, (m, k, n, units) in cases.items():
            plan = tm.tiled_matmul_plan(m, n, k, tile)
            assert plan == tm.schedule_plan(m, n, k, tile, resident), (tile, label, plan)
            assert units is None or plan["units"] == units, (tile, label, plan)
            x, w = _tiled_operands(m, k, n, cuda_device)
            want = tm.tiled_matmul_reference(x, w)
            before = tm.LAUNCHES["tiled_matmul"]
            got = tm.tiled_matmul(x, w, tile)
            torch.cuda.synchronize()
            assert tm.LAUNCHES["tiled_matmul"] == before + 1
            assert got.shape == want.shape and bool(torch.isfinite(got).all())
            assert float((got.float() - want.float()).abs().max()) <= _tol(want), (tile, label)


@pytest.mark.cuda
def test_torch_tiled_matmul_repeats_bits_on_card(cuda_device):
    """K15 at the bench shape, 2664 x 4096 -> 4096, at every tile: a repeated
    call gives the same bits (each output summed in one fixed order), one
    launch a call; and the profiler sees one kernel a call."""
    from torch.profiler import ProfilerActivity, profile

    from sparse_matrix_fine_tuning_torch.kernels.experimental import tiled_matmul as tm

    x, w = _tiled_operands(2664, 4096, 4096, cuda_device)
    for tile in tm.TILES:
        before = tm.LAUNCHES["tiled_matmul"]
        first = tm.tiled_matmul(x, w, tile)
        again = tm.tiled_matmul(x, w, tile)
        torch.cuda.synchronize()
        assert tm.LAUNCHES["tiled_matmul"] == before + 2
        assert torch.equal(first, again), tile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tm.tiled_matmul(x, w)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "tiled_mm_kernel" in kernels[0], kernels


@pytest.mark.cuda
def test_torch_tiled_matmul_refuses_what_it_does_not_take(cuda_device):
    """float32, K or N no multiple of 8, and a tile that is not instantiated
    raise on the card and launch nothing."""
    from sparse_matrix_fine_tuning_torch.kernels.experimental import tiled_matmul as tm

    before = dict(tm.LAUNCHES)
    x = torch.randn(64, 64, device=cuda_device)
    with pytest.raises(RuntimeError, match="bfloat16"):
        tm.tiled_matmul(x, x)
    with pytest.raises(RuntimeError, match="not instantiated"):
        tm.tiled_matmul(x.bfloat16(), x.bfloat16(), (256, 256, 2))
    for k, n in ((60, 64), (64, 60)):
        with pytest.raises(RuntimeError, match="multiples of 8"):
            tm.tiled_matmul(torch.randn(64, k, device=cuda_device).bfloat16(),
                            torch.randn(k, n, device=cuda_device).bfloat16())
    assert tm.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FWD_TILE_CASES)
def test_torch_fwd_tile_matches_plain_on_card(cuda_device, case, dtype):
    """K12 at every row tile against ``monarch_kernel_reference``, and equal
    bit for bit to K1 at the row tile K1's own plan picks."""
    x, w1, w2, _ = _inputs(case, dtype, cuda_device)
    before = monarch_cuda.LAUNCHES["monarch_fwd_tile"]
    with torch.no_grad():
        want = monarch_cuda.monarch_kernel_reference(x, w1, w2)
        k1 = monarch_cuda.monarch_kernel(x, w1, w2)
        for rows in monarch_cuda.FWD_TILE_ROWS:
            got = monarch_cuda.monarch_fwd_tile(x, w1, w2, rows)
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == want.dtype
            assert float((got.float() - want.float()).abs().max()) <= _tol(want), rows
            assert torch.equal(got, k1), rows
    assert monarch_cuda.LAUNCHES["monarch_fwd_tile"] == before + len(monarch_cuda.FWD_TILE_ROWS)


@pytest.mark.cuda
def test_torch_benchlib_time_ms_on_card(cuda_device):
    """A small op is host-bound: its device time is no larger than its call
    time, and both are positive."""
    from sparse_matrix_fine_tuning_torch.utils import benchlib

    x = torch.ones(16, device=cuda_device)
    device_ms, call_ms = benchlib.time_ms(lambda: x * 2, reps=20, rounds=3)
    assert 0 < device_ms <= call_ms


# -- the dw experiments: K13 (K4 at a row group), K14, the cluster kernel at blk_r 8, 16
# (batch, K, Q, P, L, S, R): the cluster kernel at blk_r 8 and 16, ragged rows,
# P = 1024 as at the experiments' widths; and the dw script's shape
DW_CASES = [(600, 4, 8, 64, 4, 48, 8), (601, 4, 16, 1024, 4, 256, 16),
            (2664, 4, 16, 1024, 4, 1024, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DW_CASES[:2])
def test_torch_backward_fast_path_at_blk_r_8_and_16_on_card(cuda_device, case, dtype):
    """K3 and K4 at blk_r 8 and 16 take the cluster kernel
    (``monarch_bwd_plan``'s "fast") and agree with their plain versions; at
    blk_r 4 the plan keeps the cluster kernel too."""
    batch, k, q, p, l, s, r = case
    x, w1, w2, dout = _inputs(case, dtype, cuda_device)
    for with_dx in (True, False):
        assert monarch_cuda.monarch_bwd_plan(batch, w1.shape, w2.shape, with_dx=with_dx,
                                             dtype=dtype)[0]
    assert monarch_cuda.monarch_bwd_plan(batch, (k, 4, p), (l, s, 4))[0]
    with torch.no_grad():
        got = monarch_cuda.monarch_bwd(x, w1, w2, dout) + \
            monarch_cuda.monarch_dw_fused(x, dout, w1, w2)
        want = monarch_cuda.monarch_bwd_reference(x, w1, w2, dout) + \
            monarch_cuda.monarch_dw_fused_reference(x, dout, w1, w2)
        torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and bool(torch.isfinite(g).all())
        assert float((g.float() - w.float()).abs().max()) <= _tol(w.to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DW_CASES)
def test_torch_dw_tile_matches_plain_on_card(cuda_device, case, dtype):
    """K13 at 16 rows and at every ``DW_TILE_ROWS`` (the rows ragged against
    each) and K14 against K4's plain version; K13 repeats bit for bit, and
    K14 is K13 at ``MERGED_DW_ROWS``, bit for bit; one launch a call."""
    batch = case[0]
    x, w1, w2, dout = _inputs(case, dtype, cuda_device)
    before = dict(monarch_cuda.LAUNCHES)
    rows_list = (16, *monarch_cuda.DW_TILE_ROWS)
    with torch.no_grad():
        want = monarch_cuda.monarch_dw_fused_reference(x, dout, w1, w2)
        for rows in rows_list:
            assert monarch_cuda.monarch_bwd_plan(batch, w1.shape, w2.shape, rows, dtype=dtype) \
                == (True, -(-batch // rows))
            got = monarch_cuda.monarch_dw_tile(x, dout, w1, w2, rows)
            again = monarch_cuda.monarch_dw_tile(x, dout, w1, w2, rows)
            torch.cuda.synchronize()
            for g, a, w in zip(got, again, want):
                assert g.shape == w.shape and g.dtype == torch.float32
                assert float((g - w).abs().max()) <= _tol(w.to(dtype)), rows
                assert torch.equal(g, a)
            if rows == monarch_cuda.MERGED_DW_ROWS:
                merged = monarch_cuda.monarch_dw_merged(x, dout, w1, w2)
                assert all(torch.equal(a, b) for a, b in zip(merged, got))
    assert monarch_cuda.LAUNCHES["monarch_dw_tile"] == before["monarch_dw_tile"] + 2 * len(rows_list)
    assert monarch_cuda.LAUNCHES["monarch_dw_merged"] == before["monarch_dw_merged"] + 1


@pytest.mark.cuda
def test_torch_dw_tile_refuses_row_groups_it_does_not_take(cuda_device):
    """The binding refuses a row group that is no positive multiple of 16."""
    x, w1, w2, dout = _inputs(DW_CASES[0], torch.float32, cuda_device)
    ops = monarch_cuda.load_ops()
    for rows in (0, 24, -16):
        with pytest.raises(RuntimeError, match="multiple of 16"):
            ops.monarch_dw_tile(x, dout, w1, w2, rows)


# -- the int4 dequant-arithmetic variants: K16 --------------------------------
# (in, out, group): out 272 is 17 column tiles of 16; rows 3 and 13 take one
# block of rows, 40 three of 16 (five of 8 for ugdot and u2dot), its last
# block ragged.
INT4_VARIANT_SHAPE = (1536, 272, 64)


def _variant_operands(rows, device):
    from sparse_matrix_fine_tuning_torch import quant

    in_f, out_f, group = INT4_VARIANT_SHAPE
    rng = np.random.default_rng(rows)
    w = (rng.standard_normal((out_f, in_f)) * 0.05).astype(np.float32)
    codes, scales = quant.quantize_int4(w, group)
    x = torch.tensor(rng.standard_normal((rows, in_f)), dtype=torch.float32)
    return (torch.tensor(codes).to(device), torch.tensor(scales).to(device),
            x.to(device=device, dtype=torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [3, 13, 40])
@pytest.mark.parametrize("variant", ["f32mul", "bf16mul", "mul3d", "ucorr", "ugdot", "f32dot",
                                     "u2dot"])
def test_torch_int4_variant_matches_plain_on_card(cuda_device, variant, rows):
    """K16's raw output of each variant against its plain version, two bf16
    ulps of its scale (both sides sum in fp32 in another order and round
    once); the finished variant against the plain one finished; one launch
    each."""
    from sparse_matrix_fine_tuning_torch.kernels import quant_cuda as qc

    codes, scales, x = _variant_operands(rows, cuda_device)
    group = INT4_VARIANT_SHAPE[2]
    before = qc.LAUNCHES["int4_variant"]
    with torch.no_grad():
        got = qc.int4_variant_matmul(x, codes, scales, group, variant)
        want = qc.int4_variant_reference(x, codes, scales, group, variant)
        fin = qc.int4_variant(x, codes, scales, group, variant)
        fin_want = qc.finish_int4_variant(want, x, scales, group, variant)
    torch.cuda.synchronize()
    assert qc.LAUNCHES["int4_variant"] == before + 2
    assert got.shape == want.shape == (rows, INT4_VARIANT_SHAPE[1])
    assert got.dtype == want.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) <= _tol(want)
    assert float((fin.float() - fin_want.float()).abs().max()) <= _tol(want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 4, 8, 13, 16])
def test_torch_int4_variant_f32mul_is_k5_on_card(cuda_device, rows):
    """At the decode rows (M <= 16) the f32mul variant is K5's kernel at
    K5's plan: the same bits."""
    from sparse_matrix_fine_tuning_torch.kernels import quant_cuda as qc

    codes, scales, x = _variant_operands(rows, cuda_device)
    group = INT4_VARIANT_SHAPE[2]
    with torch.no_grad():
        got = qc.int4_variant_matmul(x, codes, scales, group, "f32mul")
        k5 = qc.int4_matmul(x, codes, scales, group)
    torch.cuda.synchronize()
    assert torch.equal(got, k5)


@pytest.mark.cuda
def test_torch_int4_variant_refuses_what_it_does_not_take(cuda_device):
    """The wrapper refuses x that is not bf16 and unknown variants; the
    binding refuses them too, and a group or width the kernel does not take."""
    from sparse_matrix_fine_tuning_torch.kernels import quant_cuda as qc

    codes, scales, x = _variant_operands(4, cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        qc.int4_variant_matmul(x.float(), codes, scales, 64, "f32mul")
    with pytest.raises(ValueError, match="unknown int4 variant"):
        qc.int4_variant_matmul(x, codes, scales, 64, "lut")
    ops = qc.load_ops()
    with pytest.raises(RuntimeError, match="bfloat16"):
        ops.int4_variant_mm(x.float(), codes, scales, 64, 0)
    with pytest.raises(RuntimeError, match="arith"):
        ops.int4_variant_mm(x, codes, scales, 64, 6)
    with pytest.raises(RuntimeError, match="group"):
        ops.int4_variant_mm(x, codes, scales, 40, 0)
    with pytest.raises(RuntimeError, match="out % 16"):
        ops.int4_variant_mm(x, codes[:, :264].contiguous(), scales[:, :264].contiguous(), 64, 0)
    plan = qc.int4_variant_plan(40, 1536, 272, "ugdot")
    assert plan["rows"] == 2 and plan["row_blocks"] == 20 and plan["mma"] == 0
    plan = qc.int4_variant_plan(40, 1536, 272, "f32mul")
    assert plan["rows"] == 16 and plan["row_blocks"] == 3 and plan["mma"] == 1
