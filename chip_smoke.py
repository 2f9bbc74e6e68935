"""Smoke test of the PyTorch port on one NVIDIA H100: ``python3 chip_smoke.py``.

Drives the port's main paths on a TinyLlama-1.1B-shaped Llama with Monarch
adapters on all seven projections (random seeded weights) through the
hand-written CUDA kernels, and checks them:

  1. device: a CUDA card of compute capability 9.0, its name and power limit;
  2. build: the kernels are compiled from ``kernels/csrc/`` in this checkout;
  3. forward kernels K1, K2 against their plain PyTorch versions at the
     slice's shapes, bfloat16 and float32, timed beside their bound and the
     one PyTorch call that computes the same function, summed a decoder
     layer at every row count of ROWS, each call's plan printed; then at
     ragged shapes (P and m no multiple of 8, L != K, Q != R) with x and
     base off 16 bytes;
  4. backward kernels K3, K4 likewise at the training shapes, on the
     cluster kernel of ``csrc/monarch_bwd.cu`` (its plan and launches a
     call, ptxas's registers and spills), and the
     autograd Functions of K1 and K2 (whose backward is K3);
  5. serving, float32: prefill logits and greedy tokens against a copy with
     the adapters merged on the CPU;
  6. serving, bfloat16: greedy decode timed, unmerged (K2) and merged (K1);
  7. training, float32, 2 layers: one optimizer step on the card against a
     CPU copy on the plain path, merged training off (K2, K3) and on (K4);
  8. training, bfloat16, all 22 layers, bs 4 x ga 8 x seq 512 through
     ``Trainer``: merged training off, then on from the same state on the
     same batches, timed and profiled;
  9. the quantized base: K7/K5 (forward) and K8/K6 (dx) against their plain
     versions at the slice's shapes, timed beside their bound and one
     PyTorch call on the dequantized matrix, and their autograd Functions;
     K5/K7 above 16 rows and K6/K8 in bf16 run the wgmma kernels of
     ``csrc/quant_wgmma.cu`` (int4 dequantized into B in shared memory,
     int8 into A in registers), whose four functions' SASS must hold HGMMA;
     K5/K7 at decode rows (``csrc/quant_matmul.cu``'s ``qgemv_kernel``, one
     launch a call) also timed cold, over weight sets past L2, beside
     ``F.linear`` cold and the launch floor, with each projection's plan and
     the registers of each instantiation (no local memory, two CTAs an SM);
     K5's and K7's tile forward and K6/K8 at in 1000, 1032 and 1096 (int4's
     h = in / 2 no multiple of 8) against their plain versions;
 10. quantized serving, float32, int8 and int4: prefill logits and greedy
     tokens against a copy whose codes were dequantized and whose adapters
     were merged on the CPU;
 11. quantized serving, bfloat16, timed: int8 unmerged (K7, K2), int8
     requantize-merged with the w8a8 head (K7), int4 unmerged (K5, K2);
     in each profiled decode step the wrappers count the decode kernel once
     an adapted linear, exactly; the profiler counts ``qgemv_kernel`` as
     often over the profiled steps, or one record short (it loses one now
     and then), and ``qsplit_sum`` never;
 12. quantized training: one float32 step (2 layers) on the card against a
     CPU copy, int8 and int4; then 22-layer bfloat16 training over an int8
     base (``run_alpaca --bits 8``: K7 and K8 at training rows) and over an
     int4 base (``--bits 4``), each timed and profiled;
 13. the fused dense + Monarch linear: K9 (forward), K10 (dx) and K11 (the
     factor gradients, K4's kernel) against their plain versions at
     ``bench_more_linear``'s three Llama-7B and micro-bench shapes (bf16)
     and a ragged f32 case, timed beside their bound and one PyTorch call,
     each bf16 call's tile plan printed, HGMMA in the SASS of every bf16
     K9/K10 kernel (``csrc/more_linear.cu``'s ``fused_kernel``) and no spill
     in ptxas's report, the autograd Function against the plain
     composition, then the port of ``scripts/bench_more_linear.py`` (fused,
     hybrid and plain steps);
 14. the forward-tile experiments: K15 (the wgmma + TMA tiled matmul) at
     every tile and K12 (K1 at every row tile) against their plain versions
     at a ragged shape, K12 at every row tile equal to K1 at its own plan bit
     for bit, K15's SASS checked for HGMMA, then the ports of
     ``scripts/exp_matmul_tiles.py`` and ``scripts/exp_fwd_tile.py`` at
     2664 x 4096 -> 4096 (each variant checked, then timed);
 15. the dw experiments: K13 (K4's kernel at a row group) and K14 (K13 at
     256 rows) and K3/K4 through the fast path at blk_r 8 and 16 and through
     the generic kernel against their plain versions at a ragged shape,
     the plans at the experiments' and the bench's shapes, K13 and K14 bit
     for bit, then the ports of ``scripts/exp_dw_kernel.py`` and
     ``scripts/exp_merged_v3.py`` at 2664 x 4096 -> 4096 (each variant
     checked, then timed);
 16. the int4 dequant-arithmetic variants: K16 (K5's decode kernel
     ``qgemv_kernel`` with its per-cell arithmetic a parameter) in all
     seven variants against
     their plain versions at ragged shapes, f32mul bit for bit K5 at
     decode rows, then the port of ``scripts/exp_int4_dequant_variants.py``
     at its four shapes (each variant checked against its plain version
     and the JAX script's oracle bound, then timed).

Serving (5, 6, 10 and 11) runs before the experiments (13-16), the
quantized decode profiles after as few other profiler sessions as the
script opens (ROADMAP C.10).  Each main path (6, 8 off, 8 on, each
configuration of 11, each step of 12, the bench of 13, each script of 14,
15 and 16) zeroes the launch counts of every kernel just before it and
reads them just after.  Any failed check
exits non-zero.  The line before the last is one JSON object on the
kernels (K5 and K7 at decode and, as ``int4_matmul_tile`` and
``int8_matmul_tile``, at a training micro-batch, each entry's launches
those of its own source: the decode entries serving's decode steps, the
``_tile`` entries serving's prefills and the bf16 training phases'
forwards; K9-K11: ms, plain, library and bound summed over the bench's
three shapes; K15, K12 and K13: the best tile's ms at the scripts' shape,
the tile in ``records.json``; K14 at that shape; K16 the best variant at
(4, 2048, 5632)); the last is ``{"ok": true, "device": {...}}``.
Per-case records go to ``chip_smoke_out/records.json``.
It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

try:
    import torch

    from sparse_matrix_fine_tuning_torch import quant
    from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda, quant_cuda
    from sparse_matrix_fine_tuning_torch.kernels.build import build
    from sparse_matrix_fine_tuning_torch.kernels.experimental import more_linear as ml
    from sparse_matrix_fine_tuning_torch.kernels.experimental import tiled_matmul as tm
    from sparse_matrix_fine_tuning_torch.utils import benchlib
    from sparse_matrix_fine_tuning_torch.utils.benchlib import card_line, roofline_ms, time_ms
except ImportError as exc:  # run outside a checkout of the repository
    print(f"chip_smoke: cannot import the port ({exc}); run it from the repository root",
          file=sys.stderr)
    sys.exit(2)

SEED = 0
# TinyLlama-1.1B widths (bench.py:130-140) and its Monarch adapters.
MODEL = dict(vocab_size=32000, hidden_size=2048, num_hidden_layers=22,
             num_attention_heads=32, num_key_value_heads=4, intermediate_size=5632)
PEFT = {"monarch": True, "nblocks": 4, "blk_r": 4, "adapter": True,
        "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj"]}
# (name, in, out) of the adapted projections of one decoder layer.
PROJECTIONS = [("q", 2048, 2048), ("k", 2048, 256), ("v", 2048, 256), ("o", 2048, 2048),
               ("gate", 2048, 5632), ("up", 2048, 5632), ("down", 5632, 2048)]
ROWS = (4, 65, 256, 2048)
N_ADAPTED = 7 * MODEL["num_hidden_layers"]
BATCH, PROMPT, NEW = 4, 64, 128  # bench.py:128
PROMPT_LENS = (64, 48, 33, 17)
F32_NEW = 32
# f32 prefill logits, kernel path against the merged reference: 22 layers of
# fp32 sums taken in another order (x W^T + monarch(x) against x (W + M)^T)
F32_LOGIT_TOL = 1e-3
# Training (bench.py:389-418 with the 1.1B widths): rows of the backward
# kernels' checks, one micro-batch being 4 x 512 = 2048 rows.
BWD_ROWS = (65, 2047, 2048)
TRAIN_BS, TRAIN_GA, TRAIN_SEQ, TRAIN_STEPS = 4, 8, 512, 4  # 1 warm-up + 3 timed
F32_TRAIN = dict(layers=2, bs=2, ga=2, seq=128)
TRAIN_LR = 1e-4
# f32 training step, card against the CPU copy (2 layers, fp32 sums in
# another order, TF32 off): the loss within 1e-5 of itself; every factor's
# (clipped) gradient within 1e-4 of its largest element; the updated factors
# within 1e-2 * lr wherever the gradient is above 1e-3 of its largest (the
# first AdamW step is lr * g / (|g| + eps), about lr * sign(g)), and within
# 2 * lr elsewhere, where a gradient near zero may round to either sign.
F32_TRAIN_LOSS_RTOL, F32_TRAIN_GRAD_TOL = 1e-5, 1e-4
# bf16 training, merged against unmerged on the same batches: the merged
# operand rounds W + M to bf16 once, the unmerged path rounds W x and adds
# monarch(x) in fp32; after 4 AdamW steps the losses (about 10.4) may differ
# by this much.
BF16_MERGED_LOSS_ATOL = 2e-2
KERNELS = {
    "monarch_kernel": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_fwd.cu",
                       "sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py:157"),
    "monarch_add": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_fwd.cu",
                    "sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py:164"),
    "monarch_bwd": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_bwd.cu",
                    "sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py:173"),
    "monarch_dw_fused": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_bwd.cu",
                         "sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py:364"),
    # K5 and K7 at decode rows (M <= 16: quant_matmul.cu's decode kernel) and
    # at a training micro-batch (bf16, M > 16: the wgmma kernel); K6 and K8
    # in bf16
    "int4_matmul": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_matmul.cu",
                    "sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py:115"),
    "int4_matmul_tile": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_wgmma.cu",
                         "sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py:115"),
    "int4_matmul_dx": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_wgmma.cu",
                       "sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py:141"),
    "int8_matmul": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_matmul.cu",
                    "sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py:305"),
    "int8_matmul_tile": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_wgmma.cu",
                         "sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py:305"),
    "int8_matmul_dx": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_wgmma.cu",
                       "sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py:312"),
    "more_linear_fwd": ("sparse_matrix_fine_tuning_torch/kernels/csrc/more_linear.cu",
                        "sparse_matrix_fine_tuning_tpu/kernels/experimental/more_linear.py:52"),
    "more_linear_dx": ("sparse_matrix_fine_tuning_torch/kernels/csrc/more_linear.cu",
                       "sparse_matrix_fine_tuning_tpu/kernels/experimental/more_linear.py:80"),
    "more_linear_dw": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_bwd.cu",
                       "sparse_matrix_fine_tuning_tpu/kernels/experimental/more_linear.py:108"),
    "tiled_matmul": ("sparse_matrix_fine_tuning_torch/kernels/csrc/tiled_matmul.cu",
                     "scripts/exp_matmul_tiles.py:20"),
    "monarch_fwd_tile": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_fwd.cu",
                         "scripts/exp_fwd_tile.py:21"),
    "monarch_dw_tile": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_bwd.cu",
                        "scripts/exp_dw_kernel.py:24"),
    "monarch_dw_merged": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_bwd.cu",
                          "scripts/exp_merged_v3.py:23"),
    "int4_variant": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_matmul.cu",
                     "scripts/exp_int4_dequant_variants.py:108"),
}
# The quantized base (quant/, run_alpaca.py --bits): (bits, whether dx).
QUANT_KERNELS = {"int8_matmul": (8, False), "int8_matmul_dx": (8, True),
                 "int4_matmul": (4, False), "int4_matmul_dx": (4, True)}
QUANT_GROUP = 64  # quantize_frozen_base's default group
# K5/K7 at decode rows timed cold: each projection's calls rotate over
# weight sets of more than this many bytes, twice the 50 MB L2
DECODE_ROTATE_BYTES = 100e6
# Prefill logits cosine, quantized bf16 model against the unquantized bf16
# one, on this random 22-layer model, which passes the weights' rounding
# noise on undamped.  int8 (per-column absmax, a step of 1/127 of the
# column's largest weight, an rms error near 0.8% of the weights' rms):
# >= 0.99.  int4 (group-64 absmax, a step of 1/7 of the group's largest
# weight, an rms error near 10%: about 150 times int8's variance): 1 - cos
# grows with that variance, and int8's measured 1 - cos of 0.0027 (H100,
# this script) scaled by it gives about 0.4, so >= 0.6.  The requantize-
# merged int8 model with the w8a8 head adds one more int8 rounding of
# W + delta and of the head's activations: >= 0.99.
QUANT_COS = {8: 0.99, 4: 0.6}
# decode steps each quantized configuration profiles (profile_decode)
DECODE_PROFILE_STEPS = 8
# The fused dense + Monarch linear (K9-K11): short labels of
# bench_more_linear.SHAPES, and the ragged f32 check (tests/kernels/
# test_more_linear.py:17): (label, rows, n, m, nblocks, blk_r).
MORE_KERNELS = ("more_linear_fwd", "more_linear_dx", "more_linear_dw")
MORE_LABELS = ("qkv", "micro", "gate")
MORE_RAGGED = ("ragged", 200, 128, 96, 4, 8)
# The bench's fused loss against its plain one: each bf16 y is within two
# ulps (2**-7 relatively) of the plain path's, so each y**2 within 2**-6.
MORE_LOSS_RTOL = 2.0 ** -6
# instantiations of bf16's K9/K10 kernel (csrc/more_linear.cu): six pairs
# of tile and summary width, forward and dx
MORE_FUSED_KERNELS = 12
# K9/K10 at J = 32, 2664 x 1800 -> 1800 ((rows, n, m, K, Q, L) of
# compare_more_linear.inputs), where one card run once gave other bits:
# MORE_REPEATS calls of each must equal the first bit for bit.
MORE_REPEAT_CASE = (2664, 1800, 1800, 4, 8, 4)
MORE_REPEATS = 50
# The forward-tile experiments' ragged checks: K15 at (M, K, N) with M past
# every BM, K past the k step of 64 and N past every BN (multiples of 8, as
# TMA needs); K12 at (B, n, m, nblocks, rank) in f32, B past every row tile.
TILES_RAGGED = (200, 200, 392)
TILES_BENCH = (2664, 4096, 4096)  # K15's repeat check: exp_matmul_tiles.SHAPE
FWD_TILE_RAGGED = (37, 256, 384, 4, 4)
# The dw experiments' ragged checks, (M, K, Q, P, L, S, R): the fast path at
# blk_r 8 and 16, and the generic kernel (P % 8 != 0), M past every row
# group; K13's row groups there: the 16-row tile and the sweep's.
DW_RAGGED = ((200, 4, 8, 64, 4, 48, 8, True), (200, 4, 16, 64, 4, 48, 16, True),
             (200, 4, 16, 60, 4, 48, 16, False))
DW_RAGGED_ROWS = (16, *monarch_cuda.DW_TILE_ROWS)
# K1/K2's ragged checks, (B, K, Q, P, L, S, R, offset of x and base in
# elements): P and S * L no multiple of 8, K != L and Q != R, rows past the
# decode bound and past a row tile, P past 64 chunks (3 chunks a lane), a
# training micro-batch at down_proj's P, R = 16 (K12's rank), and a wide J
# (512: the plan's shared memory past 48 KB, K1 then K2; 2048: past 227 KB
# at one tile of 16 rows, so the plan halves the tile).
FWD_RAGGED = ((5, 4, 4, 13, 4, 7, 4, 1), (17, 2, 8, 36, 4, 9, 4, 1), (3, 3, 5, 9, 5, 3, 3, 1),
              (65, 4, 4, 1100, 4, 36, 4, 0), (2048, 4, 4, 1408, 4, 65, 4, 1),
              (33, 2, 32, 20, 4, 13, 16, 1), (16, 4, 128, 520, 8, 40, 64, 0),
              (16, 8, 256, 64, 8, 24, 256, 1))
# K5-K8 where int4's h = in / 2 is no multiple of 8 (ROADMAP C.8): (in, out,
# group), at M 17 and 129 (the tile path), bf16
QUANT_RAGGED_IN = ((1000, 272, 20), (1032, 272, 43), (1096, 384, 137))
QUANT_RAGGED_ROWS = (17, 129)
# K16's ragged checks: rows 3, 13 (one block of 16) and 40 (three blocks;
# five of 8 for ugdot and u2dot) at in 1536 -> out 272 (17 column tiles of
# 16), group 64.
INT4_VARIANT_ROWS = (3, 13, 40)
INT4_VARIANT_RAGGED = (1536, 272, 64)
# K16's JSON line: the best variant at this shape of the script
INT4_VARIANT_SHAPE = (4, 2048, 5632)
OUT_DIR = "chip_smoke_out"  # per-case records; .gitignore lists it
RECORDS: list[dict] = []  # one per kernel case, written to OUT_DIR


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def reset_counts() -> None:
    """Zero the launch counts of every kernel (K1-K4, K12-K14, K5-K8, K16,
    K9-K11 and K15)."""
    monarch_cuda.reset_launch_counts()
    quant_cuda.reset_launch_counts()
    ml.reset_launch_counts()
    tm.reset_launch_counts()


def counts() -> dict:
    """The launch counts of every kernel since the last reset."""
    return {**monarch_cuda.LAUNCHES, **quant_cuda.LAUNCHES, **ml.LAUNCHES, **tm.LAUNCHES}


def phase_device() -> str:
    require(torch.cuda.is_available(), "no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    require(cap == (9, 0), f"needs compute capability 9.0 (sm_90a), got {cap}")
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)}, capability {cap}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(card, flush=True)
    return card


def phase_build():
    t0 = time.perf_counter()
    lib = build(verbose=True)
    monarch_cuda.load_ops()
    print(f"[build] {time.perf_counter() - t0:.1f} s, {lib}", flush=True)
    return lib


def cost(name: str, m_rows: int, n_in: int, n_out: int, dtype: torch.dtype,
         r: int = PEFT["blk_r"]) -> tuple[int, int]:
    """(bytes, operations) the kernel's function needs: each input read once,
    each output written once (dw in fp32); multiply-adds count two.  K5-K8:
    the codes, the f32 scales, the activations in and the result out;
    2 * M * in * out operations.  K9/K10: x (or dout), the dense weight and
    the factors in, the output out; the dense product and the two factors'
    multiply-adds (r * (in + out) a row, the factors themselves, not the
    TPU kernel's K-times-larger expansion).  K11 is K4's function."""
    item = 2 if dtype == torch.bfloat16 else 4
    if name in ("more_linear_fwd", "more_linear_dx"):
        factors = r * (n_in + n_out)
        return (m_rows * (n_in + n_out) + n_in * n_out + factors) * item, \
            2 * m_rows * (n_in * n_out + factors)
    if name == "more_linear_dw":
        name = "monarch_dw_fused"
    if name in QUANT_KERNELS:
        bits = QUANT_KERNELS[name][0]
        codes = n_in * n_out // (2 if bits == 4 else 1)
        scale_rows = n_in // QUANT_GROUP if bits == 4 else 1
        return codes + 4 * scale_rows * n_out + m_rows * (n_in + n_out) * item, \
            2 * m_rows * n_in * n_out
    factors = r * (n_in + n_out)  # w1 (K, Q, P) has r * n_in elements, w2 r * n_out
    rows = {"monarch_kernel": n_in + n_out, "monarch_add": n_in + 2 * n_out,
            "monarch_bwd": 2 * n_in + n_out, "monarch_dw_fused": n_in + n_out}[name]
    nbytes = (m_rows * rows + factors) * item
    if name in ("monarch_bwd", "monarch_dw_fused"):
        nbytes += factors * 4
    macs = {"monarch_kernel": r * (n_in + n_out), "monarch_add": r * (n_in + n_out),
            "monarch_bwd": r * (3 * n_in + 2 * n_out),
            "monarch_dw_fused": r * (2 * n_in + 2 * n_out)}[name]
    return nbytes, 2 * m_rows * macs + (m_rows * n_out if name == "monarch_add" else 0)


def bound(name: str, m_rows: int, n_in: int, n_out: int, dtype: torch.dtype,
          r: int = PEFT["blk_r"]) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    return roofline_ms(*cost(name, m_rows, n_in, n_out, dtype, r), dtype)


def tolerance(dtype: torch.dtype, ref: torch.Tensor) -> float:
    """f32: the two sum in another order, 1e-5 of the output's scale.
    bf16: the intermediate may round one ulp apart, and the output rounds
    once more, so two bf16 ulps of the output's scale (2**-6 of it)."""
    scale = float(ref.float().abs().max())
    return scale * (1e-5 if dtype == torch.float32 else 2.0 ** -6)


def _record(name: str, proj: str, n_in: int, n_out: int, m_rows: int, dtype: torch.dtype,
            err: float, share: float, ms: float, plain_ms: float, call: float, plain_call: float,
            library_ms, r: int = PEFT["blk_r"]) -> dict:
    """Print and keep one case: ``err`` is the largest absolute error over the
    kernel's outputs, ``share`` the largest error / tolerance among them;
    ``r`` the adapters' blk_r."""
    bound_ms, bound_by = bound(name, m_rows, n_in, n_out, dtype, r)
    gbs = cost(name, m_rows, n_in, n_out, dtype, r)[0] / ms / 1e6
    lib = f"{library_ms:.5f}" if library_ms is not None else "none"
    print(f"[kernels] {name:16s} {proj:5s} {n_in}->{n_out:<5d} {m_rows:5d} {str(dtype)[6:]:8s} "
          f"{err:.3e}  {share:.3f}  {ms:.5f}  {plain_ms:.5f}  {lib:8s}  {bound_ms:.5f} "
          f"({bound_by})  {call:.5f}  {plain_call:.5f}  {gbs:.1f}", flush=True)
    rec = {"kernel": name, "proj": proj, "in": n_in, "out": n_out, "rows": m_rows, "blk_r": r,
           "dtype": str(dtype)[6:], "max_abs_err": err, "share_of_tol": share, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "call_ms": call, "plain_call_ms": plain_call, "GB_per_s": gbs}
    RECORDS.append(rec)
    return rec


_HEADER = ("[kernels] kernel           proj  in->out     M     dtype    max_abs_err  /tol   "
           "dev_ms    plain_ms  library   bound_ms           call_ms  plain_call  GB/s")


def _layer_sums(recs: list[dict]) -> dict:
    """Per decoder layer: the seven projections' ms, plain, library and bound;
    ``bound_by`` is the kind ("bytes" or "operations") that bounds the larger
    part of the layer's bound."""
    out = {k: sum(r[k] for r in recs) for k in ("ms", "plain_ms", "bound_ms")}
    libs = [r["library_ms"] for r in recs]
    out["library_ms"] = None if None in libs else sum(libs)
    by_kind = {"bytes": 0.0, "operations": 0.0}
    for r in recs:
        by_kind[r["bound_by"]] += r["bound_ms"]
    out["bound_by"] = max(by_kind, key=by_kind.get)
    return out


def _offset(t: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous copy of ``t`` starting ``off`` elements into its buffer
    (off 16 bytes for off > 0), as a sliced view would."""
    buf = torch.empty(t.numel() + off, device=t.device, dtype=t.dtype)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


def phase_kernels_ragged(g: torch.Generator) -> float:
    """K1 and K2 at ``FWD_RAGGED``, f32 and bf16, against their plain
    versions (``tolerance``); x and base sliced views where the case says
    so.  Returns the largest error over the tolerance."""
    share = 0.0
    with torch.inference_mode():
        for b, K, Q, P, L, S, R, off in FWD_RAGGED:
            for dtype in (torch.float32, torch.bfloat16):
                x = _offset(torch.randn(b, K * P, generator=g, device="cuda").to(dtype), off)
                w1 = (torch.randn(K, Q, P, generator=g, device="cuda") / P ** 0.5).to(dtype)
                w2 = (torch.randn(L, S, R, generator=g, device="cuda") / R ** 0.5).to(dtype)
                base = _offset(torch.randn(b, S * L, generator=g, device="cuda").to(dtype), off)
                for got, ref in ((monarch_cuda.monarch_kernel(x, w1, w2),
                                  monarch_cuda.monarch_kernel_reference(x, w1, w2)),
                                 (monarch_cuda.monarch_add(base, x, w1, w2),
                                  monarch_cuda.monarch_add_reference(base, x, w1, w2))):
                    torch.cuda.synchronize()
                    err = float((got.float() - ref.float()).abs().max())
                    tol = tolerance(dtype, ref)
                    require(got.shape == ref.shape and err <= tol
                            and bool(torch.isfinite(got).all()),
                            f"K1/K2 at {(b, K, Q, P, L, S, R)} off {off} {dtype}: max abs err "
                            f"{err} > {tol}")
                    share = max(share, err / tol)
    return share


def phase_kernels(card: str) -> dict:
    """K1 and K2 against their plain versions at the slice's shapes, with the
    library call that computes the same function on a precomputed dense
    matrix: ``F.linear(x, M)`` for K1, ``torch.addmm(base, x, M^T)`` for K2;
    the sums a decoder layer (bf16) at every row count, each call's plan;
    then the ragged cases (``phase_kernels_ragged``)."""
    from sparse_matrix_fine_tuning_torch.ops.monarch import monarch_dense_equivalent

    g = torch.Generator(device="cuda").manual_seed(SEED)
    nb, r = PEFT["nblocks"], PEFT["blk_r"]
    worst = {"monarch_kernel": 0.0, "monarch_add": 0.0}
    per_layer = {(name, m_rows): [] for name in worst for m_rows in ROWS}
    print(f"[kernels] card: {card}", flush=True)
    for m_rows in ROWS:
        for proj, n_in, n_out in PROJECTIONS:
            plan = monarch_cuda.monarch_fwd_plan(m_rows, (nb, r, n_in // nb),
                                                 (nb, n_out // nb, r))
            print(f"[kernels] K1/K2 plan, bf16, M={m_rows} {proj}: {plan}", flush=True)
    print(_HEADER, flush=True)
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for m_rows in ROWS:
                for proj, n_in, n_out in PROJECTIONS:
                    p, s = n_in // nb, n_out // nb
                    x = torch.randn(m_rows, n_in, generator=g, device="cuda").to(dtype)
                    w1 = (torch.randn(nb, r, p, generator=g, device="cuda") / p ** 0.5).to(dtype)
                    w2 = (torch.randn(nb, s, r, generator=g, device="cuda") / r ** 0.5).to(dtype)
                    base = torch.randn(m_rows, n_out, generator=g, device="cuda").to(dtype)
                    dense = monarch_dense_equivalent(w1.float(), w2.float()).to(dtype)
                    cases = {
                        "monarch_kernel": (lambda: monarch_cuda.monarch_kernel(x, w1, w2),
                                           lambda: monarch_cuda.monarch_kernel_reference(x, w1, w2),
                                           lambda: torch.nn.functional.linear(x, dense)),
                        "monarch_add": (lambda: monarch_cuda.monarch_add(base, x, w1, w2),
                                        lambda: monarch_cuda.monarch_add_reference(base, x, w1, w2),
                                        lambda: torch.addmm(base, x, dense.t())),
                    }
                    for name, (kern, plain, library) in cases.items():
                        got, ref = kern(), plain()
                        torch.cuda.synchronize()
                        require(got.shape == ref.shape and got.dtype == ref.dtype,
                                f"{name} {proj} M={m_rows}: {got.shape}/{got.dtype} vs "
                                f"{ref.shape}/{ref.dtype}")
                        err = float((got.float() - ref.float()).abs().max())
                        tol = tolerance(dtype, ref)
                        (ms, call), (plain_ms, plain_call) = time_ms(kern), time_ms(plain)
                        rec = _record(name, proj, n_in, n_out, m_rows, dtype, err, err / tol, ms,
                                      plain_ms, call, plain_call, time_ms(library)[0])
                        require(err <= tol and bool(torch.isfinite(got).all()),
                                f"{name} {proj} M={m_rows} {dtype}: max_abs_err {err} > tol {tol}")
                        worst[name] = max(worst[name], err)
                        if dtype == torch.bfloat16:
                            per_layer[(name, m_rows)].append(rec)
    sums = {key: _layer_sums(recs) for key, recs in per_layer.items()}
    for m_rows in ROWS:
        print(f"[kernels] {card}: device time per decoder layer at M={m_rows} (bf16, "
              "7 projections): "
              + ", ".join(f"{k} {sums[(k, m_rows)]['ms']:.5f} ms (plain "
                          f"{sums[(k, m_rows)]['plain_ms']:.5f}, library "
                          f"{sums[(k, m_rows)]['library_ms']:.5f}, bound "
                          f"{sums[(k, m_rows)]['bound_ms']:.5f} ms)" for k in worst), flush=True)
    RECORDS.append({"monarch_fwd_per_layer": [{"kernel": k, "rows": m, **v}
                                              for (k, m), v in sums.items()], "card": card})
    share = phase_kernels_ragged(g)
    print(f"[kernels] {card}: K1/K2 at {len(FWD_RAGGED)} ragged shapes (f32, bf16; x and "
          f"base off 16 bytes where marked) within tolerance, worst {share:.3f} of it",
          flush=True)
    # the JSON line: decode's shape (M = 4), where the unmerged serving path runs K2
    layer = {name: sums[(name, 4)] for name in worst}
    return {"worst": worst, "layer": layer}


def kernel_ptxas(lib, kernel: str, count: int, tag: str) -> None:
    """ptxas's registers and spills of each of the ``count`` instantiations
    of ``kernel``, from the build's log (``kernels/_build/<key>/build.log``,
    which the build keeps); none may spill."""
    from sparse_matrix_fine_tuning_torch.kernels.build import LOG_NAME
    from sparse_matrix_fine_tuning_torch.scripts.compare_monarch_bwd import ptxas_lines

    lines = [ln for ln in ptxas_lines((lib.parent / LOG_NAME).read_text()) if kernel in ln]
    require(len(lines) == count, f"ptxas: {len(lines)} {kernel} instantiations, expected {count}")
    for line in lines:
        name, rest = line.split(": ", 1)
        args = name[name.index(kernel) + len(kernel):]
        print(f"[{tag}] ptxas {kernel}{args[:24]}: {rest}", flush=True)
        require(" 0 bytes spill stores" in rest, f"ptxas: {line} spills")


def phase_kernels_bwd(card: str, lib) -> dict:
    """K3 and K4 against their plain versions at the training shapes: the
    seven projections, rows M in BWD_ROWS (ragged and whole), bf16 and f32,
    each on the cluster kernel (``monarch_bwd_plan_fields``, printed with its
    launches a call at a training micro-batch), after ptxas's registers and
    spills of its 12 instantiations (``kernel_ptxas``).
    No single PyTorch call computes either function (dx and the two factor
    gradients of the Monarch structure), so they have no library time.
    Tolerances: dx as the forward's output; the fp32 factor gradients 1e-5
    of their scale in f32, 2**-6 of it in bf16 (an intermediate one bf16 ulp
    apart enters every row's product)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    nb, r = PEFT["nblocks"], PEFT["blk_r"]
    worst = {"monarch_bwd": 0.0, "monarch_dw_fused": 0.0}
    train = {name: [] for name in worst}
    kernel_ptxas(lib, "bwd_cluster_kernel", 12, "kernels")
    for dtype in (torch.bfloat16, torch.float32):
        for m_rows in BWD_ROWS:
            for proj, n_in, n_out in PROJECTIONS:
                for with_dx in (True, False):
                    plan = monarch_cuda.monarch_bwd_plan_fields(
                        m_rows, (nb, r, n_in // nb), (nb, n_out // nb, r), with_dx=with_dx,
                        dtype=dtype)
                    require(plan["fast"] == 1, f"K3/K4 {proj} M={m_rows}: not the cluster "
                                               f"kernel: {plan}")
                    if dtype == torch.bfloat16 and m_rows == TRAIN_BS * TRAIN_SEQ:
                        # the cluster kernel, and the clusters' sum where there
                        # is more than one cluster (compare_monarch_bwd.py
                        # counts them with the profiler; a profile here made
                        # the later decode profiles lose records, ROADMAP C.10)
                        print(f"[kernels] {'K3' if with_dx else 'K4'} plan, bf16, M={m_rows} "
                              f"{proj}: {plan}; {1 + (plan['clusters'] > 1)} launches a call",
                              flush=True)
    print(_HEADER, flush=True)
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            for m_rows in BWD_ROWS:
                for proj, n_in, n_out in PROJECTIONS:
                    p, s = n_in // nb, n_out // nb
                    x = torch.randn(m_rows, n_in, generator=g, device="cuda").to(dtype)
                    w1 = (torch.randn(nb, r, p, generator=g, device="cuda") / p ** 0.5).to(dtype)
                    w2 = (torch.randn(nb, s, r, generator=g, device="cuda") / r ** 0.5).to(dtype)
                    dout = torch.randn(m_rows, n_out, generator=g, device="cuda").to(dtype)
                    cases = {
                        "monarch_bwd": (lambda: monarch_cuda.monarch_bwd(x, w1, w2, dout),
                                        lambda: monarch_cuda.monarch_bwd_reference(x, w1, w2, dout)),
                        "monarch_dw_fused": (
                            lambda: monarch_cuda.monarch_dw_fused(x, dout, w1, w2),
                            lambda: monarch_cuda.monarch_dw_fused_reference(x, dout, w1, w2)),
                    }
                    for name, (kern, plain) in cases.items():
                        got, ref = kern(), plain()
                        torch.cuda.synchronize()
                        err = share = 0.0
                        for out, want in zip(got, ref):
                            require(out.shape == want.shape and out.dtype == want.dtype,
                                    f"{name} {proj} M={m_rows}: {out.shape}/{out.dtype} vs "
                                    f"{want.shape}/{want.dtype}")
                            require(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
                            e = float((out.float() - want.float()).abs().max())
                            err, share = max(err, e), max(share, e / tolerance(dtype, want))
                        (ms, call), (plain_ms, plain_call) = (time_ms(kern, 20, 3),
                                                              time_ms(plain, 20, 3))
                        rec = _record(name, proj, n_in, n_out, m_rows, dtype, err, share, ms,
                                      plain_ms, call, plain_call, None)
                        require(share <= 1.0, f"{name} {proj} M={m_rows} {dtype}: an output is "
                                              f"over its tolerance ({share:.3f} of it)")
                        worst[name] = max(worst[name], err)
                        if dtype == torch.bfloat16 and m_rows == TRAIN_BS * TRAIN_SEQ:
                            train[name].append(rec)
    layer = {name: _layer_sums(recs) for name, recs in train.items()}
    print(f"[kernels] {card}: device time per decoder layer at a training micro-batch "
          f"(M={TRAIN_BS * TRAIN_SEQ}, bf16, 7 projections): "
          + ", ".join(f"{k} {v['ms']:.5f} ms (plain {v['plain_ms']:.5f}, bound "
                      f"{v['bound_ms']:.5f} ms)" for k, v in layer.items()), flush=True)
    return {"worst": worst, "layer": layer}


def phase_autograd(card: str) -> None:
    """The autograd Functions of K1 and K2 (backward K3): torch.autograd.grad
    of a fixed random cotangent against the plain Functions' gradients, for
    x, w1, w2 and base, at every projection with M = 2047, bf16 and f32,
    tolerances as ``tolerance``.  Then the adapter layer with dropout 0.1 in
    training mode: its forward is K1, its gradient K3, against the same
    layer's arithmetic on the plain path with the same dropout mask."""
    import torch.nn.functional as F

    from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    nb, r, m_rows = PEFT["nblocks"], PEFT["blk_r"], 2047
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for proj, n_in, n_out in PROJECTIONS:
            p, s = n_in // nb, n_out // nb
            x = torch.randn(m_rows, n_in, generator=g, device="cuda").to(dtype)
            w1 = (torch.randn(nb, r, p, generator=g, device="cuda") / p ** 0.5).to(dtype)
            w2 = (torch.randn(nb, s, r, generator=g, device="cuda") / r ** 0.5).to(dtype)
            base = torch.randn(m_rows, n_out, generator=g, device="cuda").to(dtype)
            cot = torch.randn(m_rows, n_out, generator=g, device="cuda").to(dtype)
            for name, kern, plain, leaves in (
                    ("monarch_kernel", monarch_cuda.monarch_kernel,
                     monarch_cuda.monarch_kernel_reference, (x, w1, w2)),
                    ("monarch_add", monarch_cuda.monarch_add,
                     monarch_cuda.monarch_add_reference, (base, x, w1, w2))):
                a = [t.clone().requires_grad_() for t in leaves]
                b = [t.clone().requires_grad_() for t in leaves]
                before = monarch_cuda.LAUNCHES["monarch_bwd"]
                got = torch.autograd.grad(kern(*a), a, cot)
                want = torch.autograd.grad(plain(*b), b, cot)
                torch.cuda.synchronize()
                require(monarch_cuda.LAUNCHES["monarch_bwd"] == before + 1,
                        f"the backward of {name} did not launch K3")
                for gt, wt in zip(got, want):
                    e = float((gt.float() - wt.float()).abs().max())
                    tol = tolerance(dtype, wt)
                    require(gt.dtype == wt.dtype and e <= tol,
                            f"grad of {name} {proj} {dtype}: {e} > {tol}")
                    worst = max(worst, e / tol)
    print(f"[autograd] {card}: gradients of K1 and K2 (backward K3) at M={m_rows}, all 7 "
          f"projections, bf16 and f32: worst error {worst:.3f} of its tolerance", flush=True)

    gw = torch.Generator(device="cuda").manual_seed(SEED + 7)
    layer = MonarchLinear(2048, 2048, peft_config={"dropout": 0.1},
                          weights=torch.randn(2048, 2048, generator=gw, device="cuda") / 45,
                          device="cuda").to(torch.bfloat16).train()
    with torch.no_grad():
        layer.blkdiag2.normal_(0.0, 0.1, generator=gw)
    x = torch.randn(m_rows, 2048, generator=gw, device="cuda").to(torch.bfloat16)
    cot = torch.randn(m_rows, 2048, generator=gw, device="cuda").to(torch.bfloat16)
    before = dict(monarch_cuda.LAUNCHES)
    torch.manual_seed(SEED)
    got = torch.autograd.grad(layer(x), (layer.blkdiag1, layer.blkdiag2), cot)
    torch.manual_seed(SEED)
    w1, w2 = layer.blkdiag1.detach().requires_grad_(), layer.blkdiag2.detach().requires_grad_()
    plain = F.linear(x, layer.dense) + F.dropout(
        monarch_cuda.monarch_kernel_reference(x, w1, w2), 0.1, training=True)
    want = torch.autograd.grad(plain, (w1, w2), cot)
    torch.cuda.synchronize()
    require(monarch_cuda.LAUNCHES["monarch_kernel"] == before["monarch_kernel"] + 1
            and monarch_cuda.LAUNCHES["monarch_bwd"] == before["monarch_bwd"] + 1,
            "the dropout adapter did not run K1 forward and K3 backward")
    for gt, wt in zip(got, want):
        e, tol = float((gt - wt).abs().max()), tolerance(torch.bfloat16, wt)
        require(e <= tol, f"dropout adapter factor gradient: {e} > {tol}")
    print(f"[autograd] dropout 0.1 adapter (q shape, bf16, M={m_rows}): K1 forward and K3 "
          "backward, factor gradients within tolerance of the plain path", flush=True)


def slice_config(dtype: str):
    from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig

    return LlamaConfig(**MODEL, param_dtype=dtype, dtype=dtype,
                       max_position_embeddings=PROMPT + 3 * NEW)


def build_model(dtype: str, state=None):
    """The slice's model on the card, with Monarch adapters on all seven
    projections; random seeded weights, or ``state`` where given."""
    from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
    from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    model = LlamaForCausalLM(slice_config(dtype), device="cuda", generator=g)
    adapted = init_monarch(model, PEFT, generator=g)
    require(len(adapted) == N_ADAPTED, f"{len(adapted)} adapted linears, expected {N_ADAPTED}")
    if state is not None:
        model.load_state_dict(state)
    return model.eval()


@torch.no_grad()
def randomize_adapters(model) -> float:
    """Seeded random nonzero factors (the plain-adapter init zeroes blkdiag2,
    which would hide a kernel that writes zeros), scaled so that
    |monarch(x)| / |dense(x)| is about 0.1 for q_proj at layer 0 on the
    prompts' real input.  Returns that ratio."""
    from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    layers = [m for m in model.modules() if isinstance(m, MonarchLinear)]
    for m in layers:
        m.blkdiag1.normal_(0.0, 1.0, generator=g).div_(m.in_blksz ** 0.5)
        m.blkdiag2.normal_(0.0, 1.0, generator=g).div_(m.blk_r ** 0.5)
    ids, mask = prompts(torch.Generator(device="cuda").manual_seed(SEED + 2))
    layer0 = model.model.layers[0]
    x = layer0.input_layernorm(model.model.embed_tokens(ids))[mask.bool()]
    q = layer0.self_attn.q_proj

    def ratio():
        mon = monarch_cuda.monarch_kernel_reference(x, q.blkdiag1.to(x.dtype), q.blkdiag2.to(x.dtype))
        return float(mon.float().norm() / q._dense_forward(x).float().norm())

    scale = 0.1 / ratio()
    for m in layers:
        m.blkdiag2.mul_(scale)
    return ratio()


def prompts(g: torch.Generator):
    """Four left-padded prompts of lengths 64, 48, 33 and 17, padded to 64."""
    vocab = MODEL["vocab_size"]
    ids = torch.randint(3, vocab, (len(PROMPT_LENS), PROMPT), generator=g, device="cuda")
    mask = torch.zeros_like(ids)
    for row, n in enumerate(PROMPT_LENS):
        mask[row, PROMPT - n:] = 1
    return ids * mask, mask


def phase_f32() -> dict:
    """The slice in float32 against a copy with no kernel in it: the
    adapters merged on the CPU by the plain functions, then moved to the card."""
    import copy

    from sparse_matrix_fine_tuning_torch.peft.surgery import merge_all_adapters

    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 products in both
    torch.backends.cudnn.allow_tf32 = False
    model = build_model("float32")
    ratio = randomize_adapters(model)
    print(f"[f32] |monarch(x)|/|dense(x)| at layer 0 q_proj: {ratio:.4f}", flush=True)
    ref = copy.deepcopy(model).cpu()
    require(merge_all_adapters(ref) == N_ADAPTED, "merge on the CPU missed adapters")
    ref = ref.to("cuda")
    ids, mask = prompts(torch.Generator(device="cuda").manual_seed(SEED + 2))
    monarch_cuda.reset_launch_counts()
    with torch.inference_mode():
        got = model(ids, attention_mask=mask)
        want = ref(ids, attention_mask=mask)
    torch.cuda.synchronize()
    require(monarch_cuda.LAUNCHES["monarch_add"] == N_ADAPTED,
            f"prefill launched {monarch_cuda.LAUNCHES}; expected {N_ADAPTED} fused adds")
    valid = mask.bool()
    err = float((got - want)[valid].abs().max())
    scale = float(want[valid].abs().max())
    tol = F32_LOGIT_TOL * scale
    print(f"[f32] prefill logits {tuple(got.shape)}: max_abs_err {err:.3e}, tol {tol:.3e} "
          f"({F32_LOGIT_TOL:g} of max|logit| {scale:.3f})", flush=True)
    require(bool(torch.isfinite(got).all()), "non-finite f32 logits")
    require(err <= tol, f"f32 prefill logits differ: {err} > {tol}")

    check_greedy(model, ref, ids, mask, tol, "f32")
    # kept on the host, so that the peak memory of a later phase is its own
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model, ref
    torch.cuda.empty_cache()
    return {"logits": got.detach(), "mask": mask, "ids": ids, "state": state}


def check_greedy(model, ref, ids, mask, tol: float, tag: str) -> None:
    """Greedy F32_NEW tokens of ``model`` against ``ref``: identical, or the
    first divergence of a row at a near-tie of the reference's logits (gap
    within ``tol``)."""
    from sparse_matrix_fine_tuning_torch.models.generate import (
        GenerationConfig,
        _positions_from_mask,
        generate,
    )

    gc = GenerationConfig(max_new_tokens=F32_NEW)
    toks = generate(model, ids, mask, gc)
    ref_toks = generate(ref, ids, mask, gc)
    require(tuple(toks.shape) == (len(PROMPT_LENS), PROMPT + F32_NEW), f"tokens {toks.shape}")
    for row in range(toks.shape[0]):
        diff = (toks[row] != ref_toks[row]).nonzero()
        if len(diff) == 0:
            continue
        # the first divergence must be a true near-tie of the reference's logits
        at = int(diff[0])
        seq = ref_toks[row:row + 1, :at]
        m = torch.cat([mask[row:row + 1], torch.ones_like(seq[:, PROMPT:])], dim=-1)
        with torch.inference_mode():
            last = ref(seq, attention_mask=m, positions=_positions_from_mask(m))[0, -1]
        gap = float(last[ref_toks[row, at]] - last[toks[row, at]])
        print(f"[{tag}] row {row} diverges at step {at - PROMPT}: logit gap {gap:.3e} "
              f"(tol {tol:.3e})", flush=True)
        require(gap <= tol, f"{tag} tokens differ at row {row}, step {at - PROMPT}, gap {gap}")
    same = int((toks == ref_toks).all(dim=-1).sum())
    print(f"[{tag}] greedy {F32_NEW} tokens: {same}/{toks.shape[0]} rows identical to the "
          "reference", flush=True)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_busy_ms(fn, calls: int, label: str, kernels: dict | None = None):
    """Device time per call of ``fn`` from torch.profiler (None when the
    profiler sees no device time), and the top kernels by device time;
    ``kernels``, where given, receives each device kernel's launches a call
    by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    if kernels is not None:
        for _, count, key in rows:
            kernels[key] = kernels.get(key, 0) + count / calls
    busy_ms = sum(row[0] for row in rows) / calls
    if busy_ms == 0:
        print(f"[profile] {label}: device time not measured (the profiler saw no device time)",
              flush=True)
        return None
    launches = sum(row[1] for row in rows) / calls
    print(f"[profile] {calls} {label} under the profiler: wall {wall_ms / calls:.3f} ms each "
          f"(profiler on), device busy {busy_ms:.3f} ms and {launches:.0f} kernels each",
          flush=True)
    for dev_ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"[profile]   {dev_ms / calls:8.4f} ms  {count // calls:5d} launches  {key[:90]}",
              flush=True)
    return busy_ms


@torch.inference_mode()
def profile_decode(model, ids, mask, steps: int = 8, kernels: dict | None = None,
                   wrappers: list | None = None):
    """Device time per decode forward after a prefill, from torch.profiler;
    ``kernels`` as ``device_busy_ms``'s; ``wrappers``, where given, receives
    the wrappers' launch counts (``counts``) of each profiled step, one dict
    a step."""
    from sparse_matrix_fine_tuning_torch.models.generate import _positions_from_mask
    from sparse_matrix_fine_tuning_torch.models.llama import init_caches

    b, t = ids.shape
    caches = init_caches(model.config, b, t + steps + 1, torch.bfloat16, "cuda")
    mask_full = torch.cat([mask, mask.new_zeros(b, steps + 1)], dim=-1)
    pos = _positions_from_mask(mask)
    logits, caches = model(ids, attention_mask=mask_full, positions=pos, caches=caches,
                           cache_index=0)
    tok, pos = logits[:, -1].argmax(-1)[:, None], pos[:, -1:] + 1

    def step(i):
        mask_full[:, t + i] = 1
        return model(tok, attention_mask=mask_full, positions=pos + i, caches=caches,
                     cache_index=t + i)

    def counted(i):
        before = counts()
        out = step(i + 1)
        if wrappers is not None:
            after = counts()
            wrappers.append({k: after[k] - before[k] for k in after})
        return out

    step(0)
    return device_busy_ms(counted, steps, "decode steps", kernels)


def phase_bf16(f32: dict, card: str) -> dict:
    """The slice in bfloat16, timed as bench.py times the JAX one: batch 4,
    prompt 64, 128 new tokens, no EOS.  The counted main path is: unmerged
    greedy generate (K2 on every adapted linear), merge of the adapters on
    the card (K1), greedy generate of the merged model."""
    from sparse_matrix_fine_tuning_torch.models.generate import GenerationConfig, generate
    from sparse_matrix_fine_tuning_torch.peft.surgery import merge_all_adapters

    model = build_model("bfloat16", f32["state"])
    resident_gb = torch.cuda.memory_allocated() / 1e9
    with torch.inference_mode():
        logits = model(f32["ids"], attention_mask=f32["mask"])
    valid = f32["mask"].bool()
    require(bool(torch.isfinite(logits).all()), "non-finite bf16 logits")
    cos = float(torch.nn.functional.cosine_similarity(
        logits[valid].float().flatten(), f32["logits"][valid].float().flatten(), dim=0))
    print(f"[bf16] prefill logits cosine to f32: {cos:.5f} (need >= 0.99)", flush=True)
    require(cos >= 0.99, f"bf16 prefill logits cosine {cos} < 0.99")

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    mask = torch.ones(BATCH, PROMPT, dtype=torch.long, device="cuda")

    def fresh_ids():
        return torch.randint(2, MODEL["vocab_size"], (BATCH, PROMPT), generator=g, device="cuda")

    gc = GenerationConfig(max_new_tokens=NEW, eos_token_id=None)
    gc1 = GenerationConfig(max_new_tokens=1, eos_token_id=None)
    steps = NEW - 1  # decode forwards: one per new token after the prefill's

    def gen_s(new_cfg):
        ids = fresh_ids()
        return timed(lambda: generate(model, ids, mask, new_cfg))[1]

    generate(model, fresh_ids(), mask, GenerationConfig(max_new_tokens=8, eos_token_id=None))
    prefill = [gen_s(gc1) for _ in range(5)]
    gens = [gen_s(gc) for _ in range(3)]
    busy_ms = profile_decode(model, fresh_ids(), mask)
    probe = fresh_ids()
    with torch.inference_mode():
        unmerged_logits = model(probe, attention_mask=mask)

    reset_counts()  # the counted main path starts here
    ids = fresh_ids()
    toks, main_s = timed(lambda: generate(model, ids, mask, gc))
    adds = monarch_cuda.LAUNCHES["monarch_add"]
    _, merge_s = timed(lambda: merge_all_adapters(model))
    merged_toks, merged_main_s = timed(lambda: generate(model, ids, mask, gc))
    launches = counts()  # the counted main path ends here

    require(tuple(toks.shape) == (BATCH, PROMPT + NEW), f"tokens {tuple(toks.shape)}")
    require(bool(((toks >= 0) & (toks < MODEL["vocab_size"])).all()), "token out of range")
    want = N_ADAPTED * (1 + steps)
    print(f"[bf16] launches in the main path: {launches}; monarch_add in the unmerged "
          f"generate {adds}, expected {N_ADAPTED} x (1 + {steps}) = {want}", flush=True)
    require(adds == want == launches["monarch_add"], "fused-add launches do not match")
    require(launches["monarch_kernel"] == N_ADAPTED,
            f"merge launched monarch_kernel {launches['monarch_kernel']} times, "
            f"expected {N_ADAPTED}")
    require(all(launches[k] == 0 for k in QUANT_KERNELS), f"quantized kernels ran: {launches}")

    with torch.inference_mode():
        merged_logits = model(probe, attention_mask=mask)
    merged_cos = float(torch.nn.functional.cosine_similarity(
        merged_logits.float().flatten(), unmerged_logits.float().flatten(), dim=0))
    agree = float((merged_toks[:, PROMPT:] == toks[:, PROMPT:]).float().mean())
    merged_prefill = [gen_s(gc1) for _ in range(3)]
    merged_gens = [merged_main_s] + [gen_s(gc) for _ in range(2)]

    med = statistics.median
    prefill_ms = med(prefill) * 1e3
    gen_med = med(gens + [main_s])
    decode_ms = (gen_med * 1e3 - prefill_ms) / steps
    merged_prefill_ms = med(merged_prefill) * 1e3
    merged_decode_ms = (med(merged_gens) * 1e3 - merged_prefill_ms) / steps
    print(f"[bf16] {card}: batch {BATCH}, prompt {PROMPT}, {NEW} new tokens, unmerged adapters: "
          f"prefill {prefill_ms:.3f} ms (median of {len(prefill)}), decode {decode_ms:.4f} "
          f"ms/step, {BATCH * NEW / gen_med:.1f} tokens/s (generate median of "
          f"{len(gens) + 1}: {gen_med:.4f} s; all {[round(x, 4) for x in gens + [main_s]]}); "
          f"weights and buffers resident {resident_gb:.3f} GB", flush=True)
    if busy_ms is not None:
        print(f"[bf16] {card}: decode device busy {busy_ms:.3f} ms/step (profiled) of {decode_ms:.3f} "
              f"ms/step (unprofiled): idle share {1 - busy_ms / decode_ms:.3f}", flush=True)
    print(f"[bf16] {card}: merged on the card in {merge_s * 1e3:.1f} ms; merged: prefill "
          f"{merged_prefill_ms:.3f} ms, decode {merged_decode_ms:.4f} ms/step, "
          f"{BATCH * NEW / med(merged_gens):.1f} tokens/s; prefill logits cosine merged to "
          f"unmerged {merged_cos:.5f}; greedy tokens agree on {agree:.3f} of positions",
          flush=True)
    require(merged_cos >= 0.99, f"merged bf16 logits cosine {merged_cos} < 0.99")
    return {"launches": launches}


def train_data(rows: int, seq: int, seed: int) -> dict:
    """Seeded random token rows, every position a label (numpy, as Trainer
    takes them)."""
    import numpy as np

    ids = np.random.default_rng(seed).integers(3, MODEL["vocab_size"], (rows, seq)).astype(np.int32)
    return {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids.copy()}


def train_model(dtype: str, layers: int):
    """The training slice's model on the card: TinyLlama-1.1B widths,
    ``layers`` decoder layers, adapters on all seven projections with the
    random nonzero factors of ``randomize_adapters``."""
    from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
    from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM
    from sparse_matrix_fine_tuning_torch.peft.surgery import init_monarch

    cfg = LlamaConfig(**{**MODEL, "num_hidden_layers": layers}, param_dtype=dtype, dtype=dtype,
                      max_position_embeddings=TRAIN_SEQ)
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    model = LlamaForCausalLM(cfg, device="cuda", generator=g)
    require(len(init_monarch(model, PEFT, generator=g)) == 7 * layers, "adapters missing")
    randomize_adapters(model)
    return model


def train_args(merged: str, bs: int, ga: int, steps: int):
    from sparse_matrix_fine_tuning_torch.training.trainer import TrainingArgs

    return TrainingArgs(output_dir=os.path.join(OUT_DIR, "train"), learning_rate=TRAIN_LR,
                        max_steps=steps, per_device_train_batch_size=bs,
                        gradient_accumulation_steps=ga, warmup_ratio=0.0, logging_steps=0,
                        log_param_steps=0, merged_training=merged)


def check_step(model, data: dict, merged: str, expect: dict, tag: str) -> dict:
    """One optimizer step (``F32_TRAIN``) through Trainer on the card and on
    a CPU copy on the plain path.  The card's step launches exactly
    ``expect``; the loss, every factor's gradient and the updated factors
    agree within the F32_TRAIN_* tolerances.  ``tag`` opens the printed
    line; returns the card's launch counts."""
    import copy

    from sparse_matrix_fine_tuning_torch.training.trainer import Trainer

    c = F32_TRAIN
    out = {}
    for dev, m in (("cuda", model), ("cpu", copy.deepcopy(model).cpu())):
        tr = Trainer(m, train_args(merged, c["bs"], c["ga"], 1), train_data=data,
                     extra_trainable_paths=(), device=dev)
        batch, _ = next(tr._batches(data, c["bs"], shuffle=False, accum=c["ga"]))
        reset_counts()
        loss = float(tr.train_step(batch))
        launches = counts()
        out[dev] = (loss, {n: (p.grad.detach().cpu(), p.detach().cpu())
                           for n, p in m.named_parameters() if p.requires_grad}, launches)
        tr.close()
    (loss, got, launches), (want_loss, want, _) = out["cuda"], out["cpu"]
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"{tag}: launches {launches}, expected {expect}")
    require(abs(loss - want_loss) <= F32_TRAIN_LOSS_RTOL * abs(want_loss),
            f"{tag}: loss {loss} on the card, {want_loss} on the CPU")
    require(sorted(got) == sorted(want) and len(got) == 2 * 7 * c["layers"],
            f"{tag}: the trainable set is not the factors")
    worst_g = worst_p = 0.0
    for name, (grad, param) in got.items():
        wgrad, wparam = want[name]
        scale = float(wgrad.abs().max())
        eg = float((grad - wgrad).abs().max())
        require(eg <= F32_TRAIN_GRAD_TOL * scale,
                f"{tag}: grad of {name}: {eg} > {F32_TRAIN_GRAD_TOL} x {scale}")
        strong = wgrad.abs() >= 1e-3 * scale
        dp = (param - wparam).abs()
        require(float(dp[strong].max()) <= 1e-2 * TRAIN_LR
                and float(dp.max()) <= 2 * TRAIN_LR, f"{tag}: update of {name}")
        worst_g, worst_p = max(worst_g, eg / scale), max(worst_p, float(dp.max()))
    print(f"{tag}: loss {loss:.6f} card, {want_loss:.6f} CPU; worst factor gradient error "
          f"{worst_g:.2e} of its scale; worst update difference {worst_p:.2e} (lr {TRAIN_LR}); "
          f"launches {expect}", flush=True)
    return launches


def train_timed(model, merged: str, tag: str, extra: str = "") -> dict:
    """bf16 training at full size through Trainer: bs 4 x ga 8 x seq 512, 1
    warm-up and 3 timed optimizer steps, the launch counts zeroed just
    before the first step and read just after the last, then one step
    under the profiler.  Prints step ms, tokens/s, MFU, peak memory and the
    idle share after ``tag`` (and ``extra``); returns the losses and the
    launch counts."""
    from sparse_matrix_fine_tuning_torch.training.trainer import Trainer

    data = train_data(TRAIN_BS * TRAIN_GA * TRAIN_STEPS, TRAIN_SEQ, SEED + 10)
    cfg = model.config
    h, i, kv = cfg.hidden_size, cfg.intermediate_size, cfg.kv_heads * cfg.head_width
    p_matmul = cfg.num_hidden_layers * (2 * h * h + 2 * h * kv + 3 * h * i) + h * cfg.vocab_size
    # Model FLOPs per token with a frozen base: forward 2P and input
    # gradient 2P for every matmul (no weight gradient), plus 12 L h T for
    # the attention scores and values (causality not discounted); the
    # adapters' own FLOPs are left out.  bench.py:460-465 counts 6P: its
    # base is frozen too, but it counts the weight gradient.
    flops_per_token = 4 * p_matmul + 12 * cfg.num_hidden_layers * h * TRAIN_SEQ
    tr = Trainer(model, train_args(merged, TRAIN_BS, TRAIN_GA, TRAIN_STEPS), train_data=data,
                 extra_trainable_paths=(), device="cuda")
    batches = [b for b, _ in tr._batches(data, TRAIN_BS, shuffle=False, accum=TRAIN_GA)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the counted main path starts here
    losses, secs = [], []
    for batch in batches:
        loss, sec = timed(lambda: tr.train_step(batch))
        losses.append(float(loss))
        secs.append(sec)
    launches = counts()  # the counted main path ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(secs[1:]) * 1e3
    busy = device_busy_ms(lambda k: tr.train_step(batches[k]), 1,
                          f"bf16 training step ({tag.split(': ', 1)[-1]})")
    tr.close()
    require(all(map(math.isfinite, losses)), f"{tag}: losses {losses}")
    tps = TRAIN_BS * TRAIN_GA * TRAIN_SEQ / (step_ms / 1e3)
    mfu = flops_per_token * tps / benchlib.PEAK_OPS[torch.bfloat16]
    idle = f"{1 - busy / step_ms:.3f}" if busy is not None else "not measured"
    print(f"{tag}: losses {[round(x, 5) for x in losses]}; step {step_ms:.2f} ms (median of "
          f"{len(secs) - 1}; all {[round(x * 1e3, 2) for x in secs]}), {tps:.0f} tokens/s, MFU "
          f"{100 * mfu:.2f}% of 989 TFLOP/s ({flops_per_token / 1e9:.3f} GFLOP/token: 4 P_matmul "
          f"+ 12 L h T), {extra}peak memory {peak_gb:.2f} GB, device busy "
          f"{busy if busy is None else round(busy, 2)} ms/step, idle share {idle}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return {"losses": losses, "launches": launches}


def phase_train_f32(card: str) -> None:
    """One optimizer step (bs 2 x ga 2 x seq 128, full width, 2 layers, f32,
    TF32 off) through Trainer on the card against a CPU copy on the plain
    path (``check_step``), with merged training off (K2 forward, K3
    backward) and on (K4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = F32_TRAIN
    model = train_model("float32", c["layers"])
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    data = train_data(c["bs"] * c["ga"], c["seq"], SEED + 9)
    n = 7 * c["layers"] * c["ga"]
    expect = {"off": {"monarch_add": n, "monarch_bwd": n}, "on": {"monarch_dw_fused": n}}
    for merged in ("off", "on"):
        model.load_state_dict(state)
        check_step(model, data, merged, expect[merged], f"[train-f32] {card}: merged {merged}")
    del model
    torch.cuda.empty_cache()


def phase_train_bf16(card: str) -> dict:
    """The training slice at full size (``train_timed``): TinyLlama-1.1B
    widths, all 22 layers, bf16; merged training off and then on from the
    same factors on the same batches."""
    model = train_model("bfloat16", MODEL["num_hidden_layers"])
    factors = {n: p.detach().clone() for n, p in model.named_parameters() if "blkdiag" in n}
    runs = {}
    for merged in ("off", "on"):
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in factors:
                    p.copy_(factors[n])
        runs[merged] = train_timed(model, merged, f"[train-bf16] {card}: merged {merged}")
        launches = runs[merged]["launches"]
        want = N_ADAPTED * TRAIN_GA * TRAIN_STEPS
        counted = ("monarch_add", "monarch_bwd") if merged == "off" else ("monarch_dw_fused",)
        require(all(launches[k] == want for k in counted)
                and all(v == 0 for k, v in launches.items() if k not in counted),
                f"merged {merged}: launches {launches}; expected {want} of {counted}")
    diff = max(abs(a - b) for a, b in zip(runs["off"]["losses"], runs["on"]["losses"]))
    print(f"[train-bf16] merged against unmerged: largest loss difference {diff:.5f} "
          f"(tol {BF16_MERGED_LOSS_ATOL})", flush=True)
    require(diff <= BF16_MERGED_LOSS_ATOL, f"merged and unmerged losses differ by {diff}")
    del model
    torch.cuda.empty_cache()
    return {"launches": {**runs["off"]["launches"],
                         "monarch_dw_fused": runs["on"]["launches"]["monarch_dw_fused"]}}


# -- the quantized base (K5-K8) ------------------------------------------------

def _quant_weight(bits: int, n_in: int, n_out: int, g: torch.Generator):
    """Codes and scales of a seeded random (n_out, n_in) weight, quantized on
    the card as ``quantize_frozen_base`` does, and its dequantized matrix."""
    w = torch.randn(n_out, n_in, generator=g, device="cuda") * 0.02
    if bits == 8:
        codes, scales = quant._quantize_int8_device(w)
        dense = quant.dequantize_int8(codes, scales)
    else:
        codes, scales = quant._quantize_int4_device(w, QUANT_GROUP)
        dense = quant.dequantize_int4(codes, scales, QUANT_GROUP)
    return codes, scales, dense


def _quant_calls(name: str, a, codes, scales, dense):
    """(kernel, plain version, library call) of one K5-K8 case on operand a
    (x for the forward, dy for dx); the library call is one PyTorch product
    with the dequantized matrix, precomputed in a's dtype."""
    bits, dx = QUANT_KERNELS[name]
    g = QUANT_GROUP
    if bits == 8:
        kern = quant_cuda.int8_matmul_dx if dx else quant_cuda.int8_matmul
        plain = quant_cuda.int8_matmul_dx_reference if dx else quant_cuda.int8_matmul_reference
        args = (a, codes, scales)
    else:
        kern = quant_cuda.int4_matmul_dx if dx else quant_cuda.int4_matmul
        plain = quant_cuda.int4_matmul_dx_reference if dx else quant_cuda.int4_matmul_reference
        args = (a, codes, scales, g)
    w = dense.to(a.dtype)
    library = (lambda: torch.matmul(a, w)) if dx else (lambda: torch.nn.functional.linear(a, w))
    return (lambda: kern(*args)), (lambda: plain(*args)), library


def phase_quant_kernels(card: str, lib) -> dict:
    """K7/K5 at ROWS and K8/K6 at BWD_ROWS, the seven projections, bf16 and
    f32, against their plain versions, timed beside their bound and the
    library call on the dequantized matrix (``F.linear(x, W)`` forward,
    ``torch.matmul(dy, W)`` for dx).  Tolerances as ``tolerance``, for the
    output and for dx alike: both sides round each dequantized weight to the
    working dtype once and sum in fp32, in another order.  K5 and K7 in bf16
    above 16 rows (``int4_matmul_tile`` and ``int8_matmul_tile`` in the JSON
    line) and K6 and K8 in bf16 run the wgmma kernels, whose four functions
    (``qwgmma_kernel`` for int4, ``qwgmma_rs_kernel`` for int8, forward and
    dx) must hold HGMMA in their SASS (``check_hgmma``)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    worst = dict.fromkeys((*QUANT_KERNELS, "int4_matmul_tile", "int8_matmul_tile"), 0.0)
    per_layer = {(name, m): [] for name in QUANT_KERNELS for m in (4, TRAIN_BS * TRAIN_SEQ)}
    print(_HEADER, flush=True)
    with torch.inference_mode():
        for name, (bits, dx) in QUANT_KERNELS.items():
            for dtype in (torch.bfloat16, torch.float32):
                for m_rows in (BWD_ROWS if dx else ROWS):
                    for proj, n_in, n_out in PROJECTIONS:
                        codes, scales, dense = _quant_weight(bits, n_in, n_out, g)
                        a = torch.randn(m_rows, n_out if dx else n_in, generator=g,
                                        device="cuda").to(dtype)
                        kern, plain, library = _quant_calls(name, a, codes, scales, dense)
                        got, ref = kern(), plain()
                        torch.cuda.synchronize()
                        require(got.shape == ref.shape and got.dtype == ref.dtype,
                                f"{name} {proj} M={m_rows}: {got.shape}/{got.dtype} vs "
                                f"{ref.shape}/{ref.dtype}")
                        err = float((got.float() - ref.float()).abs().max())
                        tol = tolerance(dtype, ref)
                        (ms, call), (plain_ms, plain_call) = (time_ms(kern, 20, 3),
                                                              time_ms(plain, 20, 3))
                        rec = _record(name, proj, n_in, n_out, m_rows, dtype, err, err / tol, ms,
                                      plain_ms, call, plain_call, time_ms(library, 20, 3)[0])
                        require(err <= tol and bool(torch.isfinite(got).all()),
                                f"{name} {proj} M={m_rows} {dtype}: max_abs_err {err} > tol {tol}")
                        tile = not dx and dtype == torch.bfloat16 and m_rows > 16
                        key = name + "_tile" if tile else name
                        worst[key] = max(worst[key], err)
                        if dtype == torch.bfloat16 and (name, m_rows) in per_layer:
                            per_layer[(name, m_rows)].append(rec)
    layer = {key: _layer_sums(recs) for key, recs in per_layer.items() if recs}
    for (name, m_rows), v in layer.items():
        print(f"[quant-kernels] {card}: {name} per decoder layer (M={m_rows}, bf16, 7 "
              f"projections): {v['ms']:.5f} ms (plain {v['plain_ms']:.5f}, library "
              f"{v['library_ms']:.5f}, bound {v['bound_ms']:.5f} ms, {v['bound_by']})", flush=True)
    decode_rows(card, layer)
    quant_ragged_in(card, g)
    hgmma = check_hgmma(lib, "qwgmma", 4)
    print(f"[quant-kernels] {card}: HGMMA in all {hgmma} wgmma kernels (int4 and int8, "
          f"forward and dx)", flush=True)
    # the JSON line: the forward at decode (serving's shape) and at a
    # training micro-batch (``_tile``); dx at a training micro-batch
    main = {name: layer[(name, TRAIN_BS * TRAIN_SEQ if dx else 4)]
            for name, (_, dx) in QUANT_KERNELS.items()}
    for name in ("int4_matmul", "int8_matmul"):
        main[name + "_tile"] = layer[(name, TRAIN_BS * TRAIN_SEQ)]
    return {"worst": worst, "layer": main}


def quant_ragged_in(card: str, g: torch.Generator) -> None:
    """K5-K8 in bf16 at ``QUANT_RAGGED_IN`` x ``QUANT_RAGGED_ROWS``, forward
    (the wgmma tile path) and dx, against their plain versions: int4's h =
    in / 2 is no multiple of 8 there, where the tile forward reads an
    aligned copy of x (ROADMAP C.8; it trapped before)."""
    with torch.inference_mode():
        for n_in, n_out, group in QUANT_RAGGED_IN:
            w = torch.randn(n_out, n_in, generator=g, device="cuda") * 0.02
            for bits in (4, 8):
                if bits == 4:
                    codes, scales = quant._quantize_int4_device(w, group)
                    pairs = lambda x, dy: (  # noqa: E731
                        (quant_cuda.int4_matmul(x, codes, scales, group),
                         quant_cuda.int4_matmul_reference(x, codes, scales, group)),
                        (quant_cuda.int4_matmul_dx(dy, codes, scales, group),
                         quant_cuda.int4_matmul_dx_reference(dy, codes, scales, group)))
                else:
                    codes, scales = quant._quantize_int8_device(w)
                    pairs = lambda x, dy: (  # noqa: E731
                        (quant_cuda.int8_matmul(x, codes, scales),
                         quant_cuda.int8_matmul_reference(x, codes, scales)),
                        (quant_cuda.int8_matmul_dx(dy, codes, scales),
                         quant_cuda.int8_matmul_dx_reference(dy, codes, scales)))
                for m_rows in QUANT_RAGGED_ROWS:
                    x = torch.randn(m_rows, n_in, generator=g, device="cuda").bfloat16()
                    dy = torch.randn(m_rows, n_out, generator=g, device="cuda").bfloat16()
                    for what, (got, ref) in zip(("forward", "dx"), pairs(x, dy)):
                        torch.cuda.synchronize()
                        err = float((got.float() - ref.float()).abs().max())
                        tol = tolerance(torch.bfloat16, ref)
                        require(got.shape == ref.shape and err <= tol
                                and bool(torch.isfinite(got).all()),
                                f"int{bits} {what} at in {n_in} (group {group}) M={m_rows}: "
                                f"max abs err {err} > {tol}")
    print(f"[quant-kernels] {card}: int4 and int8, forward and dx, bf16, at in "
          f"{', '.join(str(c[0]) for c in QUANT_RAGGED_IN)} (int4's h % 8 != 0), M "
          f"{' and '.join(map(str, QUANT_RAGGED_ROWS))}: within tolerance", flush=True)


def decode_rows(card: str, layer: dict) -> None:
    """K5 and K7 at M = 4 as a decode step finds them: each projection's
    timed calls rotate over weight sets of more than ``DECODE_ROTATE_BYTES``
    (L2 holds none of them, as a step reads each layer's weights once),
    beside ``F.linear`` on rotating dequantized bf16 weights and the launch
    floor (an empty kernel at the decode kernel's grid, cluster and shared
    memory), summed over the seven projections and printed beside the warm
    numbers of ``layer`` (one weight set); then the plan of each projection
    and the registers of each K5/K7 instantiation of the decode kernel."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    for bits in (4, 8):
        name = f"int{bits}_matmul"
        cold = {"ms": 0.0, "library_ms": 0.0, "floor_ms": 0.0}
        with torch.inference_mode():
            for proj, n_in, n_out in PROJECTIONS:
                codes, scales, _ = _quant_weight(bits, n_in, n_out, g)
                nbytes = codes.numel() + 4 * scales.numel()
                sets = [(codes, scales)] + [_quant_weight(bits, n_in, n_out, g)[:2]
                                            for _ in range(math.ceil(DECODE_ROTATE_BYTES / nbytes))]
                n_dense = min(len(sets), math.ceil(DECODE_ROTATE_BYTES / (2 * n_in * n_out)) + 1)
                denses = [(quant.dequantize_int8(c, s) if bits == 8 else
                           quant.dequantize_int4(c, s, QUANT_GROUP)).to(torch.bfloat16)
                          for c, s in sets[:n_dense]]
                x = torch.randn(4, n_in, generator=g, device="cuda").to(torch.bfloat16)
                kern = (lambda c, s: quant_cuda.int8_matmul(x, c, s)) if bits == 8 else (
                    lambda c, s: quant_cuda.int4_matmul(x, c, s, QUANT_GROUP))
                state = {"i": 0}

                def nxt(items):
                    state["i"] += 1
                    return items[state["i"] % len(items)]

                ms = time_ms(lambda: kern(*nxt(sets)), 20, 3)[0]
                lib_ms = time_ms(lambda: torch.nn.functional.linear(x, nxt(denses)), 20, 3)[0]
                floor_ms = time_ms(lambda: quant_cuda.decode_empty(
                    bits, torch.bfloat16, 4, n_in, n_out, QUANT_GROUP), 20, 3)[0]
                plan = quant_cuda.decode_plan(bits, torch.bfloat16, 4, n_in, n_out, QUANT_GROUP)
                print(f"[decode-rows] {name} {proj:5s} {n_in}->{n_out}: cold {ms:.5f} ms "
                      f"({len(sets)} weight sets), F.linear cold {lib_ms:.5f} ({len(denses)}), "
                      f"launch floor {floor_ms:.5f}; plan {plan}", flush=True)
                RECORDS.append({"kernel": name, "proj": proj, "in": n_in, "out": n_out, "rows": 4,
                                "cold_ms": ms, "cold_library_ms": lib_ms, "floor_ms": floor_ms,
                                "weight_sets": len(sets), "plan": plan})
                cold["ms"] += ms
                cold["library_ms"] += lib_ms
                cold["floor_ms"] += floor_ms
                del sets, denses
        warm = layer[(name, 4)]
        print(f"[decode-rows] {card}: {name} per decoder layer (M=4, bf16): warm {warm['ms']:.5f} "
              f"ms, cold {cold['ms']:.5f}; F.linear warm {warm['library_ms']:.5f}, cold "
              f"{cold['library_ms']:.5f}; launch floor {cold['floor_ms']:.5f}; bound "
              f"{warm['bound_ms']:.5f}", flush=True)
        RECORDS.append({"kernel": name, "layer_rows": 4, "warm": warm, "cold": cold, "card": card})
    for a in quant_cuda.decode_attrs():
        if a["arith"] == 0:
            print(f"[decode-rows] qgemv_kernel int{a['bits']} "
                  f"{'bf16 (mma)' if a['bf16'] else 'f32 (FMA)'}, {a['rows']} rows a block: "
                  f"{a['registers']} registers, {a['local_bytes']} bytes local, "
                  f"{a['ctas_per_sm']} CTAs an SM", flush=True)
        require(a["local_bytes"] == 0 and a["ctas_per_sm"] >= 2,
                f"a decode-kernel instantiation spills or runs one CTA an SM: {a}")


def phase_quant_autograd(card: str) -> None:
    """The autograd Functions of K7 and K5: the gradient of x at M = 2047,
    every projection, bf16 and f32, against the plain version's autograd;
    each backward launches its dx kernel (K8, K6) exactly once."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    worst = 0.0
    for bits, name in ((8, "int8_matmul"), (4, "int4_matmul")):
        for dtype in (torch.bfloat16, torch.float32):
            for proj, n_in, n_out in PROJECTIONS:
                codes, scales, _ = _quant_weight(bits, n_in, n_out, g)
                x = torch.randn(2047, n_in, generator=g, device="cuda").to(dtype)
                cot = torch.randn(2047, n_out, generator=g, device="cuda").to(dtype)
                extra = () if bits == 8 else (QUANT_GROUP,)
                kern = quant_cuda.int8_matmul if bits == 8 else quant_cuda.int4_matmul
                plain = (quant_cuda.int8_matmul_reference if bits == 8
                         else quant_cuda.int4_matmul_reference)
                a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
                before = quant_cuda.LAUNCHES[name + "_dx"]
                (got,) = torch.autograd.grad(kern(a, codes, scales, *extra), a, cot)
                (want,) = torch.autograd.grad(plain(b, codes, scales, *extra), b, cot)
                torch.cuda.synchronize()
                require(quant_cuda.LAUNCHES[name + "_dx"] == before + 1,
                        f"the backward of {name} did not launch its dx kernel once")
                e, tol = float((got.float() - want.float()).abs().max()), tolerance(dtype, want)
                require(got.dtype == want.dtype and e <= tol,
                        f"grad of {name} {proj} {dtype}: {e} > {tol}")
                worst = max(worst, e / tol)
    print(f"[quant-autograd] {card}: gradients of x through K7 and K5 (backward K8, K6) at "
          f"M=2047, all 7 projections, bf16 and f32: worst error {worst:.3f} of its tolerance",
          flush=True)


# -- the fused dense + Monarch linear (K9-K11) ---------------------------------

def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def more_linear_repeats() -> None:
    """K9 and K10 (bf16) at ``MORE_REPEAT_CASE``: ``MORE_REPEATS`` calls of
    each give the first call's bits (PERF.md §7 left a race at J = 32
    open; every run of this script now looks for it)."""
    from sparse_matrix_fine_tuning_torch.scripts.compare_more_linear import inputs

    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    x, dout, wd, w1, w2 = inputs(*MORE_REPEAT_CASE, torch.bfloat16, g)
    with torch.no_grad():
        for name, call in (("K9", lambda: ml.more_linear_fwd(x, wd, w1, w2)),
                           ("K10", lambda: ml.more_linear_dx(dout, wd, w1, w2))):
            first = call()
            same = sum(bool(torch.equal(call(), first)) for _ in range(MORE_REPEATS))
            require(same == MORE_REPEATS, f"{name} at {MORE_REPEAT_CASE}: {MORE_REPEATS - same} "
                                          f"of {MORE_REPEATS} repeats gave other bits")
    print(f"[more-linear] K9 and K10 at {MORE_REPEAT_CASE} (J = 32): {MORE_REPEATS} repeats "
          "each equal the first bit for bit", flush=True)


def phase_more_linear(card: str, lib) -> dict:
    """The fused dense + Monarch linear, at ``bench_more_linear``'s three
    shapes in bf16 and at one ragged f32 case:
      * K9, K10 and K11 against their plain versions (``tolerance``; K11's
        fp32 factor gradients to that of the inputs' dtype), timed beside
        their bound, the plain version and one PyTorch call on the merged
        dense matrix Wd + M (M the factors' dense equivalent):
        ``F.linear(x, Wd + M)`` for K9, ``torch.matmul(dout, Wd + M)`` for
        K10, none for K11 (no single call gives both factor gradients);
      * one forward and backward of ``more_linear``: y and the gradients of
        x, w1 and w2 against the plain composition's autograd, each kernel
        launched exactly once.
    bf16's K9/K10 kernel (``fused_kernel``): its plan at each bench shape,
    HGMMA in the SASS of all its instantiations and ptxas's report of no
    spill.  Then the counted main path: ``bench_more_linear.run`` at the
    three shapes (fused, hybrid and plain steps), the launch counts zeroed
    just before and read just after."""
    import torch.nn.functional as F

    from sparse_matrix_fine_tuning_torch.ops.monarch import (
        monarch_dense_equivalent,
        monarch_forward_f32,
    )
    from sparse_matrix_fine_tuning_torch.scripts import bench_more_linear as bench

    worst = dict.fromkeys(MORE_KERNELS, 0.0)
    main = {name: [] for name in MORE_KERNELS}
    cases = [((label, *shape[1:]), torch.bfloat16)
             for label, shape in zip(MORE_LABELS, bench.SHAPES)]
    cases.append((MORE_RAGGED, torch.float32))
    print(_HEADER, flush=True)
    for (label, rows, n, m, nb, r), dtype in cases:
        x, wd, w1, w2 = bench.make_inputs(rows, n, m, nb, r, dtype, seed=SEED + 15)
        g = torch.Generator(device="cuda").manual_seed(SEED + 16)
        dout = torch.randn(rows, m, generator=g, device="cuda").to(dtype)
        merged = (wd.float() + monarch_dense_equivalent(w1.float(), w2.float())).to(dtype)
        calls = {
            "more_linear_fwd": (lambda: ml.more_linear_fwd(x, wd, w1, w2),
                                lambda: ml.more_linear_fwd_reference(x, wd, w1, w2),
                                lambda: F.linear(x, merged)),
            "more_linear_dx": (lambda: ml.more_linear_dx(dout, wd, w1, w2),
                               lambda: ml.more_linear_dx_reference(dout, wd, w1, w2),
                               lambda: torch.matmul(dout, merged)),
            "more_linear_dw": (lambda: ml.more_linear_dw(x, dout, w1, w2),
                               lambda: ml.more_linear_dw_reference(x, dout, w1, w2), None),
        }
        with torch.no_grad():
            for name, (kern, plain, library) in calls.items():
                got, ref = _outputs(kern()), _outputs(plain())
                torch.cuda.synchronize()
                err = share = 0.0
                for out, want in zip(got, ref):
                    require(out.shape == want.shape and out.dtype == want.dtype,
                            f"{name} {label}: {out.shape}/{out.dtype} vs {want.shape}/{want.dtype}")
                    require(bool(torch.isfinite(out).all()), f"{name} {label}: non-finite output")
                    e = float((out.float() - want.float()).abs().max())
                    err, share = max(err, e), max(share, e / tolerance(dtype, want))
                (ms, call), (plain_ms, plain_call) = time_ms(kern, 20, 3), time_ms(plain, 20, 3)
                lib_ms = time_ms(library, 20, 3)[0] if library is not None else None
                rec = _record(name, label, n, m, rows, dtype, err, share, ms, plain_ms, call,
                              plain_call, lib_ms, r)
                require(share <= 1.0, f"{name} {label} {dtype}: an output is over its tolerance "
                                      f"({share:.3f} of it)")
                worst[name] = max(worst[name], err)
                if dtype == torch.bfloat16:
                    main[name].append(rec)

        # the autograd Function: one forward and backward
        leaves = [t.clone().requires_grad_() for t in (x, w1, w2)]
        plain_leaves = [t.clone().requires_grad_() for t in (x, w1, w2)]
        before = dict(ml.LAUNCHES)
        y = ml.more_linear(leaves[0], wd, *leaves[1:])
        y.backward(dout)
        torch.cuda.synchronize()
        require(ml.LAUNCHES == {k: v + 1 for k, v in before.items()},
                f"more_linear {label}: one forward and backward launched "
                f"{ {k: ml.LAUNCHES[k] - v for k, v in before.items()} }, expected 1 of each")
        xb, w1b, w2b = plain_leaves
        comp = (xb.float() @ wd.float().T + monarch_forward_f32(xb, w1b, w2b)).to(dtype)
        want = [comp.detach(), *torch.autograd.grad(comp, plain_leaves, dout)]
        for what, g, w in zip(("y", "dx", "dw1", "dw2"), [y.detach()] + [t.grad for t in leaves],
                              want):
            e, tol = float((g.float() - w.float()).abs().max()), tolerance(dtype, w)
            require(g.dtype == w.dtype and g.shape == w.shape and e <= tol,
                    f"more_linear {label} {dtype}: {what} {e} > {tol}")
        del x, wd, w1, w2, dout, merged, y, leaves, plain_leaves, comp, want
        torch.cuda.empty_cache()
    print(f"[more-linear] {card}: K9, K10, K11 and the autograd Function (y, dx, dw1, dw2) "
          "within tolerance of the plain versions at the three bench shapes (bf16) and the "
          "ragged case (f32); one launch of each a forward and backward", flush=True)
    for label, (_, rows, n, m, nb, r) in zip(MORE_LABELS, bench.SHAPES):
        for name, dx in (("K9", False), ("K10", True)):
            print(f"[more-linear] plan {label} {name}: "
                  f"{ml.more_linear_plan(rows, n, m, nb * r, dx)}", flush=True)
    hgmma = check_hgmma(lib, "fused_kernel", MORE_FUSED_KERNELS)
    kernel_ptxas(lib, "fused_kernel", MORE_FUSED_KERNELS, "more-linear")
    more_linear_repeats()
    print(f"[more-linear] {card}: HGMMA in all {hgmma} bf16 K9/K10 kernels, none spills",
          flush=True)

    reset_counts()  # the counted main path starts here
    runs = [bench.run(*shape) for shape in bench.SHAPES]
    launches = counts()  # the counted main path ends here
    steps = sum(run["steps"] for run in runs)
    expect = {"more_linear_fwd": steps + len(runs), "more_linear_dx": steps,
              "more_linear_dw": steps, "monarch_add": steps, "monarch_bwd": steps}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"bench_more_linear: launches {launches}; expected {expect}")
    for label, run in zip(MORE_LABELS, runs):
        require(run["rel_diff"] <= MORE_LOSS_RTOL,
                f"bench_more_linear {label}: fused loss {run['rel_diff']} from the plain one")
        print(f"[more-linear] {card}: bench {label}: device us a step fused "
              f"{run['fused_us']:.1f}, hybrid {run['hybrid_us']:.1f}, plain {run['plain_us']:.1f} "
              f"(wall {run['fused_wall_us']:.1f}, {run['hybrid_wall_us']:.1f}, "
              f"{run['plain_wall_us']:.1f}); loss rel diff {run['rel_diff']:.2e}", flush=True)
    RECORDS.append({"bench_more_linear": runs, "card": card})
    return {"worst": worst, "layer": {name: _layer_sums(recs) for name, recs in main.items()},
            "launches": {name: launches[name] for name in MORE_KERNELS}}


# -- the forward-tile experiments (K15, K12) ------------------------------------

def check_hgmma(lib, prefix: str, count: int) -> int:
    """Each of the ``count`` kernels whose name holds ``prefix`` in the built
    library holds the warpgroup MMA (``HGMMA`` in its SASS, read with the
    toolkit's ``cuobjdump``), so that a build that dropped wgmma cannot pass.
    Returns how many were found."""
    from sparse_matrix_fine_tuning_torch.kernels.build import _cuda_home

    sass = subprocess.run([str(_cuda_home() / "bin" / "cuobjdump"), "-sass", str(lib)],
                          check=True, stdout=subprocess.PIPE, text=True).stdout
    kernels = [f for f in sass.split("Function : ")[1:] if prefix in f.splitlines()[0]]
    require(len(kernels) == count,
            f"cuobjdump found {len(kernels)} {prefix} functions, expected {count}")
    for f in kernels:
        require("HGMMA" in f, f"no HGMMA in the SASS of {f.splitlines()[0].strip()}")
    return len(kernels)


def phase_tiles(card: str, lib) -> dict:
    """K15 and K12, the kernels of the forward-tile experiments:
      * at a ragged shape, outside the counted paths: K15 at every tile
        against ``tiled_matmul_reference`` (bf16) and K12 at every row tile
        against ``monarch_kernel_reference`` (f32; and bf16 at 8 rows bit
        for bit against K1, whose instantiation it is);
      * every K15 kernel's SASS holds HGMMA (``check_hgmma``) and none
        spills (``kernel_ptxas``); at the bench shape each tile's plan is
        the Python mirror's (``schedule_plan``) and a repeated call gives
        the same bits;
      * the counted main paths: the ports of ``exp_matmul_tiles`` and
        ``exp_fwd_tile`` at 2664 x 4096 -> 4096, each of which checks every
        variant against its plain version before timing it, the launch
        counts zeroed just before each and read just after."""
    from sparse_matrix_fine_tuning_torch.scripts import exp_fwd_tile, exp_matmul_tiles

    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    m, k, n = TILES_RAGGED
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn(k, n, generator=g, device="cuda").to(torch.bfloat16)
    ref = tm.tiled_matmul_reference(x, w)
    for tile in tm.TILES:
        got = tm.tiled_matmul(x, w, tile)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        require(got.shape == ref.shape and err <= tolerance(torch.bfloat16, ref),
                f"tiled_matmul {tile} at {TILES_RAGGED}: max abs err {err}")
    b, n_in, n_out, nb, rank = FWD_TILE_RAGGED
    x = torch.randn(b, n_in, generator=g, device="cuda")
    w1 = torch.randn(nb, rank, n_in // nb, generator=g, device="cuda") / (n_in // nb) ** 0.5
    w2 = torch.randn(nb, n_out // nb, rank, generator=g, device="cuda") / rank ** 0.5
    ref = monarch_cuda.monarch_kernel_reference(x, w1, w2)
    for rows in monarch_cuda.FWD_TILE_ROWS:
        got = monarch_cuda.monarch_fwd_tile(x, w1, w2, rows)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        require(got.shape == ref.shape and err <= tolerance(torch.float32, ref),
                f"monarch_fwd_tile rows {rows} at {FWD_TILE_RAGGED} f32: max abs err {err}")
    xb, w1b, w2b = (t.to(torch.bfloat16) for t in (x, w1, w2))
    k1_rows = monarch_cuda.monarch_fwd_plan(b, w1b.shape, w2b.shape)["rows"]
    with torch.no_grad():
        k1 = monarch_cuda.monarch_kernel(xb, w1b, w2b)
        for rows in monarch_cuda.FWD_TILE_ROWS:
            require(torch.equal(monarch_cuda.monarch_fwd_tile(xb, w1b, w2b, rows), k1),
                    f"monarch_fwd_tile at {rows} rows differs from K1 at its own row tile "
                    f"({k1_rows})")
    hgmma = check_hgmma(lib, "tiled_mm_kernel", len(tm.TILES))
    kernel_ptxas(lib, "tiled_mm_kernel", len(tm.TILES), "tiles")
    m, k, n = TILES_BENCH
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    for tile in tm.TILES:
        plan = tm.tiled_matmul_plan(m, n, k, tile)
        require(plan == tm.schedule_plan(m, n, k, tile, plan["resident"]),
                f"tiled_matmul {tile}: the kernel's plan {plan} is not the Python mirror's")
        require(torch.equal(tm.tiled_matmul(x, w, tile), tm.tiled_matmul(x, w, tile)),
                f"tiled_matmul {tile} at {TILES_BENCH}: a repeated call gave other bits")
        print(f"[tiles] plan {tile} at {TILES_BENCH}: {plan}", flush=True)
    del x, w
    print(f"[tiles] {card}: K15 at {len(tm.TILES)} tiles and K12 at "
          f"{len(monarch_cuda.FWD_TILE_ROWS)} row tiles within tolerance at the ragged shapes; "
          f"K12 at every row tile equals K1 at its own ({k1_rows} rows); HGMMA in all "
          f"{hgmma} K15 kernels, none spills; K15 repeats bit for bit at {TILES_BENCH}, "
          "its plan the mirror's", flush=True)

    reset_counts()  # the counted main path starts here: exp_matmul_tiles
    mm = exp_matmul_tiles.run()
    launches = counts()  # ... and ends here
    expect = {"tiled_matmul": mm["steps"]}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"exp_matmul_tiles: launches {launches}; expected {expect}")
    mm_launches = launches["tiled_matmul"]
    reset_counts()  # the counted main path starts here: exp_fwd_tile
    fwd = [exp_fwd_tile.run(*shape) for shape in exp_fwd_tile.SHAPES]
    launches = counts()  # ... and ends here
    expect = {"monarch_fwd_tile": sum(run["steps"] for run in fwd)}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"exp_fwd_tile: launches {launches}; expected {expect}")
    for t in mm["tiles"]:
        require(t["max_abs_err"] <= mm["tolerance"], f"tiled_matmul {t['tile']}: {t}")
    for run in fwd:
        for t in run["tiles"]:
            require(t["max_abs_err"] <= run["tolerance"], f"monarch_fwd_tile {run['tag']}: {t}")
    best, script = mm["best"], fwd[0]
    print(f"[tiles] {card}: exp_matmul_tiles best tile {tuple(best['tile'])} "
          f"{best['ms']:.5f} ms ({best['tflops']:.1f} TFLOP/s), torch.matmul "
          f"{mm['library_ms']:.5f}, bound {mm['bound_ms']:.5f} ms; exp_fwd_tile best row tile "
          + "; ".join(f"{r['best']['rows']} {r['best']['ms']:.5f} ms (copy floor "
                      f"{r['copy_ms']:.5f}, bound {r['bound_ms']:.5f})" for r in fwd), flush=True)
    RECORDS.append({"exp_matmul_tiles": mm, "exp_fwd_tile": fwd, "card": card})
    layer = {
        "tiled_matmul": {"ms": best["ms"], "plain_ms": mm["plain_ms"],
                         "bound_ms": mm["bound_ms"], "bound_by": mm["bound_by"],
                         "library_ms": mm["library_ms"]},
        "monarch_fwd_tile": {"ms": script["best"]["ms"], "plain_ms": script["plain_ms"],
                             "bound_ms": script["bound_ms"], "bound_by": script["bound_by"],
                             "library_ms": script["library_ms"]},
    }
    worst = {"tiled_matmul": max(t["max_abs_err"] for t in mm["tiles"]),
             "monarch_fwd_tile": max(t["max_abs_err"] for r in fwd for t in r["tiles"])}
    return {"layer": layer, "worst": worst,
            "launches": {"tiled_matmul": mm_launches,
                         "monarch_fwd_tile": expect["monarch_fwd_tile"]}}


# -- the dw experiments (K13, K14) -------------------------------------------

def phase_dw(card: str) -> dict:
    """K13 and K14, the kernels of the dw experiments, and K3/K4 through the
    fast path at blk_r 8 and 16:
      * outside the counted paths, at the ragged shapes of ``DW_RAGGED`` in
        f32 and bf16: K3 and K4 against their plain versions, on the path
        ``monarch_bwd_plan`` names; K13 at 16 rows and at every
        ``DW_TILE_ROWS`` against K4's plain version;
      * ``monarch_bwd_plan`` reports the fast path at the bench's three
        shapes and the dw script's two;
      * at the dw script's shape (bf16): two K13 launches at 256 rows equal
        bit for bit, K14 equals K13 at 256 rows bit for bit, and K14 timed
        against the plain version on rotating input sets;
      * the counted main paths: the ports of ``exp_dw_kernel`` and
        ``exp_merged_v3`` at 2664 x 4096 -> 4096, each of which checks every
        variant before timing it, the launch counts zeroed just before each
        and read just after."""
    from sparse_matrix_fine_tuning_torch.scripts import bench_more_linear as bench
    from sparse_matrix_fine_tuning_torch.scripts import exp_dw_kernel, exp_merged_v3

    g = torch.Generator(device="cuda").manual_seed(SEED + 31)
    with torch.no_grad():
        for m_rows, k, q, p, l, s, r, fast in DW_RAGGED:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(m_rows, k * p, generator=g, device="cuda").to(dtype)
                w1 = (torch.randn(k, q, p, generator=g, device="cuda") / p ** 0.5).to(dtype)
                w2 = (torch.randn(l, s, r, generator=g, device="cuda") / r ** 0.5).to(dtype)
                dout = torch.randn(m_rows, s * l, generator=g, device="cuda").to(dtype)
                tag = f"M={m_rows} (K, Q, P)=({k}, {q}, {p}) (L, S, R)=({l}, {s}, {r}) {dtype}"
                for with_dx in (True, False):
                    plan = monarch_cuda.monarch_bwd_plan(m_rows, w1.shape, w2.shape,
                                                         with_dx=with_dx, dtype=dtype)
                    require(plan[0] == fast, f"monarch_bwd_plan {tag}: {plan}, fast {fast}")
                ref_bwd = monarch_cuda.monarch_bwd_reference(x, w1, w2, dout)
                ref_dw = ref_bwd[1:]
                cases = [("K3", monarch_cuda.monarch_bwd(x, w1, w2, dout), ref_bwd),
                         ("K4", monarch_cuda.monarch_dw_fused(x, dout, w1, w2), ref_dw)]
                cases += [(f"K13 rows {rows}", monarch_cuda.monarch_dw_tile(x, dout, w1, w2, rows),
                           ref_dw) for rows in DW_RAGGED_ROWS]
                torch.cuda.synchronize()
                for name, got, want in cases:
                    for out, ref in zip(got, want):
                        err = float((out.float() - ref.float()).abs().max())
                        require(out.shape == ref.shape and out.dtype == ref.dtype
                                and bool(torch.isfinite(out).all())
                                and err <= tolerance(dtype, ref),
                                f"{name} {tag}: max abs err {err} > {tolerance(dtype, ref)}")
    plans = {}
    for label, (_, rows, n, m, nb, r) in zip(MORE_LABELS, bench.SHAPES):
        plans[f"bench {label}"] = monarch_cuda.monarch_bwd_plan(
            rows, (nb, r, n // nb), (nb, m // nb, r), with_dx=True)
    for tag, b, n, m, nb, r in exp_dw_kernel.SHAPES:
        plans[f"exp_dw_kernel rank {r}"] = monarch_cuda.monarch_bwd_plan(
            b, (nb, r, n // nb), (nb, m // nb, r))
    require(all(fast for fast, _ in plans.values()), f"not the fast path: {plans}")

    _, b, n, m, nb, r = exp_dw_kernel.SHAPES[0]
    pairs, w1, w2 = exp_dw_kernel.make_inputs(b, n, m, nb, r)
    x, dout = pairs[0]
    rows = monarch_cuda.MERGED_DW_ROWS
    with torch.no_grad():
        first = monarch_cuda.monarch_dw_tile(x, dout, w1, w2, rows)
        second = monarch_cuda.monarch_dw_tile(x, dout, w1, w2, rows)
        merged = monarch_cuda.monarch_dw_merged(x, dout, w1, w2)
        ref = monarch_cuda.monarch_dw_fused_reference(x, dout, w1, w2)
        torch.cuda.synchronize()
        require(all(torch.equal(a, c) for a, c in zip(first, second)),
                "two K13 launches at blk_r 16 differ")
        require(all(torch.equal(a, c) for a, c in zip(first, merged)),
                f"K14 differs from K13 at {rows} rows")
        merged_err = exp_dw_kernel.check("K14", merged, ref)
        merged_ms = time_ms(exp_dw_kernel.rotating(
            lambda xx, dd: monarch_cuda.monarch_dw_merged(xx, dd, w1, w2), pairs),
            exp_dw_kernel.REPS, exp_dw_kernel.ROUNDS)[0]
    del pairs, x, dout, first, second, merged, ref
    torch.cuda.empty_cache()
    print(f"[dw] {card}: K3, K4 and K13 at {len(DW_RAGGED_ROWS)} row groups within tolerance "
          f"at {len(DW_RAGGED)} ragged shapes (f32, bf16); fast path at "
          + ", ".join(f"{k} {v}" for k, v in plans.items())
          + f"; K13 repeats bit for bit, K14 equals K13 at {rows} rows; K14 {merged_ms:.5f} ms",
          flush=True)

    reset_counts()  # the counted main path starts here: exp_dw_kernel
    dw = [exp_dw_kernel.run(*shape) for shape in exp_dw_kernel.SHAPES]
    launches = counts()  # ... and ends here
    expect = {"monarch_dw_tile": sum(len(run["tiles"]) * run["steps"] for run in dw),
              "more_linear_dw": sum(run["steps"] for run in dw)}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"exp_dw_kernel: launches {launches}; expected {expect}")
    tile_launches = expect["monarch_dw_tile"]
    reset_counts()  # the counted main path starts here: exp_merged_v3
    mv3 = [exp_merged_v3.run(*shape) for shape in exp_merged_v3.SHAPES]
    launches = counts()  # ... and ends here
    steps = sum(run["steps"] for run in mv3)
    expect = {"monarch_add": steps, "monarch_bwd": steps, "monarch_dw_fused": steps,
              "monarch_dw_merged": steps}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"exp_merged_v3: launches {launches}; expected {expect}")
    script = dw[0]
    print(f"[dw] {card}: exp_dw_kernel "
          + "; ".join(f"rank {run['shape'][4]}: best row group {run['best']['rows']} "
                      f"{run['best']['ms']:.5f} ms, K11 {run['k11']['ms']:.5f}, plain "
                      f"{run['plain_ms']:.5f}, read floor {run['floor_ms']:.5f}, bound "
                      f"{run['bound_ms']:.5f}" for run in dw)
          + "; exp_merged_v3 device us a micro-batch "
          + "; ".join(f"rank {run['shape'][4]}: " + ", ".join(
              f"{k} {v['us']:.1f}" for k, v in run["variants"].items()) for run in mv3),
          flush=True)
    RECORDS.append({"exp_dw_kernel": dw, "exp_merged_v3": mv3, "plans": plans,
                    "monarch_dw_merged_ms": merged_ms, "card": card})
    layer = {
        "monarch_dw_tile": {"ms": script["best"]["ms"], "plain_ms": script["plain_ms"],
                            "bound_ms": script["bound_ms"], "bound_by": script["bound_by"],
                            "library_ms": None},
        "monarch_dw_merged": {"ms": merged_ms, "plain_ms": script["plain_ms"],
                              "bound_ms": script["bound_ms"], "bound_by": script["bound_by"],
                              "library_ms": None},
    }
    worst = {"monarch_dw_tile": max(t["max_abs_err"] for run in dw for t in run["tiles"]),
             "monarch_dw_merged": merged_err}
    return {"layer": layer, "worst": worst,
            "launches": {"monarch_dw_tile": tile_launches, "monarch_dw_merged": steps}}


def phase_int4_variants(card: str) -> dict:
    """K16, the int4 dequant-arithmetic variants:
      * outside the counted path, at ``INT4_VARIANT_RAGGED`` and each of
        ``INT4_VARIANT_ROWS``: every variant's raw output against its plain
        version (two bf16 ulps of its scale), and f32mul equal to K5 bit
        for bit where K5 takes the decode kernel (M <= 16);
      * the counted main path: the port of ``exp_int4_dequant_variants`` at
        its four shapes, which checks every variant against its plain
        version and the JAX script's oracle bound before timing it, the
        launch counts zeroed just before and read just after."""
    from sparse_matrix_fine_tuning_torch.scripts import exp_int4_dequant_variants as script

    n_in, n_out, group = INT4_VARIANT_RAGGED
    g = torch.Generator(device="cuda").manual_seed(SEED + 41)
    worst = 0.0
    with torch.no_grad():
        packed, scales = quant._quantize_int4_device(
            torch.randn(n_out, n_in, generator=g, device="cuda") * 0.05, group)
        for m_rows in INT4_VARIANT_ROWS:
            x = torch.randn(m_rows, n_in, generator=g, device="cuda").to(torch.bfloat16)
            k5 = quant_cuda.int4_matmul(x, packed, scales, group)
            for name in quant_cuda.INT4_VARIANTS:
                got = quant_cuda.int4_variant_matmul(x, packed, scales, group, name)
                ref = quant_cuda.int4_variant_reference(x, packed, scales, group, name)
                torch.cuda.synchronize()
                err = float((got.float() - ref.float()).abs().max())
                require(got.shape == ref.shape and got.dtype == ref.dtype
                        and bool(torch.isfinite(got).all()) and err <= tolerance(ref.dtype, ref),
                        f"K16 {name} M={m_rows} {n_in}->{n_out}: max abs err {err} > "
                        f"{tolerance(ref.dtype, ref)}")
                worst = max(worst, err)
                if name == "f32mul" and m_rows <= 16:
                    require(torch.equal(got, k5), f"K16 f32mul differs from K5 at M={m_rows}")
    print(f"[int4-variants] {card}: K16's {len(quant_cuda.INT4_VARIANTS)} variants within "
          f"tolerance at M {INT4_VARIANT_ROWS}, {n_in}->{n_out}; f32mul equals K5 at decode rows",
          flush=True)

    reset_counts()  # the counted main path starts here: exp_int4_dequant_variants
    runs = [script.run(*shape) for shape in script.SHAPES]
    launches = counts()  # ... and ends here
    expect = {k: sum(run["launches"][k] for run in runs) for k in ("int4_variant", "int4_matmul")}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"exp_int4_dequant_variants: launches {launches}; expected {expect}")
    for run in runs:
        best = run["variants"][run["best"]]
        print(f"[int4-variants] {card}: B={run['shape'][0]} {run['shape'][1]}->{run['shape'][2]}: "
              + ", ".join(f"{k} {v['ms']:.5f}" for k, v in run["variants"].items())
              + f" ms; best {run['best']} ({best['share_of_bound']:.1%} of the bound "
              f"{run['bound_ms']:.5f}, {run['bound_by']}); K5 {run['k5_ms']:.5f}, F.linear "
              f"{run['library_ms']:.5f}, read floor {run['floor_ms']:.5f}", flush=True)
    RECORDS.append({"exp_int4_dequant_variants": runs, "card": card})
    main = next(run for run in runs if tuple(run["shape"]) == INT4_VARIANT_SHAPE)
    best = main["variants"][main["best"]]
    worst = max([worst] + [v["max_abs_err"] for run in runs for v in run["variants"].values()])
    layer = {"int4_variant": {"ms": best["ms"], "plain_ms": best["plain_ms"],
                              "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                              "library_ms": main["library_ms"]}}
    return {"layer": layer, "worst": {"int4_variant": worst},
            "launches": {"int4_variant": expect["int4_variant"]}}


def dequantized_copy(model):
    """A CPU copy of a quantized model with no kernel in it: each layer's
    codes dequantized into a float32 dense by the plain functions."""
    import copy

    from torch import nn

    from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear

    ref = copy.deepcopy(model).cpu()
    for m in ref.modules():
        if isinstance(m, MonarchLinear) and m.quant_bits:
            if m.quant_bits == 8:
                w = quant.dequantize_int8(m.dense, m.dense_scales)
            else:
                w = quant.dequantize_int4(m.dense, m.dense_scales, m.quant_group)
            m.dense = nn.Parameter(w, requires_grad=False)
            m.dense_scales, m.quant_bits, m.quant_group = None, 0, 0
    return ref


def phase_quant_f32(f32: dict, card: str) -> None:
    """Quantized serving in float32, int8 and int4: the 22-layer model with
    the random adapters of ``randomize_adapters``, quantized on the card,
    against a copy with no kernel in it (codes dequantized by the plain
    functions and the adapters merged, on the CPU, then moved to the card).
    Prefill launches K7 (or K5) and K2 once on each adapted linear."""
    from sparse_matrix_fine_tuning_torch.peft.surgery import merge_all_adapters

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ids, mask = f32["ids"], f32["mask"]
    for bits in (8, 4):
        model = build_model("float32", f32["state"])
        require(quant.quantize_frozen_base(model, bits=bits) == N_ADAPTED, "quantize missed layers")
        ref = dequantized_copy(model)
        require(merge_all_adapters(ref) == N_ADAPTED, "merge on the CPU missed adapters")
        ref = ref.to("cuda")
        name = f"int{bits}_matmul"
        reset_counts()
        with torch.inference_mode():
            got = model(ids, attention_mask=mask)
        launches = counts()
        with torch.inference_mode():
            want = ref(ids, attention_mask=mask)
        torch.cuda.synchronize()
        require(launches[name] == N_ADAPTED and launches["monarch_add"] == N_ADAPTED
                and sum(launches.values()) == 2 * N_ADAPTED,
                f"int{bits} prefill launched {launches}; expected {N_ADAPTED} of {name} and of "
                "monarch_add")
        valid = mask.bool()
        err = float((got - want)[valid].abs().max())
        scale = float(want[valid].abs().max())
        tol = F32_LOGIT_TOL * scale
        print(f"[quant-f32] {card}: int{bits} prefill logits {tuple(got.shape)}: max_abs_err "
              f"{err:.3e}, tol {tol:.3e} ({F32_LOGIT_TOL:g} of max|logit| {scale:.3f}); "
              f"launches {name} {launches[name]}, monarch_add {launches['monarch_add']}",
              flush=True)
        require(bool(torch.isfinite(got).all()), f"non-finite int{bits} f32 logits")
        require(err <= tol, f"int{bits} f32 prefill logits differ: {err} > {tol}")
        check_greedy(model, ref, ids, mask, tol, f"quant-f32 int{bits}")
        del model, ref
        torch.cuda.empty_cache()


def phase_quant_bf16(f32: dict, card: str) -> dict:
    """Quantized serving in bfloat16, timed as ``phase_bf16``: batch 4,
    prompt 64, 128 new tokens, three configurations of the 22-layer model:
    (a) int8 base, adapters unmerged (K7 and K2 on every adapted linear);
    (b) int8 base with ``requantize_merge_adapters`` (its deltas through
        K1) and the w8a8 ``Int8LMHead``, ``bench.py:141-145`` (K7 only);
    (c) int4 base, adapters unmerged (K5 and K2).
    Each generate is a counted main path; the prefill logits are held
    against the unquantized bf16 model's (cosine, ``QUANT_COS``).  The host
    clock drifts over minutes, so each configuration's timed generates
    alternate with the unquantized bf16 model's, which is timed beside it;
    the counted generate runs alone, last.  Resident and peak memory are the
    configuration's own: measured from what was allocated before its model
    was built.  A counted generate launches the forward once an adapted
    linear for its prefill (BATCH x PROMPT = 256 rows: the wgmma kernel)
    and once a decode step (BATCH rows: the decode kernel); the returned
    launches split them so (``int8_matmul_tile``, ``int8_matmul``)."""
    from sparse_matrix_fine_tuning_torch.models.generate import GenerationConfig, generate

    base = build_model("bfloat16", f32["state"])
    with torch.inference_mode():
        base_logits = base(f32["ids"], attention_mask=f32["mask"])
    valid = f32["mask"].bool()
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    mask = torch.ones(BATCH, PROMPT, dtype=torch.long, device="cuda")

    def fresh_ids():
        return torch.randint(2, MODEL["vocab_size"], (BATCH, PROMPT), generator=g, device="cuda")

    gc = GenerationConfig(max_new_tokens=NEW, eos_token_id=None)
    gc1 = GenerationConfig(max_new_tokens=1, eos_token_id=None)
    steps = NEW - 1
    med = statistics.median
    out = {}
    for label, bits, merged in (("a: int8 unmerged", 8, False),
                                ("b: int8 requantize-merged, w8a8 head", 8, True),
                                ("c: int4 unmerged", 4, False)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        model = build_model("bfloat16", f32["state"])
        require(quant.quantize_frozen_base(model, bits=bits) == N_ADAPTED, "quantize missed layers")
        if merged:
            reset_counts()
            require(quant.requantize_merge_adapters(model) == N_ADAPTED, "requantize-merge")
            require(monarch_cuda.LAUNCHES["monarch_kernel"] == N_ADAPTED,
                    f"requantize-merge launched {counts()}; expected {N_ADAPTED} of K1")
            require(quant.quantize_lm_head(model, impl="w8a8"), "lm_head not quantized")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident_gb = (torch.cuda.memory_allocated() - before) / 1e9
        with torch.inference_mode():
            logits = model(f32["ids"], attention_mask=f32["mask"])
        require(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
        cos = float(torch.nn.functional.cosine_similarity(
            logits[valid].float().flatten(), base_logits[valid].float().flatten(), dim=0))
        need = QUANT_COS[bits]
        print(f"[quant-bf16] {label}: prefill logits cosine to the unquantized bf16 model "
              f"{cos:.5f} (need >= {need})", flush=True)
        require(cos >= need, f"{label}: logits cosine {cos} < {need}")

        def gen_s(m, cfg):
            ids = fresh_ids()
            return timed(lambda: generate(m, ids, mask, cfg))[1]

        def alternate(cfg, n):
            """n timed generates of the quantized model and of the unquantized
            one, alternating."""
            pairs = [(gen_s(model, cfg), gen_s(base, cfg)) for _ in range(n)]
            return [p[0] for p in pairs], [p[1] for p in pairs]

        generate(model, fresh_ids(), mask, GenerationConfig(max_new_tokens=8, eos_token_id=None))
        generate(base, fresh_ids(), mask, GenerationConfig(max_new_tokens=8, eos_token_id=None))
        prefill, base_prefill = alternate(gc1, 3)
        gens, base_gens = alternate(gc, 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()  # the counted main path starts here
        ids = fresh_ids()
        toks, main_s = timed(lambda: generate(model, ids, mask, gc))
        launches = counts()  # the counted main path ends here
        peak_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
        kernels, wrappers = {}, []
        busy_ms = profile_decode(model, fresh_ids(), mask, steps=DECODE_PROFILE_STEPS,
                                 kernels=kernels, wrappers=wrappers)
        name = f"int{bits}_matmul"
        # the decode kernel once an adapted linear a step, one launch a call:
        # the wrappers' own count, exact every step; the profiler, which
        # loses a record now and then (ROADMAP C.10), within one record of
        # it over the profiled steps and never above it; qsplit_sum never
        per_step = [w[name] for w in wrappers]
        require(per_step == [N_ADAPTED] * DECODE_PROFILE_STEPS,
                f"{label}: the wrappers counted {per_step} {name} launches in the profiled "
                f"decode steps; expected {N_ADAPTED} each")
        if busy_ms is not None:
            want = N_ADAPTED * DECODE_PROFILE_STEPS
            gemv = round(DECODE_PROFILE_STEPS * sum(
                n for key, n in kernels.items() if "qgemv_kernel" in key))
            split = round(DECODE_PROFILE_STEPS * sum(
                n for key, n in kernels.items() if "qsplit_sum" in key))
            print(f"[quant-bf16] {label}: {DECODE_PROFILE_STEPS} decode steps launch "
                  f"qgemv_kernel {gemv} times by the profiler, {sum(per_step)} by the wrappers' "
                  f"count ({name}: {per_step}), qsplit_sum {split} times", flush=True)
            require(want - 1 <= gemv <= want and split == 0,
                    f"{label}: the profiler counted qgemv_kernel {gemv} and qsplit_sum {split} "
                    f"times in {DECODE_PROFILE_STEPS} decode steps; expected {want} (at least "
                    f"{want - 1}) and 0")
        want = N_ADAPTED * (1 + steps)
        expect = {name: want, "monarch_add": 0 if merged else want}
        require(tuple(toks.shape) == (BATCH, PROMPT + NEW), f"{label}: tokens {tuple(toks.shape)}")
        require(launches == {**dict.fromkeys(launches, 0), **expect},
                f"{label}: launches {launches}; expected {expect}")
        prefill_ms = med(prefill) * 1e3
        gen_med = med(gens + [main_s])
        decode_ms = (gen_med * 1e3 - prefill_ms) / steps
        base_prefill_ms = med(base_prefill) * 1e3
        base_decode_ms = (med(base_gens) * 1e3 - base_prefill_ms) / steps
        idle = f"{1 - busy_ms / decode_ms:.3f}" if busy_ms is not None else "not measured"
        print(f"[quant-bf16] {card}: {label}: prefill {prefill_ms:.3f} ms (median of "
              f"{len(prefill)}), decode {decode_ms:.4f} ms/step, {BATCH * NEW / gen_med:.1f} "
              f"tokens/s (generate median of {len(gens) + 1}: {gen_med:.4f} s; all "
              f"{[round(x, 4) for x in gens + [main_s]]}); device busy "
              f"{busy_ms if busy_ms is None else round(busy_ms, 3)} ms/step, idle share {idle}; "
              f"weights and buffers resident {resident_gb:.3f} GB, peak {peak_gb:.3f} GB; "
              f"launches {expect}", flush=True)
        print(f"[quant-bf16] {card}: {label}: the unquantized bf16 model, timed alternately "
              f"with it: prefill {base_prefill_ms:.3f} ms, decode {base_decode_ms:.4f} ms/step "
              f"(generates {[round(x, 4) for x in base_gens]} s against "
              f"{[round(x, 4) for x in gens]})", flush=True)
        out[label] = launches
        del model
        torch.cuda.empty_cache()
    # each counted generate's launches were required exact above: one
    # prefill (N_ADAPTED) and `steps` decode steps of N_ADAPTED each
    launches = {}
    for name in ("int8_matmul", "int4_matmul"):
        total = sum(v[name] for v in out.values())
        prefills = N_ADAPTED * sum(1 for v in out.values() if v[name])
        launches.update({name: total - prefills, name + "_tile": prefills})
    return {"launches": launches}


def phase_quant_train_f32(card: str) -> None:
    """One optimizer step (bs 2 x ga 2 x seq 128, full width, 2 layers, f32,
    TF32 off, merged training off) over an int8 and an int4 base, through
    Trainer on the card against a CPU copy on the plain path, with
    ``phase_train_f32``'s tolerances.  Launches: K7/K5 and K2 in the forward
    and K3 in the backward on every adapted linear each micro-batch; K8/K6
    on all but layer 0's q, k and v, whose input (the frozen embedding,
    normalised) needs no gradient."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = F32_TRAIN
    n_adapted = 7 * c["layers"]
    data = train_data(c["bs"] * c["ga"], c["seq"], SEED + 14)
    for bits in (8, 4):
        model = train_model("float32", c["layers"])
        require(quant.quantize_frozen_base(model, bits=bits) == n_adapted, "quantize missed layers")
        name = f"int{bits}_matmul"
        expect = {name: n_adapted * c["ga"], "monarch_add": n_adapted * c["ga"],
                  "monarch_bwd": n_adapted * c["ga"], name + "_dx": (n_adapted - 3) * c["ga"]}
        check_step(model, data, "off", expect, f"[quant-train-f32] {card}: int{bits}")
        del model
        torch.cuda.empty_cache()


def phase_quant_train_bf16(card: str, bits: int) -> dict:
    """QLoRA-style training at full size (``run_alpaca.py --bits 8`` or
    ``--bits 4``): the 22-layer bf16 model over an int8 or int4 base, bs 4 x
    ga 8 x seq 512, merged training off, 1 warm-up and 3 timed optimizer
    steps through Trainer, the launch counts zeroed just before the first
    step and read just after the last (``train_timed``).  Launches, exact:
    the base's forward (K7, K5) and K2 and K3 on every adapted linear each
    micro-batch, its dx (K8, K6) on all but layer 0's q, k and v, whose
    input needs no gradient; nothing else."""
    model = train_model("bfloat16", MODEL["num_hidden_layers"])
    require(quant.quantize_frozen_base(model, bits=bits) == N_ADAPTED, "quantize missed layers")
    torch.cuda.empty_cache()
    resident = f"weights and buffers resident {torch.cuda.memory_allocated() / 1e9:.3f} GB, "
    launches = train_timed(model, "off", f"[quant-train-bf16] {card}: int{bits} base, merged off",
                           resident)["launches"]
    micro = TRAIN_GA * TRAIN_STEPS
    name = f"int{bits}_matmul"
    expect = {name: N_ADAPTED * micro, "monarch_add": N_ADAPTED * micro,
              "monarch_bwd": N_ADAPTED * micro, name + "_dx": (N_ADAPTED - 3) * micro}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"int{bits} training: launches {launches}; expected {expect}")
    del model
    torch.cuda.empty_cache()
    return {"launches": {name: launches[name], name + "_dx": launches[name + "_dx"]}}


def main() -> None:
    t0 = time.perf_counter()

    def lap(tag: str) -> None:
        print(f"[time] {tag} done at {time.perf_counter() - t0:.1f} s", flush=True)

    card = phase_device()
    lib = phase_build()
    fwd = phase_kernels(card)
    bwd = phase_kernels_bwd(card, lib)
    qk = phase_quant_kernels(card, lib)
    lap("kernels")
    phase_autograd(card)
    phase_quant_autograd(card)
    # serving first: its quantized decode profiles lose records after other
    # profiler sessions in the process (ROADMAP C.10), and the experiments
    # below open a dozen
    f32 = phase_f32()
    phase_quant_f32(f32, card)
    lap("f32 serving")
    serving = phase_bf16(f32, card)
    qserving = phase_quant_bf16(f32, card)
    del f32
    lap("bf16 serving")
    more = phase_more_linear(card, lib)
    lap("fused dense+Monarch linear")
    tiles = phase_tiles(card, lib)
    lap("forward-tile experiments")
    dws = phase_dw(card)
    lap("dw experiments")
    variants = phase_int4_variants(card)
    lap("int4 dequant variants")
    phase_train_f32(card)
    phase_quant_train_f32(card)
    lap("f32 training")
    training = phase_train_bf16(card)
    q8training = phase_quant_train_bf16(card, 8)
    q4training = phase_quant_train_bf16(card, 4)
    lap("bf16 training")
    launches = {"monarch_kernel": serving["launches"]["monarch_kernel"],
                "monarch_add": serving["launches"]["monarch_add"],
                "monarch_bwd": training["launches"]["monarch_bwd"],
                "monarch_dw_fused": training["launches"]["monarch_dw_fused"],
                # the forwards by the kernel that ran them: serving's decode
                # steps (the decode kernel), serving's prefills and the
                # quantized training steps' micro-batches (the wgmma kernel)
                "int8_matmul": qserving["launches"]["int8_matmul"],
                "int8_matmul_tile": qserving["launches"]["int8_matmul_tile"]
                + q8training["launches"]["int8_matmul"],
                "int8_matmul_dx": q8training["launches"]["int8_matmul_dx"],
                "int4_matmul": qserving["launches"]["int4_matmul"],
                "int4_matmul_tile": qserving["launches"]["int4_matmul_tile"]
                + q4training["launches"]["int4_matmul"],
                "int4_matmul_dx": q4training["launches"]["int4_matmul_dx"],
                **more["launches"], **tiles["launches"], **dws["launches"],
                **variants["launches"]}
    measured = {**fwd["layer"], **bwd["layer"], **qk["layer"], **more["layer"], **tiles["layer"],
                **dws["layer"], **variants["layer"]}
    worst = {**fwd["worst"], **bwd["worst"], **qk["worst"], **more["worst"], **tiles["worst"],
             **dws["worst"], **variants["worst"]}
    require(all(launches[name] > 0 for name in KERNELS), f"a kernel never launched: {launches}")
    lines = [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
              "launches": launches[name], "max_abs_err": worst[name],
              "ms": measured[name]["ms"], "plain_ms": measured[name]["plain_ms"],
              "bound_ms": measured[name]["bound_ms"], "bound_by": measured[name]["bound_by"],
              "library_ms": measured[name]["library_ms"]}
             for name, (src, replaces) in KERNELS.items()]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "records.json"), "w") as f:
        json.dump({"card": card, "records": RECORDS, "kernels": lines}, f, indent=1)
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
