"""Smoke test of the PyTorch port on one NVIDIA H100: ``python3 chip_smoke.py``.

Drives the port's main paths on a TinyLlama-1.1B-shaped Llama with Monarch
adapters on all seven projections (random seeded weights) through the
hand-written CUDA kernels, and checks them:

  1. device: a CUDA card of compute capability 9.0, its name and power limit;
  2. build: the kernels are compiled from ``kernels/csrc/`` in this checkout;
  3. forward kernels K1, K2 against their plain PyTorch versions at the
     slice's shapes, bfloat16 and float32, timed beside their bound and the
     one PyTorch call that computes the same function;
  4. backward kernels K3, K4 likewise at the training shapes, and the
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
 10. quantized serving, float32, int8 and int4: prefill logits and greedy
     tokens against a copy whose codes were dequantized and whose adapters
     were merged on the CPU;
 11. quantized serving, bfloat16, timed: int8 unmerged (K7, K2), int8
     requantize-merged with the w8a8 head (K7), int4 unmerged (K5, K2);
 12. quantized training: one float32 step (2 layers) on the card against a
     CPU copy, int8 and int4; then 22-layer bfloat16 training over an int4
     base (``run_alpaca --bits 4``), timed and profiled;
 13. the fused dense + Monarch linear: K9 (forward), K10 (dx) and K11 (the
     factor gradients, K4's kernel) against their plain versions at
     ``bench_more_linear``'s three Llama-7B and micro-bench shapes (bf16)
     and a ragged f32 case, timed beside their bound and one PyTorch call,
     the autograd Function against the plain composition, then the port of
     ``scripts/bench_more_linear.py`` (fused, hybrid and plain steps).

Each main path (6, 8 off, 8 on, each configuration of 11, each step of 12,
the bench of 13) zeroes the launch counts of every kernel just before it
and reads them just after.  Any failed check exits non-zero.  The line
before the last is one JSON object on the kernels (K9-K11: ms, plain,
library and bound summed over the bench's three shapes); the last is
``{"ok": true, "device": {...}}``.  Per-case records go to
``chip_smoke_out/records.json``.  It imports nothing of JAX.
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published HBM3 rate
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16; fp32 off tensor cores
KERNELS = {
    "monarch_kernel": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_fwd.cu",
                       "sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py:157"),
    "monarch_add": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_fwd.cu",
                    "sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py:164"),
    "monarch_bwd": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_bwd.cu",
                    "sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py:173"),
    "monarch_dw_fused": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_bwd.cu",
                         "sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py:364"),
    "int4_matmul": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_matmul.cu",
                    "sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py:115"),
    "int4_matmul_dx": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_matmul.cu",
                       "sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py:141"),
    "int8_matmul": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_matmul.cu",
                    "sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py:305"),
    "int8_matmul_dx": ("sparse_matrix_fine_tuning_torch/kernels/csrc/quant_matmul.cu",
                       "sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py:312"),
    "more_linear_fwd": ("sparse_matrix_fine_tuning_torch/kernels/csrc/more_linear.cu",
                        "sparse_matrix_fine_tuning_tpu/kernels/experimental/more_linear.py:52"),
    "more_linear_dx": ("sparse_matrix_fine_tuning_torch/kernels/csrc/more_linear.cu",
                       "sparse_matrix_fine_tuning_tpu/kernels/experimental/more_linear.py:80"),
    "more_linear_dw": ("sparse_matrix_fine_tuning_torch/kernels/csrc/monarch_bwd.cu",
                       "sparse_matrix_fine_tuning_tpu/kernels/experimental/more_linear.py:108"),
}
# The quantized base (quant/, run_alpaca.py --bits): (bits, whether dx).
QUANT_KERNELS = {"int8_matmul": (8, False), "int8_matmul_dx": (8, True),
                 "int4_matmul": (4, False), "int4_matmul_dx": (4, True)}
QUANT_GROUP = 64  # quantize_frozen_base's default group
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
# The fused dense + Monarch linear (K9-K11): short labels of
# bench_more_linear.SHAPES, and the ragged f32 check (tests/kernels/
# test_more_linear.py:17): (label, rows, n, m, nblocks, blk_r).
MORE_KERNELS = ("more_linear_fwd", "more_linear_dx", "more_linear_dw")
MORE_LABELS = ("qkv", "micro", "gate")
MORE_RAGGED = ("ragged", 200, 128, 96, 4, 8)
# The bench's fused loss against its plain one: each bf16 y is within two
# ulps (2**-7 relatively) of the plain path's, so each y**2 within 2**-6.
MORE_LOSS_RTOL = 2.0 ** -6
OUT_DIR = "chip_smoke_out"  # per-case records; .gitignore lists it
RECORDS: list[dict] = []  # one per kernel case, written to OUT_DIR


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def reset_counts() -> None:
    """Zero the launch counts of every kernel (K1-K4, K5-K8 and K9-K11)."""
    monarch_cuda.reset_launch_counts()
    quant_cuda.reset_launch_counts()
    ml.reset_launch_counts()


def counts() -> dict:
    """The launch counts of every kernel since the last reset."""
    return {**monarch_cuda.LAUNCHES, **quant_cuda.LAUNCHES, **ml.LAUNCHES}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, stdout=subprocess.PIPE, text=True).stdout.strip()
    return out.splitlines()[0]


def phase_device() -> str:
    require(torch.cuda.is_available(), "no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    require(cap == (9, 0), f"needs compute capability 9.0 (sm_90a), got {cap}")
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)}, capability {cap}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(card, flush=True)
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = build(verbose=True)
    monarch_cuda.load_ops()
    print(f"[build] {time.perf_counter() - t0:.1f} s, {lib}", flush=True)


def time_ms(fn, reps: int = 50, rounds: int = 5) -> tuple[float, float]:
    """(device ms, call ms) per call: medians over rounds of `reps`
    back-to-back calls between two CUDA events, after a warmup.

    call ms: the queue is empty when the start event is recorded, so it
    includes the host's cost of each call, as an eager decode step sees it.
    device ms: a spin kernel (``torch.cuda._sleep``) holds the queue for
    twice the host time of the calls, so the calls run back to back on the
    card and the events see device time only."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run(stall_cycles: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if stall_cycles:
            torch.cuda._sleep(stall_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    call_ms = statistics.median(run(0) for _ in range(rounds))
    stall = int(2 * call_ms * reps * 2.0e6)  # ms -> cycles at up to 2 GHz
    device_ms = statistics.median(run(stall) for _ in range(rounds))
    return device_ms, call_ms


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
    nbytes, ops = cost(name, m_rows, n_in, n_out, dtype, r)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


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


def phase_kernels(card: str) -> dict:
    """K1 and K2 against their plain versions at the slice's shapes, with the
    library call that computes the same function on a precomputed dense
    matrix: ``F.linear(x, M)`` for K1, ``torch.addmm(base, x, M^T)`` for K2."""
    from sparse_matrix_fine_tuning_torch.ops.monarch import monarch_dense_equivalent

    g = torch.Generator(device="cuda").manual_seed(SEED)
    nb, r = PEFT["nblocks"], PEFT["blk_r"]
    worst = {"monarch_kernel": 0.0, "monarch_add": 0.0}
    decode = {name: [] for name in worst}
    print(f"[kernels] card: {card}", flush=True)
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
                        if dtype == torch.bfloat16 and m_rows == 4:
                            decode[name].append(rec)
    layer = {name: _layer_sums(recs) for name, recs in decode.items()}
    print(f"[kernels] {card}: device time per decoder layer at decode (M=4, bf16, "
          "7 projections): "
          + ", ".join(f"{k} {v['ms']:.5f} ms (plain {v['plain_ms']:.5f}, library "
                      f"{v['library_ms']:.5f}, bound {v['bound_ms']:.5f} ms)"
                      for k, v in layer.items()), flush=True)
    return {"worst": worst, "layer": layer}


def phase_kernels_bwd(card: str) -> dict:
    """K3 and K4 against their plain versions at the training shapes: the
    seven projections, rows M in BWD_ROWS (ragged and whole), bf16 and f32.
    No single PyTorch call computes either function (dx and the two factor
    gradients of the Monarch structure), so they have no library time.
    Tolerances: dx as the forward's output; the fp32 factor gradients 1e-5
    of their scale in f32, 2**-6 of it in bf16 (an intermediate one bf16 ulp
    apart enters every row's product)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    nb, r = PEFT["nblocks"], PEFT["blk_r"]
    worst = {"monarch_bwd": 0.0, "monarch_dw_fused": 0.0}
    train = {name: [] for name in worst}
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


def device_busy_ms(fn, calls: int, label: str):
    """Device time per call of ``fn`` from torch.profiler (None when the
    profiler sees no device time), and the top kernels by device time."""
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
def profile_decode(model, ids, mask, steps: int = 8):
    """Device time per decode forward after a prefill, from torch.profiler."""
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

    step(0)
    return device_busy_ms(lambda i: step(i + 1), steps, "decode steps")


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
    mfu = flops_per_token * tps / PEAK_OPS[torch.bfloat16]
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


def phase_quant_kernels(card: str) -> dict:
    """K7/K5 at ROWS and K8/K6 at BWD_ROWS, the seven projections, bf16 and
    f32, against their plain versions, timed beside their bound and the
    library call on the dequantized matrix (``F.linear(x, W)`` forward,
    ``torch.matmul(dy, W)`` for dx).  Tolerances as ``tolerance``, for the
    output and for dx alike: both sides round each dequantized weight to the
    working dtype once and sum in fp32, in another order."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    worst = dict.fromkeys(QUANT_KERNELS, 0.0)
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
                        worst[name] = max(worst[name], err)
                        if dtype == torch.bfloat16 and (name, m_rows) in per_layer:
                            per_layer[(name, m_rows)].append(rec)
    layer = {key: _layer_sums(recs) for key, recs in per_layer.items() if recs}
    for (name, m_rows), v in layer.items():
        print(f"[quant-kernels] {card}: {name} per decoder layer (M={m_rows}, bf16, 7 "
              f"projections): {v['ms']:.5f} ms (plain {v['plain_ms']:.5f}, library "
              f"{v['library_ms']:.5f}, bound {v['bound_ms']:.5f} ms, {v['bound_by']})", flush=True)
    # the JSON line: the forward at decode (serving's shape), dx at a
    # training micro-batch
    main = {name: layer[(name, TRAIN_BS * TRAIN_SEQ if dx else 4)]
            for name, (_, dx) in QUANT_KERNELS.items()}
    return {"worst": worst, "layer": main}


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


def phase_more_linear(card: str) -> dict:
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
    Then the counted main path: ``bench_more_linear.run`` at the three shapes
    (fused, hybrid and plain steps), the launch counts zeroed just before
    and read just after."""
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
        print(f"[more-linear] {card}: bench {label}: fused {run['fused_us']:.1f}, hybrid "
              f"{run['hybrid_us']:.1f}, plain {run['plain_us']:.1f} us a step; loss rel diff "
              f"{run['rel_diff']:.2e}", flush=True)
    RECORDS.append({"bench_more_linear": runs, "card": card})
    # where a bench step's device time goes: one step of each path per
    # shape under the profiler (not part of the counted main path)
    for label, shape in zip(MORE_LABELS, bench.SHAPES):
        x, wd, w1, w2 = bench.make_inputs(*shape[1:])
        x, w1, w2 = (t.requires_grad_() for t in (x, w1, w2))
        for name, loss_fn in bench.PATHS.items():
            bench.value_and_grad(loss_fn, x, wd, w1, w2)
            device_busy_ms(lambda i: bench.value_and_grad(loss_fn, x, wd, w1, w2), 2,
                           f"bench {label} {name} steps")
    return {"worst": worst, "layer": {name: _layer_sums(recs) for name, recs in main.items()},
            "launches": {name: launches[name] for name in MORE_KERNELS}}


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
    was built."""
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
        busy_ms = profile_decode(model, fresh_ids(), mask)
        name = f"int{bits}_matmul"
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
    return {"launches": {
        "int8_matmul": sum(v["int8_matmul"] for v in out.values()),
        "int4_matmul": sum(v["int4_matmul"] for v in out.values())}}


def phase_quant_train_f32(card: str) -> dict:
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
    out = {}
    for bits in (8, 4):
        model = train_model("float32", c["layers"])
        require(quant.quantize_frozen_base(model, bits=bits) == n_adapted, "quantize missed layers")
        name = f"int{bits}_matmul"
        expect = {name: n_adapted * c["ga"], "monarch_add": n_adapted * c["ga"],
                  "monarch_bwd": n_adapted * c["ga"], name + "_dx": (n_adapted - 3) * c["ga"]}
        out[bits] = check_step(model, data, "off", expect, f"[quant-train-f32] {card}: int{bits}")
        del model
        torch.cuda.empty_cache()
    return {"launches": {"int8_matmul_dx": out[8]["int8_matmul_dx"]}}


def phase_quant_train_bf16(card: str) -> dict:
    """QLoRA-style training at full size (``run_alpaca.py --bits 4``): the
    22-layer bf16 model over an int4 base, bs 4 x ga 8 x seq 512, merged
    training off, 1 warm-up and 3 timed optimizer steps through Trainer,
    the launch counts zeroed just before the first step and read just after
    the last (``train_timed``)."""
    model = train_model("bfloat16", MODEL["num_hidden_layers"])
    require(quant.quantize_frozen_base(model, bits=4) == N_ADAPTED, "quantize missed layers")
    torch.cuda.empty_cache()
    resident = f"weights and buffers resident {torch.cuda.memory_allocated() / 1e9:.3f} GB, "
    launches = train_timed(model, "off", f"[quant-train-bf16] {card}: int4 base, merged off",
                           resident)["launches"]
    micro = TRAIN_GA * TRAIN_STEPS
    expect = {"int4_matmul": N_ADAPTED * micro, "monarch_add": N_ADAPTED * micro,
              "monarch_bwd": N_ADAPTED * micro, "int4_matmul_dx": (N_ADAPTED - 3) * micro}
    require(launches == {**dict.fromkeys(launches, 0), **expect},
            f"int4 training: launches {launches}; expected {expect}")
    del model
    torch.cuda.empty_cache()
    return {"launches": {"int4_matmul": launches["int4_matmul"],
                         "int4_matmul_dx": launches["int4_matmul_dx"]}}


def main() -> None:
    t0 = time.perf_counter()

    def lap(tag: str) -> None:
        print(f"[time] {tag} done at {time.perf_counter() - t0:.1f} s", flush=True)

    card = phase_device()
    phase_build()
    fwd = phase_kernels(card)
    bwd = phase_kernels_bwd(card)
    qk = phase_quant_kernels(card)
    lap("kernels")
    phase_autograd(card)
    phase_quant_autograd(card)
    more = phase_more_linear(card)
    lap("fused dense+Monarch linear")
    f32 = phase_f32()
    phase_quant_f32(f32, card)
    lap("f32 serving")
    serving = phase_bf16(f32, card)
    qserving = phase_quant_bf16(f32, card)
    del f32
    lap("bf16 serving")
    phase_train_f32(card)
    qtrain_f32 = phase_quant_train_f32(card)
    lap("f32 training")
    training = phase_train_bf16(card)
    qtraining = phase_quant_train_bf16(card)
    lap("bf16 training")
    launches = {"monarch_kernel": serving["launches"]["monarch_kernel"],
                "monarch_add": serving["launches"]["monarch_add"],
                "monarch_bwd": training["launches"]["monarch_bwd"],
                "monarch_dw_fused": training["launches"]["monarch_dw_fused"],
                "int8_matmul": qserving["launches"]["int8_matmul"],
                "int8_matmul_dx": qtrain_f32["launches"]["int8_matmul_dx"],
                "int4_matmul": qserving["launches"]["int4_matmul"]
                + qtraining["launches"]["int4_matmul"],
                "int4_matmul_dx": qtraining["launches"]["int4_matmul_dx"],
                **more["launches"]}
    measured = {**fwd["layer"], **bwd["layer"], **qk["layer"], **more["layer"]}
    worst = {**fwd["worst"], **bwd["worst"], **qk["worst"], **more["worst"]}
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
