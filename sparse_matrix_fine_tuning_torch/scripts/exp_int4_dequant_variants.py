"""Time the int4 decode product's dequantize-arithmetic variants (K16) on
the card: ``python -m sparse_matrix_fine_tuning_torch.scripts.exp_int4_dequant_variants``.

Counterpart of ``scripts/exp_int4_dequant_variants.py``, which asked why
the TPU's int4 decode kernel (K5) ran far from its roofline by timing
seven arithmetic variants of its per-cell dequantization.  This one runs
the same seven (``quant_cuda.INT4_VARIANTS``) through K16, K5's decode kernel
(``qgemv_kernel``) with its per-cell arithmetic a template parameter, at the
JAX script's four shapes (``SHAPES``), group ``G``, seed and weight scale.
For each shape and variant, in order:

  1. the kernel's raw output against its plain version
     (``int4_variant_reference``) within two bf16 ulps of the raw
     output's scale (``tolerance``);
  2. the finished variant (ucorr and ugdot minus ``unsigned_correction``)
     against the oracle ``bf16(x @ dequantize_int4(..., bf16))`` within the
     JAX script's bound, ``0.02 * max(scale, 1)`` (:313-317);
  3. only then its time.

Nothing is caught: a variant that fails to build, launch or check fails
the script.  Beside each variant it prints, in device microseconds
(``utils/benchlib.time_ms``, call microseconds beside them): its share of
the bound, the raw kernel alone (ucorr and ugdot), the plain version,
K16's plan; once a shape: K5 (``quant_cuda.int4_matmul``, the production
path at that M: the decode kernel at M <= 16, the wgmma tile kernel
above), ``F.linear(x, W)`` on the dequantized bf16 weight as the library
line, a read floor of the codes and scales (a float sum of each), and the
device time of f32mul's (K5's) kernel from torch.profiler
(``kernel_times``): one launch a call, ``qgemv_kernel``, the mean over the
records the profiler kept and their count, with any other kernel it
launched beside it.

The weights of set 0 are the JAX script's (numpy ``default_rng(0)``, normal
times 0.02, quantized by the port's ``quant.quantize_int4``, which is bit
for bit JAX's; then x from the same generator, in bf16).  The timed calls
rotate over ``weight_sets`` seeded sets, more than 100 MB of codes and
scales together, so that no call finds its weight left in the 50 MB L2 by
the call before (a decode step reads a different weight in every layer).
The bound is the larger of the bytes (codes, scales, x and y, once each)
over 3.35 TB/s and the operations over the tensor cores' 989 TFLOP/s; the
operations over the CUDA cores' 67 TFLOP/s, where K16 runs, are printed
beside it.  ``_pick_fwd_tiles``, the JAX script's VMEM tile picker, has no
counterpart here.  It needs a CUDA card and fails without one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sparse_matrix_fine_tuning_torch import quant
from sparse_matrix_fine_tuning_torch.kernels import quant_cuda
from sparse_matrix_fine_tuning_torch.utils import benchlib

G = 64
# (B, in, out): TinyLlama-1.1B's decode shapes and the 7B down_proj at
# decode and at 256 rows (the JAX script's :264-265)
SHAPES = ((4, 5632, 2048), (4, 2048, 5632), (4, 11008, 4096), (256, 11008, 4096))
SEED = 0
WEIGHT_SCALE = 0.02
ROTATE_BYTES = 100e6  # codes and scales the timed calls rotate over
ORACLE_RTOL = 0.02  # the JAX script's bound: 0.02 * max(scale, 1)
REPS, ROUNDS = 20, 5  # calls a timed round; rounds (utils/benchlib.time_ms)
PROFILED_CALLS = 20  # f32mul calls under the profiler, for K5's kernel time


def weight_bytes(n_in: int, n_out: int, group: int = G) -> int:
    """Bytes of the packed codes and the f32 scales."""
    return n_in * n_out // 2 + 4 * (n_in // group) * n_out


def weight_sets(n_in: int, n_out: int, group: int = G) -> int:
    """Weight sets the timed calls rotate over: at least ``ROTATE_BYTES``."""
    return math.ceil(ROTATE_BYTES / weight_bytes(n_in, n_out, group))


def cost(b: int, n_in: int, n_out: int, group: int = G) -> tuple[int, int]:
    """(bytes, operations): the codes, the f32 scales and x (bf16) read
    once, y (bf16) written once; 2 * b * in * out operations."""
    return weight_bytes(n_in, n_out, group) + 2 * b * (n_in + n_out), 2 * b * n_in * n_out


def bound_ms(b: int, n_in: int, n_out: int) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    return benchlib.roofline_ms(*cost(b, n_in, n_out), torch.bfloat16)


def cuda_core_ms(b: int, n_in: int, n_out: int) -> float:
    """The operations over the CUDA cores' fp32 rate (no tensor cores)."""
    return cost(b, n_in, n_out)[1] / benchlib.PEAK_OPS[torch.float32] * 1e3


def tolerance(ref: torch.Tensor) -> float:
    """Two bf16 ulps of the raw output's scale (2**-6 of it), as
    ``chip_smoke.tolerance`` holds bf16: both sides sum in fp32 in another
    order and round the output once."""
    return float(ref.float().abs().max()) * 2.0 ** -6


def oracle_bound(oracle: torch.Tensor) -> float:
    return ORACLE_RTOL * max(float(oracle.float().abs().max()), 1.0)


def jax_inputs(b: int, n_in: int, n_out: int):
    """Set 0 and x as the JAX script makes them (:273-278), on the card:
    (packed_t, scales, x)."""
    rng = np.random.default_rng(SEED)
    w = (rng.normal(size=(n_out, n_in)) * WEIGHT_SCALE).astype(np.float32)
    packed_t, scales = quant.quantize_int4(w, G)
    x = torch.from_numpy(rng.normal(size=(b, n_in)).astype(np.float32)).to(torch.bfloat16)
    return (torch.from_numpy(packed_t).cuda(), torch.from_numpy(scales).cuda(), x.cuda())


def make_weights(n_in: int, n_out: int, count: int):
    """``count`` more (packed_t, scales) on the card beside the JAX script's
    set 0: seeded normals times 0.02, quantized on the card."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = []
    for _ in range(count):
        w = torch.randn(n_out, n_in, generator=g, device="cuda") * WEIGHT_SCALE
        out.append(quant._quantize_int4_device(w, G))
    return out


def check(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """The largest absolute error; raises past ``tol``."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name}: {tuple(got.shape)}/{got.dtype}, expected "
                           f"{tuple(want.shape)}/{want.dtype}, or not finite")
    err = float((got.float() - want.float()).abs().max())
    if err > tol:
        raise RuntimeError(f"{name}: max abs err {err} > tolerance {tol}")
    return err


def kernel_times(fn, calls: int = PROFILED_CALLS) -> tuple[dict, int, int]:
    """(device us of each kernel ``fn`` launches, by name: the decode kernel
    ``qgemv`` and any other, the mean over its records; the calls made; the
    ``qgemv`` records the profiler kept), from one
    ``benchlib.device_profile`` session of ``calls`` calls.  The padded
    window kept every record of an isolated run, but in ``chip_smoke.py``'s
    full run one session kept 8 of 20 (ROADMAP C.10): the mean is over the
    records kept, and their count goes with it.  Empty where none was kept."""
    out, count = {}, {}
    torch.cuda.synchronize()
    with benchlib.device_profile() as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0) or 0
        if us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            name = "qgemv" if "qgemv" in ev.key else ev.key[:40]
            out[name] = out.get(name, 0.0) + us
            count[name] = count.get(name, 0) + ev.count
    return {k: v / count[k] for k, v in out.items()}, calls, count.get("qgemv", 0)


def rotating(fn, items):
    """A call of ``fn(*item)`` on the next of ``items`` each time."""
    state = {"i": 0}

    def call():
        item = items[state["i"] % len(items)]
        state["i"] += 1
        return fn(*item)

    return call


def run(b: int, n_in: int, n_out: int) -> dict:
    """Check and time every variant at one shape.  ``launches``: the K16
    and K5 launches this made (a check, a timing, and for ucorr and ugdot a
    timing of the raw kernel alone)."""
    packed_t, scales, x = jax_inputs(b, n_in, n_out)
    sets = weight_sets(n_in, n_out)
    weights = [(packed_t, scales)] + make_weights(n_in, n_out, sets - 1)
    bound, bound_by = bound_ms(b, n_in, n_out)
    cores = cuda_core_ms(b, n_in, n_out)
    with torch.no_grad():
        dense = quant.dequantize_int4(packed_t, scales, G, torch.bfloat16)  # W (out, in)
        oracle = (x.float() @ dense.float().T).to(torch.bfloat16)
    print(f"--- B={b} {n_in}->{n_out}: bound {bound * 1e3:.2f} us ({bound_by}); "
          f"{cores * 1e3:.2f} us on the CUDA cores; {sets} weight sets "
          f"({sets * weight_bytes(n_in, n_out) / 1e6:.1f} MB) rotated", flush=True)
    timed_calls = benchlib.calls_per_timing(REPS, ROUNDS)
    launches = {"int4_variant": 0, "int4_matmul": 0}

    def timed(fn, ws=weights) -> tuple[float, float]:
        return benchlib.time_ms(rotating(fn, ws), REPS, ROUNDS)

    out = {"shape": [b, n_in, n_out], "group": G, "bound_ms": bound, "bound_by": bound_by,
           "cuda_core_ms": cores, "weight_sets": sets, "variants": {}}
    with torch.no_grad():
        # the codes' bytes as floats (their values unused): torch's float sum
        floor_ms, floor_call = timed(lambda p, s: (p.view(torch.float32).sum(), s.sum()))
        out["floor_ms"] = floor_ms
        print(f"  read floor  {floor_ms * 1e3:9.2f} device us  (codes and scales; "
              f"wall {floor_call * 1e3:.1f} us)", flush=True)
        k5_ref = quant_cuda.int4_variant_reference(x, packed_t, scales, G, "f32mul")
        k5 = quant_cuda.int4_matmul(x, packed_t, scales, G)
        k5_err = check("K5", k5, k5_ref, tolerance(k5_ref))
        out["k5_ms"], k5_call = timed(lambda p, s: quant_cuda.int4_matmul(x, p, s, G))
        launches["int4_matmul"] += 1 + timed_calls
        denses = [(quant.dequantize_int4(p, s, G, torch.bfloat16),) for p, s in weights]
        out["library_ms"], lib_call = timed(lambda w: torch.nn.functional.linear(x, w), denses)
        del denses
        print(f"  K5          {out['k5_ms'] * 1e3:9.2f} device us  {bound / out['k5_ms']:6.1%} "
              f"of bound  err {k5_err:.2e}  (wall {k5_call * 1e3:.1f} us)", flush=True)
        print(f"  F.linear    {out['library_ms'] * 1e3:9.2f} device us  "
              f"{bound / out['library_ms']:6.1%} of bound  (dequantized bf16 W, 4x the bytes; "
              f"wall {lib_call * 1e3:.1f} us)", flush=True)
        for name in quant_cuda.INT4_VARIANTS:
            plan = quant_cuda.int4_variant_plan(b, n_in, n_out, name)
            ref = quant_cuda.int4_variant_reference(x, packed_t, scales, G, name)
            raw = quant_cuda.int4_variant_matmul(x, packed_t, scales, G, name)
            err = check(f"{name} raw", raw, ref, tolerance(ref))
            fin = quant_cuda.finish_int4_variant(raw, x, scales, G, name)
            oracle_err = check(f"{name} against the oracle", fin, oracle, oracle_bound(oracle))
            if name == "f32mul" and b <= 16 and not torch.equal(raw, k5):
                raise RuntimeError("f32mul differs from K5 at the decode rows")
            ms, call = timed(lambda p, s: quant_cuda.int4_variant(x, p, s, G, name))
            launches["int4_variant"] += 1 + timed_calls
            kernel_ms = ms
            if name in quant_cuda.UNSIGNED_VARIANTS:
                kernel_ms = timed(
                    lambda p, s: quant_cuda.int4_variant_matmul(x, p, s, G, name))[0]
                launches["int4_variant"] += timed_calls
            plain_ms = timed(
                lambda p, s: quant_cuda.finish_int4_variant(
                    quant_cuda.int4_variant_reference(x, p, s, G, name), x, s, G, name))[0]
            if name == "f32mul":  # K5's kernel under the profiler
                out["k5_kernel_us"], made, kept = kernel_times(rotating(
                    lambda p, s: quant_cuda.int4_variant_matmul(x, p, s, G, name), weights))
                out["k5_kernel_records"] = kept
                launches["int4_variant"] += made
                print("  K5's kernel under the profiler, device us a call: " + (", ".join(
                    f"{k} {v:.2f}" for k, v in out["k5_kernel_us"].items()) or "not measured")
                    + f" ({kept} of {made} qgemv records kept)", flush=True)
            out["variants"][name] = {
                "ms": ms, "call_ms": call, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "max_abs_err": err, "oracle_err": oracle_err,
                "oracle_share": oracle_err / oracle_bound(oracle),
                "share_of_bound": bound / ms, "plan": plan}
            print(f"  {name:9s}   {ms * 1e3:9.2f} device us  {bound / ms:6.1%} of bound  "
                  f"kernel {kernel_ms * 1e3:.2f}  plain {plain_ms * 1e3:.2f}  err {err:.2e}  "
                  f"oracle {oracle_err:.3e} ({oracle_err / oracle_bound(oracle):.3f} of its "
                  f"bound)  "
                  f"plan {plan}  (wall {call * 1e3:.1f} us)", flush=True)
    best = min(out["variants"], key=lambda k: out["variants"][k]["ms"])
    out["best"] = best
    out["launches"] = launches
    print(f"  best {best}: {out['variants'][best]['ms'] * 1e3:.2f} us, "
          f"{out['variants'][best]['ms'] / out['k5_ms']:.2f}x K5, "
          f"{out['variants'][best]['ms'] / floor_ms:.2f}x the read floor", flush=True)
    return out


def main() -> list[dict]:
    benchlib.require_card("exp_int4_dequant_variants")
    print(f"device: {benchlib.card_line()}, torch {torch.__version__}", flush=True)
    return [run(*shape) for shape in SHAPES]


if __name__ == "__main__":
    main()
