"""K17-K19 (splash attention's causal flash-attention kernels), this tree's
against another tree's, on the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.compare_attention --old DIR``.

``DIR`` holds another tree's ``kernels/csrc`` (for example the parent
commit's, unpacked with ``git archive``).  Each tree's
``flash_attention.cu`` is built into a library of its own (nvcc, in
parallel; ptxas's registers and spills printed) and called through its C
interface (``smft_flash_attn_fwd``, ``smft_flash_attn_dq``,
``smft_flash_attn_dkv``) with ctypes.  In order:

  1. each library in bf16 and f32 against the plain versions
     (``ops/attention.py``; K18 and K19 fed the plain forward's lse and di)
     at ``CHECKS``: ``chip_smoke.py``'s ``ATTN_SHAPES`` and ``RAGGED`` (t =
     1, t under one 128-row tile, one tile plus a row, t ragged against the
     64-row tiles and steps, and items under, one past and over one wave of
     132 CTAs).  The bounds are ``chip_smoke.py``'s: each output within two bf16
     ulps (f32: 1e-5) of its scale and each 64-row block within
     ``ATTN_BLOCK_RTOL``, lse within 1e-5 of its scale; where the exact
     output is 0 (t = 1: dq and dk, whose ds = p (dp - di) is 0 with o = v)
     within ``ZERO_ATOL`` instead.  The outputs start as NaN, so a row that
     no CTA wrote fails; a repeated call gives the same bits; each
     library's plan of each persistent bf16 call (K17-K19 in this tree) is
     the mirror's (``attention_cuda.schedule_plan``);
  2. device ms a call (``utils/benchlib.time_ms``) of K17, K18 and K19 in
     bf16 at ``SHAPES`` (the 1.1B training micro-batch, then the attention
     bench's), the libraries in turns (old, new, new, old: each one's time
     the mean of its two), beside SDPA (``scaled_dot_product_attention(
     is_causal=True)``: its forward for K17, its backward, dq, dk and dv in
     one call, for K18 + K19) and the bound
     (``ops/attention.attention_cost`` over 3.35 TB/s or 989 TFLOP/s).

Nothing is caught: a build, launch or check that fails ends the script.
It needs a CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from sparse_matrix_fine_tuning_torch.kernels import attention_cuda
from sparse_matrix_fine_tuning_torch.kernels import build as kbuild
from sparse_matrix_fine_tuning_torch.ops import attention as attn_ref
from sparse_matrix_fine_tuning_torch.ops.attention import attention_cost
from sparse_matrix_fine_tuning_torch.scripts.compare_monarch_bwd import in_turns, ptxas_lines
from sparse_matrix_fine_tuning_torch.utils import benchlib
from sparse_matrix_fine_tuning_torch.utils.testing import ATTN_BLOCK_RTOL, attention_block_error

SOURCE = "flash_attention.cu"
OUT = kbuild.BUILD_ROOT / "compare_attention"
KERNELS = ("splash_fwd", "splash_dq", "splash_dkv")
# (label, (b, t, heads, head_dim)) timed: the 1.1B training micro-batch
# (bs 4 x seq 512, 32 heads of 64), then the attention bench's shape
# (scripts/bench_attention.py:17)
SHAPES = [("1.1B", (4, 512, 32, 64)), ("bench", (4, 1024, 32, 128))]
# chip_smoke.py's ATTN_SHAPES, checked here too
SMOKE_SHAPES = [(4, 1024, 32, 128), (4, 512, 32, 64), (2, 200, 4, 64), (1, 1000, 2, 128),
                (3, 129, 5, 64), (2, 65, 3, 64)]
# Ragged against the persistent kernels' 128-row tiles, K17's 64-row kv
# tiles at head_dim 128, K18's 64-row kv tiles and K19's 64-row steps, at
# both head_dims: t = 1; t under one tile; one tile plus a row (8 items:
# under a wave); 133 items (a wave of 132 CTAs and one more, t = 6 tiles +
# 65 rows, 13 steps + 1 row); 198 items (t = 5 tiles + 60 rows); t of one
# 64-row step; 133 of K18's units (pairs of q tiles; t = one tile + a row)
RAGGED = [(1, 1, 2, 64), (1, 1, 2, 128), (2, 100, 3, 64), (2, 100, 3, 128), (1, 129, 4, 64),
          (1, 833, 19, 64), (3, 700, 11, 128), (2, 64, 3, 128), (7, 129, 19, 64)]
CHECKS = SMOKE_SHAPES + RAGGED
ZERO_ATOL = 1e-4  # an output whose exact value is 0: both sides keep an fp32 residue
REPS, ROUNDS = 20, 3


def build_lib(csrc: Path, name: str, out_root: Path = OUT) -> ctypes.CDLL:
    """``csrc``'s ``flash_attention.cu`` in a shared library of its own."""
    out = out_root / name.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    nvcc = str(kbuild._cuda_home() / "bin" / "nvcc")
    cmd = [nvcc, kbuild.GENCODE, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-shared",
           "-Xptxas", "-v", "-I", str(csrc), "-o", str(out / "lib.so"), str(csrc / SOURCE)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"build of {csrc / SOURCE} failed:\n{proc.stdout}")
    print(f"{name}: built {csrc / SOURCE}; ptxas:\n  "
          + "\n  ".join(ptxas_lines(proc.stdout)), flush=True)
    for line in proc.stdout.splitlines():
        if "C7512" in line or "warning" in line.lower():
            print(f"{name}: {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    ptr, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.smft_flash_attn_fwd.argtypes = [c_int, c_int] + [ptr] * 5 + [i64] * 4 + [ptr]
    lib.smft_flash_attn_dq.argtypes = [c_int, c_int] + [ptr] * 7 + [i64] * 4 + [ptr]
    lib.smft_flash_attn_dkv.argtypes = [c_int, c_int] + [ptr] * 8 + [i64] * 4 + [ptr]
    if hasattr(lib, "smft_flash_attn_plan"):
        lib.smft_flash_attn_plan.argtypes = [c_int, c_int] + [i64] * 4 + [ptr]
    return lib


CUDA_ERROR_INVALID_VALUE = 1  # what a plan returns for a kernel that is not persistent


def plan_of(lib, kernel: str, shape) -> dict | None:
    """The library's plan of a persistent bf16 call (``attention_cuda.PLAN_KEYS``),
    None where it has none: a library without ``smft_flash_attn_plan``, or
    one whose plan refuses the kernel (a one-CTA-a-tile design)."""
    if not hasattr(lib, "smft_flash_attn_plan"):
        return None
    out = (ctypes.c_int64 * len(attention_cuda.PLAN_KEYS))()
    err = lib.smft_flash_attn_plan(attention_cuda._WHICH[kernel], torch.cuda.current_device(),
                                   *shape, ctypes.cast(out, ctypes.c_void_p))
    if err == CUDA_ERROR_INVALID_VALUE and kernel == "splash_dq":
        return None
    if err:
        raise RuntimeError(f"smft_flash_attn_plan returned {err}")
    return dict(zip(attention_cuda.PLAN_KEYS, list(out)))


def inputs(shape, dtype: torch.dtype, g: torch.Generator):
    """(q, k, v, dout), N(0, 1), q scaled by 1/sqrt(head_dim) as the model
    does, then the plain forward's lse and di (K18's and K19's inputs)."""
    q, k, v, dout = (torch.randn(shape, generator=g, device="cuda") for _ in range(4))
    q = q / shape[-1] ** 0.5
    q, k, v, dout = (x.to(dtype) for x in (q, k, v, dout))
    o, lse = attn_ref.causal_attention_reference(q, k, v)
    return q, k, v, dout, lse, attn_ref.attention_di(o, dout)


def call_of(lib, kernel: str, q, k, v, dout, lse, di):
    """A callable that runs the library's ``kernel`` into outputs that start
    as NaN and returns them (a tuple)."""
    b, t, h, d = q.shape
    dtype = 0 if q.dtype == torch.float32 else 1
    dev = q.device.index or 0
    stream = torch.cuda.current_stream().cuda_stream
    nan = float("nan")
    if kernel == "splash_fwd":
        outs = (torch.full_like(q, nan), torch.full((b, h, t), nan, device=q.device))
        args = [q, k, v, outs[0], outs[1]]
        fn = lib.smft_flash_attn_fwd
    elif kernel == "splash_dq":
        outs = (torch.full_like(q, nan),)
        args = [q, k, v, dout, lse, di, outs[0]]
        fn = lib.smft_flash_attn_dq
    else:
        outs = (torch.full_like(q, nan), torch.full_like(q, nan))
        args = [q, k, v, dout, lse, di, *outs]
        fn = lib.smft_flash_attn_dkv
    ptrs = [x.data_ptr() for x in args]

    def call():
        err = fn(dtype, dev, *ptrs, b, t, h, d, stream)
        if err:
            raise RuntimeError(f"{kernel} returned {err}")
        return outs
    call.tensors = args  # the pointers stay valid while call lives
    return call


def plain_of(kernel: str, q, k, v, dout, lse, di) -> tuple:
    if kernel == "splash_fwd":
        return attn_ref.causal_attention_reference(q, k, v)
    if kernel == "splash_dq":
        return (attn_ref.attention_dq_reference(q, k, v, dout, lse, di),)
    return attn_ref.attention_dkv_reference(q, k, v, dout, lse, di)


def check_outputs(got: tuple, ref: tuple, dtype: torch.dtype) -> dict:
    """``chip_smoke.attention_check``'s bounds (see the module's doc), with
    ``ZERO_ATOL`` where the exact output is 0.  Returns the largest abs
    error, block error and share of a bound; raises nothing."""
    err = share = block = 0.0
    ok = True
    for a, b in zip(got, ref):
        e = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        ok &= a.shape == b.shape and a.dtype == b.dtype and bool(torch.isfinite(a).all())
        if b.dim() == 3:  # lse, fp32
            tol = 1e-5 * scale
        elif scale <= ZERO_ATOL:
            tol = ZERO_ATOL
        else:
            tol = scale * (1e-5 if dtype == torch.float32 else 2.0 ** -6)
            blk = attention_block_error(a, b)
            ok &= blk <= ATTN_BLOCK_RTOL[dtype]
            block, share = max(block, blk), max(share, blk / ATTN_BLOCK_RTOL[dtype])
        ok &= e <= tol
        err, share = max(err, e), max(share, e / tol)
    return {"err": err, "block": block, "share": share, "ok": ok}


def check_lib(name: str, lib, g: torch.Generator) -> dict:
    worst = {}
    with torch.no_grad():
        for shape in CHECKS:
            for dtype in (torch.bfloat16, torch.float32):
                xs = inputs(shape, dtype, g)
                for kernel in KERNELS:
                    call = call_of(lib, kernel, *xs)
                    got = tuple(x.clone() for x in call())
                    ref = plain_of(kernel, *xs)
                    torch.cuda.synchronize()
                    c = check_outputs(got, ref, dtype)
                    if not c["ok"]:
                        raise RuntimeError(f"{name} {kernel} {shape} {dtype}: {c}")
                    again = call()
                    if not all(torch.equal(a, b) for a, b in zip(again, got)):
                        raise RuntimeError(f"{name} {kernel} {shape} {dtype}: a repeated call "
                                           "gave other bits")
                    key = f"{kernel} {'bf16' if dtype == torch.bfloat16 else 'f32'}"
                    worst[key] = max(worst.get(key, 0.0), c["share"])
                    if dtype == torch.bfloat16:
                        plan = plan_of(lib, kernel, shape)
                        if plan is None and name == "new":
                            raise RuntimeError(f"{name} {kernel} {shape}: no plan")
                        if plan is not None:
                            mirror = attention_cuda.schedule_plan(kernel, *shape, plan["sms"],
                                                                  plan["per_sm"])
                            if plan != mirror:
                                raise RuntimeError(f"{name} {kernel} {shape}: plan {plan}, "
                                                   f"the mirror's {mirror}")
                del xs
        print(f"{name}: K17-K19 within their bounds at {len(CHECKS)} shapes, bf16 and f32, "
              f"every row written, repeats bit for bit, plans the mirror's; largest share of a "
              f"bound {worst}", flush=True)
    return worst


def sdpa_calls(q, k, v, dout):
    """SDPA's forward and its backward (dq, dk, dv in one call) on (b, h, t,
    d) views, q already scaled."""
    import torch.nn.functional as F

    qh, kh, vh = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=1.0)
    douth = dout.transpose(1, 2)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=1.0)

    def bwd():
        return torch.autograd.grad(out, (qh, kh, vh), douth, retain_graph=True)
    return fwd, bwd


def time_shapes(libs: dict, g: torch.Generator) -> dict:
    out = {}
    for label, shape in SHAPES:
        xs = inputs(shape, torch.bfloat16, g)
        fwd, bwd = sdpa_calls(*xs[:4])
        sdpa = {"fwd": benchlib.time_ms(fwd, REPS, ROUNDS)[0],
                "bwd": benchlib.time_ms(bwd, REPS, ROUNDS)[0]}
        rec = {"sdpa_fwd": sdpa["fwd"], "sdpa_bwd": sdpa["bwd"]}
        with torch.no_grad():
            for kernel in KERNELS:
                times = in_turns({name: call_of(lib, kernel, *xs) for name, lib in libs.items()})
                bound, by = benchlib.roofline_ms(*attention_cost(kernel, shape, torch.bfloat16),
                                                 torch.bfloat16)
                plan = plan_of(libs["new"], kernel, shape)
                print(f"{label} {shape} {kernel}: ms " + ", ".join(
                    f"{n} {ms:.5f} ({100 * bound / ms:.1f}% of the bound)"
                    for n, ms in times.items())
                    + f"; bound {bound:.5f} ({by}); new/old {times['new'] / times['old']:.3f}"
                    + (f"; plan {plan}" if plan else ""), flush=True)
                rec[kernel] = {**times, "bound": bound, "bound_by": by, "plan": plan}
        for name in libs:
            bwd_ms = rec["splash_dq"][name] + rec["splash_dkv"][name]
            print(f"{label} {shape} {name}: K17 {rec['splash_fwd'][name]:.5f} ms against SDPA's "
                  f"forward {sdpa['fwd']:.5f} ({rec['splash_fwd'][name] / sdpa['fwd']:.3f}x); "
                  f"K18 + K19 {bwd_ms:.5f} ms against SDPA's backward {sdpa['bwd']:.5f} "
                  f"({bwd_ms / sdpa['bwd']:.3f}x)", flush=True)
        out[label] = rec
        del xs, fwd, bwd
    return out


def run(libs: dict) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    checks = {name: check_lib(name, lib, g) for name, lib in libs.items()}
    return {"checks": checks, "times": time_shapes(libs, g)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="another tree's kernels/csrc (flash_attention.cu)")
    args = ap.parse_args(argv)
    benchlib.require_card("compare_attention")
    print(f"device: {benchlib.card_line()}, torch {torch.__version__}", flush=True)
    with ThreadPoolExecutor(2) as ex:
        old, new = ex.map(build_lib, (args.old, kbuild.CSRC), ("old", "new"))
    return run({"old": old, "new": new})


if __name__ == "__main__":
    main()
