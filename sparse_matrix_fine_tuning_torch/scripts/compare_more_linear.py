"""K9 and K10 (the fused dense + Monarch linear's forward and input
gradient), this tree's kernels against another tree's, on the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.compare_more_linear --old DIR``.

``DIR`` holds another tree's ``kernels/csrc`` (for example the parent
commit's, unpacked with ``git archive``).  Each tree's ``more_linear.cu``
is built into a library of its own (nvcc, in parallel; ptxas's registers
and spills printed) and called through its C interface,
``smft_more_linear``, with ctypes.  In order:

  1. each library against the plain versions
     (``more_linear.more_linear_fwd_reference``, ``more_linear_dx_reference``)
     at ragged shapes (``CASES``: widths off every tile, P no multiple of 8,
     K != L, J = K Q of 8 to 64, the factors off 16 bytes) and at
     ``bench_more_linear``'s three shapes, float32 and bfloat16, K9 and K10:
     1e-5 (f32) or 2**-6 (bf16) of the output's scale, as ``chip_smoke.py``
     holds them; a bf16 call repeated gives the same bits;
  2. device ms a call (``utils/benchlib.time_ms``) of K9 and K10 at the three
     bench shapes, bf16, the libraries in turns (old, new, new, old: each
     one's time the mean of its two), beside the bound (``chip_smoke.cost``:
     bytes over 3.35 TB/s or operations over 989 TFLOP/s, the larger) and one
     PyTorch call on the merged dense matrix Wd + M (``F.linear`` for K9,
     ``torch.matmul`` for K10), with this tree's plan of each call;
  3. each library's kernel launches a call and their device us, by the
     profiler (the old design's row-summary pre-pass beside its GEMM);
  4. the fused, hybrid and plain steps of ``bench_more_linear`` (device and
     wall us a step) at the three shapes, through this tree's kernels.

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
import torch.nn.functional as F

from sparse_matrix_fine_tuning_torch.kernels import build as kbuild
from sparse_matrix_fine_tuning_torch.kernels.experimental import more_linear as ml
from sparse_matrix_fine_tuning_torch.ops.monarch import monarch_dense_equivalent
from sparse_matrix_fine_tuning_torch.scripts import bench_more_linear as bench
from sparse_matrix_fine_tuning_torch.scripts.compare_monarch_bwd import in_turns, ptxas_lines
from sparse_matrix_fine_tuning_torch.utils import benchlib

# (rows, n, m, K, Q, L, offset of w1 and w2 in elements), R = K Q / L:
# tests/test_torch_kernels_cuda.py's MORE_CASES (P = 64, 32, 24, 16 and
# 256: a 64-wide k step straddling factor blocks; m = 24 under one tile; 9
# rows; J = 64), the 128-row tile plans at J = 16, 32 and 64 ragged in M
# and N, P no multiple of 8 (n = 40), K =
# 3 with L = 2 (J = 12, padded to 16), and factors off 16 bytes
CASES = [(256, 256, 384, 4, 4, 4, 0), (200, 128, 96, 4, 8, 4, 0), (65, 96, 192, 4, 4, 4, 0),
         (9, 64, 24, 4, 2, 2, 0), (300, 1024, 1024, 4, 16, 4, 0), (2664, 1800, 1800, 4, 4, 4, 0),
         (2664, 1800, 1800, 4, 8, 4, 0), (2664, 1800, 1800, 4, 16, 4, 0),
         (2664, 1024, 2048, 4, 16, 4, 0),
         (33, 40, 48, 4, 4, 4, 0), (17, 48, 64, 3, 4, 2, 0), (130, 512, 264, 4, 8, 4, 1)]
# the identity checks' (n, m), x = I (n rows): the 64 x 128 plan, and the
# 128 x 256 one (16 x 16 tiles)
IDENTITY = [(256, 384), (2048, 4096)]
NAMES = ("more_linear_fwd", "more_linear_dx")  # K9, K10
LABELS = ("qkv", "micro", "gate")  # bench_more_linear.SHAPES, as chip_smoke.py names them
REPS, ROUNDS = 20, 3
OUT = kbuild.BUILD_ROOT / "compare_more_linear"
PLAN_KEYS = ml.PLAN_KEYS


def build_lib(csrc: Path, name: str, source: str = "more_linear.cu") -> ctypes.CDLL:
    """``csrc``'s ``source`` in a shared library of its own."""
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    nvcc = str(kbuild._cuda_home() / "bin" / "nvcc")
    cmd = [nvcc, kbuild.GENCODE, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-shared",
           "-Xptxas", "-v", "-I", str(csrc), "-o", str(out / "lib.so"), str(csrc / source)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"build of {csrc / source} failed:\n{proc.stdout}")
    print(f"{name}: built {csrc / source}; ptxas:\n  "
          + "\n  ".join(ptxas_lines(proc.stdout)), flush=True)
    for line in proc.stdout.splitlines():
        if "C7512" in line or "warning" in line.lower():
            print(f"{name}: {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    lib.smft_more_linear.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    if hasattr(lib, "smft_more_linear_plan"):
        lib.smft_more_linear_plan.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p])
    return lib


def plan_of(lib, dx: bool, m_rows: int, n: int, m: int, J: int) -> dict | None:
    """The library's plan of a bf16 call (``PLAN_KEYS``), None where it has
    no plan function (the old design)."""
    if not hasattr(lib, "smft_more_linear_plan"):
        return None
    out = (ctypes.c_int64 * len(PLAN_KEYS))()
    err = lib.smft_more_linear_plan(0, int(dx), m_rows, n, m, J, ctypes.cast(out, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"smft_more_linear_plan returned {err}")
    return dict(zip(PLAN_KEYS, list(out)))


def offset_view(t: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``off`` elements into its
    buffer (off 16 bytes for off > 0), as a sliced view would."""
    buf = torch.empty(t.numel() + off, device=t.device, dtype=t.dtype)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


def call_of(lib, dx: bool, a, wd, w1, w2):
    """A callable that runs the library's K9 (a = x) or K10 (a = dout) into a
    preallocated output and returns it."""
    m, n = wd.shape
    K, Q, P = w1.shape
    L, S, R = w2.shape
    m_rows = a.shape[0]
    out = torch.empty(m_rows, n if dx else m, device=a.device, dtype=a.dtype)
    work = torch.empty(max(m_rows * K * Q, 1), device=a.device)  # the old design's summaries
    args = [0 if a.dtype == torch.float32 else 1, a.device.index or 0, int(dx), a.data_ptr(),
            wd.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(), work.data_ptr(),
            m_rows, n, m, K, Q, P, L, S, R]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.smft_more_linear(*args, stream)
        if err:
            raise RuntimeError(f"smft_more_linear returned {err}")
        return out
    call.tensors = (a, wd, w1, w2, work)  # args' pointers stay valid while call lives
    return call


def tolerance(ref: torch.Tensor, dtype: torch.dtype) -> float:
    """f32: 1e-5 of the output's scale (sums in another order); bf16: 2**-6
    (the row summary may round one ulp apart, and the output rounds once)."""
    return float(ref.float().abs().max()) * (1e-5 if dtype == torch.float32 else 2.0 ** -6)


def reference(dx: bool, a, wd, w1, w2) -> torch.Tensor:
    fn = ml.more_linear_dx_reference if dx else ml.more_linear_fwd_reference
    return fn(a, wd, w1, w2)


def check(name: str, call, dx: bool, a, wd, w1, w2, what: str) -> torch.Tensor:
    want = reference(dx, a, wd, w1, w2)
    got = call().clone()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = tolerance(want, a.dtype)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()) or err > tol:
        raise RuntimeError(f"{name}: {NAMES[dx]} {what}: max abs err {err} > {tol}")
    if a.dtype == torch.bfloat16 and not torch.equal(call(), got):
        raise RuntimeError(f"{name}: {NAMES[dx]} {what}: a repeated call gave other bits")
    return got


def inputs(m_rows: int, n: int, m: int, K: int, Q: int, L: int, dtype, g: torch.Generator,
           off: int = 0):
    """x (M, n), dout (M, m), dense_w (m, n), w1 (K, Q, P), w2 (L, S, R),
    seeded, scaled as the tests' (w1 and w2 ``off`` elements into their
    buffers)."""
    R = K * Q // L

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    x, dout = randn(m_rows, n), randn(m_rows, m)
    wd = randn(m, n, scale=n ** -0.5)
    w1 = offset_view(randn(K, Q, n // K, scale=(n // K) ** -0.5), off)
    w2 = offset_view(randn(L, m // L, R, scale=R ** -0.5), off)
    return x, dout, wd, w1, w2


def bench_inputs(shape, dtype=torch.bfloat16):
    """``bench_more_linear.make_inputs`` at one of its shapes, and a dout."""
    _, rows, n, m, nb, r = shape
    x, wd, w1, w2 = bench.make_inputs(rows, n, m, nb, r, dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    return x, torch.randn(rows, m, generator=g, device="cuda").to(dtype), wd, w1, w2


def identity_checks(name: str, lib, g: torch.Generator) -> None:
    """Each operand layout alone, bf16, at a 64 x 128 and a 128 x 256 tile
    plan: K9 with x = I and w2 = 0 gives Wd^T, K10 with dout = I and w1 = 0
    gives Wd, bit for bit (one product a sum); with Wd = 0 each gives the
    Monarch term alone, held to the plain version."""
    with torch.no_grad():
        for width, out in IDENTITY:
            x, dout, wd, w1, w2 = inputs(width, width, out, 4, 4, 4, torch.bfloat16, g)
            eye_n = torch.eye(width, device="cuda", dtype=torch.bfloat16)
            got = call_of(lib, False, eye_n, wd, w1, torch.zeros_like(w2))()
            torch.cuda.synchronize()
            if not torch.equal(got, wd.T):
                raise RuntimeError(f"{name}: K9 at x = I ({width} -> {out}) is not Wd^T: "
                                   f"{int((got != wd.T).sum())} entries differ")
            eye_m = torch.eye(out, device="cuda", dtype=torch.bfloat16)
            got = call_of(lib, True, eye_m, wd, torch.zeros_like(w1), w2)()
            torch.cuda.synchronize()
            if not torch.equal(got, wd):
                raise RuntimeError(f"{name}: K10 at dout = I ({width} -> {out}) is not Wd: "
                                   f"{int((got != wd).sum())} entries differ")
            zero = torch.zeros_like(wd)
            check(name, call_of(lib, False, eye_n, zero, w1, w2), False, eye_n, zero, w1, w2,
                  f"the Monarch term alone at x = I ({width} -> {out})")
            check(name, call_of(lib, True, dout, zero, w1, w2), True, dout, zero, w1, w2,
                  f"the Monarch term alone ({width} -> {out})")
        print(f"{name}: identity checks exact, Monarch terms within tolerance", flush=True)


def check_lib(name: str, lib, g: torch.Generator) -> None:
    identity_checks(name, lib, g)
    with torch.no_grad():
        for m_rows, n, m, K, Q, L, off in CASES:
            for dtype in (torch.float32, torch.bfloat16):
                x, dout, wd, w1, w2 = inputs(m_rows, n, m, K, Q, L, dtype, g, off)
                for dx, a in ((False, x), (True, dout)):
                    check(name, call_of(lib, dx, a, wd, w1, w2), dx, a, wd, w1, w2,
                          f"{(m_rows, n, m, K, Q, L)} off {off} {dtype}")
        print(f"{name}: ragged cases within tolerance (f32, bf16; K9, K10)", flush=True)
        for shape in bench.SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                x, dout, wd, w1, w2 = bench_inputs(shape, dtype)
                for dx, a in ((False, x), (True, dout)):
                    check(name, call_of(lib, dx, a, wd, w1, w2), dx, a, wd, w1, w2,
                          f"{shape[0]} {dtype}")
        print(f"{name}: the three bench shapes within tolerance (f32, bf16; K9, K10)", flush=True)


def cost(name: str, m_rows: int, n: int, m: int, r: int) -> tuple[int, int]:
    """(bytes, operations) of a bf16 call, as ``chip_smoke.cost``: x (or
    dout), the dense weight and the factors (r (n + m) elements) read once,
    the output written once; the dense product's and the two factors'
    multiply-adds, two operations each."""
    n_in, n_out = (m, n) if name == "more_linear_dx" else (n, m)
    factors = r * (n_in + n_out)
    return (m_rows * (n_in + n_out) + n_in * n_out + factors) * 2, \
        2 * m_rows * (n_in * n_out + factors)


def time_shapes(libs: dict) -> dict:
    out = {}
    with torch.no_grad():
        for label, shape in zip(LABELS, bench.SHAPES):
            _, rows, n, m, nb, r = shape
            x, dout, wd, w1, w2 = bench_inputs(shape)
            merged = (wd.float() + monarch_dense_equivalent(w1.float(), w2.float())).to(
                torch.bfloat16)
            library = {"more_linear_fwd": lambda: F.linear(x, merged),
                       "more_linear_dx": lambda: torch.matmul(dout, merged)}
            for dx, a in ((False, x), (True, dout)):
                name = NAMES[dx]
                calls = {lib_name: call_of(lib, dx, a, wd, w1, w2)
                         for lib_name, lib in libs.items()}
                for lib_name, call in calls.items():
                    check(lib_name, call, dx, a, wd, w1, w2, label)
                times = in_turns(calls)
                lib_ms = benchlib.time_ms(library[name], REPS, ROUNDS)[0]
                bound, by = benchlib.roofline_ms(*cost(name, rows, n, m, r), torch.bfloat16)
                plan = plan_of(libs["new"], dx, rows, n, m, nb * r)
                print(f"{label} {name}: ms " + ", ".join(f"{k} {v:.5f}" for k, v in times.items())
                      + f"; library {lib_ms:.5f}; bound {bound:.5f} ({by}); share of the bound "
                      + ", ".join(f"{k} {bound / v:.3f}" for k, v in times.items())
                      + f"; plan {plan}", flush=True)
                out[f"{label} {name}"] = {**times, "library": lib_ms, "bound": bound,
                                          "plan": plan}
            del x, dout, wd, w1, w2, merged
            torch.cuda.empty_cache()
    return out


def count_launches(libs: dict) -> dict:
    """Kernels a call launches and their device us, by the profiler, at the
    three bench shapes."""
    out = {}
    with torch.no_grad():
        for label, shape in zip(LABELS, bench.SHAPES):
            x, dout, wd, w1, w2 = bench_inputs(shape)
            for lib_name, lib in libs.items():
                for dx, a in ((False, x), (True, dout)):
                    call = call_of(lib, dx, a, wd, w1, w2)
                    call()
                    torch.cuda.synchronize()
                    with benchlib.device_profile() as prof:
                        call()
                        torch.cuda.synchronize()
                    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                               if e.device_type == torch.autograd.DeviceType.CUDA]
                    out[f"{label} {lib_name} {NAMES[dx]}"] = kernels
                    print(f"launches {label} {lib_name} {NAMES[dx]}: {len(kernels)} ("
                          + ", ".join(f"{k[:40]} {us:.2f} us" for k, us in kernels) + ")",
                          flush=True)
    return out


def run(libs: dict) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, lib in libs.items():
        check_lib(name, lib, g)
    out = {"calls": time_shapes(libs), "launches": count_launches(libs)}
    out["bench"] = [bench.run(*shape) for shape in bench.SHAPES]
    for label, step in zip(LABELS, out["bench"]):
        print(f"bench {label}: device us a step fused {step['fused_us']:.1f}, hybrid "
              f"{step['hybrid_us']:.1f}, plain {step['plain_us']:.1f}", flush=True)
    return out


def main() -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="another tree's kernels/csrc (more_linear.cu)")
    args = ap.parse_args()
    benchlib.require_card("compare_more_linear")
    print(f"device: {benchlib.card_line()}, torch {torch.__version__}", flush=True)
    with ThreadPoolExecutor(2) as ex:
        old, new = ex.map(build_lib, (args.old, kbuild.CSRC), ("old", "new"))
    return run({"old": old, "new": new})


if __name__ == "__main__":
    main()
