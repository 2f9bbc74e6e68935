"""K15 (the tiled bf16 matmul), this tree's kernel against another tree's,
on the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.compare_tiled_matmul --old DIR``.

``DIR`` holds another tree's ``kernels/csrc`` (for example the parent
commit's, unpacked with ``git archive``).  Each tree's ``tiled_matmul.cu``
is built into a library of its own (nvcc, in parallel; ptxas's registers
and spills printed) and called through its C interface,
``smft_tiled_matmul``, with ctypes.  In order:

  1. each library at every tile against the plain version
     (``tiled_matmul.tiled_matmul_reference``): x = I and w = I give the
     other operand bit for bit (one product a sum); then ``RAGGED`` (rows,
     k and columns off every tile, a wave of units and one unit past it, K
     under one k step) and ``SHAPES`` within 2**-6 of the output's scale, as
     ``chip_smoke.py`` holds it; a call repeated gives the same bits;
  2. device ms a call (``utils/benchlib.time_ms``) at ``SHAPES`` (the
     bench's 2664 x 4096 -> 4096 and TinyLlama-1.1B's MLP at 2048 rows)
     and every tile, the libraries in turns (old, new, new, old: each
     one's time the mean of its two), beside ``torch.matmul`` (timed once a
     shape), the bound (bytes over 3.35 TB/s or operations over 989
     TFLOP/s, the larger) and this tree's plan of each call;
  3. each library's kernel launches a call and their device us at the
     bench shape and the best tile, by the profiler (its first session in
     the process: a late one may lose records).

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

from sparse_matrix_fine_tuning_torch.kernels import build as kbuild
from sparse_matrix_fine_tuning_torch.kernels.experimental import tiled_matmul as tm
from sparse_matrix_fine_tuning_torch.scripts.compare_monarch_bwd import in_turns, ptxas_lines
from sparse_matrix_fine_tuning_torch.utils import benchlib

SOURCE = "tiled_matmul.cu"
OUT = kbuild.BUILD_ROOT / "compare_tiled_matmul"
# (M, K, N): the bench shape (scripts/exp_matmul_tiles.py:57), then
# TinyLlama-1.1B's gate/up (2048 x 2048 -> 5632: 352 tiles of 128 x 256,
# 2.67 waves on 132 SMs) and down (2048 x 5632 -> 2048: 128 tiles, under one
# wave) at a 2048-row micro-batch
SHAPES = [(2664, 4096, 4096), (2048, 2048, 5632), (2048, 5632, 2048)]
# (M, K, N) of the checks: ragged in every dimension (K = 64 k + 8, N past
# every BN), at 128 x 256 tiles on 132 CTAs one wave of units (22 row tiles
# by 6 columns: 66 units of two row tiles) and one unit past it (134 row
# tiles, one column), K under one k step and of one, and one row
RAGGED = [(200, 200, 392), (2664, 1032, 264), (2811, 520, 1536), (17147, 1032, 248),
          (300, 8, 264), (2050, 64, 1000), (1, 64, 8)]
# n of the identity checks, x = I (n x n) times w (n x n) and w = I: under a
# wave of units and 4.85 waves (128 x 256 tiles, 132 CTAs)
IDENTITY = [512, 4096]


def build_lib(csrc: Path, name: str, out_root: Path = OUT) -> ctypes.CDLL:
    """``csrc``'s ``tiled_matmul.cu`` in a shared library of its own."""
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
    lib.smft_tiled_matmul.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                      + [ctypes.c_int64] * 3 + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p])
    if hasattr(lib, "smft_tiled_matmul_plan"):
        lib.smft_tiled_matmul_plan.argtypes = ([ctypes.c_int] + [ctypes.c_int64] * 3
                                               + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return lib


def plan_of(lib, m: int, k: int, n: int, tile) -> dict | None:
    """The library's plan of a call (``tiled_matmul.PLAN_KEYS``), None where
    it has no plan function (the one-CTA-a-tile design)."""
    if not hasattr(lib, "smft_tiled_matmul_plan"):
        return None
    out = (ctypes.c_int64 * len(tm.PLAN_KEYS))()
    err = lib.smft_tiled_matmul_plan(torch.cuda.current_device(), m, n, k, *tile,
                                     ctypes.cast(out, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"smft_tiled_matmul_plan returned {err}")
    return dict(zip(tm.PLAN_KEYS, list(out)))


def call_of(lib, x: torch.Tensor, w: torch.Tensor, tile):
    """A callable that runs the library's kernel at ``tile`` into a
    preallocated output and returns it."""
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty(m, n, device=x.device, dtype=x.dtype)
    args = [x.device.index or 0, x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k, *tile]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.smft_tiled_matmul(*args, stream)
        if err:
            raise RuntimeError(f"smft_tiled_matmul {tile} returned {err}")
        return y
    call.tensors = (x, w)  # args' pointers stay valid while call lives
    return call


def cost(m: int, k: int, n: int) -> tuple[int, int]:
    """(bytes, operations): x and w read once, y written once (bf16); a
    multiply-add counts two."""
    return 2 * (m * k + k * n + m * n), 2 * m * k * n


def tolerance(ref: torch.Tensor) -> float:
    """Two bf16 ulps at the output's scale (2**-6 of it): both sides sum in
    fp32, in another order, and round once to bf16."""
    return float(ref.float().abs().max()) * 2.0 ** -6


def old_waves(m: int, n: int, tile, sms: int = 132) -> float:
    """Waves of the one-CTA-a-tile grid (tiles over SMs at one CTA an SM)."""
    return tm.cdiv(m, tile[0]) * tm.cdiv(n, tile[1]) / sms


def inputs(m: int, k: int, n: int, g: torch.Generator):
    """x (m, k) and w (k, n) bf16, scaled as the JAX script's (w times 0.02)."""
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    return x, w


def check(name: str, call, x, w, tile, what: str) -> float:
    want = tm.tiled_matmul_reference(x, w)
    got = call().clone()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if got.shape != want.shape or not bool(torch.isfinite(got).all()) or err > tolerance(want):
        raise RuntimeError(f"{name} {tile} {what}: max abs err {err} > {tolerance(want)}")
    if not torch.equal(call(), got):
        raise RuntimeError(f"{name} {tile} {what}: a repeated call gave other bits")
    return err


def check_lib(name: str, lib, g: torch.Generator) -> None:
    with torch.no_grad():
        for n in IDENTITY:
            eye = torch.eye(n, device="cuda", dtype=torch.bfloat16)
            w = torch.randn(n, n, generator=g, device="cuda").to(torch.bfloat16)
            for tile in tm.TILES:
                for a, b, want, label in ((eye, w, w, "x = I"), (w, eye, w, "w = I")):
                    got = call_of(lib, a, b, tile)()
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise RuntimeError(f"{name} {tile}: {label} ({n}) is not the other "
                                           f"operand: {int((got != want).sum())} entries differ")
        print(f"{name}: identity checks exact at every tile (n {IDENTITY})", flush=True)
        worst = 0.0
        for m, k, n in RAGGED + SHAPES:
            x, w = inputs(m, k, n, g)
            for tile in tm.TILES:
                worst = max(worst, check(name, call_of(lib, x, w, tile), x, w, tile, f"{(m, k, n)}"))
        print(f"{name}: every tile within tolerance at {len(RAGGED + SHAPES)} shapes, repeats "
              f"bit for bit (largest error {worst:.3e})", flush=True)


def time_shapes(libs: dict, g: torch.Generator) -> dict:
    out = {}
    with torch.no_grad():
        for m, k, n in SHAPES:
            x, w = inputs(m, k, n, g)
            lib_ms = benchlib.time_ms(lambda: torch.matmul(x, w), 20, 3)[0]
            bound, by = benchlib.roofline_ms(*cost(m, k, n), torch.bfloat16)
            print(f"{(m, k, n)}: torch.matmul {lib_ms:.5f} ms, bound {bound:.5f} ({by})",
                  flush=True)
            for tile in tm.TILES:
                times = in_turns({lib_name: call_of(lib, x, w, tile)
                                  for lib_name, lib in libs.items()})
                plan = plan_of(libs["new"], m, k, n, tile)
                print(f"{(m, k, n)} {tile}: ms " + ", ".join(f"{k_} {v:.5f}"
                                                             for k_, v in times.items())
                      + f"; old waves {old_waves(m, n, tile):.2f}; share of the bound "
                      + ", ".join(f"{k_} {bound / v:.3f}" for k_, v in times.items())
                      + f"; vs torch.matmul " + ", ".join(f"{k_} {v / lib_ms:.3f}"
                                                          for k_, v in times.items())
                      + f"; plan {plan}", flush=True)
                out[f"{(m, k, n)} {tile}"] = {**times, "library": lib_ms, "bound": bound,
                                              "plan": plan}
            del x, w
    return out


def count_launches(libs: dict, tile, g: torch.Generator) -> dict:
    """Kernels (and memsets) a call launches and their device us, by the
    profiler, at the bench shape."""
    out = {}
    m, k, n = SHAPES[0]
    x, w = inputs(m, k, n, g)
    with torch.no_grad():
        for lib_name, lib in libs.items():
            call = call_of(lib, x, w, tile)
            call()
            torch.cuda.synchronize()
            with benchlib.device_profile() as prof:
                call()
                torch.cuda.synchronize()
            kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            out[lib_name] = kernels
            print(f"launches {lib_name} {tile} at {SHAPES[0]}: {len(kernels)} ("
                  + ", ".join(f"{name[:48]} {us:.2f} us" for name, us in kernels) + ")",
                  flush=True)
    return out


def run(libs: dict) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, lib in libs.items():
        check_lib(name, lib, g)
    calls = time_shapes(libs, g)
    bench = {tile: calls[f"{SHAPES[0]} {tile}"]["new"] for tile in tm.TILES}
    best = min(bench, key=bench.get)
    print(f"best tile at {SHAPES[0]}: {best}", flush=True)
    return {"calls": calls, "best": list(best), "launches": count_launches(libs, best, g)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="another tree's kernels/csrc (tiled_matmul.cu)")
    args = ap.parse_args(argv)
    benchlib.require_card("compare_tiled_matmul")
    print(f"device: {benchlib.card_line()}, torch {torch.__version__}", flush=True)
    with ThreadPoolExecutor(2) as ex:
        old, new = ex.map(build_lib, (args.old, kbuild.CSRC), ("old", "new"))
    return run({"old": old, "new": new})


if __name__ == "__main__":
    main()
