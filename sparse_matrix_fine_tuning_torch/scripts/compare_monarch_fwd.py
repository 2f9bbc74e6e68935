"""K1 and K2 (the Monarch forward and its fused residual add), this tree's
kernel against another tree's, on the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.compare_monarch_fwd --old DIR [--sweep]``.

``DIR`` holds another tree's ``kernels/csrc`` (for example the parent
commit's, unpacked with ``git archive``).  Each tree's ``monarch_fwd.cu``
is built into a library of its own (nvcc, in parallel) and called through
its C interface, ``smft_monarch_fwd``, with ctypes.  For each library, in
order:

  1. the plain versions (``monarch_cuda.monarch_kernel_reference``,
     ``monarch_add_reference``) at ragged shapes (P and m no multiple of 8,
     L != K, x, base and out off 16 bytes), f32 and bf16, then at the 1.1B
     model's seven projections (nblocks 4, blk_r 4) at every row count of
     ``ROWS``, bf16: 1e-5 (f32) or two bf16 ulps (bf16) of the output's
     scale;
  2. only then the timing: device ms a call (``utils/benchlib.time_ms``)
     of K1 and K2 at each projection and row count, bf16, the libraries in
     turns (old, new, new, old: each one's time the mean of its two),
     summed over the seven projections as ms a decoder layer, beside
     ``F.linear`` (K1) and ``torch.addmm`` (K2) on the dense equivalent
     matrix, and the bound (bytes over 3.35 TB/s or operations over 989
     TFLOP/s, the larger).

Then, for this tree's kernel alone: its plan (``monarch_fwd_plan``'s
fields) at each row count and projection, its launch floor at M = 4
(``smft_monarch_fwd_empty``: an empty kernel at each call's grid, threads
and shared memory), and with ``--sweep`` forced row tiles and column splits
at each row count (``smft_monarch_fwd_planned``), each checked bit for bit
against the plan's own launch.

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
from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda
from sparse_matrix_fine_tuning_torch.ops.monarch import monarch_dense_equivalent
from sparse_matrix_fine_tuning_torch.utils import benchlib

# (name, in, out) of the 1.1B model's adapted projections, as chip_smoke.py's
PROJECTIONS = [("q", 2048, 2048), ("k", 2048, 256), ("v", 2048, 256), ("o", 2048, 2048),
               ("gate", 2048, 5632), ("up", 2048, 5632), ("down", 5632, 2048)]
ROWS = (4, 65, 256, 2048)
NBLOCKS, BLK_R = 4, 4
# (B, K, Q, P, L, S, R, offset in elements of x, base and out)
RAGGED = [(5, 4, 4, 13, 4, 7, 4, 1), (17, 2, 8, 36, 4, 9, 4, 1), (65, 4, 4, 1100, 4, 36, 4, 0),
          (3, 3, 5, 9, 5, 3, 3, 1)]
# --sweep: (rows, chunks) forced at each row count (0: the plan's own)
SWEEP = {4: [(0, 16), (0, 32), (0, 64)],
         65: [(4, 0), (2, 0), (2, 128), (8, 64)],
         256: [(4, 0), (2, 0), (8, 0), (4, 128)],
         2048: [(8, 0), (4, 0), (16, 0), (8, 256)]}
REPS, ROUNDS = 20, 3
OUT = kbuild.BUILD_ROOT / "compare_monarch_fwd"
NAMES = ("monarch_kernel", "monarch_add")


def build_lib(csrc: Path, name: str) -> ctypes.CDLL:
    """``csrc``'s monarch_fwd.cu in a shared library of its own."""
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    nvcc = str(kbuild._cuda_home() / "bin" / "nvcc")
    cmd = [nvcc, kbuild.GENCODE, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-shared",
           "-Xptxas", "-v", "-I", str(csrc), "-o", str(out / "lib.so"),
           str(csrc / "monarch_fwd.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"build of {csrc} failed:\n{proc.stdout}")
    regs = [line.strip() for line in proc.stdout.splitlines() if "registers" in line]
    print(f"{name}: built {csrc / 'monarch_fwd.cu'}; ptxas: " + " | ".join(regs), flush=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    dims = [ctypes.c_int64] + [ctypes.c_int] * 6
    lib.smft_monarch_fwd.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + dims + [
        ctypes.c_void_p]
    if hasattr(lib, "smft_monarch_fwd_planned"):
        lib.smft_monarch_fwd_planned.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + dims
            + [ctypes.c_int, ctypes.c_int64, ctypes.c_void_p])
        lib.smft_monarch_fwd_empty.argtypes = lib.smft_monarch_fwd.argtypes
        lib.smft_monarch_fwd_plan.argtypes = (
            [ctypes.c_int] + dims + [ctypes.c_int, ctypes.c_int64, ctypes.c_void_p])
    return lib


def offset_view(t: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``off`` elements into its
    buffer (off 16 bytes for off > 0), as a sliced view would."""
    buf = torch.empty(t.numel() + off, device=t.device, dtype=t.dtype)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


def forward(lib, x, w1, w2, base=None, plan=None, off: int = 0, empty: bool = False):
    """A callable that runs the library's K1 (or K2, with ``base``) into a
    preallocated output (``off`` elements into its buffer); ``plan`` =
    (rows, chunks) forces this tree's plan; ``empty`` launches the
    empty kernel at the call's plan instead."""
    m_rows = x.shape[0]
    K, Q, P = w1.shape
    L, S, R = w2.shape
    out = offset_view(torch.empty(m_rows, S * L, device=x.device, dtype=x.dtype), off)
    dtype = 1 if x.dtype == torch.bfloat16 else 0
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            base.data_ptr() if base is not None else None, out.data_ptr())

    def call():
        if empty:
            err = lib.smft_monarch_fwd_empty(dtype, 0, *ptrs, m_rows, K, Q, P, L, S, R, stream)
        elif plan is None:
            err = lib.smft_monarch_fwd(dtype, 0, *ptrs, m_rows, K, Q, P, L, S, R, stream)
        else:
            err = lib.smft_monarch_fwd_planned(dtype, 0, *ptrs, m_rows, K, Q, P, L, S, R,
                                               *plan, stream)
        if err:
            raise RuntimeError(f"smft_monarch_fwd returned {err}")
        return out
    return call


def plan_of(lib, m_rows: int, w1_shape, w2_shape) -> dict:
    """The bf16 plan of this tree's library for a call on ``m_rows`` rows."""
    out = (ctypes.c_int64 * len(monarch_cuda.FWD_PLAN_KEYS))()
    err = lib.smft_monarch_fwd_plan(2, m_rows, *w1_shape, *w2_shape, 0, 0,
                                    ctypes.cast(out, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"smft_monarch_fwd_plan returned {err}")
    return dict(zip(monarch_cuda.FWD_PLAN_KEYS, list(out)))


def tolerance(ref: torch.Tensor) -> float:
    """f32: 1e-5 of the output's scale (sums in another order); bf16: two
    ulps (the intermediate may round one ulp apart, the output once more)."""
    return float(ref.float().abs().max()) * (1e-5 if ref.dtype == torch.float32 else 2.0 ** -6)


def inputs(m_rows: int, n_in: int, n_out: int, g: torch.Generator):
    """x (M, in), w1 (nblocks, blk_r, in / nblocks), w2 (nblocks, out /
    nblocks, blk_r), base (M, out), bf16, seeded, scaled as chip_smoke.py's."""
    nb, r = NBLOCKS, BLK_R
    p, s = n_in // nb, n_out // nb
    x = torch.randn(m_rows, n_in, generator=g, device="cuda").bfloat16()
    w1 = (torch.randn(nb, r, p, generator=g, device="cuda") / p ** 0.5).bfloat16()
    w2 = (torch.randn(nb, s, r, generator=g, device="cuda") / r ** 0.5).bfloat16()
    base = torch.randn(m_rows, n_out, generator=g, device="cuda").bfloat16()
    return x, w1, w2, base


def check(name: str, lib, got_fn, x, w1, w2, base, what: str) -> None:
    want = (monarch_cuda.monarch_kernel_reference(x, w1, w2) if base is None else
            monarch_cuda.monarch_add_reference(base, x, w1, w2))
    got = got_fn()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if got.shape != want.shape or err > tolerance(want) or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name}: {what}: max abs err {err} > {tolerance(want)}")


def check_lib(name: str, lib, g: torch.Generator) -> None:
    for b, K, Q, P, L, S, R, off in RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(b, K * P, generator=g, device="cuda").to(dtype)
            w1 = (torch.randn(K, Q, P, generator=g, device="cuda") / P ** 0.5).to(dtype)
            w2 = (torch.randn(L, S, R, generator=g, device="cuda") / R ** 0.5).to(dtype)
            base = torch.randn(b, S * L, generator=g, device="cuda").to(dtype)
            x, base = offset_view(x, off), offset_view(base, off)
            for bs in (None, base):
                check(name, lib, forward(lib, x, w1, w2, bs, off=off), x, w1, w2, bs,
                      f"{(b, K, Q, P, L, S, R)} off {off} {dtype} base {bs is not None}")
    print(f"{name}: ragged and unaligned cases within tolerance (f32, bf16; K1, K2)",
          flush=True)


def cost(m_rows: int, n_in: int, n_out: int, add: bool, item: int = 2) -> tuple[int, int]:
    """(bytes, operations): x, the factors (blk_r (in + out) elements) and
    the output, base for K2, each once; blk_r multiply-adds an input and an
    output element a row, and K2's add."""
    factors = BLK_R * (n_in + n_out)
    nbytes = (m_rows * (n_in + n_out + (n_out if add else 0)) + factors) * item
    return nbytes, 2 * m_rows * factors + (m_rows * n_out if add else 0)


def run(libs: dict, sweep: bool) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, lib in libs.items():
        check_lib(name, lib, g)
    new = libs["new"]
    out = {}
    with torch.no_grad():
        for m_rows in ROWS:
            sums = {(kind, k): 0.0 for kind in list(libs) + ["library", "bound"]
                    for k in NAMES}
            for proj, n_in, n_out in PROJECTIONS:
                x, w1, w2, base = inputs(m_rows, n_in, n_out, g)
                dense = monarch_dense_equivalent(w1.float(), w2.float()).to(x.dtype)
                pl = plan_of(new, m_rows, w1.shape, w2.shape)
                line = []
                for k, bs in zip(NAMES, (None, base)):
                    calls = {}
                    for name, lib in libs.items():
                        calls[name] = forward(lib, x, w1, w2, bs)
                        check(name, lib, calls[name], x, w1, w2, bs, f"{k} {proj} M={m_rows}")
                    times = {name: [] for name in libs}
                    for name in list(libs) + list(libs)[::-1]:  # old, new, new, old
                        times[name].append(benchlib.time_ms(calls[name], REPS, ROUNDS)[0])
                    lib_call = ((lambda: F.linear(x, dense)) if bs is None else
                                (lambda: torch.addmm(base, x, dense.t())))
                    lib_ms = benchlib.time_ms(lib_call, REPS, ROUNDS)[0]
                    bound = benchlib.roofline_ms(*cost(m_rows, n_in, n_out, bs is not None),
                                                 x.dtype)[0]
                    for name in libs:
                        sums[(name, k)] += sum(times[name]) / len(times[name])
                    sums[("library", k)] += lib_ms
                    sums[("bound", k)] += bound
                    line.append(f"{k} " + ", ".join(
                        f"{name} {sum(t) / len(t) * 1e3:.2f}" for name, t in times.items())
                        + f", library {lib_ms * 1e3:.2f}, bound {bound * 1e3:.3f}")
                print(f"M={m_rows} {proj:5s} {n_in}->{n_out} plan {pl}: us " + "; ".join(line),
                      flush=True)
            print(f"M={m_rows} per decoder layer, ms: " + ", ".join(
                f"{k} {kind} {v:.5f}" for (kind, k), v in sums.items()), flush=True)
            out[f"M{m_rows}"] = {f"{kind}_{k}": v for (kind, k), v in sums.items()}
        out["floor"] = launch_floor(new, g)
        if sweep:
            out["sweep"] = sweep_plans(new, g)
    return out


def timed_variants(lib, variants: dict, m_rows: int, g: torch.Generator) -> dict:
    """ms a decoder layer of K1 and K2 at each forced plan of ``variants``
    (label -> (rows, chunks)), each checked bit for bit against the
    plan's own launch first; the variants timed in turns, forward and
    back."""
    sums = {(label, k): 0.0 for label in variants for k in NAMES}
    for proj, n_in, n_out in PROJECTIONS:
        x, w1, w2, base = inputs(m_rows, n_in, n_out, g)
        for k, bs in zip(NAMES, (None, base)):
            own = forward(lib, x, w1, w2, bs)().clone()
            calls = {}
            for label, plan in variants.items():
                calls[label] = forward(lib, x, w1, w2, bs, plan=plan)
                got = calls[label]()
                torch.cuda.synchronize()
                if not torch.equal(got, own):
                    raise RuntimeError(f"plan {label} {plan} differs from the plan's own "
                                       f"launch at {k} {proj} M={m_rows}")
            times = {label: [] for label in variants}
            for label in list(variants) + list(variants)[::-1]:
                times[label].append(benchlib.time_ms(calls[label], REPS, ROUNDS)[0])
            for label in variants:
                sums[(label, k)] += sum(times[label]) / 2
    return sums


def launch_floor(lib, g: torch.Generator) -> dict:
    """ms a decoder layer at M = 4 of the empty kernel at each K1 and K2
    call's plan."""
    sums = dict.fromkeys(NAMES, 0.0)
    for proj, n_in, n_out in PROJECTIONS:
        x, w1, w2, base = inputs(4, n_in, n_out, g)
        for k, bs in zip(NAMES, (None, base)):
            sums[k] += benchlib.time_ms(forward(lib, x, w1, w2, bs, empty=True), REPS, ROUNDS)[0]
    print("M=4 launch floor (empty kernel at each call's plan), ms a decoder layer: "
          + ", ".join(f"{k} {v:.5f}" for k, v in sums.items()), flush=True)
    return sums


def sweep_plans(lib, g: torch.Generator) -> dict:
    out = {}
    for m_rows, plans in SWEEP.items():
        variants = {f"rows {r} chunks {c}": (r, c) for r, c in plans}
        sums = timed_variants(lib, variants, m_rows, g)
        print(f"M={m_rows} sweep, ms a decoder layer: " + ", ".join(
            f"{k} {label} {v:.5f}" for (label, k), v in sums.items()), flush=True)
        out[f"M{m_rows}"] = {f"{label}_{k}": v for (label, k), v in sums.items()}
    return out


def main() -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="another tree's kernels/csrc (monarch_fwd.cu)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time this tree's kernel at forced row tiles and column splits")
    args = ap.parse_args()
    benchlib.require_card("compare_monarch_fwd")
    print(f"device: {benchlib.card_line()}, torch {torch.__version__}", flush=True)
    with ThreadPoolExecutor(2) as ex:
        old, new = ex.map(build_lib, (args.old, kbuild.CSRC), ("old", "new"))
    return run({"old": old, "new": new}, args.sweep)


if __name__ == "__main__":
    main()
