"""K3 and K4 (the Monarch backward and its one-read factor-gradient pass),
this tree's kernel against another tree's, on the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.compare_monarch_bwd --old DIR [--sweep]``.

``DIR`` holds another tree's ``kernels/csrc`` (for example the parent
commit's, unpacked with ``git archive``).  Each tree's ``monarch_bwd.cu``
is built into a library of its own (nvcc, in parallel; ptxas's registers
and spills printed) and called through its C interface,
``smft_monarch_bwd``, with ctypes.  In order:

  1. each library against the plain versions
     (``monarch_cuda.monarch_bwd_reference``, ``monarch_dw_fused_reference``)
     at ragged and unaligned shapes (``RAGGED``), then at the 1.1B model's
     seven projections (nblocks 4, blk_r 4) at every row count of ``ROWS``,
     float32 and bfloat16, K3 and K4: 1e-5 (f32) or 2**-6 (bf16) of each
     output's scale, as ``chip_smoke.py`` holds them;
  2. device ms a call (``utils/benchlib.time_ms``) of K3 and K4 at each
     projection and row count, bf16, the libraries in turns (old, new, new,
     old: each one's time the mean of its two), summed over the seven
     projections as ms a decoder layer beside the bound (bytes over 3.35
     TB/s or operations over 989 TFLOP/s, the larger); then K4 at its own
     plan and at 256 rows a group (K13 at K14's group) at the dw
     experiments' shapes (2664 x 4096 -> 4096, rank 16 and 4), their calls
     rotating over input sets past L2 as ``exp_dw_kernel``'s do;
  3. each library's kernel launches a call and their device us, by the
     profiler;
  4. with ``--sweep``, this tree's cluster kernel at forced row tiles and
     stage depths (``smft_monarch_bwd_planned``), each checked bit for bit
     against the plan's own launch, and at forced row groups (the clusters'
     count follows) with and without forced tiles, each checked against the
     plain versions; all timed a decoder layer at M = 2048.  The cluster
     size is not swept: the kernel's cluster is one CTA a block of x (K =
     4).

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
from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda
from sparse_matrix_fine_tuning_torch.scripts import exp_dw_kernel
from sparse_matrix_fine_tuning_torch.utils import benchlib

# (name, in, out) of the 1.1B model's adapted projections, as chip_smoke.py's
PROJECTIONS = [("q", 2048, 2048), ("k", 2048, 256), ("v", 2048, 256), ("o", 2048, 2048),
               ("gate", 2048, 5632), ("up", 2048, 5632), ("down", 5632, 2048)]
ROWS = (65, 2047, 2048)  # chip_smoke.BWD_ROWS: ragged and a training micro-batch
NBLOCKS, BLK_R = 4, 4
# (M, K, Q, P, L, S, R, offset in elements of x, dout and dx): the cluster
# kernel at blk_r 4, 8 and 16 ragged against its 16- and 32-row tiles, a
# slice of dout uneven over the cluster (S = 14, 6) and down_proj's P =
# 1408; one row; the generic kernel at P % 8 != 0, odd S, L != K and off 16
# bytes.
RAGGED = [(200, 4, 8, 64, 4, 48, 8, 0), (601, 4, 16, 1024, 4, 256, 16, 0),
          (65, 4, 4, 1408, 4, 512, 4, 0), (17, 4, 4, 520, 4, 14, 4, 0),
          (1, 4, 8, 16, 4, 6, 8, 0), (33, 4, 4, 32, 4, 32, 4, 1), (30, 4, 4, 12, 4, 8, 4, 0),
          (9, 4, 2, 16, 2, 13, 4, 0)]
DW_ROWS = 256  # K13's group at K14's ts (monarch_cuda.MERGED_DW_ROWS)
# --sweep at M = 2048: (rows a group, tile, stages) forced, 0 the plan's
# own; with the plan's own groups each must give the plan's own bits, and
# with smaller groups (more clusters, where smaller tiles and fewer stages
# fit two CTAs an SM) the plain versions' values
SWEEP = [(0, 16, 1), (0, 16, 2), (0, 16, 3), (0, 32, 1), (0, 32, 2), (0, 32, 3),
         (32, 0, 0), (32, 16, 1), (32, 16, 2), (32, 32, 1), (16, 16, 1), (64, 0, 0),
         (128, 0, 0)]
REPS, ROUNDS = 20, 3
OUT = kbuild.BUILD_ROOT / "compare_monarch_bwd"
NAMES = ("monarch_bwd", "monarch_dw_fused")  # K3, K4


def ptxas_lines(log: str) -> list[str]:
    """One line a kernel of nvcc's ``-Xptxas -v`` log: its name, registers
    and spill bytes."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used")[1].split("registers")[0].strip()
            out.append(f"{name}: {regs} registers; {spill}")
            name, spill = None, ""
    return out


def build_lib(csrc: Path, name: str) -> ctypes.CDLL:
    """``csrc``'s monarch_bwd.cu in a shared library of its own."""
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    nvcc = str(kbuild._cuda_home() / "bin" / "nvcc")
    cmd = [nvcc, kbuild.GENCODE, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-shared",
           "-Xptxas", "-v", "-I", str(csrc), "-o", str(out / "lib.so"),
           str(csrc / "monarch_bwd.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"build of {csrc} failed:\n{proc.stdout}")
    print(f"{name}: built {csrc / 'monarch_bwd.cu'}; ptxas:\n  "
          + "\n  ".join(ptxas_lines(proc.stdout)), flush=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    dims = [ctypes.c_int64] + [ctypes.c_int] * 6 + [ctypes.c_int64]
    lib.smft_monarch_bwd.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + dims + [
        ctypes.c_void_p]
    lib.smft_monarch_bwd_workspace.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + dims
    lib.smft_monarch_bwd_workspace.restype = ctypes.c_int64
    if hasattr(lib, "smft_monarch_bwd_planned"):
        lib.smft_monarch_bwd_planned.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + dims + [ctypes.c_int] * 2
            + [ctypes.c_void_p])
        lib.smft_monarch_bwd_plan_fields.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_int64] + [ctypes.c_int] * 6
            + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return lib


def offset_view(t: torch.Tensor, off: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``off`` elements into its
    buffer (off 16 bytes for off > 0), as a sliced view would."""
    buf = torch.empty(t.numel() + off, device=t.device, dtype=t.dtype)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


def plan_of(lib, m_rows: int, w1_shape, w2_shape, with_dx: bool, itemsize: int = 2,
            rows: int = 0, tile: int = 0, stages: int = 0) -> dict:
    """This tree's plan of a call (``monarch_cuda.BWD_PLAN_KEYS``)."""
    out = (ctypes.c_int64 * len(monarch_cuda.BWD_PLAN_KEYS))()
    err = lib.smft_monarch_bwd_plan_fields(itemsize, 0, m_rows, *w1_shape, *w2_shape, rows,
                                           int(with_dx), tile, stages,
                                           ctypes.cast(out, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"smft_monarch_bwd_plan_fields returned {err}")
    return dict(zip(monarch_cuda.BWD_PLAN_KEYS, list(out)))


def backward(lib, x, dout, w1, w2, with_dx: bool, rows: int = 0, plan=None, off: int = 0):
    """A callable that runs the library's K3 (``with_dx``) or K4 into
    preallocated outputs (dx ``off`` elements into its buffer) and returns
    them; ``plan`` = (tile, stages) forces this tree's cluster kernel's."""
    m_rows = x.shape[0]
    K, Q, P = w1.shape
    L, S, R = w2.shape
    dev = x.device
    dx = offset_view(torch.empty_like(x), off) if with_dx else None
    dw1 = torch.empty(K, Q, P, device=dev)
    dw2 = torch.empty(L, S, R, device=dev)
    dtype = 1 if x.dtype == torch.bfloat16 else 0
    ptrs = [x.data_ptr(), dout.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            dx.data_ptr() if with_dx else None]
    dims = (m_rows, K, Q, P, L, S, R, rows)
    if plan is None:
        floats = lib.smft_monarch_bwd_workspace(dtype, 0, *ptrs, *dims)
    else:
        fields = plan_of(lib, m_rows, w1.shape, w2.shape, with_dx, x.element_size(), rows, *plan)
        if not fields["fast"]:
            raise RuntimeError(f"plan {plan} does not fit {(m_rows, K, Q, P, L, S, R)}")
        floats = fields["clusters"] * K * Q * (P + S) if fields["clusters"] > 1 else 0
    if floats < 0:
        raise RuntimeError("smft_monarch_bwd_workspace failed")
    work = torch.empty(max(floats, 1), device=dev)
    args = [dtype, 0, *ptrs, work.data_ptr() if floats else None, dw1.data_ptr(),
            dw2.data_ptr(), *dims]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        if plan is None:
            err = lib.smft_monarch_bwd(*args, stream)
        else:
            err = lib.smft_monarch_bwd_planned(*args, *plan, stream)
        if err:
            raise RuntimeError(f"smft_monarch_bwd returned {err}")
        return (dx, dw1, dw2) if with_dx else (dw1, dw2)
    call.tensors = (x, dout, w1, w2, work)  # args' pointers stay valid while call lives
    return call


def tolerance(ref: torch.Tensor, dtype: torch.dtype) -> float:
    """f32: 1e-5 of the output's scale (sums in another order); bf16: 2**-6
    (an intermediate one ulp apart enters every row's product)."""
    return float(ref.float().abs().max()) * (1e-5 if dtype == torch.float32 else 2.0 ** -6)


def check(name: str, got_fn, x, dout, w1, w2, with_dx: bool, what: str) -> tuple:
    want = monarch_cuda.monarch_bwd_reference(x, w1, w2, dout)
    want = want if with_dx else want[1:]
    got = got_fn()
    torch.cuda.synchronize()
    for out, ref in zip(got, want):
        err = float((out.float() - ref.float()).abs().max())
        tol = tolerance(ref.to(x.dtype), x.dtype)
        if (out.shape != ref.shape or not bool(torch.isfinite(out).all()) or err > tol):
            raise RuntimeError(f"{name}: {what}: max abs err {err} > {tol}")
    return got


def inputs(m_rows: int, K: int, Q: int, P: int, L: int, S: int, R: int, dtype,
           g: torch.Generator):
    """x (M, K P), dout (M, L S), w1 (K, Q, P), w2 (L, S, R), seeded, scaled
    as chip_smoke.py's."""
    x = torch.randn(m_rows, K * P, generator=g, device="cuda").to(dtype)
    w1 = (torch.randn(K, Q, P, generator=g, device="cuda") / P ** 0.5).to(dtype)
    w2 = (torch.randn(L, S, R, generator=g, device="cuda") / R ** 0.5).to(dtype)
    dout = torch.randn(m_rows, L * S, generator=g, device="cuda").to(dtype)
    return x, dout, w1, w2


def projection(m_rows: int, n_in: int, n_out: int, dtype, g: torch.Generator):
    return inputs(m_rows, NBLOCKS, BLK_R, n_in // NBLOCKS, NBLOCKS, n_out // NBLOCKS, BLK_R,
                  dtype, g)


def check_lib(name: str, lib, g: torch.Generator) -> None:
    with torch.no_grad():
        for m_rows, K, Q, P, L, S, R, off in RAGGED:
            for dtype in (torch.float32, torch.bfloat16):
                x, dout, w1, w2 = inputs(m_rows, K, Q, P, L, S, R, dtype, g)
                x, dout = offset_view(x, off), offset_view(dout, off)
                for with_dx in (True, False):
                    check(name, backward(lib, x, dout, w1, w2, with_dx, off=off), x, dout, w1,
                          w2, with_dx, f"{(m_rows, K, Q, P, L, S, R)} off {off} {dtype} "
                          f"dx {with_dx}")
        print(f"{name}: ragged and unaligned cases within tolerance (f32, bf16; K3, K4)",
              flush=True)
        for m_rows in ROWS:
            for proj, n_in, n_out in PROJECTIONS:
                for dtype in (torch.float32, torch.bfloat16):
                    x, dout, w1, w2 = projection(m_rows, n_in, n_out, dtype, g)
                    for with_dx in (True, False):
                        check(name, backward(lib, x, dout, w1, w2, with_dx), x, dout, w1, w2,
                              with_dx, f"{proj} M={m_rows} {dtype} dx {with_dx}")
        print(f"{name}: the 1.1B projections at M in {ROWS} within tolerance (f32, bf16; K3, "
              "K4)", flush=True)


def cost(m_rows: int, n_in: int, n_out: int, with_dx: bool, item: int = 2,
         r: int = BLK_R) -> tuple[int, int]:
    """(bytes, operations), as ``chip_smoke.cost``: x, dout (and dx for K3)
    each once, the factors (r (in + out) elements) read in the dtype and
    their gradients written in fp32; r multiply-adds an element of x for
    out1, dw1 (and dx), and of dout for dout1 and dw2, a row."""
    factors = r * (n_in + n_out)
    rows = 2 * n_in + n_out if with_dx else n_in + n_out
    nbytes = (m_rows * rows + factors) * item + factors * 4
    macs = r * (3 * n_in + 2 * n_out) if with_dx else r * (2 * n_in + 2 * n_out)
    return nbytes, 2 * m_rows * macs


def in_turns(calls: dict) -> dict:
    """Device ms a call of each callable, timed in turns forward and back
    (old, new, new, old), each the mean of its two."""
    times = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        times[name].append(benchlib.time_ms(calls[name], REPS, ROUNDS)[0])
    return {name: sum(t) / len(t) for name, t in times.items()}


def time_layers(libs: dict, g: torch.Generator) -> dict:
    out = {}
    with torch.no_grad():
        for m_rows in ROWS:
            sums = {(kind, k): 0.0 for kind in list(libs) + ["bound"] for k in NAMES}
            for proj, n_in, n_out in PROJECTIONS:
                x, dout, w1, w2 = projection(m_rows, n_in, n_out, torch.bfloat16, g)
                line = []
                for k, with_dx in zip(NAMES, (True, False)):
                    calls = {name: backward(lib, x, dout, w1, w2, with_dx)
                             for name, lib in libs.items()}
                    for name in libs:
                        check(name, calls[name], x, dout, w1, w2, with_dx,
                              f"{k} {proj} M={m_rows}")
                    times = in_turns(calls)
                    bound = benchlib.roofline_ms(*cost(m_rows, n_in, n_out, with_dx),
                                                 torch.bfloat16)[0]
                    for name, ms in times.items():
                        sums[(name, k)] += ms
                    sums[("bound", k)] += bound
                    line.append(f"{k} " + ", ".join(f"{name} {ms * 1e3:.2f}"
                                                    for name, ms in times.items())
                                + f", bound {bound * 1e3:.3f}")
                plan = plan_of(libs["new"], m_rows, w1.shape, w2.shape, True)
                print(f"M={m_rows} {proj:5s} {n_in}->{n_out} plan {plan}: us "
                      + "; ".join(line), flush=True)
            print(f"M={m_rows} per decoder layer, ms: " + ", ".join(
                f"{k} {kind} {v:.5f}" for (kind, k), v in sums.items()), flush=True)
            out[f"M{m_rows}"] = {f"{kind}_{k}": v for (kind, k), v in sums.items()}
    return out


def rotate(calls: list):
    """A call of the next of ``calls`` each time (one an input set)."""
    state = {"i": 0}

    def call():
        fn = calls[state["i"] % len(calls)]
        state["i"] += 1
        return fn()
    return call


def time_dw(libs: dict) -> dict:
    """K4 at its own plan and at ``DW_ROWS`` rows a group, at the dw
    experiments' shapes, the calls rotating over input sets past L2."""
    out = {}
    with torch.no_grad():
        for tag, b, n, m, nb, r in exp_dw_kernel.SHAPES:
            pairs, w1, w2 = exp_dw_kernel.make_inputs(b, n, m, nb, r)
            for rows in (0, DW_ROWS):
                calls = {}
                for name, lib in libs.items():
                    per_set = [backward(lib, xx, dd, w1, w2, False, rows) for xx, dd in pairs]
                    check(name, per_set[0], *pairs[0], w1, w2, False, f"{tag} rows {rows}")
                    calls[name] = rotate(per_set)
                times = in_turns(calls)
                bound = exp_dw_kernel.bound_ms(b, n, m, nb, r)[0]
                plan = plan_of(libs["new"], b, w1.shape, w2.shape, False, rows=rows)
                print(f"dw {tag} rows {rows or 'plan'}: ms " + ", ".join(
                    f"{name} {ms:.5f}" for name, ms in times.items())
                    + f", bound {bound:.5f}; plan {plan}", flush=True)
                out[f"rank{r}_rows{rows}"] = {**times, "bound": bound}
            del pairs
            torch.cuda.empty_cache()
    return out


def count_launches(libs: dict, g: torch.Generator) -> dict:
    """Kernels a call launches and their device us, by the profiler: K3 and
    K4 at q_proj (M = 2048 and 65) and at the dw shape (rank 16)."""
    out = {}
    cases = [("q M=2048", projection(2048, 2048, 2048, torch.bfloat16, g)),
             ("q M=65", projection(65, 2048, 2048, torch.bfloat16, g)),
             ("dw rank 16", inputs(2664, 4, 16, 1024, 4, 1024, 16, torch.bfloat16, g))]
    with torch.no_grad():
        for tag, (x, dout, w1, w2) in cases:
            for name, lib in libs.items():
                for k, with_dx in zip(NAMES, (True, False)):
                    call = backward(lib, x, dout, w1, w2, with_dx)
                    call()
                    torch.cuda.synchronize()
                    with benchlib.device_profile() as prof:
                        call()
                        torch.cuda.synchronize()
                    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                               if e.device_type == torch.autograd.DeviceType.CUDA]
                    out[f"{tag} {name} {k}"] = len(kernels)
                    print(f"launches {tag} {name} {k}: {len(kernels)} ("
                          + ", ".join(f"{n[:48]} {us:.2f} us" for n, us in kernels) + ")",
                          flush=True)
    return out


def sweep(lib, g: torch.Generator) -> dict:
    """This tree's kernel at each forced (rows a group, tile, stages) of
    ``SWEEP`` that fits, against the plan's own launch (bit for bit where the
    row groups are the plan's own, else within the plain versions'
    tolerance), ms a decoder layer at M = 2048, bf16, each sum over the
    projections where the plan fits (their count beside it)."""
    m_rows = 2048
    sums, fits = {}, {}
    with torch.no_grad():
        for proj, n_in, n_out in PROJECTIONS:
            x, dout, w1, w2 = projection(m_rows, n_in, n_out, torch.bfloat16, g)
            for k, with_dx in zip(NAMES, (True, False)):
                own = [t.clone() for t in backward(lib, x, dout, w1, w2, with_dx)()]
                calls = {"plan": backward(lib, x, dout, w1, w2, with_dx)}
                for rows, tile, stages in SWEEP:
                    fields = plan_of(lib, m_rows, w1.shape, w2.shape, with_dx, 2, rows, tile,
                                     stages)
                    if not fields["fast"]:
                        continue  # does not fit in shared memory
                    label = f"rows {rows or 'plan'} tile {tile or 'plan'}/{stages or 'plan'}"
                    fn = backward(lib, x, dout, w1, w2, with_dx, rows,
                                  (tile, stages) if tile else None)
                    if rows:
                        check("new", fn, x, dout, w1, w2, with_dx, f"{k} {proj} {label}")
                    else:
                        got = fn()
                        torch.cuda.synchronize()
                        if not all(torch.equal(a, b) for a, b in zip(got, own)):
                            raise RuntimeError(f"{label} differs from the plan's own launch "
                                               f"at {k} {proj}")
                    calls[label] = fn
                    if with_dx:
                        print(f"sweep {proj} {label}: {fields}", flush=True)
                times = in_turns(calls)
                print(f"sweep {proj} {k} us: " + ", ".join(
                    f"{label} {ms * 1e3:.2f}" for label, ms in times.items()), flush=True)
                for label, ms in times.items():
                    sums[(label, k)] = sums.get((label, k), 0.0) + ms
                    fits[(label, k)] = fits.get((label, k), 0) + 1
    print(f"M={m_rows} sweep (cluster size 4 only), ms over the projections that fit: " + ", ".join(
        f"{k} {label} {v:.5f} ({fits[(label, k)]} of 7)" for (label, k), v in sums.items()),
        flush=True)
    return {f"{label}_{k}": v for (label, k), v in sums.items()}


def run(libs: dict, do_sweep: bool) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, lib in libs.items():
        check_lib(name, lib, g)
    out = {"layers": time_layers(libs, g), "dw": time_dw(libs),
           "launches": count_launches(libs, g)}
    if do_sweep:
        out["sweep"] = sweep(libs["new"], g)
    return out


def main() -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="another tree's kernels/csrc (monarch_bwd.cu)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time this tree's kernel at forced row tiles, stages and groups")
    args = ap.parse_args()
    benchlib.require_card("compare_monarch_bwd")
    print(f"device: {benchlib.card_line()}, torch {torch.__version__}", flush=True)
    with ThreadPoolExecutor(2) as ex:
        old, new = ex.map(build_lib, (args.old, kbuild.CSRC), ("old", "new"))
    return run({"old": old, "new": new}, args.sweep)


if __name__ == "__main__":
    main()
