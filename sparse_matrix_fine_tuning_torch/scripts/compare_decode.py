"""K5 and K7 at decode rows, this tree's decode kernel against another
tree's, on the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.compare_decode --old DIR``.

``DIR`` holds another tree's ``kernels/csrc`` (for example the parent
commit's, unpacked with ``git archive``).  Each tree's ``quant_matmul.cu``
is built with its ``quant_wgmma.cu`` into a library of its own (nvcc, in
parallel) and called through its C interface, ``smft_quant_mm``, with
ctypes.  For each library, in order:

  1. the identity check: one-hot rows of x (M 1, 8 and 16, at the start of
     `in`, across int4's two halves and at its end) give rows of W bit for
     bit, bf16 and f32, int8 at in 1096 and int4 at 1088 (group 32);
  2. the plain versions (``quant_cuda.int8_matmul_reference``,
     ``int4_matmul_reference``) at the 1.1B model's seven projections, M 4
     and 16, bf16, two bf16 ulps of the output's scale;
  3. only then the timing: device ms a call (``utils/benchlib.time_ms``)
     at each projection, M 4 and 16, bf16, the libraries in turns (old,
     new, new, old: each one's time the mean of its two), warm (one
     weight set, which L2 holds) and cold (calls rotating over weight sets
     of more than ``ROTATE_BYTES``), summed over the seven projections.

Nothing is caught: a build, launch or check that fails ends the script.
It needs a CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from sparse_matrix_fine_tuning_torch import quant
from sparse_matrix_fine_tuning_torch.kernels import build as kbuild
from sparse_matrix_fine_tuning_torch.kernels import quant_cuda
from sparse_matrix_fine_tuning_torch.utils import benchlib

GROUP = 64
# (name, in, out) of the 1.1B model's adapted projections, as chip_smoke.py's
PROJECTIONS = [("q", 2048, 2048), ("k", 2048, 256), ("v", 2048, 256), ("o", 2048, 2048),
               ("gate", 2048, 5632), ("up", 2048, 5632), ("down", 5632, 2048)]
ROWS = (4, 16)
ROTATE_BYTES = 100e6
REPS, ROUNDS = 20, 3
OUT = kbuild.BUILD_ROOT / "compare_decode"


def build_lib(csrc: Path, name: str) -> ctypes.CDLL:
    """``csrc``'s quant_matmul.cu and quant_wgmma.cu in one shared library."""
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    nvcc = str(kbuild._cuda_home() / "bin" / "nvcc")
    cmd = [nvcc, kbuild.GENCODE, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-shared",
           "-I", str(csrc), "-o", str(out / "lib.so"), str(csrc / "quant_matmul.cu"),
           str(csrc / "quant_wgmma.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"build of {csrc} failed:\n{proc.stdout}")
    lib = ctypes.CDLL(str(out / "lib.so"))
    lib.smft_quant_mm.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
                                  + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p])
    lib.smft_quant_mm_workspace.argtypes = [ctypes.c_int] * 4 + [ctypes.c_int64] * 3
    lib.smft_quant_mm_workspace.restype = ctypes.c_int64
    return lib


def forward(lib, bits: int, x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
            group: int = GROUP):
    """A callable that runs the library's forward into a preallocated y."""
    m_rows, n_in = x.shape
    n_out = codes.shape[1]
    dtype = 1 if x.dtype == torch.bfloat16 else 0
    floats = lib.smft_quant_mm_workspace(dtype, 0, bits, 0, m_rows, n_in, n_out)
    work = torch.empty(max(floats, 1), device=x.device, dtype=torch.float32)
    y = torch.empty(m_rows, n_out, device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.smft_quant_mm(dtype, 0, bits, 0, x.data_ptr(), codes.data_ptr(),
                                scales.data_ptr(), y.data_ptr(), work.data_ptr(), m_rows, n_in,
                                n_out, group if bits == 4 else 0, stream)
        if err:
            raise RuntimeError(f"smft_quant_mm returned {err}")
        return y
    return call


def weight(bits: int, n_in: int, n_out: int, g: torch.Generator, group: int = GROUP):
    w = torch.randn(n_out, n_in, generator=g, device="cuda") * 0.02
    return quant._quantize_int4_device(w, group) if bits == 4 else quant._quantize_int8_device(w)


def plain(bits, x, codes, scales, group=GROUP):
    if bits == 8:
        return quant_cuda.int8_matmul_reference(x, codes, scales)
    return quant_cuda.int4_matmul_reference(x, codes, scales, group)


def check_identity(lib, name: str, g: torch.Generator) -> None:
    for bits, n_in, n_out, group in ((8, 1096, 272, 0), (4, 1088, 272, 32)):
        codes, scales = weight(bits, n_in, n_out, g, group or GROUP)
        for dtype in (torch.bfloat16, torch.float32):
            w = (quant_cuda.dequant_int8_t(codes, scales, dtype) if bits == 8 else
                 torch.cat(quant_cuda.dequant_int4_t(codes, scales, group, dtype)))
            for m_rows in (1, 8, 16):
                for start in (0, n_in // 2 - m_rows // 2, n_in - m_rows):
                    x = torch.zeros(m_rows, n_in, device="cuda", dtype=dtype)
                    x[torch.arange(m_rows), start + torch.arange(m_rows)] = 1
                    y = forward(lib, bits, x, codes, scales, group)()
                    torch.cuda.synchronize()
                    if not torch.equal(y, w[start:start + m_rows]):
                        raise RuntimeError(f"{name}: int{bits} {dtype} M={m_rows} at {start}: "
                                           f"not the rows of W")
    print(f"{name}: identity: rows of W bit for bit (int8 in 1096, int4 in 1088 group 32; "
          f"M 1, 8, 16; bf16, f32)", flush=True)


def rotating(calls):
    state = {"i": 0}

    def call():
        state["i"] += 1
        return calls[state["i"] % len(calls)]()
    return call


def run(libs: dict) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, lib in libs.items():
        check_identity(lib, name, g)
    out = {}
    with torch.no_grad():
        for bits in (4, 8):
            for m_rows in ROWS:
                sums = {(name, kind): 0.0 for name in libs for kind in ("warm", "cold")}
                for proj, n_in, n_out in PROJECTIONS:
                    codes, scales = weight(bits, n_in, n_out, g)
                    nbytes = codes.numel() + 4 * scales.numel()
                    sets = [(codes, scales)] + [weight(bits, n_in, n_out, g) for _ in
                                                range(math.ceil(ROTATE_BYTES / nbytes))]
                    x = torch.randn(m_rows, n_in, generator=g, device="cuda").to(torch.bfloat16)
                    want = plain(bits, x, codes, scales)
                    tol = float(want.float().abs().max()) * 2.0 ** -6
                    calls = {}
                    for name, lib in libs.items():
                        y = forward(lib, bits, x, codes, scales)()
                        torch.cuda.synchronize()
                        err = float((y.float() - want.float()).abs().max())
                        if err > tol or not bool(torch.isfinite(y).all()):
                            raise RuntimeError(f"{name}: int{bits} {proj} M={m_rows}: max abs "
                                               f"err {err} > {tol}")
                        calls[name] = (forward(lib, bits, x, codes, scales),
                                       rotating([forward(lib, bits, x, c, s) for c, s in sets]))
                    line = []
                    for kind, idx in (("warm", 0), ("cold", 1)):
                        times = {name: [] for name in libs}
                        order = list(libs) + list(libs)[::-1]  # old, new, new, old
                        for name in order:
                            times[name].append(benchlib.time_ms(calls[name][idx], REPS, ROUNDS)[0])
                        for name in libs:
                            ms = sum(times[name]) / len(times[name])
                            sums[(name, kind)] += ms
                            line.append(f"{name} {kind} {ms * 1e3:.2f}")
                    print(f"int{bits} M={m_rows} {proj:5s} {n_in}->{n_out}: us "
                          + ", ".join(line), flush=True)
                    del sets, calls
                print(f"int{bits} M={m_rows} per decoder layer, ms: "
                      + ", ".join(f"{name} {kind} {v:.5f}" for (name, kind), v in sums.items()),
                      flush=True)
                out[f"int{bits}_M{m_rows}"] = {f"{name}_{kind}": v for (name, kind), v in
                                               sums.items()}
    return out


def main() -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="another tree's kernels/csrc (quant_matmul.cu, quant_wgmma.cu)")
    args = ap.parse_args()
    benchlib.require_card("compare_decode")
    print(f"device: {benchlib.card_line()}, torch {torch.__version__}", flush=True)
    with ThreadPoolExecutor(2) as ex:
        old, new = ex.map(build_lib, (args.old, kbuild.CSRC), ("old", "new"))
    return run({"old": old, "new": new})


if __name__ == "__main__":
    main()
