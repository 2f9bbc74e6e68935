"""Where the quantized wgmma kernels (``kernels/csrc/quant_wgmma.cu``: K5's
tile path and K6 for int4, K7's tile path and K8 for int8) spend their
time, on the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.probe_int4_wgmma
[--bits 4|8]`` (int4 by default).

It builds copies of ``quant_wgmma.cu``, each changed by a source patch, into
separate libraries called through ``ctypes``.  int4 (``qwgmma_kernel``):
  * ``base``: as it is;
  * ``no_dequant``: the dequant warpgroups wait and arrive but write no B;
  * ``no_mma``: the consumer warpgroups wait and release but issue no wgmma;
  * ``loads_only``: both, leaving the TMA loads and the barriers;
  * ``trace``: ``clock64()`` stamps at every role's waits of every stage.
int8 (``--bits 8``, ``qwgmma_rs_kernel``, A in registers):
  * ``base``; ``no_build`` (A zeros: no code reads, no unpack; the waits
    for each stage stay); ``no_mma``; ``loads_only`` (both);
  * ``g<G>b<B>``: both directions on the wgmma schedule of G k16 steps a
    group and B A buffers (the kept ones: the forward g1b4, dx g4b1);
  * ``scales_late``: dx reads each group's scales at its build, not a
    group ahead;
  * ``trace``: ``clock64()`` stamps at the producer's and the consumers'
    waits of every stage.
At the 1.1B model's gate_proj (2048 -> 5632) and down_proj (5632 -> 2048)
at M = 2048 rows, bf16, it prints each variant's device ms a call
(``utils/benchlib.time_ms``; the variants that drop work give wrong
numbers, so none is checked) and the trace's medians over CTAs and stages,
in clocks a stage.  int4: the period, the MMAs, the dequant's work and its
waits for codes and for a free B stage, the consumers' waits for x and
for B.  int8: the period, the consumers' waits for a stage, the
producer's waits for a free one, and the time from a stage's loads being
issued to its first use.  int4 codes are group-64, int8 codes one scale
row, both quantized from the same seeded weights.  It needs a CUDA card
and fails without one.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from sparse_matrix_fine_tuning_torch import quant
from sparse_matrix_fine_tuning_torch.kernels import build
from sparse_matrix_fine_tuning_torch.utils import benchlib

SOURCE = build.CSRC / "quant_wgmma.cu"
SHAPES = (("gate", 2048, 5632, 0), ("gate", 2048, 5632, 1), ("down", 5632, 2048, 0))
ROWS, GROUP = 2048, 64
REPS, ROUNDS = 20, 3
TRACE_CTAS, TRACE_EVENTS, TRACE_STAGES = 1024, 16, 64

# The trace's stamps: (anchor, text put before it, text put after it); each
# anchor must occur once.  Event numbers index EVENTS.
_TRACE = [
    ("namespace {\n\nusing namespace smft_hopper;", "{head}", ""),
    ("  if (threadIdx.x == 0) {\n    for (int s = 0; s < kSa; ++s) {",
     "  if (threadIdx.x == 0) TR(10, 0);\n", ""),
    ("      const int s = kt % depth;\n", "", "      TR(acts ? 0 : 2, kt);\n"),
    ("        tma_load_2d(c_smem + s * kCBytes, &map_codes, full, col0, row0);\n      }\n",
     "", "      TR(acts ? 1 : 3, kt);\n"),
    ("      wait_or_trap(c_full + 8 * sc, (kt / kSc) & 1);\n", "", "      if (t == 0) TR(4, kt);\n"),
    ("      if (kt >= kSb) wait_or_trap(b_empty + 8 * sb, ((kt / kSb) - 1) & 1);\n",
     "", "      if (t == 0) TR(5, kt);\n"),
    ("        mbar_arrive(c_empty + 8 * sc);  // after the stores that used the codes\n      }\n",
     "", "      if (t == 0) TR(6, kt);\n"),
    ("    wait_or_trap(a_full + 8 * sa, (kt / kSa) & 1);\n",
     "", "    if (threadIdx.x == 0) TR(7, kt);\n"),
    ("    wait_or_trap(b_full + 8 * sb, (kt / kSb) & 1);\n",
     "", "    if (threadIdx.x == 0) TR(8, kt);\n"),
    ("    wgmma_wait<0>();\n", "", "    if (threadIdx.x == 0) TR(9, kt);\n"),
    ("\n  // The fragment", "  if (threadIdx.x == 0) TR(11, 0);\n", ""),
]
_TRACE_HEAD = f"""__device__ unsigned long long g_trace[{TRACE_CTAS * TRACE_EVENTS * TRACE_STAGES}];
#define TR(ev, kt)                                                                   \\
  do {{                                                                              \\
    const int cta_ = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); \\
    if (cta_ < {TRACE_CTAS} && (kt) < {TRACE_STAGES})                                \\
      g_trace[(cta_ * {TRACE_EVENTS} + (ev)) * {TRACE_STAGES} + (kt)] = clock64();   \\
  }} while (0)
extern "C" int probe_trace_read(void* dst) {{
  return cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}}
"""
_STORES_BEGIN = ("#pragma unroll\n      for (int i = 0; i < 4; ++i) {\n"
                 "        const int r = 4 * rs + i;\n        if (!uniform)")
_STORES_END = "      fence_proxy_async();\n"
_MMAS = ("wgmma_m64n128k16<0>(acc, da, db);", "wgmma_m64n128k16<1>(acc, da, db);")
VARIANTS = ("base", "no_dequant", "no_mma", "loads_only", "trace")
# int8: the register-A kernel (qwgmma_rs_kernel) with its roles dropped, its
# schedules changed, its dx scales read late, or stamped
_RS_MMA = "wgmma_m64n256k16_rs(acc, cur[i], sw128_desc(xs + (k16 % 4) * 32, 16, kAtomBytes));"
_RS_BUILD = "build(k16, s[i], x[i]);"
_RS_NO_BUILD = "x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0u;"
_RS_SCHED = ("  static constexpr int kGroup = 1, kBufs = 4;\n",
             "  static constexpr int kGroup = 4, kBufs = 1;\n")
# (k16 steps a group, A buffers) that fit the launch bound's registers
SCHEDULES = {f"g{g}b{b}": (g, b) for g, b in ((1, 2), (1, 3), (1, 4), (2, 1), (2, 2), (2, 3),
                                              (4, 1))}
_RS_LOAD_AHEAD = "    if (q + 1 < total) load_group(q + 1, sc_next);\n"
_RS_BUILD_NEXT = "    if (q + 1 < total) build_group(q + 1, sc_next, next);\n"
_RS_LOAD_LATE = ("    if (q + 1 < total) {\n      load_group(q + 1, sc_next);\n"
                 "      build_group(q + 1, sc_next, next);\n    }\n")
_RS_TRACE = [
    ("namespace {\n\nusing namespace smft_hopper;", "{head}", ""),
    ("  if (threadIdx.x == 0) {\n    for (int s = 0; s < kRsStages; ++s) {",
     "  if (threadIdx.x == 0) TR(10, 0);\n", ""),
    ("      const int s = kt % kRsStages;\n", "", "      TR(0, kt);\n"),
    ("      const uint32_t full = full0 + 8 * s, dst = base + s * kRsStage;\n",
     "      TR(5, kt);\n", ""),
    ("      tma_load_2d(dst + kRsXBytes, &map_codes, full, kDx ? k0 : n0, kDx ? n0 : k0);\n",
     "", "      TR(1, kt);\n"),
    ("      if (k16 % 4 == 0) wait_or_trap(full0 + 8 * (kt % kRsStages), (kt / kRsStages) & 1);\n",
     "      if (k16 % 4 == 0 && threadIdx.x == 0) TR(2, kt);\n",
     "      if (k16 % 4 == 0 && threadIdx.x == 0) TR(3, kt);\n"),
    ("      mbar_arrive(empty0 + 8 * ((done / 4 - 1) % kRsStages));\n", "",
     "    if (done > 0 && done % 4 == 0 && threadIdx.x == 0) TR(4, done / 4 - 1);\n"),
    ("\n  // The sums:", "  if (threadIdx.x == 0) TR(11, 0);\n", ""),
]
INT8_VARIANTS = ("base", "no_build", "no_mma", "loads_only", *SCHEDULES, "scales_late", "trace")
BITS_VARIANTS = {4: VARIANTS, 8: INT8_VARIANTS}
# quant_matmul.cu's split-reduction pass, which a variant built alone lacks;
# the probe's shapes have enough tiles never to split
_SPLIT_STUB = """
extern "C" int smft_split_sum_bf16(const float*, void*, int64_t, int, void*) {
  return cudaErrorNotSupported;
}
"""
EVENTS = ("A wait", "A issued", "C wait", "C issued", "D codes", "D B free", "D done",
          "M x", "M B", "M done", "start", "end")


def _once(src: str, anchor: str) -> int:
    if src.count(anchor) != 1:
        raise RuntimeError(f"probe_int4_wgmma: {SOURCE.name} no longer holds this anchor once: "
                           f"{anchor!r}")
    return src.index(anchor)


def _replace_once(src: str, old: str, new: str) -> str:
    _once(src, old)
    return src.replace(old, new)


def _stamp(src: str, stamps) -> str:
    for anchor, before, after in stamps:
        i = _once(src, anchor)
        before = before.replace("{head}", _TRACE_HEAD)
        src = src[:i] + before + anchor + after + src[i + len(anchor):]
    return src


def patched_source(variant: str, src: str | None = None, bits: int = 4) -> str:
    """``quant_wgmma.cu`` as the variant of ``bits``' mode builds it; raises
    where an anchor of the patch is missing, so the probe cannot measure a
    stale patch."""
    if variant not in BITS_VARIANTS.get(bits, ()):
        raise ValueError(f"unknown variant {variant!r} for bits {bits}; expected one of "
                         f"{BITS_VARIANTS.get(bits)}")
    src = SOURCE.read_text() if src is None else src
    if bits == 8:
        if variant in ("no_build", "loads_only"):
            src = _replace_once(src, _RS_BUILD, _RS_NO_BUILD)
        if variant in ("no_mma", "loads_only"):
            src = _replace_once(src, _RS_MMA, "(void)xs, (void)cur;")
        if variant in SCHEDULES:  # both lines found before either changes
            group, bufs = SCHEDULES[variant]
            for i, old in enumerate(_RS_SCHED):
                src = _replace_once(src, old, f"@sched{i}@")
            for i in range(len(_RS_SCHED)):
                src = src.replace(f"@sched{i}@", f"  static constexpr int kGroup = {group}, "
                                                 f"kBufs = {bufs};\n")
        if variant == "scales_late":
            src = _replace_once(src, _RS_LOAD_AHEAD, "")
            src = _replace_once(src, _RS_BUILD_NEXT, _RS_LOAD_LATE)
        if variant == "trace":
            src = _stamp(src, _RS_TRACE)
        return src
    if variant in ("no_dequant", "loads_only"):
        a = _once(src, _STORES_BEGIN)
        b = src.index(_STORES_END, a)
        src = src[:a] + src[b:]
    if variant in ("no_mma", "loads_only"):
        for mma in _MMAS:
            _once(src, mma)
            src = src.replace(mma, "(void)da, (void)db;")
    if variant == "trace":
        src = _stamp(src, _TRACE)
    return src


def _build(variants, out_dir: Path, bits: int) -> dict:
    nvcc = str(build._cuda_home() / "bin" / "nvcc")
    procs = {}
    for v in variants:
        cu = out_dir / f"{v}.cu"
        cu.write_text(patched_source(v, bits=bits) + _SPLIT_STUB)
        procs[v] = subprocess.Popen(
            [nvcc, build.GENCODE, "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
             "-I", str(build.CSRC), str(cu), "-o", str(out_dir / f"{v}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for v, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"probe_int4_wgmma: building {v} failed:\n{out}")
        lib = ctypes.CDLL(str(out_dir / f"{v}.so"))
        lib.smft_quant_wgmma.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
                                         + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p])
        lib.smft_quant_wgmma.restype = ctypes.c_int
        lib.smft_quant_wgmma_workspace.argtypes = [ctypes.c_int] * 3 + [ctypes.c_int64] * 3
        lib.smft_quant_wgmma_workspace.restype = ctypes.c_int64
        libs[v] = lib
    return libs


def _call(lib, bits: int, dx: int, a, codes, scales, n_in: int, n_out: int):
    device = a.device.index or 0
    out = torch.empty(ROWS, n_in if dx else n_out, device=a.device, dtype=torch.bfloat16)
    work = torch.empty(max(1, lib.smft_quant_wgmma_workspace(bits, device, dx, ROWS, n_in, n_out)),
                       device=a.device)
    group = GROUP if bits == 4 else n_in

    def run():
        err = lib.smft_quant_wgmma(bits, device, dx, a.data_ptr(), codes.data_ptr(),
                                   scales.data_ptr(), out.data_ptr(), work.data_ptr(), ROWS, n_in,
                                   n_out, group, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe_int4_wgmma: launch failed with cudaError {err}")
    return run


def trace_medians(tr: np.ndarray, ctas: int, steps: int) -> dict:
    """Medians over CTAs and stages 1 .. steps - 2 of the per-stage spans,
    in clocks, from the stamps ``tr`` (CTA, event, stage)."""
    t, k = tr[:ctas].astype(np.int64), np.arange(1, steps - 1)

    def span(e1, e2, lag=0):
        return float(np.median(t[:, e2, k] - t[:, e1, k - lag]))

    return {"period": float(np.median(t[:, 9, k] - t[:, 9, k - 1])),
            "mma": span(8, 9), "dequant work": span(5, 6),
            "dequant waits codes": span(6, 4, 1), "dequant waits B": span(4, 5),
            "consumers wait x": span(9, 7, 1), "consumers wait B": span(7, 8)}


def rs_trace_medians(tr: np.ndarray, ctas: int, steps: int) -> dict:
    """The register-A kernel's medians over CTAs and stages 1 .. steps - 2,
    in clocks, from the stamps ``tr`` (CTA, event, stage)."""
    t, k = tr[:ctas].astype(np.int64), np.arange(1, steps - 1)

    def span(e1, e2):
        return float(np.median(t[:, e2, k] - t[:, e1, k]))

    return {"period": float(np.median(t[:, 4, k] - t[:, 4, k - 1])),
            "consumers wait stage": span(2, 3), "producer waits slot": span(0, 5),
            "issue to use": span(1, 3)}


def stage_counts(bits: int, dx: int, n_in: int, n_out: int) -> tuple[int, int]:
    """(stages a CTA, CTAs) of the kernel at ROWS rows, the stages cut to
    the trace's TRACE_STAGES.  int4: a stage is 64 code rows forward, 128
    columns of out dx, over 128-row tiles of 128 columns (dx: 64 code rows
    and their partners); int8: k = 64 a stage, over 256-token tiles of 128
    columns of out (dx: of in)."""
    if bits == 4:
        steps = n_out // 128 if dx else n_in // 128
        ctas = (n_in // 128 if dx else n_out // 128) * (ROWS // 128)
    else:
        steps = (n_out if dx else n_in) // 64
        ctas = ((n_in if dx else n_out) // 128) * (ROWS // 256)
    return min(steps, TRACE_STAGES), ctas


def run(bits: int = 4) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("probe_int4_wgmma needs a CUDA card")
    if bits not in BITS_VARIANTS:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    print(benchlib.card_line(), flush=True)
    variants = BITS_VARIANTS[bits]
    g = torch.Generator().manual_seed(0)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build(variants, Path(tmp), bits)
        for proj, n_in, n_out, dx in SHAPES:
            w = (torch.randn(n_out, n_in, generator=g) * 0.05).numpy()
            q = quant.quantize_int4(w, GROUP) if bits == 4 else quant.quantize_int8(w)
            codes, scales = (torch.as_tensor(t).cuda() for t in q)
            a = torch.randn(ROWS, n_out if dx else n_in, generator=g).cuda().to(torch.bfloat16)
            tag = f"int{bits} {proj} {'dx' if dx else 'forward'} M={ROWS}"
            ms = {}
            for v in variants:
                try:
                    ms[v] = benchlib.time_ms(_call(libs[v], bits, dx, a, codes, scales, n_in,
                                                   n_out), REPS, ROUNDS)[0]
                except RuntimeError as exc:
                    raise RuntimeError(f"probe_int4_wgmma: {tag}, {v}: {exc}") from exc
            print(f"[probe] {tag}: device ms a call " +
                  ", ".join(f"{v} {ms[v]:.4f}" for v in variants), flush=True)
            _call(libs["trace"], bits, dx, a, codes, scales, n_in, n_out)()
            torch.cuda.synchronize()
            buf = np.zeros(TRACE_CTAS * TRACE_EVENTS * TRACE_STAGES, dtype=np.uint64)
            if libs["trace"].probe_trace_read(ctypes.c_void_p(buf.ctypes.data)):
                raise RuntimeError("probe_int4_wgmma: reading the trace failed")
            steps, tiles = stage_counts(bits, dx, n_in, n_out)
            medians = trace_medians if bits == 4 else rs_trace_medians
            med = medians(buf.reshape(TRACE_CTAS, TRACE_EVENTS, TRACE_STAGES),
                          min(tiles, TRACE_CTAS), steps)
            print(f"[probe] {tag}: clocks a stage (medians, {steps} stages a CTA): " +
                  ", ".join(f"{k} {v:.0f}" for k, v in med.items()), flush=True)
            results[tag] = {"ms": ms, "trace": med}
    return results


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--bits", type=int, default=4, choices=sorted(BITS_VARIANTS))
    try:
        run(parser.parse_args().bits)
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        sys.exit(1)
