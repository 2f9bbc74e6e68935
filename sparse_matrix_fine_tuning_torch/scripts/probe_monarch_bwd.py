"""Where the cluster kernel of K3/K4 (``csrc/monarch_bwd.cu``) spends its
time, on the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.probe_monarch_bwd``.

Builds patched copies of this tree's ``monarch_bwd.cu`` (``VARIANTS``),
each into a library of its own (nvcc, in parallel): one phase of a row
tile dropped (the summaries with their stores into the cluster's shared
memory, the cluster barrier of the exchange, the products, or one
product), or the whole kernel at another block size (256 or 512 threads a
CTA at blk_r 4 and 8, where the kernel runs 384; two 256-thread CTAs an SM
at most 128 registers, the plan taking 16-row tiles first).  It times K3
and K4 of each, in turns with the unpatched kernel, a decoder layer at a
training micro-batch (the 1.1B projections, M = 2048, bf16) and at the dw
experiments' rank-16 shape.  A dropped phase leaves the results wrong: those
variants are timed, never checked (the unpatched kernel and the whole ones,
``CHECKED``, are checked against the plain versions first).  The difference
of a variant's time to the whole kernel's is what that phase costs where it
does not overlap the rest.  ``tests/test_torch_probe_monarch_bwd.py``
checks on the CPU that every patch still applies.  It needs a CUDA card
and fails without one.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor

import torch

from sparse_matrix_fine_tuning_torch.kernels import build as kbuild
from sparse_matrix_fine_tuning_torch.scripts import compare_monarch_bwd as cmp
from sparse_matrix_fine_tuning_torch.utils import benchlib

SOURCE = kbuild.CSRC / "monarch_bwd.cu"
OUT = kbuild.BUILD_ROOT / "probe_monarch_bwd"
_OFF = "prm.M < 0 && "  # a condition the compiler cannot fold: the phase never runs
# name -> [(text of monarch_bwd.cu, its replacement)]
VARIANTS = {
    "full": [],
    "no summaries": [
        ("    // -- summaries: out1 of block c, to every CTA of the cluster, and the\n",
         "    if (prm.M < 0) {\n"
         "    // -- summaries: out1 of block c, to every CTA of the cluster, and the\n"),
        ("    // -- the exchange:", "    }\n    // -- the exchange:")],
    "no cluster barrier": [
        ("    // rounded to T, into o1, d1c and d1r\n    cluster_arrive();\n    cluster_wait();\n",
         "    // rounded to T, into o1, d1c and d1r\n")],
    "no products": [
        ("    // -- the products from the staged tile\n",
         "    // -- the products from the staged tile\n    if (prm.M < 0) {\n"),
        ("    fence_async_smem();  // this tile's reads of stage st",
         "    }\n    fence_async_smem();  // this tile's reads of stage st")],
    "no dw1": [("for (int mt = warp; mt < (P + 15) / 16; mt += kFastWarps) {",
                "for (int mt = warp; " + _OFF + "mt < (P + 15) / 16; mt += kFastWarps) {")],
    "no dx": [("for (int nb = warp; nb < P / 8; nb += kFastWarps) {",
               "for (int nb = warp; " + _OFF + "nb < P / 8; nb += kFastWarps) {")],
    "no dw2": [("for (int mt = warp; mt < (sl + 15) / 16; mt += kFastWarps) {",
                "for (int mt = warp; " + _OFF + "mt < (sl + 15) / 16; mt += kFastWarps) {")],
}
VARIANTS["copies only"] = (VARIANTS["no summaries"] + VARIANTS["no cluster barrier"]
                           + VARIANTS["no products"])
# whole kernels at another block size (blk_r 4 and 8; 16 keeps 256 threads,
# whose dw sums fill the shared memory): checked like the unpatched one
_THREADS = "__host__ __device__ constexpr int fast_threads(int q) { return q == 16 ? 256 : 384; }"
VARIANTS["256 threads"] = [(_THREADS, _THREADS.replace("384", "256"))]
VARIANTS["512 threads"] = [(_THREADS, _THREADS.replace("384", "512"))]
VARIANTS["2 CTAs an SM"] = [
    ("__launch_bounds__(fast_threads(Q), 1) bwd_cluster_kernel",
     "__launch_bounds__(fast_threads(Q), 2) bwd_cluster_kernel"),
    (_THREADS, _THREADS.replace("384", "256")),
    ("constexpr int kTiles[][2] = {{32, 3}, {32, 2}, {32, 1}, {16, 3}, {16, 2}, {16, 1}, {8, 2}, "
     "{8, 1}};", "constexpr int kTiles[][2] = {{16, 2}, {16, 1}, {8, 2}, {8, 1}};")]
CHECKED = ("full", "256 threads", "512 threads", "2 CTAs an SM")
REPS, ROUNDS = 20, 3


def patched(name: str, source: str) -> str:
    """``source`` with variant ``name``'s patches; raises if one does not
    apply once."""
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise RuntimeError(f"probe variant {name!r}: its patch does not apply: {old[:60]!r}")
        source = source.replace(old, new)
    return source


def build_variant(name: str):
    out = OUT / name.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    (out / "monarch_bwd.cu").write_text(patched(name, SOURCE.read_text()))
    return cmp.build_lib(out, name)


def run() -> dict:
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(build_variant, VARIANTS)))
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    with torch.no_grad():
        shapes = [(proj, cmp.projection(2048, n_in, n_out, torch.bfloat16, g))
                  for proj, n_in, n_out in cmp.PROJECTIONS]
        for k, with_dx in zip(cmp.NAMES, (True, False)):
            sums = dict.fromkeys(libs, 0.0)
            for proj, (x, dout, w1, w2) in shapes:
                for name in CHECKED:
                    cmp.check(name, cmp.backward(libs[name], x, dout, w1, w2, with_dx), x,
                              dout, w1, w2, with_dx, f"{k} {proj}")
                calls = {name: cmp.backward(lib, x, dout, w1, w2, with_dx)
                         for name, lib in libs.items()}
                for name, ms in cmp.in_turns(calls).items():
                    sums[name] += ms
            print(f"M=2048 {k}, ms a decoder layer: "
                  + ", ".join(f"{name} {ms:.5f}" for name, ms in sums.items()), flush=True)
            out[f"layer {k}"] = sums
        x, dout, w1, w2 = cmp.inputs(2664, 4, 16, 1024, 4, 1024, 16, torch.bfloat16, g)
        for k, with_dx in zip(cmp.NAMES, (True, False)):
            calls = {name: cmp.backward(lib, x, dout, w1, w2, with_dx)
                     for name, lib in libs.items()}
            times = cmp.in_turns(calls)
            print(f"2664 x 4096 -> 4096 rank 16 {k}, ms: "
                  + ", ".join(f"{name} {ms:.5f}" for name, ms in times.items()), flush=True)
            out[f"rank16 {k}"] = times
    return out


def main() -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    benchlib.require_card("probe_monarch_bwd")
    print(f"device: {benchlib.card_line()}, torch {torch.__version__}", flush=True)
    return run()


if __name__ == "__main__":
    main()
