"""Where K9 and K10 (``csrc/more_linear.cu``, bf16) spend their time, on
the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.probe_more_linear [--old DIR]``.

Builds patched copies of ``more_linear.cu`` (``VARIANTS``: this tree's
kernel; with ``--old DIR``, ``OLD_VARIANTS`` of that tree's, the design this
tree's replaced), each into a library of its own (nvcc, in parallel), with
one phase dropped, and times K9 and K10 of each, in turns with the
unpatched kernel, at ``bench_more_linear``'s three shapes (bf16).  A
dropped phase leaves the results wrong: those variants are timed, never
checked (the unpatched kernel and the whole ones, ``CHECKED``, are checked
against the plain versions first).  The difference of a variant's time to the whole kernel's is what
that phase costs where it does not overlap the rest.
``tests/test_torch_probe_more_linear.py`` checks on the CPU that every
patch of ``VARIANTS`` still applies to this tree's source.  It needs a CUDA
card and fails without one.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from sparse_matrix_fine_tuning_torch.kernels import build as kbuild
from sparse_matrix_fine_tuning_torch.scripts import bench_more_linear as bench
from sparse_matrix_fine_tuning_torch.scripts import compare_more_linear as cmp
from sparse_matrix_fine_tuning_torch.utils import benchlib

SOURCE = "more_linear.cu"
OUT = kbuild.BUILD_ROOT / "probe_more_linear"
_NEVER = "if (p.M < 0)\n"  # a condition the compiler cannot fold: the work never runs
# name -> [(text of this tree's more_linear.cu, its replacement)]
VARIANTS = {
    "full": [],
    # the row summaries' wgmma m64nJKk16 in the mainloop
    "no summary mma": [("      mma_summary<JK>(sacc, da,",
                        "      " + _NEVER + "      mma_summary<JK>(sacc, da,")],
    # the builder warps' loads and writes of each stage's factor slice
    "no factor slices": [
        ("      if (p.fast) fs.fetch(", "      if (p.M < 0 && p.fast) fs.fetch("),
        ("      if (p.fast) {\n        fs.store(",
         "      if (p.M >= 0) {\n      } else if (p.fast) {\n        fs.store(")],
    # the tile's Monarch factor and the epilogue's register-A wgmma
    "no monarch term": [
        ("      if (!kDx && p.fast_epi) {",
         "      if (p.M >= 0) {\n      } else if (!kDx && p.fast_epi) {"),
        ("    mma_monarch<BN>(acc, af[q],", "    " + _NEVER + "    mma_monarch<BN>(acc, af[q],")],
}
VARIANTS["mainloop only"] = (VARIANTS["no summary mma"] + VARIANTS["no factor slices"]
                             + VARIANTS["no monarch term"])
# the builders' fence of each slice to the async proxy (the MMAs may then
# read stale entries)
_FENCE = ("      fence_proxy_async();\n      __syncwarp();\n"
          "      if (lane == 0) mbar_arrive(bars + 8 * s);")
VARIANTS["no slice fence"] = [(_FENCE, "      " + _NEVER + _FENCE)]
# the epilogue's TMA stores of the output tile
VARIANTS["no output stores"] = [("        tma_store_2d(&map_y,", "        " + _NEVER
                                 + "        tma_store_2d(&map_y,")]
# the whole kernel with every factor slice written whole at every step (the
# fast paths off): checked
VARIANTS["slices written whole"] = [("  p.fast = fast;\n", "  p.fast = 0;\n")]
# the whole kernel with K9's Monarch factor written by the general path
# (write_factor) instead of by runs of w2: checked
VARIANTS["no fast_epi"] = [("  p.fast_epi = !kDx &&", "  p.fast_epi = 0 && !kDx &&")]
# the whole kernel with W1bd's rows read 2 bytes at a time instead of 16
# (K10's Monarch factor at the bench shapes): checked
VARIANTS["no w1_vec"] = [("  p.w1_vec = g.P % 8 == 0 &&", "  p.w1_vec = 0 && g.P % 8 == 0 &&")]
CHECKED = ("full", "slices written whole", "no fast_epi", "no w1_vec")
# The design this tree's replaced (the parent commit's: a row-summary
# pre-pass, then an mma.sync GEMM whose epilogue adds the Monarch term):
# name -> [(text of that more_linear.cu, its replacement)]
OLD_VARIANTS = {
    "full": [],
    # the epilogue's staging of the summary rows and factor columns and its
    # D FMAs an output
    "no monarch term": [
        ("  const Epi e = stage_epilogue<bf16, kDx>(reinterpret_cast<float*>(smem), summ, w1, w2, "
         "g, m0,\n                                          n0, N);\n  __syncthreads();\n", ""),
        (" + monarch_term(e, row_l, col_l, jb0);", ";"),
        (" + monarch_term(e, row_l, col_l + 1, jb1);", ";")],
    # the pre-pass launch (the GEMM's epilogue reads the scratch as it is)
    "no summary": [("  if (db == 4) {\n    summary_kernel<T, kDx, 4>",
                    "  if (sizeof(T) == 2) {\n  } else if (db == 4) {\n"
                    "    summary_kernel<T, kDx, 4>")],
}
OLD_VARIANTS["gemm only"] = OLD_VARIANTS["no monarch term"] + OLD_VARIANTS["no summary"]


def patched(name: str, source: str, variants: dict | None = None) -> str:
    """``source`` with variant ``name``'s patches; raises if one does not
    apply once."""
    for old, new in (VARIANTS if variants is None else variants)[name]:
        if source.count(old) != 1:
            raise RuntimeError(f"probe variant {name!r}: its patch does not apply: {old[:60]!r}")
        source = source.replace(old, new)
    return source


def build_variant(csrc: Path, variants: dict, name: str):
    out = OUT / name.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    (out / SOURCE).write_text(patched(name, (csrc / SOURCE).read_text(), variants))
    for header in csrc.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    return cmp.build_lib(out, name)


def run(csrc: Path, variants: dict, checked=CHECKED) -> dict:
    with ThreadPoolExecutor(len(variants)) as ex:
        libs = dict(zip(variants, ex.map(lambda v: build_variant(csrc, variants, v), variants)))
    out = {}
    with torch.no_grad():
        for label, shape in zip(cmp.LABELS, bench.SHAPES):
            x, dout, wd, w1, w2 = cmp.bench_inputs(shape)
            for dx, a in ((False, x), (True, dout)):
                name = cmp.NAMES[dx]
                for v in [v for v in checked if v in libs]:
                    cmp.check(v, cmp.call_of(libs[v], dx, a, wd, w1, w2), dx, a, wd, w1, w2, label)
                calls = {v: cmp.call_of(lib, dx, a, wd, w1, w2) for v, lib in libs.items()}
                times = cmp.in_turns(calls)
                print(f"{label} {name}, ms: "
                      + ", ".join(f"{v} {ms:.5f}" for v, ms in times.items()), flush=True)
                out[f"{label} {name}"] = times
            del x, dout, wd, w1, w2
            torch.cuda.empty_cache()
    return out


def main() -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="probe another tree's kernels/csrc (the replaced design) instead")
    ap.add_argument("--variants", nargs="+", default=None,
                    help="only these variants (beside \"full\"); default all")
    args = ap.parse_args()
    benchlib.require_card("probe_more_linear")
    print(f"device: {benchlib.card_line()}, torch {torch.__version__}", flush=True)
    variants, checked = (OLD_VARIANTS, ("full",)) if args.old is not None else (VARIANTS, CHECKED)
    if args.variants is not None:
        unknown = set(args.variants) - set(variants)
        if unknown:
            raise SystemExit(f"probe_more_linear: no variants {sorted(unknown)}")
        variants = {v: variants[v] for v in variants if v == "full" or v in args.variants}
    return run(args.old if args.old is not None else kbuild.CSRC, variants, checked)


if __name__ == "__main__":
    main()
