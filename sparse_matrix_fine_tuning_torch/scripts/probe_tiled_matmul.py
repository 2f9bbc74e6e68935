"""Where K15 (``csrc/tiled_matmul.cu``) spends its time, on the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.probe_tiled_matmul [--variants NAME ...]``.

Builds patched copies of ``tiled_matmul.cu`` (``VARIANTS``), each into a
library of its own (nvcc, in parallel), with one phase dropped or one
choice changed, and times each in turns with the unpatched kernel at
``compare_tiled_matmul.SHAPES``, at ``TILES``.  A dropped phase leaves the
results wrong: those variants are timed, never checked (the unpatched
kernel and the whole ones, ``CHECKED``, are checked against the plain
version first).  The difference of a variant's time to the whole kernel's
is what that phase costs where it does not overlap the rest.
``tests/test_torch_probe_tiled_matmul.py`` checks on the CPU that every
patch still applies to this tree's source.  It needs a CUDA card and fails
without one.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
import torch

from sparse_matrix_fine_tuning_torch.kernels import build as kbuild
from sparse_matrix_fine_tuning_torch.scripts import compare_tiled_matmul as cmp
from sparse_matrix_fine_tuning_torch.utils import benchlib

SOURCE = cmp.SOURCE
OUT = kbuild.BUILD_ROOT / "probe_tiled_matmul"
TILES = [(128, 256, 4), (128, 256, 3)]  # the sweep's best tiles at the bench shape
_NEVER = "M < 0"  # a condition the compiler cannot fold: the work never runs
# name -> [(text of this tree's tiled_matmul.cu, its replacement)]
VARIANTS = {
    "full": [],
    # one CTA a cluster, each loading its own w tile (checked)
    "no multicast": [("constexpr int kCluster = 2;", "constexpr int kCluster = 1;")],
    # the units in column-major order over all the row tiles (the old grid's
    # order) instead of groups of 16 row tiles (checked)
    "one raster group": [("constexpr int kGroupRows = 16;", "constexpr int kGroupRows = 1 << 20;")],
    # the epilogue's TMA stores of the output (the staging is still written)
    "no output stores": [("if (col < N) tma_store_2d(&map_y,",
                          f"if (col < N && {_NEVER}) tma_store_2d(&map_y,")],
    # the producers' loads of w's tile (each stage then waits on x's bytes)
    "no w loads": [("mbar_expect_tx(full, T::kABytes + T::kBBytes);",
                    "mbar_expect_tx(full, T::kABytes);"),
                   ("for (int j = rank * kBoxes; j < (rank + 1) * kBoxes; ++j) {",
                    f"for (int j = rank * kBoxes; {_NEVER} && j < (rank + 1) * kBoxes; ++j) {{")],
    # the whole epilogue: the staging's writes and the stores
    "mainloop only": [("for (int h = 0; h < BN / T::kOutCols; ++h) {",
                       f"for (int h = 0; {_NEVER} && h < BN / T::kOutCols; ++h) {{")],
}
CHECKED = ("full", "no multicast", "one raster group")


def patched(name: str, source: str) -> str:
    """``source`` with variant ``name``'s patches; raises if one does not
    apply once."""
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise RuntimeError(f"probe variant {name!r}: its patch does not apply: {old[:60]!r}")
        source = source.replace(old, new)
    return source


def build_variant(name: str):
    out = OUT / "src" / name.replace(" ", "_").replace(",", "")
    out.mkdir(parents=True, exist_ok=True)
    (out / SOURCE).write_text(patched(name, (kbuild.CSRC / SOURCE).read_text()))
    for header in kbuild.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    return cmp.build_lib(out, name, OUT)


def run(variants: list[str]) -> dict:
    with ThreadPoolExecutor(len(variants)) as ex:
        libs = dict(zip(variants, ex.map(build_variant, variants)))
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    with torch.no_grad():
        for m, k, n in cmp.SHAPES:
            x, w = cmp.inputs(m, k, n, g)
            for tile in TILES:
                for v in [v for v in CHECKED if v in libs]:
                    cmp.check(v, cmp.call_of(libs[v], x, w, tile), x, w, tile, f"{(m, k, n)}")
                times = cmp.in_turns({v: cmp.call_of(lib, x, w, tile) for v, lib in libs.items()})
                print(f"{(m, k, n)} {tile}, ms: "
                      + ", ".join(f"{v} {ms:.5f}" for v, ms in times.items()), flush=True)
                out[f"{(m, k, n)} {tile}"] = times
            del x, w
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=None,
                    help="only these variants (beside \"full\"); default all")
    args = ap.parse_args(argv)
    benchlib.require_card("probe_tiled_matmul")
    print(f"device: {benchlib.card_line()}, torch {torch.__version__}", flush=True)
    chosen = list(VARIANTS)
    if args.variants is not None:
        unknown = set(args.variants) - set(VARIANTS)
        if unknown:
            raise SystemExit(f"probe_tiled_matmul: no variants {sorted(unknown)}")
        chosen = [v for v in VARIANTS if v == "full" or v in args.variants]
    return run(chosen)


if __name__ == "__main__":
    main()
