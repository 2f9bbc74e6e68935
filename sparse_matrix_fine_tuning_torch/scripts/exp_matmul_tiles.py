"""Sweep the tiled bf16 matmul (K15) against ``torch.matmul`` on the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.exp_matmul_tiles``.

Counterpart of ``scripts/exp_matmul_tiles.py``, at its shape and inputs
(:57-60): x (2664, 4096) @ w (4096, 4096), bfloat16, fp32 sum, bf16 out; x
standard normal, w standard normal times 0.02, from a seeded generator.
The TPU script swept VMEM-sized tiles of a Pallas kernel against XLA; this
one sweeps ``tiled_matmul.TILES`` of the hand-written Hopper kernel
(``kernels/csrc/tiled_matmul.cu``) against ``torch.matmul`` (cuBLAS).

It prints the card's name and power limit, the bound (the larger of the
operations over 989 TFLOP/s and the bytes over 3.35 TB/s), the library row
and the plain version's row, then for each tile: its largest error against
the plain version (checked first; a failed check fails the script), device
us a call, TFLOP/s, the share of the bound and the ratio to
``torch.matmul``.  Times are ``utils/benchlib.time_ms``'s device times; the
wall time a call is printed beside them, labelled.  It needs a CUDA card
and fails without one.
"""

from __future__ import annotations

import torch

from sparse_matrix_fine_tuning_torch.kernels.experimental.tiled_matmul import (
    TILES,
    tiled_matmul,
    tiled_matmul_reference,
)
from sparse_matrix_fine_tuning_torch.utils import benchlib

SHAPE = (2664, 4096, 4096)  # (M, K, N): scripts/exp_matmul_tiles.py:57
REPS, ROUNDS = 20, 5  # calls a timed round; rounds (utils/benchlib.time_ms)
PLAIN_REPS, PLAIN_ROUNDS = 5, 3  # the fp32 plain version is about 20x slower


def cost(m: int, k: int, n: int) -> tuple[int, int]:
    """(bytes, operations) of the product: x and w read once, y written once
    (bf16); a multiply-add counts two."""
    return 2 * (m * k + k * n + m * n), 2 * m * k * n


def bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    return benchlib.roofline_ms(*cost(m, k, n), torch.bfloat16)


def tolerance(ref: torch.Tensor) -> float:
    """Two bf16 ulps at the output's scale (2**-6 of it): both sides sum in
    fp32, in another order, and round once to bf16."""
    return float(ref.float().abs().max()) * 2.0 ** -6


def make_inputs(m: int, k: int, n: int, seed: int = 0):
    """x (m, k) and w (k, n) bf16 on the card, scaled as the JAX script's."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
    return x, w


def check(x: torch.Tensor, w: torch.Tensor, tile, ref: torch.Tensor) -> float:
    """The kernel at ``tile`` against the plain version; raises if it is off
    by more than ``tolerance`` or not finite.  Returns the largest error."""
    y = tiled_matmul(x, w, tile)
    torch.cuda.synchronize()
    if y.shape != ref.shape or y.dtype != ref.dtype:
        raise RuntimeError(f"tiled_matmul {tile}: {tuple(y.shape)}/{y.dtype}, expected "
                           f"{tuple(ref.shape)}/{ref.dtype}")
    err = float((y.float() - ref.float()).abs().max())
    if not (err <= tolerance(ref) and bool(torch.isfinite(y).all())):
        raise RuntimeError(f"tiled_matmul {tile} at {tuple(x.shape)} @ {tuple(w.shape)}: max abs "
                           f"err {err} > tolerance {tolerance(ref)}")
    return err


def run(m: int = SHAPE[0], k: int = SHAPE[1], n: int = SHAPE[2]) -> dict:
    """The sweep at (m, k, n).  The kernel runs ``"steps"`` times: once a tile
    for its check and ``benchlib.calls_per_timing(REPS, ROUNDS)`` to time it."""
    x, w = make_inputs(m, k, n)
    ref = tiled_matmul_reference(x, w)
    bound, bound_by = bound_ms(m, k, n)
    flops = cost(m, k, n)[1]

    def row(label: str, ms: float, call_ms: float, extra: str = "") -> None:
        print(f"  {label:22s} {ms * 1e3:9.1f} device us  {flops / ms / 1e9:6.1f} TFLOP/s  "
              f"{bound / ms:6.1%} of bound  {extra}(wall {call_ms * 1e3:.1f} us)", flush=True)

    print(f"tiled matmul {m} x {k} @ {k} x {n}, bf16: bound {bound * 1e3:.1f} us ({bound_by})",
          flush=True)
    library_ms, library_call = benchlib.time_ms(lambda: torch.matmul(x, w), REPS, ROUNDS)
    row("library torch.matmul", library_ms, library_call)
    plain_ms, plain_call = benchlib.time_ms(lambda: tiled_matmul_reference(x, w), PLAIN_REPS,
                                            PLAIN_ROUNDS)
    row("plain (fp32 matmul)", plain_ms, plain_call)
    tiles = []
    for tile in TILES:
        err = check(x, w, tile, ref)
        ms, call_ms = benchlib.time_ms(lambda: tiled_matmul(x, w, tile), REPS, ROUNDS)
        row(f"tile {tile}", ms, call_ms,
            f"{ms / library_ms:5.2f}x torch.matmul  err {err:.2e}  ")
        tiles.append({"tile": list(tile), "ms": ms, "call_ms": call_ms, "max_abs_err": err,
                      "tflops": flops / ms / 1e9, "share_of_bound": bound / ms,
                      "vs_library": ms / library_ms})
    best = min(tiles, key=lambda t: t["ms"])
    print(f"  best tile {tuple(best['tile'])}: {best['ms'] * 1e3:.1f} us, "
          f"{best['vs_library']:.2f}x torch.matmul's {library_ms * 1e3:.1f} us", flush=True)
    return {"shape": [m, k, n], "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms, "plain_ms": plain_ms, "tolerance": tolerance(ref),
            "tiles": tiles, "best": best,
            "steps": len(TILES) * (1 + benchlib.calls_per_timing(REPS, ROUNDS))}


def main() -> dict:
    benchlib.require_card("exp_matmul_tiles")
    print(f"device: {benchlib.card_line()}, torch {torch.__version__}", flush=True)
    return run()


if __name__ == "__main__":
    main()
