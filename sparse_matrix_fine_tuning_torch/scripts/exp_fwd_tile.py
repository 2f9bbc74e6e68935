"""Sweep the Monarch forward's row tile (K12) on the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.exp_fwd_tile``.

Counterpart of ``scripts/exp_fwd_tile.py``.  The TPU script asked why its
fused forward ran far from its roofline, by timing a copy floor, XLA's
unfused forward, XLA on the expanded weights and a Pallas kernel over row
tiles ts.  This one times, in device microseconds (``utils/benchlib``) with
the share of the bound beside each:

  copy floor     ``x * 1.0000001``: reads and writes x once (:57-58)
  plain unfused  ``blockdiag_butterfly_multiply`` (PyTorch ops)
  library        ``F.linear`` on the dense equivalent matrix; it stands in
                 for the script's "xla expanded" row, since the port never
                 builds the expanded W1bd/W2hat
  rows R         K12, K1's kernel at a row tile of R
                 (``monarch_cuda.FWD_TILE_ROWS``), each checked against
                 the plain version before it is timed (a failed check fails
                 the script)

at two shapes: the JAX script's (:47-50: x (2664, 4096) bf16, nblocks K =
4, factors w1 (K, r*K, n/K) and w2 (K, m/K, r*K) with r = 4, so a rank of
r*K = 16 a block), and the same widths with a rank of 4 a block, the
port's blk_r 4 adapters.  The bound is the bytes of x, the factors and the
output over 3.35 TB/s (the operations are far under the card's line).  It
needs a CUDA card and fails without one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda
from sparse_matrix_fine_tuning_torch.ops.monarch import (
    blockdiag_butterfly_multiply,
    monarch_dense_equivalent,
)
from sparse_matrix_fine_tuning_torch.utils import benchlib

# (tag, B, n, m, nblocks, rank a block)
SHAPES = [
    ("exp_fwd_tile (2664 x 4096 -> 4096, nblocks 4, rank r*K = 16)", 2664, 4096, 4096, 4, 16),
    ("blk_r 4 adapter (2664 x 4096 -> 4096, nblocks 4, rank 4)", 2664, 4096, 4096, 4, 4),
]
REPS, ROUNDS = 50, 5  # calls a timed round; rounds (utils/benchlib.time_ms)


def cost(b: int, n: int, m: int, nblocks: int, rank: int) -> tuple[int, int]:
    """(bytes, operations) of the forward in bf16: x, w1 (nblocks, rank,
    n/nblocks) and w2 (nblocks, m/nblocks, rank) read once, the output
    written once; rank multiply-adds an input and an output element a row."""
    factors = rank * (n + m)
    return 2 * (b * (n + m) + factors), 2 * b * factors


def bound_ms(b: int, n: int, m: int, nblocks: int, rank: int) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    return benchlib.roofline_ms(*cost(b, n, m, nblocks, rank), torch.bfloat16)


def tolerance(ref: torch.Tensor) -> float:
    """Two bf16 ulps at the output's scale (2**-6 of it): the intermediate
    may round one ulp apart, and the output rounds once more."""
    return float(ref.float().abs().max()) * 2.0 ** -6


def make_inputs(b: int, n: int, m: int, nblocks: int, rank: int, seed: int = 0):
    """x (b, n), w1 (nblocks, rank, n / nblocks), w2 (nblocks, m / nblocks,
    rank), bf16 on the card, scaled as the JAX script's (:48-50)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    return (randn(b, n), randn(nblocks, rank, n // nblocks, scale=0.02),
            randn(nblocks, m // nblocks, rank, scale=0.02))


def check(x, w1, w2, rows: int, ref: torch.Tensor) -> float:
    """K12 at ``rows`` against the plain version; raises if it is off by more
    than ``tolerance`` or not finite.  Returns the largest error."""
    y = monarch_cuda.monarch_fwd_tile(x, w1, w2, rows)
    torch.cuda.synchronize()
    if y.shape != ref.shape or y.dtype != ref.dtype:
        raise RuntimeError(f"monarch_fwd_tile rows {rows}: {tuple(y.shape)}/{y.dtype}, "
                           f"expected {tuple(ref.shape)}/{ref.dtype}")
    err = float((y.float() - ref.float()).abs().max())
    if not (err <= tolerance(ref) and bool(torch.isfinite(y).all())):
        raise RuntimeError(f"monarch_fwd_tile rows {rows} at {tuple(x.shape)}: max abs err "
                           f"{err} > tolerance {tolerance(ref)}")
    return err


def run(tag: str, b: int, n: int, m: int, nblocks: int, rank: int) -> dict:
    """The sweep at one shape.  K12 runs ``"steps"`` times: once a row tile
    for its check and ``benchlib.calls_per_timing(REPS, ROUNDS)`` to time it."""
    x, w1, w2 = make_inputs(b, n, m, nblocks, rank)
    ref = monarch_cuda.monarch_kernel_reference(x, w1, w2)
    dense = monarch_dense_equivalent(w1.float(), w2.float()).to(x.dtype)
    bound, bound_by = bound_ms(b, n, m, nblocks, rank)
    print(f"{tag}: bound {bound * 1e3:.2f} us ({bound_by})", flush=True)

    def timed(label: str, fn, extra: str = "") -> tuple[float, float]:
        ms, call_ms = benchlib.time_ms(fn, REPS, ROUNDS)
        print(f"  {label:14s} {ms * 1e3:8.2f} device us  {bound / ms:6.1%} of bound  {extra}"
              f"(wall {call_ms * 1e3:.1f} us)", flush=True)
        return ms, call_ms

    out = {"tag": tag, "shape": [b, n, m, nblocks, rank], "bound_ms": bound,
           "bound_by": bound_by, "tolerance": tolerance(ref)}
    out["copy_ms"] = timed("copy floor", lambda: x * 1.0000001)[0]
    out["plain_ms"] = timed("plain unfused", lambda: blockdiag_butterfly_multiply(x, w1, w2))[0]
    out["library_ms"] = timed("library", lambda: F.linear(x, dense))[0]
    tiles = []
    for rows in monarch_cuda.FWD_TILE_ROWS:
        err = check(x, w1, w2, rows, ref)
        ms, call_ms = timed(f"rows {rows}", lambda: monarch_cuda.monarch_fwd_tile(x, w1, w2, rows),
                            f"err {err:.2e}  ")
        tiles.append({"rows": rows, "ms": ms, "call_ms": call_ms, "max_abs_err": err,
                      "share_of_bound": bound / ms, "vs_copy": ms / out["copy_ms"]})
    out["tiles"] = tiles
    out["best"] = min(tiles, key=lambda t: t["ms"])
    out["steps"] = len(tiles) * (1 + benchlib.calls_per_timing(REPS, ROUNDS))
    print(f"  best row tile {out['best']['rows']}: {out['best']['ms'] * 1e3:.2f} us, "
          f"{out['best']['vs_copy']:.2f}x the copy floor", flush=True)
    return out


def main() -> list[dict]:
    benchlib.require_card("exp_fwd_tile")
    print(f"device: {benchlib.card_line()}, torch {torch.__version__}", flush=True)
    return [run(*shape) for shape in SHAPES]


if __name__ == "__main__":
    main()
