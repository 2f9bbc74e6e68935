"""Sweep the factor-gradient pass's row group (K13) on the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.exp_dw_kernel``.

Counterpart of ``scripts/exp_dw_kernel.py``, which asked why the TPU's dw
pass ran far from its roofline by timing XLA's four dots, the shipped
kernel and a Pallas kernel over sequence tiles ts.  This one times, in
device microseconds (``utils/benchlib``) with the share of the bound and
the kernel's plan ``(fast, groups)`` beside each:

  read floor   ``x.sum()`` and ``dout.sum()``: one read each of x and dout
  plain        ``monarch_dw_fused_reference`` (PyTorch ops), for the
               script's "jnp dw (4 XLA dots)"
  K11          ``more_linear_dw``, K4's kernel at its own plan, for
               "existing _more_dw_call"
  rows R       K13, K4's kernel with R rows a group
               (``monarch_cuda.DW_TILE_ROWS``, the script's ts), for
               "v2 ts=R"

each kernel checked against the plain version before it is timed (a
failed check fails the script).  2664 rows is ragged against every row
group, so the checks also hold the masking of the last group's rows, which
the JAX kernel lacks (it reads the padding of its last tile).

Shapes: the JAX script's (:88-93: x and dout (2664, 4096) bf16, nblocks
K = 4, w1 (K, r*K, n/K) and w2 (K, m/K, r*K) with r = 4, a rank of r*K = 16
a block, factors scaled 0.02), and the same widths with a rank of 4 a
block, the port's blk_r 4 adapters.  x and dout together are 43.6 MB,
about the H100's 50 MB L2, so the timed calls rotate through ``SETS``
input sets (131 MB) and no call finds its inputs left in L2 by the call
before.  The bound is bytes: x and dout and the factors read once, fp32
dw1 and dw2 written once, over 3.35 TB/s.  The operations' line at the
tensor cores' 989 TFLOP/s is far under it; the line at the CUDA cores'
67 TFLOP/s, the floor of a design that does not use the tensor cores (as
the port's kernels do not), is printed beside it.  It needs a CUDA card
and fails without one.
"""

from __future__ import annotations

import torch

from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda
from sparse_matrix_fine_tuning_torch.kernels.experimental import more_linear as ml
from sparse_matrix_fine_tuning_torch.utils import benchlib

# (tag, B, n, m, nblocks, rank a block)
SHAPES = [
    ("exp_dw_kernel (2664 x 4096 -> 4096, nblocks 4, rank r*K = 16)", 2664, 4096, 4096, 4, 16),
    ("blk_r 4 adapter (2664 x 4096 -> 4096, nblocks 4, rank 4)", 2664, 4096, 4096, 4, 4),
]
REPS, ROUNDS = 20, 5  # calls a timed round; rounds (utils/benchlib.time_ms)
SETS = 3  # input sets the timed calls rotate through: 3 x 43.6 MB > the 50 MB L2


def cost(b: int, n: int, m: int, nblocks: int, rank: int) -> tuple[int, int]:
    """(bytes, operations) of the dw pass in bf16: x (b, n) and dout (b, m)
    and the factors (rank * (n + m) elements) read once, fp32 dw1 and dw2
    (as many) written once; out1, dout1, dw1 and dw2 take rank multiply-adds
    an element of x or dout a row."""
    factors = rank * (n + m)
    return 2 * b * (n + m) + 2 * factors + 4 * factors, 2 * b * 2 * factors


def bound_ms(b: int, n: int, m: int, nblocks: int, rank: int) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    return benchlib.roofline_ms(*cost(b, n, m, nblocks, rank), torch.bfloat16)


def cuda_core_ms(b: int, n: int, m: int, nblocks: int, rank: int) -> float:
    """The operations over the CUDA cores' fp32 rate (no tensor cores)."""
    return cost(b, n, m, nblocks, rank)[1] / benchlib.PEAK_OPS[torch.float32] * 1e3


def tolerance(ref: torch.Tensor) -> float:
    """2**-6 of the fp32 gradient's scale, as ``chip_smoke.py`` holds K4 in
    bf16: an intermediate (out1, dout1) one bf16 ulp apart enters every
    row's product."""
    return float(ref.abs().max()) * 2.0 ** -6


def make_inputs(b: int, n: int, m: int, nblocks: int, rank: int, sets: int = SETS,
                seed: int = 0):
    """``sets`` pairs (x (b, n), dout (b, m)) and w1 (nblocks, rank, n /
    nblocks), w2 (nblocks, m / nblocks, rank), bf16 on the card, scaled as
    the JAX script's (:89-92)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    pairs = [(randn(b, n), randn(b, m)) for _ in range(sets)]
    return pairs, randn(nblocks, rank, n // nblocks, scale=0.02), \
        randn(nblocks, m // nblocks, rank, scale=0.02)


def check(name: str, got, want) -> float:
    """The largest error over (dw1, dw2); raises past ``tolerance``."""
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{name}: {tuple(g.shape)}/{g.dtype}, expected "
                               f"{tuple(w.shape)}/{w.dtype}, or not finite")
        e = float((g - w).abs().max())
        if e > tolerance(w):
            raise RuntimeError(f"{name}: max abs err {e} > tolerance {tolerance(w)}")
        err = max(err, e)
    return err


def rotating(fn, pairs):
    """A call of ``fn(x, dout)`` on the next input set each time."""
    state = {"i": 0}

    def call():
        x, dout = pairs[state["i"] % len(pairs)]
        state["i"] += 1
        return fn(x, dout)

    return call


def run(tag: str, b: int, n: int, m: int, nblocks: int, rank: int) -> dict:
    """The sweep at one shape.  K11 and K13 at each row group run
    ``"steps"`` times: once for the check and
    ``benchlib.calls_per_timing(REPS, ROUNDS)`` to time it."""
    pairs, w1, w2 = make_inputs(b, n, m, nblocks, rank)
    x0, d0 = pairs[0]
    ref = monarch_cuda.monarch_dw_fused_reference(x0, d0, w1, w2)
    bound, bound_by = bound_ms(b, n, m, nblocks, rank)
    cores = cuda_core_ms(b, n, m, nblocks, rank)
    print(f"{tag}: bound {bound * 1e3:.2f} us ({bound_by}); operations "
          f"{cost(b, n, m, nblocks, rank)[1] / 1e9:.3f} GFLOP, "
          f"{cores * 1e3:.2f} us on the CUDA cores", flush=True)

    def timed(label: str, fn, extra: str = "") -> float:
        ms, call_ms = benchlib.time_ms(rotating(fn, pairs), REPS, ROUNDS)
        print(f"  {label:12s} {ms * 1e3:9.2f} device us  {bound / ms:6.1%} of bound  {extra}"
              f"(wall {call_ms * 1e3:.1f} us)", flush=True)
        return ms

    out = {"tag": tag, "shape": [b, n, m, nblocks, rank], "bound_ms": bound,
           "bound_by": bound_by, "cuda_core_ms": cores}
    out["floor_ms"] = timed("read floor", lambda x, d: (x.sum(), d.sum()))
    out["plain_ms"] = timed(
        "plain", lambda x, d: monarch_cuda.monarch_dw_fused_reference(x, d, w1, w2))
    plan = monarch_cuda.monarch_bwd_plan(b, w1.shape, w2.shape)
    err = check("K11", ml.more_linear_dw(x0, d0, w1, w2), ref)
    out["k11"] = {"ms": timed("K11", lambda x, d: ml.more_linear_dw(x, d, w1, w2),
                              f"plan {plan}  err {err:.2e}  "),
                  "plan": plan, "max_abs_err": err}
    tiles = []
    for rows in monarch_cuda.DW_TILE_ROWS:
        plan = monarch_cuda.monarch_bwd_plan(b, w1.shape, w2.shape, rows)
        err = check(f"K13 rows {rows}", monarch_cuda.monarch_dw_tile(x0, d0, w1, w2, rows), ref)
        ms = timed(f"rows {rows}",
                   lambda x, d: monarch_cuda.monarch_dw_tile(x, d, w1, w2, rows),
                   f"plan {plan}  err {err:.2e}  ")
        tiles.append({"rows": rows, "ms": ms, "plan": plan, "max_abs_err": err,
                      "share_of_bound": bound / ms, "vs_floor": ms / out["floor_ms"]})
    out["tiles"] = tiles
    out["best"] = min(tiles, key=lambda t: t["ms"])
    out["steps"] = 1 + benchlib.calls_per_timing(REPS, ROUNDS)
    print(f"  best row group {out['best']['rows']}: {out['best']['ms'] * 1e3:.2f} us, "
          f"{out['best']['vs_floor']:.2f}x the read floor; K11 {out['k11']['ms'] * 1e3:.2f} us",
          flush=True)
    return out


def main() -> list[dict]:
    benchlib.require_card("exp_dw_kernel")
    print(f"device: {benchlib.card_line()}, torch {torch.__version__}", flush=True)
    return [run(*shape) for shape in SHAPES]


if __name__ == "__main__":
    main()
