"""Time the fused dense + Monarch linear against the unfused paths on the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.bench_more_linear``.

Counterpart of ``scripts/bench_more_linear.py``, at its shapes: the Llama-7B
projections at 2664 rows (4 x 666 tokens) and the reference micro-bench
(1024 x 1024, blk_r 16), bfloat16, inputs drawn from a seeded generator and
scaled as there (:38-42).  Each path computes the value and the gradients
with respect to x, w1 and w2 of ``sum(y.float() ** 2)`` (dense_w frozen):

  fused   ``more_linear``: K9 forward, K10 and K11 backward
  hybrid  ``F.linear`` (cuBLAS) then ``monarch_cuda.monarch_add`` (K2, whose
          backward is K3); the dense part's dx is cuBLAS
  plain   ``F.linear`` plus the plain Monarch multiply (PyTorch ops)

It prints the fused loss against the plain one, then microseconds a step
(CUDA events around back-to-back steps after a warmup, the median of
several rounds) and the speedups.  It needs a CUDA card and fails without
one.
"""

from __future__ import annotations

import statistics

import torch
import torch.nn.functional as F

from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda
from sparse_matrix_fine_tuning_torch.kernels.experimental.more_linear import more_linear
from sparse_matrix_fine_tuning_torch.ops.monarch import blockdiag_butterfly_multiply

# (tag, rows, n, m, nblocks, blk_r): scripts/bench_more_linear.py:73-78
SHAPES = [
    ("llama-7B qkv-shape (2664 x 4096 -> 4096, nblocks4 blk_r4)", 2664, 4096, 4096, 4, 4),
    ("reference micro-bench (1024 x 1024, nblocks4 blk_r16)", 1024, 1024, 1024, 4, 16),
    ("llama-7B gate-shape (2664 x 4096 -> 11264pad, nblocks4 blk_r8)", 2664, 4096, 11264, 4, 8),
]
WARMUP, ROUNDS, ITERS = 3, 5, 20  # steps before timing; timed rounds of ITERS steps


def make_inputs(rows: int, n: int, m: int, nblocks: int, r: int, dtype=torch.bfloat16,
                seed: int = 0):
    """x (rows, n), dense_w (m, n), w1 (nblocks, r, n / nblocks), w2
    (nblocks, m / nblocks, r) on the card, from a seeded generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    return (randn(rows, n), randn(m, n, scale=0.02), randn(nblocks, r, n // nblocks, scale=0.02),
            randn(nblocks, m // nblocks, r, scale=0.02))


def loss_fused(x, wd, w1, w2):
    return more_linear(x, wd, w1, w2).float().square().sum()


def loss_hybrid(x, wd, w1, w2):
    return monarch_cuda.monarch_add(F.linear(x, wd), x, w1, w2).float().square().sum()


def loss_plain(x, wd, w1, w2):
    return (F.linear(x, wd) + blockdiag_butterfly_multiply(x, w1, w2)).float().square().sum()


PATHS = {"fused": loss_fused, "hybrid": loss_hybrid, "plain": loss_plain}


def value_and_grad(loss_fn, x, wd, w1, w2):
    """The loss and its gradients with respect to x, w1 and w2."""
    loss = loss_fn(x, wd, w1, w2)
    return (loss, *torch.autograd.grad(loss, (x, w1, w2)))


def time_us(fn) -> float:
    """Microseconds a call: the median over ROUNDS of CUDA events around
    ITERS back-to-back calls, after WARMUP calls."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) * 1e3 / ITERS)
    return statistics.median(per_call)


def run(tag: str, rows: int, n: int, m: int, nblocks: int, r: int) -> dict:
    """The cross-check and the three paths' times at one shape.  Each path
    runs ``WARMUP + ROUNDS * ITERS`` steps (``"steps"``); the cross-check runs
    each forward once more, without a gradient."""
    x, wd, w1, w2 = make_inputs(rows, n, m, nblocks, r)
    with torch.no_grad():
        fused, plain = float(loss_fused(x, wd, w1, w2)), float(loss_plain(x, wd, w1, w2))
    rel = abs(fused - plain) / max(abs(plain), 1e-9)
    print(f"{tag}: loss rel diff fused-vs-plain = {rel:.2e}", flush=True)
    x, w1, w2 = (t.requires_grad_() for t in (x, w1, w2))
    out = {"tag": tag, "rel_diff": rel, "steps": WARMUP + ROUNDS * ITERS}
    for name, loss_fn in PATHS.items():
        us = time_us(lambda: value_and_grad(loss_fn, x, wd, w1, w2))
        print(f"  {name:8s}: {us:9.1f} us/iter", flush=True)
        out[f"{name}_us"] = us
    print(f"  speedup fused vs plain: {out['plain_us'] / out['fused_us']:.3f}x ; vs hybrid: "
          f"{out['hybrid_us'] / out['fused_us']:.3f}x", flush=True)
    return out


def main() -> list[dict]:
    if not torch.cuda.is_available():
        raise SystemExit("bench_more_linear needs a CUDA card")
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}", flush=True)
    return [run(*shape) for shape in SHAPES]


if __name__ == "__main__":
    main()
